"""The port's ``Translator.save``/``load`` and its one-shot decoder
programs, against the JAX package's ``Translator``, on the CPU.

``translator.json`` must be what the JAX ``Translator.save`` writes for
the same config and pipelines, key for key and value for value (the
params are the port's own format: orbax cannot be read without JAX). A
loaded port translator gives the JAX translator's tokens from bridged
weights, greedy and beam. ``__call__`` keeps one program per call shape
(a CUDA graph on the card; eager and counted alike here).
"""

import json

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu_torch.data import text as ttext
from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_translation_pairs
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline, Vocab
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

MAX_NEW = 8


@pytest.fixture(scope="module")
def bundles():
    """One tiny MT bundle in both packages: the same config, the same
    weights (the Flax tree bridged), pipelines from the same corpus."""
    pairs = synthetic_translation_pairs(64, min_len=3, max_len=8, seed=2)
    src_j = JPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_j = JPipeline.fit([t for _, t in pairs], max_seq_len=14, fixed_len=16)
    kw = dict(
        src_vocab_size=len(src_j.vocab.itos), trg_vocab_size=len(trg_j.vocab.itos),
        d_model=32, ffn_hidden=64, num_heads=2, num_layers=2, max_len=16, dropout=0.0,
    )
    jm = JTransformer(JConfig(**kw))
    dummy = np.ones((2, 8), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(5), dummy, dummy)["params"])
    params = jax.tree.map(np.array, params)
    params["lm_head"]["bias"][2] = 2.0  # eos raised: rows finish at different steps
    model = load_flax_params(Transformer(TransformerConfig(**kw)), params)
    src_t = TextPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_t = TextPipeline.fit([t for _, t in pairs], max_seq_len=14, fixed_len=16)
    port = Translator(model, src_t, trg_t, device="cpu")
    return JTranslator(jm, params, src_j, trg_j), port, [s for s, _ in pairs]


def test_translator_json_equals_the_jax_one(bundles, tmp_path):
    jt, tt, _ = bundles
    jt.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    want = json.loads((tmp_path / "jax" / "translator.json").read_text())
    got = json.loads((tmp_path / "port" / "translator.json").read_text())
    assert got == want
    assert got["config"]["dtype"] == "float32"


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_a_loaded_translator_gives_the_jax_tokens(bundles, tmp_path, method):
    jt, tt, texts = bundles
    tt.save(str(tmp_path / "m"))
    loaded = Translator.load(str(tmp_path / "m"), device="cpu")
    assert loaded.src_pipe.vocab.itos == tt.src_pipe.vocab.itos
    assert loaded.trg_pipe.spec == tt.trg_pipe.spec
    for a, b in zip(loaded.model.parameters(), tt.model.parameters()):
        assert torch.equal(a, b)
    kw = dict(method=method, max_new_tokens=MAX_NEW, beam_size=3)
    want = jt(texts[:12], **kw)
    assert loaded(texts[:12], **kw) == want == tt(texts[:12], **kw)
    assert any(len(w.split()) < MAX_NEW for w in want)  # rows end before the limit


def test_save_refuses_an_unregistered_tokenizer(bundles, tmp_path):
    _, tt, texts = bundles

    def shout(text):
        return text.upper().split()

    pipe = TextPipeline(Vocab(["A", "B"]), shout, max_seq_len=4)
    bad = Translator(tt.model, pipe, tt.trg_pipe, device="cpu")
    with pytest.raises(ValueError, match="not a registered name"):
        bad.save(str(tmp_path / "bad"))
    assert not (tmp_path / "bad" / "translator.json").exists()
    ttext.register_tokenizer("shout_io_test", shout, overwrite=True)
    pipe = TextPipeline(Vocab(["A", "B"]), "shout_io_test", max_seq_len=4)
    Translator(tt.model, pipe, tt.trg_pipe, device="cpu").save(str(tmp_path / "ok"))
    assert Translator.load(str(tmp_path / "ok"), device="cpu").src_pipe.tokenizer is shout


def test_resave_over_a_directory(bundles, tmp_path):
    """A second save over the same directory replaces the params and the
    metadata; no stale file of the first is left behind."""
    _, tt, texts = bundles
    d = tmp_path / "again"
    tt.save(str(d))
    other = Transformer(tt.model.cfg, generator=torch.Generator().manual_seed(8))
    Translator(other, tt.src_pipe, tt.trg_pipe, device="cpu").save(str(d))
    loaded = Translator.load(str(d), device="cpu")
    for a, b in zip(loaded.model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert sorted(p.name for p in d.iterdir()) == ["params", "translator.json"]
    assert sorted(p.name for p in (d / "params").iterdir()) == ["params.pt"]


def test_a_config_the_port_lacks_is_refused_on_load(bundles, tmp_path):
    _, tt, _ = bundles
    tt.save(str(tmp_path / "moe"))
    path = tmp_path / "moe" / "translator.json"
    meta = json.loads(path.read_text())
    meta["config"]["expert_axis_size"] = 4  # a field the port's config lacks
    path.write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="expert_axis_size"):
        Translator.load(str(tmp_path / "moe"), device="cpu")


def test_one_shot_programs_one_per_call_shape(bundles):
    """Two calls of one shape make one program; three shapes make three
    (greedy at 4 rows, greedy at 6 rows, beam at 4 rows); sampling makes
    none."""
    _, tt, texts = bundles
    t = Translator(tt.model, tt.src_pipe, tt.trg_pipe, device="cpu")
    first = t(texts[:4], max_new_tokens=MAX_NEW)
    assert t(texts[:4], max_new_tokens=MAX_NEW) == first
    assert t.programs().size() == 1
    t(texts[:6], max_new_tokens=MAX_NEW)
    t(texts[:4], method="beam", beam_size=2, max_new_tokens=MAX_NEW)
    t(texts[:4], method="sample", rng=torch.Generator().manual_seed(0), max_new_tokens=MAX_NEW)
    assert t.programs().size() == 3
    assert [(s["name"], s["calls"]) for s in t.programs().stats()] == [
        ("greedy", 2), ("greedy", 1), ("beam", 1)
    ]
    ids = t.translate_ids(texts[:4], max_new_tokens=MAX_NEW)
    assert ids.device.type == "cpu" and ids.dtype == torch.int64 and ids.shape == (4, MAX_NEW + 1)
