"""The translation recipe's remaining single-device options in the port,
on the CPU: length buckets, remat, the profiler window, and the native
text and row-gather routes.

- ``bucket_by_length``: one epoch of ``train_translator`` against the JAX
  ``train_translator`` from the same initial weights (the JAX recipe's own
  ``init``, carried across), dropout 0: epoch loss and ``test_loss``
  within rtol 1e-4 (Adam over 12 steps, as ``tests/test_torch_train.py``),
  ``padding_efficiency`` equal.
- ``remat``: ``fit`` with ``remat=True`` trains bit for bit like
  ``remat=False`` with dropout 0.1, at 1 and 3 steps per call, for the
  dense and the MoE model; each layer's forward runs twice a step; the
  recipe builds its model with it.
- ``fit(profile_dir=)`` and ``StepWindowTracer``: the window's
  boundary-crossing semantics at strides of 1 and K, one Chrome trace
  written, and a window left by an exception stopped.
- ``TextPipeline`` encodes ASCII batches through ``text_encode.cpp``: the
  ids equal the Python chain's and the JAX package's native route's;
  ``ArrayDataset`` gathers index batches through ``batch_gather.cpp``,
  equal to numpy fancy indexing.
"""

import glob
import json
import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data.datasets import load_multi30k as j_load_multi30k
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.data.text import (
    translation_pipelines as j_translation_pipelines,
)
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    train_translator as j_train_translator,
)
from machine_learning_apache_spark_tpu_torch import native
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
from machine_learning_apache_spark_tpu_torch.models import Transformer
from machine_learning_apache_spark_tpu_torch.models.transformer import EncoderLayer
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.utils.profiling import (
    StepWindowTracer,
    annotate,
    device_trace,
)
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

FIXTURES = "assets/fixtures"
SMALL = dict(data_root=FIXTURES, d_model=32, ffn_hidden=64, num_heads=2, max_len=24,
             epochs=1, log_every=0)


# -- length buckets ------------------------------------------------------------------


def test_bucketed_epoch_matches_the_jax_recipe(monkeypatch):
    pairs = j_load_multi30k(FIXTURES, "train")
    src_pipe, trg_pipe = j_translation_pipelines(pairs, max_len=24)
    src0 = src_pipe([s for s, _ in pairs[:2]])
    trg0 = trg_pipe([t for _, t in pairs[:2]])
    jcfg = JConfig(
        src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
        d_model=32, ffn_hidden=64, num_heads=2, max_len=24, dropout=0.0,
    )
    # The JAX recipe's initial params: its init from key(seed) on train_ds[:2].
    init = JTransformer(jcfg).init(jax.random.key(0), src0, trg0[:, :-1])["params"]
    init = jax.tree.map(np.asarray, nn.unbox(init))
    want = j_train_translator(use_mesh=False, dropout=0.0, bucket_by_length=True, **SMALL)

    monkeypatch.setattr(
        trecipe, "Transformer",
        lambda cfg, generator=None: load_flax_params(Transformer(cfg), init),
    )
    got = trecipe.train_translator(
        device="cpu", dropout=0.0, bucket_by_length=True, _return_state=True, **SMALL
    )
    assert got["padding_efficiency"] == want["padding_efficiency"] < 1.0
    assert got["state"].step == 12 and len(got["fit_result"].step_losses) == 12
    np.testing.assert_allclose(got["history"][0]["loss"], want["history"][0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
    assert got["eval_samples"] == want["eval_samples"] == 80


def test_buckets_reject_k_steps_per_call_as_the_jax_recipe_does():
    with pytest.raises(ValueError, match="incompatible with bucket_by_length"):
        trecipe.train_translator(device="cpu", bucket_by_length=True, steps_per_call=2)


# -- remat ---------------------------------------------------------------------------


def _fit(k, **cfg_kw):
    """A tiny 2-layer model (dropout 0.1) trained by ``fit`` over 6 batches
    at ``k`` steps per call, from fixed weights and dropout seed."""
    cfg = trecipe.TransformerConfig(
        src_vocab_size=20, trg_vocab_size=20, d_model=16, ffn_hidden=32, num_heads=2,
        num_layers=2, max_len=8, dropout=0.1, **cfg_kw,
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(3))
    state = tstate.TrainState.create(model=model, tx=tstate.make_optimizer("adam", 1e-3))
    return tloop.fit(
        state, trecipe.make_translation_loss(0), _batches(6), epochs=1, log_every=0,
        steps_per_call=k, rng=torch.Generator().manual_seed(1),
    )


@pytest.mark.parametrize("steps_per_call", [1, 3])
@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_remat_trains_bit_for_bit_like_no_remat(moe_experts, steps_per_call, monkeypatch):
    """Dropout 0.1 draws from the fit's generator inside every layer: the
    recompute must take the first run's masks back."""
    calls = []
    forward = EncoderLayer.forward

    def counted(self, *args, **kw):
        calls.append(torch.is_grad_enabled())
        return forward(self, *args, **kw)

    base = _fit(steps_per_call, moe_experts=moe_experts)
    monkeypatch.setattr(EncoderLayer, "forward", counted)
    remat = _fit(steps_per_call, moe_experts=moe_experts, remat=True)
    assert remat.step_losses == base.step_losses and len(base.step_losses) == 6
    assert all(torch.equal(a, b) for a, b in zip(remat.state.params, base.state.params))
    # 6 steps x 2 layers x (forward + recompute).
    assert calls == [True] * (2 * 2 * 6)


def test_the_recipe_takes_remat_into_its_model():
    out = trecipe.train_translator(
        device="cpu", dropout=0.1, remat=True, _return_state=True, **SMALL
    )
    assert out["state"].model.cfg.remat and np.isfinite(out["final_loss"])


# -- the profiler window ---------------------------------------------------------------


def _traces(d):
    return glob.glob(os.path.join(str(d), "*.pt.trace.json"))


@pytest.mark.parametrize(
    "steps,window,active_at",
    [
        (range(6), (1, 3), [False, True, True, False, False, False]),
        (range(0, 16, 4), (2, 5), [False, True, False, False]),  # stride 4
        (range(0, 16, 4), (1, 3), [False, True, False, False]),  # one stride over both
    ],
    ids=["stride-1", "stride-4", "stride-over-both"],
)
def test_step_window_tracer_enters_and_leaves_on_boundary_crossings(tmp_path, steps, window, active_at):
    t = StepWindowTracer(str(tmp_path), start=window[0], stop=window[1])
    seen = []
    for step in steps:
        t.on_step(step)
        seen.append(t.active)
        with annotate("work", step=step):
            torch.ones(8).sum()
    t.close()
    assert seen == active_at
    assert len(_traces(tmp_path)) == 1 and t.path in _traces(tmp_path)
    assert "traceEvents" in json.loads(open(t.path).read())


def test_step_window_tracer_rejects_an_empty_window_and_ignores_no_dir(tmp_path):
    with pytest.raises(ValueError, match="empty trace window"):
        StepWindowTracer(str(tmp_path), start=5, stop=5)
    t = StepWindowTracer(None, start=0, stop=2)
    t.on_step(0)
    assert not t.active and t.path is None


def _mt_state():
    model = Transformer(trecipe.TransformerConfig(
        src_vocab_size=20, trg_vocab_size=20, d_model=16, ffn_hidden=32, num_heads=2,
        max_len=8, dropout=0.0,
    ))
    return tstate.TrainState.create(model=model, tx=tstate.make_optimizer("adam", 1e-3))


def _batches(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 20, (4, 8)), rng.integers(1, 20, (4, 8))) for _ in range(n)]


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fit_profile_dir_writes_one_trace_of_the_window(tmp_path, steps_per_call):
    tloop.fit(
        _mt_state(), trecipe.make_translation_loss(0), _batches(8), epochs=1, log_every=0,
        profile_dir=str(tmp_path), profile_window=(2, 5), steps_per_call=steps_per_call,
    )
    (path,) = _traces(tmp_path)
    names = {e.get("name", "") for e in json.loads(open(path).read())["traceEvents"]}
    assert any("aten::" in n for n in names)  # the traced steps' operators


def test_an_exception_inside_the_window_stops_the_profiler(tmp_path):
    def bad_loss(model, batch, rng):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        tloop.fit(
            _mt_state(), bad_loss, _batches(4), epochs=1, log_every=0,
            profile_dir=str(tmp_path / "t"), profile_window=(0, 100),
        )
    assert len(_traces(tmp_path / "t")) == 1
    with device_trace(str(tmp_path / "t2")) as prof:  # a fresh trace starts
        torch.ones(4).sum()
    assert len(_traces(tmp_path / "t2")) == 1 and prof.key_averages()


# -- native text and row gather ---------------------------------------------------------

TEXTS = [
    "Two young, White males are outside near many bushes.",
    "html <br /> breaks <br />here",
    "  collapse   whitespace\tand\nnewlines  ",
    "punct-only !?.,()",
    "",
    "under_scores and digits 123 mix_99 it's",
    " ".join(str(i) for i in range(40)),  # truncation boundary
]

needs_native = pytest.mark.skipif(not native.available(), reason="no host C++ compiler")


@needs_native
@pytest.mark.parametrize("tokenizer", ["basic_english", "word_punct"])
def test_native_ids_equal_the_python_chain_and_the_jax_native_route(tokenizer, monkeypatch):
    pipe = TextPipeline.fit(TEXTS[:4], tokenizer, max_seq_len=20, fixed_len=24)
    jpipe = JPipeline.fit(TEXTS[:4], tokenizer, max_seq_len=20, fixed_len=24)
    assert pipe._encode_native(TEXTS) is not None  # the native route ran
    got = pipe(TEXTS)
    np.testing.assert_array_equal(got, jpipe(TEXTS))  # the JAX native route
    monkeypatch.setenv("MLSPARK_NO_NATIVE_TEXT", "1")
    assert pipe._encode_native(TEXTS) is None
    want = pipe(TEXTS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32


@needs_native
def test_fixture_pipelines_encode_natively_as_the_python_chain(monkeypatch):
    pairs = j_load_multi30k(FIXTURES, "train")
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines

    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=24)
    texts = [s for s, _ in pairs]
    assert src_pipe._encode_native(texts) is not None
    got = src_pipe(texts)
    monkeypatch.setenv("MLSPARK_NO_NATIVE_TEXT", "1")
    np.testing.assert_array_equal(got, src_pipe(texts))


def test_native_gates_fall_back_to_the_python_chain():
    pipe = TextPipeline.fit(TEXTS[:4], "word_punct", max_seq_len=20, fixed_len=24)
    assert pipe._encode_native(["ein mädchen geht"]) is None  # non-ASCII
    ragged = TextPipeline.fit(TEXTS[:4], "word_punct", max_seq_len=20)
    assert ragged._encode_native(TEXTS) is None  # no fixed width
    custom = TextPipeline.fit(TEXTS[:4], str.split, max_seq_len=20, fixed_len=24)
    assert custom._encode_native(TEXTS) is None  # not a built-in tokenizer
    out = pipe(t for t in ["hello world", "second row"])  # a one-shot iterable
    assert out.shape == (2, 24) and (out != 0).any(axis=1).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
def test_dataset_batches_gather_natively_equal_to_fancy_indexing(dtype, monkeypatch):
    rng = np.random.default_rng(1)
    arrays = (rng.integers(0, 99, (50, 7)).astype(dtype), rng.integers(0, 5, 50))
    calls = []

    def counted(a, idx):
        calls.append(len(idx))
        return native.gather_rows(a, idx)

    monkeypatch.setattr(tloader, "gather_rows", counted)
    ds = tloader.ArrayDataset(*arrays)
    idx = rng.permutation(50)[:13]
    for got, want in zip(ds[idx], (a[idx] for a in arrays)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(ds[2:5], (a[2:5] for a in arrays)):  # a slice stays numpy's
        np.testing.assert_array_equal(got, want)
    assert calls == [13, 13]
    batches = list(tloader.DataLoader(ds, 8, shuffle=True, seed=3))
    order = np.concatenate([b[1] for b in batches])
    assert len(batches) == 6 and len(order) == 48
