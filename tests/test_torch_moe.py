"""The port's mixture-of-experts FFN and MoE Transformer against the JAX
package's, on the CPU.

``MoEFeedForward``'s output and load-balancing aux against the Flax
module's, with the same router and expert weights, at capacity factors
that drop tokens and that do not, with and without a validity mask
(atol 1e-5 on the output, rtol 1e-5 on the aux). A tiny MoE Transformer
(d_model 32, 2 heads, 4 experts) with the Flax initialisers' weights
carried across by ``weights.load_flax_params``: its logits (atol 1e-4,
rtol 1e-4, as ``tests/test_torch_transformer.py``), the recipe's MoE loss,
``moe_aux`` and every gradient against ``jax.value_and_grad`` of the JAX
recipe's loss (rtol 1e-5 on the loss, atol 1e-5 of the largest
gradient), the cached greedy and beam decoders' tokens and the paged and
padded serving engines' tokens identical to the JAX ones, and
``translator.json`` equal to the JAX ``Translator.save``'s. Dropout is off
wherever the packages are compared.
"""

import copy
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data.datasets import synthetic_translation_pairs
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
    beam_translate as j_beam,
    greedy_translate as j_greedy,
    greedy_translate_cached as j_greedy_cached,
)
from machine_learning_apache_spark_tpu.models.moe import MoEFeedForward as JMoE
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline, Vocab
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models import (
    MoEFeedForward,
    Transformer,
    TransformerConfig,
    beam_translate,
    greedy_translate,
    greedy_translate_cached,
)
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train.loop import to_device
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_params,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = RTOL = 1e-4
SOS, EOS, PAD = 1, 2, 0
MAX_NEW = 8
MOE = dict(moe_experts=4, moe_capacity_factor=1.0)
TINY = dict(
    src_vocab_size=31, trg_vocab_size=29, d_model=32, ffn_hidden=64,
    num_heads=2, num_layers=2, max_len=16, dropout=0.0, **MOE,
)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


# -- the layer ---------------------------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True], ids=["no-valid", "valid"])
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0], ids=["drops", "no-drops"])
def test_moe_layer_output_and_aux_match_jax(capacity_factor, with_valid):
    """Capacity 0.5 x 9 / 4 -> 2 slots per expert drops tokens; 2.0 -> 5
    slots keeps every one. Pads (``valid`` False) take no slot."""
    b, s, d, f, e = 3, 9, 16, 32, 4
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    valid = rng.random((b, s)) < 0.7 if with_valid else None
    jm = JMoE(d_model=d, ffn_hidden=f, num_experts=e, capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, nn.unbox(jm.init(jax.random.key(2), x))["params"])
    want, sown = jax.jit(
        lambda p, x, v: jm.apply({"params": p}, x, valid=v, mutable=["losses"])
    )(params, x, None if valid is None else jnp.asarray(valid))
    (want_aux,) = jax.tree.leaves(sown)

    tm = load_flax_params(MoEFeedForward(d, f, e, capacity_factor=capacity_factor), params)
    aux: list = []
    with torch.no_grad():
        got = tm(
            torch.from_numpy(x), valid=None if valid is None else torch.from_numpy(valid),
            aux=aux,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux[0].item(), float(want_aux), rtol=1e-5)
    counts = np.bincount(
        np.asarray(jnp.argmax(jnp.einsum("bsd,de->bse", x, params["router"]), -1))[
            valid if valid is not None else np.ones((b, s), bool)
        ],
        minlength=e,
    )
    dropped = (got.abs().sum(-1) == 0).numpy()
    if capacity_factor == 2.0:
        assert not dropped[valid if valid is not None else np.ones((b, s), bool)].any()
    else:
        assert counts.max() > tm.capacity(s) and dropped.any()  # overflow drops
    if valid is not None:
        assert dropped[~valid].all()  # pads are never routed


def test_moe_layer_rejects_a_misshapen_valid():
    tm = MoEFeedForward(8, 16, 2)
    torch.nn.init.zeros_(tm.router)
    with pytest.raises(ValueError, match="valid must be"):
        tm(torch.zeros(2, 5, 8), valid=torch.ones(2, 4, dtype=torch.bool))


# -- the MoE Transformer -----------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    jm = JTransformer(JConfig(**TINY))
    dummy = np.ones((2, 6), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(4), dummy, dummy)["params"])
    params = jax.tree.map(np.array, params)
    params["lm_head"]["bias"][EOS] = 1.5  # rows finish at different steps
    tm = load_flax_params(Transformer(TransformerConfig(**TINY)), params)
    src = np.random.default_rng(3).integers(4, 31, (3, 10)).astype(np.int32)
    src[2, 6:] = PAD
    return jm, params, tm, src


def _tokens(rng, n, length, vocab):
    toks = rng.integers(4, vocab, (n, length)).astype(np.int32)
    for i, m in enumerate(rng.integers(2, length + 1, n)):
        toks[i, m:] = PAD
    return toks


def test_moe_weights_round_trip_the_flax_layout(bridged):
    jm, params, tm, _ = bridged
    got, want = _flat(export_flax_params(tm)), _flat(params)
    assert got.keys() == want.keys()
    assert want["encoder/layer_0/ffn/w_up"].shape == (4, 32, 64)
    assert want["decoder/layer_1/ffn/router"].shape == (32, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # random_flax_params draws the same tree shape for an MoE config.
    rand = _flat(random_flax_params(TransformerConfig(**TINY), 0))
    assert {k: v.shape for k, v in rand.items()} == {k: v.shape for k, v in want.items()}


def test_moe_logits_match_jax_with_and_without_mask_overrides(bridged):
    """Routing validity comes from the tokens, whatever masks the caller
    passes (JAX ``transformer.py:403-408``)."""
    jm, params, tm, _ = bridged
    rng = np.random.default_rng(5)
    src, trg = _tokens(rng, 4, 12, 31), _tokens(rng, 4, 11, 29)
    fn = jax.jit(lambda p, s, t: jm.apply({"params": p}, s, t))
    want = fn(params, src, trg)
    with torch.no_grad():
        got = tm(_t(src), _t(trg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    full = np.ones((4, 1, 12, 12), bool)
    want_masked = jax.jit(lambda p, s, t: jm.apply({"params": p}, s, t, src_mask=full))(
        params, src, trg
    )
    with torch.no_grad():
        got_masked = tm(_t(src), _t(trg), src_mask=torch.from_numpy(full))
    np.testing.assert_allclose(got_masked.numpy(), np.asarray(want_masked), atol=ATOL, rtol=RTOL)


def test_moe_loss_aux_and_grads_match_jax_value_and_grad(bridged):
    jm, params, tm, _ = bridged
    rng = np.random.default_rng(6)
    src, trg = _tokens(rng, 4, 12, 31), _tokens(rng, 4, 11, 29)
    (want_loss, want_aux), want = jax.jit(
        jax.value_and_grad(j_make_translation_loss(jm, PAD), has_aux=True)
    )(params, (jnp.asarray(src), jnp.asarray(trg)), jax.random.key(0))
    model = copy.deepcopy(tm)
    loss, aux = trecipe.make_translation_loss(PAD)(
        model, to_device((src, trg), torch.device("cpu")), None
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(aux["moe_aux"].item(), float(want_aux["moe_aux"]), rtol=1e-5)
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), model.parameters()):
            p.copy_(q.grad)
    got, want = _flat(export_flax_params(holder)), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    assert np.abs(want["encoder/layer_0/ffn/router"]).max() > 0  # the router learns
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    jm, params, _, src = bridged
    s = jnp.asarray(src)
    return {
        "greedy": np.asarray(j_greedy_cached(jm, params, s, max_new_tokens=MAX_NEW)),
        "uncached": np.asarray(j_greedy(jm, params, s, max_new_tokens=MAX_NEW)),
        "beam3": np.asarray(jax.jit(
            lambda p, x: j_beam(jm, p, x, beam_size=3, max_new_tokens=MAX_NEW)
        )(params, s)),
    }


def test_moe_decoders_give_the_jax_tokens(bridged, jax_tokens):
    """A decode step routes its one token with no validity (capacity 1),
    finished rows included; the uncached decoder routes its buffer with
    the pads excluded — both as in the JAX model."""
    _, _, tm, src = bridged
    greedy = greedy_translate_cached(tm, _t(src), max_new_tokens=MAX_NEW).numpy()
    np.testing.assert_array_equal(greedy, jax_tokens["greedy"])
    uncached = greedy_translate(tm, _t(src), max_new_tokens=MAX_NEW).numpy()
    np.testing.assert_array_equal(uncached, jax_tokens["uncached"])
    beam = beam_translate(tm, _t(src), beam_size=3, max_new_tokens=MAX_NEW).numpy()
    np.testing.assert_array_equal(beam, jax_tokens["beam3"])
    assert (greedy[:, 1:-1] == PAD).any()  # finished rows fed pads to the router


# -- serving and save/load ----------------------------------------------------------


@pytest.fixture(scope="module")
def translators():
    """One tiny MoE MT bundle in both packages, same weights and vocabs."""
    pairs = synthetic_translation_pairs(64, min_len=3, max_len=8, seed=1)
    src_j = JPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_j = JPipeline.fit([t for _, t in pairs], max_seq_len=14)
    kw = {
        **TINY, "num_layers": 1,
        "src_vocab_size": len(src_j.vocab.itos), "trg_vocab_size": len(trg_j.vocab.itos),
    }
    jm = JTransformer(JConfig(**kw))
    dummy = np.ones((2, 8), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(7), dummy, dummy)["params"])
    params = jax.tree.map(np.array, params)
    params["lm_head"]["bias"][EOS] = 1.5
    model = load_flax_params(Transformer(TransformerConfig(**kw)), params)

    def pipe(p):
        return TextPipeline(Vocab(p.vocab.itos, specials=()), max_seq_len=14)

    port = Translator(model, pipe(src_j), pipe(trg_j), device="cpu")
    return JTranslator(jm, params, src_j, trg_j), port, [s for s, _ in pairs][:12]


ENGINE = dict(boundaries=(8, 16), max_batch=4, max_new_tokens=8)


@pytest.mark.parametrize("mode", ["paged", "padded"])
def test_moe_engines_give_the_jax_engines_tokens(translators, mode):
    jt, tt, texts = translators
    kw = {**ENGINE, "kv_mode": mode, "max_wait_s": 0.01}
    with jt.serve(**kw) as eng:
        want = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
    with tt.serve(**kw) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        assert eng.kv_mode == mode and eng.recompiles_after_warmup == 0
    assert got == want
    assert got == tt(texts, max_new_tokens=8)  # the one-shot oracle


def test_moe_translator_json_equals_the_jax_one_and_loads(translators, tmp_path):
    jt, tt, texts = translators
    jt.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    want = json.loads((tmp_path / "jax" / "translator.json").read_text())
    got = json.loads((tmp_path / "port" / "translator.json").read_text())
    assert got == want
    assert got["config"]["moe_experts"] == 4 and got["config"]["moe_capacity_factor"] == 1.0
    loaded = Translator.load(str(tmp_path / "port"), device="cpu")
    assert loaded.model.cfg == tt.model.cfg
    assert loaded(texts, max_new_tokens=8) == tt(texts, max_new_tokens=8)


# -- the recipe ------------------------------------------------------------------------


def test_moe_recipe_trains_and_reports_moe_aux():
    out = trecipe.train_translator(
        device="cpu", data_root="assets/fixtures", d_model=32, ffn_hidden=64,
        num_heads=2, max_len=24, epochs=1, log_every=0, moe_experts=4,
        schedule="warmup_cosine", warmup_steps=2, grad_clip=1.0, grad_accum=2,
    )
    (epoch,) = out["history"]
    assert np.isfinite(epoch["loss"]) and 1.0 <= epoch["moe_aux"] <= 4.0
    assert np.isfinite(out["test_loss"]) and 1.0 <= out["moe_aux"] <= 4.0


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(moe_experts=3, expert_parallel=2), "divide evenly"),
        (dict(expert_parallel=2), "requires moe_experts"),
        (dict(moe_experts=4, pack_sequences=True), "pack_sequences is incompatible"),
    ],
    ids=["uneven-experts", "ep-without-experts", "moe-with-packing"],
)
def test_moe_recipe_rejects_what_the_jax_recipe_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        trecipe.train_translator(device="cpu", **kw)
