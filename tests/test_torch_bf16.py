"""The port at ``dtype="bfloat16"`` against the JAX package at bf16, on the CPU.

The compute dtype's contract first: ``default_compute_dtype`` takes what
the JAX rule takes (float32 unless asked, as on any platform that is not a
TPU); parameters stay float32 at bf16 compute, the Transformer's logits
are bf16 and TinyVGG's float32 (the reference's own ``tests/test_models.py``
contract). Then the plain versions of the four kernels at bf16 (what the
wrappers run for CPU tensors and what the bf16 CUDA kernels are held
against on the card) against the Pallas kernels in interpret mode at bf16;
the Transformer and TinyVGG forward and gradients against Flax at bf16;
a few SGD steps of ``fit``; ``translator.json``.

Flax at bf16 runs its attention through the Pallas flash kernel here
(interpret mode, ``attention_impl("flash")``, the backward's Pallas
threshold at 0): the path it takes on its TPU, whose rounding points the
port mirrors (P and dS rounded to bf16 before their products). Its CPU
default, the dense XLA path, rounds the scores to bf16 instead.

Gates. Kernels: where one key block holds every key the Pallas kernel and
the plain version round at the same points and sum in float32 in other
orders, so at least 99 % of the output elements are bit-equal and the rest
within one bf16 ulp of the largest value (2^-7); across key blocks the
Pallas kernel rounds P against the running max, the plain version against
the row's final max: two ulps (2^-6). ``lse`` never rounds to bf16: 1e-5
relative. Models, set by a control run on the same weights and inputs
(Flax at bf16 against Flax at float32), distances ``‖Δ‖ / ‖ref‖`` per
tensor: the forward's distance from Flax at bf16 at most half the
control's (measured: 0, bit-equal), each gradient tensor's at most twice
the control's. The gradients cannot meet half: XLA's CPU backend sums
bf16 reductions (a bias's gradient, a dot's along its batch rows) at
other points than torch, which sums in float32 and rounds once; measured
per tensor 0.0-1.6 times the control's distance. The loss is float32 in the port and bf16 in the JAX package (a
standing difference, ROADMAP queue C): its size is pinned here.
"""

import copy
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data import loader as jloader
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import (
    TinyVGG as JTinyVGG,
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.ops import attention as jattn
from machine_learning_apache_spark_tpu.ops import pallas_attention as jpallas
from machine_learning_apache_spark_tpu.recipes import _common as jcommon
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import losses as jlosses
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_translation_pairs
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models import (
    TinyVGG,
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
from machine_learning_apache_spark_tpu_torch.recipes import _common as tcommon
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import losses as tlosses
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_like,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of the largest value, relative
LSE_REL = 1e-5
TINY = dict(
    src_vocab_size=41, trg_vocab_size=37, d_model=32, ffn_hidden=64,
    num_heads=2, num_layers=1, max_len=16, dropout=0.0,
)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as float32 numpy (exact in both packages)."""
    return torch.from_numpy(x).to(BF16).float().numpy()


def _j(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x)).to(BF16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v, np.float64)})
    return out


def _grads_tree(model):
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad)
    return export_flax_params(twin)


@pytest.fixture
def flax_on_pallas(monkeypatch):
    """Flax's attention through the Pallas kernels in interpret mode, the
    backward's too (its TPU path); undone after the test."""
    monkeypatch.setattr(
        jpallas, "flash_attention", functools.partial(jpallas.flash_attention, interpret=True)
    )
    monkeypatch.setattr(jpallas, "PALLAS_BWD_MIN_SCORES", 0)
    with jattn.attention_impl("flash"):
        yield


# -- the compute dtype ---------------------------------------------------------------


@pytest.mark.parametrize(
    "override", [None, "float32", "bfloat16", "float16", "float64", "int32", "bf16", "fp32"]
)
def test_default_compute_dtype_takes_what_jax_takes(override):
    """JAX's answer (this platform is not a TPU): float32 or bfloat16 →
    the same dtype; a string ``jnp.dtype`` refuses → ``TypeError``; a dtype
    the port builds no kernel for → ``NotImplementedError``."""
    try:
        want = jnp.dtype(jcommon.default_compute_dtype(override))
    except TypeError:
        with pytest.raises(TypeError):
            tcommon.default_compute_dtype(override)
        return
    if want.name in ("float32", "bfloat16"):
        assert tcommon.default_compute_dtype(override) == getattr(torch, want.name)
    else:
        with pytest.raises(NotImplementedError, match=want.name):
            tcommon.default_compute_dtype(override)


def test_parameters_stay_float32_and_logits_follow_the_reference():
    """``tests/test_models.py``'s mixed-precision contract: float32
    parameters at bf16 compute; Transformer logits bf16; TinyVGG logits
    float32 and close to the float32 model's on the same weights."""
    model = Transformer(TransformerConfig(**TINY, dtype=BF16))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    ones = torch.ones((2, 6), dtype=torch.long)
    assert model(ones, ones).dtype == BF16
    cnn = TinyVGG(4, dtype=BF16, generator=torch.Generator().manual_seed(0))
    assert {p.dtype for p in cnn.parameters()} == {torch.float32}
    x = torch.ones((2, 28, 28, 1))
    out = cnn(x)
    ref = TinyVGG(4, generator=torch.Generator().manual_seed(0))(x)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() < 0.15


# -- the kernels' plain versions against Pallas at bf16 -----------------------------

FLASH_CASES = [
    dict(b=2, h=2, sq=24, sk=24, d=16, causal=False, valid=None),
    dict(b=2, h=2, sq=20, sk=20, d=16, causal=False, valid=(13, 20)),
    dict(b=2, h=2, sq=19, sk=19, d=16, causal=True, valid=None),
    dict(b=2, h=2, sq=9, sk=21, d=16, causal=True, valid=(21, 15)),
    dict(b=1, h=2, sq=21, sk=9, d=16, causal=True, valid=None),
    dict(b=2, h=2, sq=11, sk=13, d=16, causal=False, valid=(0, 13)),
    dict(b=2, h=2, sq=17, sk=23, d=64, causal=True, valid=(23, 11)),
    dict(b=2, h=3, sq=130, sk=260, d=16, causal=True, valid=(200, 260)),
]
FLASH_IDS = ["no_mask", "kv_valid", "causal", "causal_sq<sk_kv_valid", "causal_sq>sk",
             "fully_masked_rows", "d64_causal_kv_valid", "multi_block"]


def _assert_bf16_close(got, want, multi_block, label):
    got, want = _f32(got), _f32(want)
    rel = _rel(got, want)
    if multi_block:
        assert rel <= 2 * ULP, (label, rel)
    else:
        assert rel <= ULP, (label, rel)
        assert np.mean(got == want) >= 0.99, (label, np.mean(got == want))


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_plain_versions_match_pallas_at_bf16(case):
    """Forward, ``lse`` and ``_flash_backward`` (called directly, so small
    shapes reach it) in interpret mode at bf16 against the plain forward
    and backward on bf16 tensors: outputs bf16, ``lse`` float32, masked
    keys' dK/dV and unseen rows' output and dQ exactly zero."""
    rng = np.random.default_rng(FLASH_CASES.index(case))
    b, h, sq, sk, d = (case[k] for k in ("b", "h", "sq", "sk", "d"))

    def f(*s):
        return _bf16_values(rng.standard_normal(s).astype(np.float32))

    q, k, v, g = f(b, h, sq, d), f(b, h, sk, d), f(b, h, sk, d), f(b, h, sq, d)
    valid = None
    if case["valid"] is not None:
        valid = np.arange(sk)[None, :] < np.asarray(case["valid"])[:, None]
    causal, multi = case["causal"], sk > 128
    jvalid = None if valid is None else jnp.asarray(valid)
    out, lse = jpallas._flash_forward(
        _j(q), _j(k), _j(v), jvalid, causal, 128, 128, True, return_lse=True
    )
    dq, dk, dv = jpallas._flash_backward(
        (causal, 128, 128, True), _j(q), _j(k), _j(v), jvalid, out, lse, _j(g)
    )
    assert out.dtype == dq.dtype == dk.dtype == jnp.bfloat16 and lse.dtype == jnp.float32

    tvalid = None if valid is None else torch.from_numpy(valid)
    t_out, t_lse = hop.flash_attention_lse_plain(_t(q), _t(k), _t(v), causal=causal, kv_valid=tvalid)
    assert t_out.dtype == BF16 and t_lse.dtype == torch.float32
    _assert_bf16_close(t_out, out, multi, "out")
    want_lse = np.asarray(lse)[:, :sq].reshape(b, h, sq)
    finite = want_lse > hop.NEG_INF / 2
    np.testing.assert_array_equal(t_lse.numpy() > hop.NEG_INF / 2, finite)
    if finite.any():
        assert _rel(t_lse.numpy()[finite], want_lse[finite]) < LSE_REL

    got = hop.flash_attention_backward_plain(
        _t(q), _t(k), _t(v), t_out, t_lse, _t(g), causal=causal, kv_valid=tvalid
    )
    for name, x, y in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert x.dtype == BF16
        _assert_bf16_close(x, y, multi, name)
    if valid is not None:
        for x in got[1:]:
            np.testing.assert_array_equal(_f32(x).transpose(0, 2, 1, 3)[~valid], 0.0)
    if not finite.all():
        np.testing.assert_array_equal(_f32(t_out)[~finite], 0.0)
        np.testing.assert_array_equal(_f32(got[0])[~finite], 0.0)


def test_plain_forward_rounds_p_where_the_reference_does():
    """The rounding point is what the bf16 gate sees: without P rounded to
    bf16 before P·V the plain forward drifts from the Pallas kernel by
    more than the rounding itself, well past the 99 % bit-equal bar."""
    rng = np.random.default_rng(1)
    q, k, v = (_bf16_values(rng.standard_normal((2, 2, 24, 16)).astype(np.float32)) for _ in range(3))
    want = _f32(jpallas._flash_forward(_j(q), _j(k), _j(v), None, False, 128, 128, True))
    unrounded = hop.flash_attention_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))[0].to(BF16)
    rounded = hop.flash_attention_lse_plain(_t(q), _t(k), _t(v))[0]
    assert np.mean(_f32(rounded) == want) >= 0.99
    assert np.mean(_f32(unrounded) == want) < 0.99


class TestRaggedAtBf16:
    """The plain ragged decode with a bf16 query over bf16 pages and over
    int8 pages, against the Pallas ``_ragged_paged_kernel`` in interpret
    mode with the same inputs. Both take P·V in float32 against the values
    (no rounding of P) and round the output to bf16 once: ≥ 99 % of the
    elements bit-equal, the rest within one ulp of the largest."""

    R, H, DH, PAGE, P = 6, 2, 8, 4, 6

    def _inputs(self, seed, int8):
        rng = np.random.default_rng(seed)
        d = self.H * self.DH
        n_pages = 1 + self.R * self.P
        lengths = np.array([0, 1, self.PAGE, 2 * self.PAGE + 3, self.P * self.PAGE, 9], np.int32)
        table = np.zeros((self.R, self.P), np.int32)
        nxt = 1
        for r in range(self.R):
            used = -(-int(lengths[r]) // self.PAGE)
            table[r, :used] = np.arange(nxt, nxt + used)
            nxt += used

        def f(*s):
            return _bf16_values(rng.standard_normal(s).astype(np.float32))

        kw = {}
        if int8:
            pages = [rng.integers(-127, 128, (n_pages, self.PAGE, d)).astype(np.int8) for _ in range(2)]
            kw["k_scale"], kw["v_scale"] = (
                (rng.random((n_pages, self.PAGE)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
        else:
            pages = [f(n_pages, self.PAGE, d) for _ in range(2)]
        return f(self.R, self.H, self.DH), pages, table, lengths, kw, (f(self.R, d), f(self.R, d))

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
    @pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
    def test_matches_pallas_interpret(self, int8, with_cur):
        query, (kp, vp), table, lengths, kw, cur = self._inputs(2 * int(int8) + int(with_cur), int8)
        if with_cur:
            kw = dict(kw, cur_k=cur[0], cur_v=cur[1])

        def jx(x):
            return jnp.asarray(x) if x.dtype in (np.int8, np.int32) else _j(x)

        def tx(x):
            t = torch.from_numpy(np.asarray(x))
            return t.to(BF16) if t.dtype == torch.float32 else t

        scales = ("k_scale", "v_scale")
        want = jpallas.ragged_paged_attention_kernel(
            _j(query), jx(kp), jx(vp), jnp.asarray(table), jnp.asarray(lengths),
            **{n: jnp.asarray(x) if n in scales else _j(x) for n, x in kw.items()}, interpret=True,
        )
        got = hop.ragged_paged_attention(
            _t(query), tx(kp), tx(vp), torch.from_numpy(table), torch.from_numpy(lengths),
            **{n: torch.from_numpy(x) if n in scales else _t(x) for n, x in kw.items()},
        )
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        _assert_bf16_close(got, want, False, "ragged")
        if not with_cur:
            np.testing.assert_array_equal(_f32(got)[0], 0.0)  # the inactive row


# -- the models against Flax at bf16 -----------------------------------------------


def _tokens(rng, n, length, vocab):
    toks = rng.integers(4, vocab, (n, length)).astype(np.int32)
    for i, m in enumerate(rng.integers(2, length + 1, n)):
        toks[i, m:] = 0
    return toks


def _dist(got, want) -> float:
    """``‖got − want‖ / ‖want‖`` over a whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _gates(got: dict, want16: dict, want32: dict, factor: float):
    """Per tensor: the port's distance (``_dist``) from Flax at bf16 within
    ``factor`` times Flax-bf16's distance from Flax at float32 (the
    control)."""
    assert got.keys() == want16.keys() == want32.keys()
    for k in want16:
        control = _dist(want16[k], want32[k])
        assert _dist(got[k], want16[k]) <= factor * control, (k, _dist(got[k], want16[k]), control)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_transformer_forward_and_grads_match_flax_at_bf16(flax_on_pallas, moe):
    """The recipe's loss through the Transformer at bf16 (the MoE option
    too, its router float32): logits against Flax's at bf16 within half
    the control's distance (bit-equal in practice), every gradient tensor
    within twice it; the loss within one bf16 ulp of the JAX loss (float32
    here, bf16 there)."""
    kw = dict(TINY, moe_experts=moe)
    jm32, jm16 = JTransformer(JConfig(**kw)), JTransformer(JConfig(**kw, dtype=jnp.bfloat16))
    dummy = np.ones((2, 6), np.int32)
    params = jax.tree.map(np.asarray, fnn.unbox(jax.jit(jm32.init)(jax.random.key(0), dummy, dummy)["params"]))
    tm = load_flax_params(Transformer(TransformerConfig(**kw, dtype=BF16)), params)
    rng = np.random.default_rng(45)
    src, trg = _tokens(rng, 4, 12, 41), _tokens(rng, 4, 11, 37)

    logits = {n: _f32(m.apply({"params": params}, src, trg[:, :-1])) for n, m in (("16", jm16), ("32", jm32))}
    got = tm(torch.from_numpy(src).long(), torch.from_numpy(trg[:, :-1]).long())
    assert got.dtype == BF16
    real = trg[:, 1:] != 0
    _gates({"logits": _f32(got)[real]}, {"logits": logits["16"][real]}, {"logits": logits["32"][real]}, 0.5)

    def jgrad(jm):
        (loss, _), g = jax.jit(jax.value_and_grad(j_make_translation_loss(jm, 0), has_aux=True))(
            params, (jnp.asarray(src), jnp.asarray(trg)), jax.random.key(0))
        return loss, _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), g))

    (loss16, g16), (_, g32) = jgrad(jm16), jgrad(jm32)
    loss, _ = trecipe.make_translation_loss(0)(tm, tloop.to_device((src, trg), torch.device("cpu")), None)
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(loss16)) <= ULP * abs(float(loss16))
    loss.backward()
    _gates(_flat(_grads_tree(tm)), g16, g32, 2.0)


def test_tinyvgg_forward_and_grads_match_flax_at_bf16():
    """TinyVGG at bf16 (the bias added after the bf16 product, as Flax's
    Conv and Dense do): logits within half the control's distance
    (bit-equal), each gradient tensor within twice it (the kernels'
    gradients bit-equal; the biases' are bf16 sums that XLA rounds
    elsewhere)."""
    rng = np.random.default_rng(11)
    x = rng.random((4, 12, 20, 3)).astype(np.float32)
    tm = TinyVGG(4, 5, BF16, input_shape=(12, 20, 3))
    drawn = random_flax_like(tm, 3)
    load_flax_params(tm, drawn)
    params = jax.tree.map(jnp.asarray, drawn)
    j16 = JTinyVGG(hidden_units=4, num_classes=5, dtype=jnp.bfloat16)
    j32 = JTinyVGG(hidden_units=4, num_classes=5)
    out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32
    want = {n: np.asarray(m.apply({"params": params}, x)) for n, m in (("16", j16), ("32", j32))}
    _gates({"logits": _f32(out)}, {"logits": want["16"]}, {"logits": want["32"]}, 0.5)
    probe = rng.standard_normal(want["16"].shape).astype(np.float32)

    def jgrad(m):
        g = jax.grad(lambda p: jnp.sum(m.apply({"params": p}, x) * probe))(params)
        return _flat(jax.tree.map(np.asarray, g))

    torch.sum(out * torch.from_numpy(probe)).backward()
    _gates(_flat(_grads_tree(tm)), jgrad(j16), jgrad(j32), 2.0)


def test_loss_is_float32_from_bf16_logits():
    """The standing difference: the JAX loss on bf16 logits is bf16, the
    port's float32 (optax's function, widened first). On the same bf16
    logits the two lie within one bf16 ulp; the port's is the float32
    loss of those logits to float32 accuracy."""
    rng = np.random.default_rng(3)
    logits = _bf16_values(rng.standard_normal((4, 11, 37)).astype(np.float32) * 3)
    labels = _tokens(rng, 4, 11, 37)
    want = jlosses.masked_token_cross_entropy(_j(logits), jnp.asarray(labels))
    want32 = jlosses.masked_token_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.masked_token_cross_entropy(_t(logits), torch.from_numpy(labels))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= ULP * abs(float(want))
    assert abs(got.item() - float(want32)) <= 1e-6 * abs(float(want32))


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_fit_sgd_steps_match_the_jax_fit_at_bf16(flax_on_pallas, steps_per_call):
    """6 SGD steps (lr 0.1) of ``fit`` at bf16 from the same weights and
    batches as the JAX ``fit`` at bf16 (and at float32, the control):
    epoch losses within two bf16 ulps of the JAX ones; each parameter's
    distance from the JAX bf16 run within three times the control's
    distance (the one-step gradients' factor of two, grown over six steps
    of a trajectory that bf16 noise moves: measured up to 2.2); parameters
    float32 throughout;
    3 steps per call bit for bit with 1."""
    kw = dict(TINY)
    jm32, jm16 = JTransformer(JConfig(**kw)), JTransformer(JConfig(**kw, dtype=jnp.bfloat16))
    dummy = np.ones((2, 6), np.int32)
    params = jax.tree.map(np.asarray, fnn.unbox(jax.jit(jm32.init)(jax.random.key(1), dummy, dummy)["params"]))
    rng = np.random.default_rng(46)
    src, trg = _tokens(rng, 24, 12, 41), _tokens(rng, 24, 11, 37)

    def jfit(jm):
        # A copy: the JAX fit donates its state, and an array made from
        # numpy without one may share the numpy buffer it would update.
        state = jstate.TrainState.create(
            apply_fn=jm.apply, params=jax.tree.map(lambda x: jnp.array(x, copy=True), params),
            tx=jstate.make_optimizer("sgd", 0.1),
        )
        res = jloop.fit(
            state, j_make_translation_loss(jm, 0),
            jloader.DataLoader(jloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
            epochs=2, mesh=None, log_every=0,
        )
        return res, _flat(jax.tree.map(np.asarray, res.state.params))

    (j16, p16), (_, p32) = jfit(jm16), jfit(jm32)

    def tfit(k):
        tm = load_flax_params(Transformer(TransformerConfig(**kw, dtype=BF16)), params)
        state = tstate.TrainState.create(model=tm, tx=tstate.make_optimizer("sgd", 0.1))
        res = tloop.fit(
            state, trecipe.make_translation_loss(0),
            tloader.DataLoader(tloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
            epochs=2, log_every=0, steps_per_call=k,
        )
        assert {p.dtype for p in tm.parameters()} == {torch.float32}
        return res, tm

    res, tm = tfit(steps_per_call)
    assert int(res.state.step) == 6 and int(j16.state.step) == 6
    np.testing.assert_allclose(
        [h["loss"] for h in res.history], [h["loss"] for h in j16.history], rtol=2 * ULP
    )
    _gates(_flat(export_flax_params(tm)), p16, p32, 3.0)
    if steps_per_call > 1:
        one, tm1 = tfit(1)
        assert one.step_losses == res.step_losses
        for a, b in zip(tm1.parameters(), tm.parameters()):
            assert torch.equal(a, b)


def test_translator_json_at_bf16_equals_the_jax_one(tmp_path):
    """``translator.json`` of a bf16 model: ``"dtype": "bfloat16"``, key
    for key the JAX file; loaded back, a bf16 model with float32
    parameters and the same tokens."""
    pairs = synthetic_translation_pairs(48, min_len=3, max_len=8, seed=2)
    src_j = JPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_j = JPipeline.fit([t for _, t in pairs], max_seq_len=14)
    kw = dict(TINY, src_vocab_size=len(src_j.vocab.itos), trg_vocab_size=len(trg_j.vocab.itos))
    jm = JTransformer(JConfig(**kw, dtype=jnp.bfloat16))
    dummy = np.ones((2, 8), np.int32)
    params = jax.tree.map(np.asarray, fnn.unbox(jax.jit(jm.init)(jax.random.key(5), dummy, dummy)["params"]))
    model = load_flax_params(Transformer(TransformerConfig(**kw, dtype=BF16)), params)
    src_t = TextPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_t = TextPipeline.fit([t for _, t in pairs], max_seq_len=14)
    tt = Translator(model, src_t, trg_t, device="cpu")
    JTranslator(jm, params, src_j, trg_j).save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    want = json.loads((tmp_path / "jax" / "translator.json").read_text())
    got = json.loads((tmp_path / "port" / "translator.json").read_text())
    assert got == want and got["config"]["dtype"] == "bfloat16"
    loaded = Translator.load(str(tmp_path / "port"), device="cpu")
    assert loaded.model.cfg.dtype == BF16
    assert {p.dtype for p in loaded.model.parameters()} == {torch.float32}
    texts = [s for s, _ in pairs][:8]
    assert loaded(texts, max_new_tokens=6) == tt(texts, max_new_tokens=6)
