"""The port's flash-attention gradient against the JAX package's, on the CPU.

The port's plain ``lse`` and plain flash-2 backward (what its wrappers run
for CPU tensors, and what the CUDA kernels are held against on the card)
against the Pallas ``_flash_forward(..., return_lse=True)`` and
``_flash_backward`` in interpret mode, called directly so that small
shapes reach the Pallas backward whatever ``PALLAS_BWD_MIN_SCORES`` says.
Then the ``FlashAttention`` autograd ``Function`` against ``jax.grad`` of
the JAX ``flash_attention`` and against ``torch.autograd.gradcheck`` in
float64. Inputs come from a numpy seed and cross as numpy arrays.
Tolerance: max |Δ| / max |ref| < 1e-4, the JAX tests' own bound for the
Pallas backward (``tests/test_ops.py:382-385``); a key that no row sees
gets exactly zero dK/dV (``tests/test_ops.py:387-401``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.ops import pallas_attention as jpallas
from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

REL = 1e-4

CASES = [
    dict(b=2, h=2, sq=24, sk=24, d=16, causal=False, valid=None),
    dict(b=2, h=2, sq=20, sk=20, d=16, causal=False, valid=(13, 20)),
    dict(b=2, h=2, sq=19, sk=19, d=16, causal=True, valid=None),
    dict(b=2, h=2, sq=9, sk=21, d=16, causal=True, valid=(21, 15)),
    dict(b=1, h=2, sq=21, sk=9, d=16, causal=True, valid=None),
    dict(b=2, h=2, sq=11, sk=13, d=16, causal=False, valid=(0, 13)),
    dict(b=2, h=2, sq=17, sk=23, d=64, causal=True, valid=(23, 11)),
]
IDS = ["no_mask", "kv_valid", "causal", "causal_sq<sk_kv_valid",
       "causal_sq>sk", "fully_masked_rows", "d64_causal_kv_valid"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    b, h, sq, sk, d = (case[k] for k in ("b", "h", "sq", "sk", "d"))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, g = f(b, h, sq, d), f(b, h, sk, d), f(b, h, sk, d), f(b, h, sq, d)
    valid = None
    if case["valid"] is not None:
        valid = np.arange(sk)[None, :] < np.asarray(case["valid"])[:, None]
    return q, k, v, g, valid


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_lse_and_backward_match_pallas_interpret(case):
    q, k, v, g, valid = _inputs(case, seed=len(IDS) + CASES.index(case))
    causal = case["causal"]
    jvalid = None if valid is None else jnp.asarray(valid)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jpallas._flash_forward(
        jq, jk, jv, jvalid, causal, 128, 128, True, return_lse=True
    )
    dq, dk, dv = jpallas._flash_backward(
        (causal, 128, 128, True), jq, jk, jv, jvalid, out, lse, jg
    )
    b, h, sq = q.shape[:3]
    want_lse = np.asarray(lse)[:, :sq].reshape(b, h, sq)

    t_out, t_lse = hop.flash_attention_lse_plain(
        _t(q), _t(k), _t(v), causal=causal, kv_valid=_t(valid)
    )
    assert _rel(t_out, out) < REL
    finite = want_lse > hop.NEG_INF / 2
    np.testing.assert_array_equal(t_lse.numpy() > hop.NEG_INF / 2, finite)
    np.testing.assert_array_equal(t_lse.numpy()[~finite], np.float32(hop.NEG_INF))
    if finite.any():
        assert _rel(t_lse.numpy()[finite], want_lse[finite]) < REL

    got = hop.flash_attention_backward_plain(
        _t(q), _t(k), _t(v), t_out, t_lse, _t(g),
        causal=causal, kv_valid=_t(valid),
    )
    for name, x, y in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert _rel(x, y) < REL, name
    if valid is not None:
        masked = ~valid  # [B, Sk]: these keys get exactly zero dK and dV
        for x in got[1:]:
            np.testing.assert_array_equal(x.numpy().transpose(0, 2, 1, 3)[masked], 0.0)
    if not finite.all():  # rows that see no key: zero output, zero dQ
        np.testing.assert_array_equal(t_out.numpy()[~finite], 0.0)
        np.testing.assert_array_equal(got[0].numpy()[~finite], 0.0)


def test_per_kernel_wrappers_split_the_plain_backward():
    """On CPU tensors the dQ and dK/dV wrappers take the plain versions,
    which together give the combined backward, and count no launch."""
    q, k, v, g, valid = _inputs(CASES[3], seed=30)
    args = (_t(q), _t(k), _t(v))
    out, lse = hop.flash_attention_lse_plain(*args, causal=True, kv_valid=_t(valid))
    delta = (_t(g) * out).sum(-1)
    before = dict(hop.LAUNCHES)
    dq = hop.flash_attention_bwd_dq(*args, _t(g), lse, delta, causal=True, kv_valid=_t(valid))
    dk, dv = hop.flash_attention_bwd_dkv(*args, _t(g), lse, delta, causal=True, kv_valid=_t(valid))
    assert hop.LAUNCHES == before
    want = hop.flash_attention_backward_plain(
        *args, out, lse, _t(g), causal=True, kv_valid=_t(valid)
    )
    for x, y in zip((dq, dk, dv), want):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["kv_valid", "causal+kv_valid"])
def test_function_grads_match_jax_grad(causal):
    """Grads through ``flash_attention`` (the ``Function``) against
    ``jax.grad`` of the JAX ``flash_attention`` in interpret mode, on
    strided head-split views of one fused projection as the model passes
    them."""
    rng = np.random.default_rng(31)
    b, sq, h, d = 2, 14, 2, 16
    fused = rng.standard_normal((b, sq, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    valid = np.arange(sq)[None, :] < np.array([[14], [9]])

    def split(x):
        return x.reshape(b, sq, 3, h, d).transpose(2, 0, 3, 1, 4)

    jq, jk, jv = split(jnp.asarray(fused))
    loss = lambda q, k, v: jnp.sum(  # noqa: E731
        jpallas.flash_attention(
            q, k, v, causal=causal, kv_valid=jnp.asarray(valid), interpret=True
        ) * g
    )
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    t_fused = torch.from_numpy(fused).requires_grad_()
    tq, tk, tv = (
        t.view(b, sq, h, d).transpose(1, 2) for t in t_fused.chunk(3, dim=-1)
    )
    out = hop.flash_attention(tq, tk, tv, causal=causal, kv_valid=_t(valid))
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv), retain_graph=True)
    for x, y in zip(grads, want):
        assert _rel(x, y) < REL
    (out * _t(g)).sum().backward()  # through chunk/view/transpose to the fused input
    assert t_fused.grad is not None and torch.isfinite(t_fused.grad).all()


def test_function_passes_gradcheck_in_float64():
    rng = np.random.default_rng(32)
    b, h, sq, sk, d = 1, 2, 5, 7, 8
    q, k, v = (
        torch.from_numpy(rng.standard_normal((b, h, n, d))).requires_grad_()
        for n in (sq, sk, sk)
    )
    valid = torch.tensor([[True, True, False, True, True, True, False]])

    def fn(q, k, v):
        return hop.flash_attention(q, k, v, causal=True, kv_valid=valid)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7)


def test_no_grad_forward_saves_nothing_and_matches():
    rng = np.random.default_rng(33)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((1, 2, 6, 8)).astype(np.float32)).requires_grad_()
        for _ in range(3)
    )
    with torch.no_grad():
        plain = hop.flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None
    graded = hop.flash_attention(q, k, v, causal=True)
    assert graded.grad_fn is not None
    torch.testing.assert_close(plain, graded.detach(), atol=0, rtol=0)


def test_ragged_paged_attention_raises_under_grad():
    rows, heads, dh, page = 2, 2, 8, 4
    pages = torch.zeros(3, page, heads * dh)
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    query = torch.randn(rows, heads, dh, generator=torch.Generator().manual_seed(0))
    hop.ragged_paged_attention(query.requires_grad_(False), pages, pages, table, lengths)
    with pytest.raises(RuntimeError, match="no backward"):
        hop.ragged_paged_attention(query.requires_grad_(), pages, pages, table, lengths)
    with torch.no_grad():
        out = hop.ragged_paged_attention(query, pages, pages, table, lengths)
    assert out.shape == (rows, heads, dh)
