"""Ring attention of the port (``parallel.ring_attention``, the glue in
``parallel.sequence`` and the dispatch of ``ops.attention``) against the
JAX package's ``ring_attention`` on a ``{seq: 4}`` (and ``{data: 2, seq:
4}``) mesh of the virtual CPU devices.

In process: each rank of a seq line is a thread (``tests/
torch_thread_line``) running the port's own code — the chunking, the
per-hop forward (``hop_forward``: the flash forward's plain version with
its ``lse``), the ``lse`` merge, the per-hop backward with the merged
``lse`` and ``delta`` and the dK/dV accumulators riding the ring — over
all n chunks. Full and causal, with and without ``kv_valid``, a fully
padded row (zeros), the output and the gradients of q, k and v
(``jax.grad`` of the JAX ring): all at atol 1e-5, float32. Then the
hop schedule, the JAX ``ValueError``s beside the port's on the same
inputs, the dispatch routing a site through the ring, its fall-throughs
(Sq ≠ Sk, a ragged batch, a dense mask, a missing ``"seq"`` axis) against
the JAX dispatch (atol 1e-5), and ``attention_impl`` against JAX's.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.ops import attention as jattention
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.parallel.ring_attention import ring_attention as j_ring
from machine_learning_apache_spark_tpu_torch.ops import attention
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh, ring_attention
from machine_learning_apache_spark_tpu_torch.parallel import sequence
from machine_learning_apache_spark_tpu_torch.parallel.ring_attention import hop_schedule
from torch_thread_line import run_line
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = 1e-5
N = 4


def _qkv(b=2, h=4, s=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _valid(b, s, lengths):
    return np.arange(s)[None, :] < np.asarray(lengths)[:, None]


@functools.lru_cache(maxsize=None)
def _j_ring_grad(axes: tuple, causal: bool, has_valid: bool):
    mesh = j_make_mesh(dict(axes), devices=jax.devices()[:int(np.prod([v for _, v in axes]))])

    def loss(q, k, v, valid):
        out = j_ring(q, k, v, mesh, causal=causal, kv_valid=valid if has_valid else None)
        return (out ** 2).sum(), out

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


def _jax_ring(qkv, valid, causal, axes=(("seq", N),)):
    (_, out), grads = _j_ring_grad(axes, causal, valid is not None)(
        *(jnp.asarray(a) for a in qkv), None if valid is None else jnp.asarray(valid))
    return [np.asarray(out), *(np.asarray(g) for g in grads)]


def _port_ring(qkv, valid, causal, method="ring"):
    """Every rank's output and gradients of sum(out²), each rank of a line
    a thread on the whole (replicated) tensors."""

    def rank(line):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
        kv_valid = None if valid is None else torch.from_numpy(valid)
        out = sequence.attend_on_line(line, method, q, k, v, causal=causal, kv_valid=kv_valid)
        (out ** 2).sum().backward()
        return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()]

    return run_line(N, rank)


def _check(got_ranks, want, atol=ATOL):
    for r, got in enumerate(got_ranks):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"rank {r} {name}")
        # Every rank of the line holds the same bits.
        assert all(np.array_equal(a, b) for a, b in zip(got, got_ranks[0]))


CASES = {
    "full": (False, None),
    "causal": (True, None),
    "kv_valid": (False, [20, 32]),
    "kv_valid causal": (True, [24, 32]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_equals_the_jax_ring(case):
    causal, lengths = CASES[case]
    qkv = _qkv()
    valid = None if lengths is None else _valid(2, 32, lengths)
    _check(_port_ring(qkv, valid, causal), _jax_ring(qkv, valid, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_fully_padded_row_gives_zeros(causal):
    qkv = _qkv(s=16, seed=1)
    valid = np.stack([np.zeros(16, bool), np.ones(16, bool)])
    got = _port_ring(qkv, valid, causal)
    want = _jax_ring(qkv, valid, causal)
    _check(got, want)
    assert np.all(got[0][0][0] == 0.0) and np.all(want[0][0] == 0.0)
    # No key seen, no gradient into the row's queries.
    assert np.all(got[0][1][0] == 0.0)


def test_data_seq_mesh_equals_the_jax_ring():
    """``{data: 2, seq: 4}``: each data index's line on its rows, against
    the JAX ring over the whole batch on 8 devices."""
    qkv = _qkv(b=4, s=16, seed=2)
    valid = _valid(4, 16, [10, 16, 12, 3])
    want = _jax_ring(qkv, valid, True, axes=(("data", 2), ("seq", N)))
    for d in (0, 1):
        rows = slice(2 * d, 2 * d + 2)
        got = _port_ring(tuple(a[rows] for a in qkv), valid[rows], True)
        _check(got, [w[rows] for w in want])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_hop_schedule_skips_the_chunks_ahead(n):
    for me in range(n):
        causal = hop_schedule(n, me, True)
        assert [src for src, _ in causal] == [(me - h) % n for h in range(n)]
        assert causal[0] == (me, "diagonal")
        # r + 1 computed hops on rank r (its diagonal and the r behind it).
        assert sum(kind != "ahead" for _, kind in causal) == me + 1
        assert all(kind == ("behind" if src < me else "ahead") for src, kind in causal[1:])
        assert [kind for _, kind in hop_schedule(n, me, False)] == ["full"] * n


@pytest.mark.parametrize("case", ["not divisible", "self-attention-shaped", "kv_valid"])
def test_validation_errors_are_the_jax_ones(case):
    q, k, v = _qkv(s=30 if case == "not divisible" else 16)
    valid = None
    if case == "self-attention-shaped":
        _, k, v = _qkv(s=32)
    if case == "kv_valid":
        valid = np.ones((2, 8), bool)
    j_mesh = j_make_mesh({"seq": 8})
    with pytest.raises(ValueError, match=case) as jerr:
        j_ring(*(jnp.asarray(a) for a in (q, k, v)), j_mesh,
               kv_valid=None if valid is None else jnp.asarray(valid))
    mesh = make_mesh({"seq": 8}, world=8, device="cpu")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match=case) as err:
        sequence.sequence_parallel_attention(
            *t, mesh, method="ring", kv_valid=None if valid is None else torch.from_numpy(valid))
    assert str(err.value) == str(jerr.value)
    if case != "not divisible":
        # The local function (a rank's chunks) refuses the same shapes.
        with pytest.raises(ValueError, match=case):
            ring_attention(*t, mesh, kv_valid=None if valid is None else torch.from_numpy(valid))


@pytest.fixture
def thread_lines(monkeypatch):
    """``sequence.sequence_line`` answering each thread with the line it
    set in ``lines.line``."""
    lines = threading.local()
    monkeypatch.setattr(sequence, "sequence_line", lambda mesh, axis="seq": lines.line)
    return lines


def test_dispatch_routes_the_site_through_the_ring(thread_lines):
    """``dot_product_attention`` under ``sequence_parallel`` on a
    ``{data: 2, seq: 4}`` mesh against the JAX dispatch on the same mesh."""
    qkv = _qkv(b=4, s=16, seed=3)
    valid = _valid(4, 16, [10, 16, 12, 16])
    j_mesh = j_make_mesh({"data": 2, "seq": N}, devices=jax.devices()[:8])
    with jattention.sequence_parallel(j_mesh):
        want = np.asarray(jattention.dot_product_attention(
            *(jnp.asarray(a) for a in qkv), causal=True, kv_valid=jnp.asarray(valid)))
    mesh = make_mesh({"data": 2, "seq": N}, world=8, device="cpu")
    calls = []
    orig = sequence.attend_on_line

    def counted(*args, **kw):
        calls.append(args[1])
        return orig(*args, **kw)

    with attention.sequence_parallel(mesh), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sequence, "attend_on_line", counted)
        for d in (0, 1):
            rows = slice(2 * d, 2 * d + 2)

            def rank(line, rows=rows):
                thread_lines.line = line
                return attention.dot_product_attention(
                    *(torch.from_numpy(a[rows]) for a in qkv), causal=True,
                    kv_valid=torch.from_numpy(valid[rows])).numpy()

            for got in run_line(N, rank):
                np.testing.assert_allclose(got, want[rows], rtol=0, atol=ATOL)
    assert calls == ["ring"] * 2 * N


def _dense_j(q, k, v, mask=None, causal=False, kv_valid=None):
    return np.asarray(jattention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), use_pallas=False))


@pytest.mark.parametrize("site", ["cross", "ragged batch", "dense mask"])
def test_dispatch_falls_through_where_the_jax_one_does(site, monkeypatch):
    """Sites the mechanism cannot take keep their usual paths, under both
    contexts; the port's SP path would need a gang, so taking it fails."""
    monkeypatch.setattr(sequence, "attend_on_line", lambda *a, **k: pytest.fail("took the ring"))
    q, k, v = _qkv(b=4, s=16, seed=4)
    mask = None
    if site == "cross":
        q = _qkv(b=4, s=8, seed=5)[0]
    if site == "ragged batch":  # 3 rows on a data axis of 2
        q, k, v = (a[:3] for a in (q, k, v))
    if site == "dense mask":
        mask = np.tril(np.ones((16, 16), bool))[None, None]
    j_mesh = j_make_mesh({"data": 2, "seq": N}, devices=jax.devices()[:8])
    mesh = make_mesh({"data": 2, "seq": N}, world=8, device="cpu")
    with jattention.sequence_parallel(j_mesh):
        want = _dense_j(q, k, v, mask)
    with attention.sequence_parallel(mesh):
        got = attention.dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["missing axis", "method"])
def test_context_refuses_what_the_jax_context_refuses(case):
    axes = {"data": 8} if case == "missing axis" else {"seq": 8}
    kw = {} if case == "missing axis" else {"method": "spiral"}
    with pytest.raises(ValueError) as jerr:
        with jattention.sequence_parallel(j_make_mesh(axes), **kw):
            pass
    with pytest.raises(ValueError) as err:
        with attention.sequence_parallel(make_mesh(axes, world=8, device="cpu"), **kw):
            pass
    assert str(err.value) == str(jerr.value)
    assert not attention._SEQ_PARALLEL_CTX


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_impl_pins_the_path_as_jax_does(impl, monkeypatch):
    """``"dense"``: the plain path over the materialised mask (a fully
    padded row averages V, as the JAX dense path does); ``"flash"``: the
    kernel path (zeros there), against JAX's Pallas kernel in interpret
    mode."""
    from machine_learning_apache_spark_tpu.ops import pallas_attention

    monkeypatch.setattr(pallas_attention, "flash_attention",
                        functools.partial(pallas_attention.flash_attention, interpret=True))
    q, k, v = _qkv(s=16, seed=6)
    valid = np.stack([np.zeros(16, bool), _valid(1, 16, [9])[0]])
    with jattention.attention_impl(impl):
        want = np.asarray(jattention.dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True, kv_valid=jnp.asarray(valid)))
    with attention.attention_impl(impl):
        got = attention.dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
            kv_valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (np.abs(got[0]).max() > 0) == (impl == "dense")
    with pytest.raises(ValueError) as jerr:
        with jattention.attention_impl("sparse"):
            pass
    with pytest.raises(ValueError) as err:
        with attention.attention_impl("sparse"):
            pass
    assert str(err.value) == str(jerr.value)


def test_an_active_sp_context_wins_over_attention_impl(thread_lines):
    qkv = _qkv(s=16, seed=7)
    mesh = make_mesh({"seq": N}, world=N, device="cpu")
    want = _jax_ring(qkv, None, True)[0]

    def rank(line):
        thread_lines.line = line
        return attention.dot_product_attention(
            *(torch.from_numpy(a) for a in qkv), causal=True).numpy()

    with attention.sequence_parallel(mesh), attention.attention_impl("dense"):
        for got in run_line(N, rank):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
