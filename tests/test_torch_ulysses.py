"""Ulysses attention of the port (``parallel.ulysses_attention`` under the
glue of ``parallel.sequence`` and the dispatch of ``ops.attention``)
against the JAX package's ``ulysses_attention`` on ``{seq: 4}`` and
``{data: 2, seq: 4}`` meshes of the virtual CPU devices.

In process: each rank of a seq line is a thread (``tests/
torch_thread_line``) running the port's code — the head↔sequence
all-to-alls (q alone, k and v stacked), ``kv_valid`` gathered to the
whole sequence, the inner attention through ``flash_attention`` (its
plain versions here), the inverse exchange. Full and causal, with and
without ``kv_valid``, a fully padded row (zeros, as the JAX module
gives), the output and the gradients of q, k and v (``jax.grad`` of the
JAX function): all at atol 1e-5, float32. The exchanges are each
other's inverse, bit for bit. The JAX ``ValueError``s (heads, sequence,
``kv_valid``) beside the port's, and the dispatch's head check (the
recipe's is in ``tests/test_torch_sequence_parallel.py``).
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
from machine_learning_apache_spark_tpu.parallel.ulysses_attention import (
    ulysses_attention as j_ulysses,
)
from machine_learning_apache_spark_tpu_torch.ops import attention
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh, sequence, ulysses_attention
from machine_learning_apache_spark_tpu_torch.parallel.ulysses_attention import (
    heads_to_seq,
    seq_to_heads,
)
from torch_thread_line import run_line
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = 1e-5
N = 4


def _qkv(b=2, h=8, s=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


@functools.lru_cache(maxsize=None)
def _j_grad(axes: tuple, causal: bool, has_valid: bool):
    mesh = j_make_mesh(dict(axes), devices=jax.devices()[:int(np.prod([v for _, v in axes]))])

    def loss(q, k, v, valid):
        out = j_ulysses(q, k, v, mesh, causal=causal, kv_valid=valid if has_valid else None)
        return (out ** 2).sum(), out

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


def _jax(qkv, valid, causal, axes=(("seq", N),)):
    (_, out), grads = _j_grad(axes, causal, valid is not None)(
        *(jnp.asarray(a) for a in qkv), None if valid is None else jnp.asarray(valid))
    return [np.asarray(out), *(np.asarray(g) for g in grads)]


def _port(qkv, valid, causal):
    def rank(line):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
        out = sequence.attend_on_line(line, "ulysses", q, k, v, causal=causal,
                                      kv_valid=None if valid is None else torch.from_numpy(valid))
        (out ** 2).sum().backward()
        return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()]

    return run_line(N, rank)


def _check(got_ranks, want):
    for r, got in enumerate(got_ranks):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"rank {r} {name}")
        assert all(np.array_equal(a, b) for a, b in zip(got, got_ranks[0]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lengths", [None, [20, 32]], ids=["no kv_valid", "kv_valid"])
def test_ulysses_equals_the_jax_ulysses(causal, lengths):
    qkv = _qkv()
    valid = None if lengths is None else np.arange(32)[None, :] < np.asarray(lengths)[:, None]
    _check(_port(qkv, valid, causal), _jax(qkv, valid, causal))


def test_fully_padded_rows_give_zeros():
    qkv = _qkv(s=16, seed=1)
    valid = np.stack([np.zeros(16, bool), np.arange(16) < 7])
    got = _port(qkv, valid, True)
    _check(got, _jax(qkv, valid, True))
    assert np.all(got[0][0][0] == 0.0) and np.all(got[0][1][0] == 0.0)


def test_data_seq_mesh_equals_the_jax_ulysses():
    qkv = _qkv(b=4, h=4, s=16, seed=2)
    valid = np.arange(16)[None, :] < np.asarray([10, 16, 12, 2])[:, None]
    want = _jax(qkv, valid, True, axes=(("data", 2), ("seq", N)))
    for d in (0, 1):
        rows = slice(2 * d, 2 * d + 2)
        _check(_port(tuple(a[rows] for a in qkv), valid[rows], True), [w[rows] for w in want])


def test_exchanges_are_each_others_inverse():
    """``seq_to_heads`` then ``heads_to_seq`` gives each rank its chunk
    back bit for bit; rank r's head group over the whole sequence is the
    r-th group of heads of the concatenated chunks."""
    x = torch.from_numpy(_qkv(b=2, h=8, s=16, seed=3)[0])
    chunks = x.chunk(N, dim=2)

    def rank(line):
        heads = seq_to_heads(line, chunks[line.index])
        return heads, heads_to_seq(line, heads)

    for r, (heads, back) in enumerate(run_line(N, rank)):
        assert torch.equal(back, chunks[r])
        assert torch.equal(heads, x[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("case", ["divisible by seq=4", "not divisible", "kv_valid"])
def test_validation_errors_are_the_jax_ones(case):
    q, k, v = _qkv(h=6 if case == "divisible by seq=4" else 8, s=30 if case == "not divisible" else 16)
    valid = np.ones((2, 8), bool) if case == "kv_valid" else None
    j_mesh = j_make_mesh({"seq": N}, devices=jax.devices()[:N])
    with pytest.raises(ValueError, match=case) as jerr:
        j_ulysses(*(jnp.asarray(a) for a in (q, k, v)), j_mesh,
                  kv_valid=None if valid is None else jnp.asarray(valid))
    mesh = make_mesh({"seq": N}, world=N, device="cpu")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tv = None if valid is None else torch.from_numpy(valid)
    with pytest.raises(ValueError, match=case) as err:
        sequence.sequence_parallel_attention(*t, mesh, method="ulysses", kv_valid=tv)
    assert str(err.value) == str(jerr.value)
    if case == "divisible by seq=4":
        # A rank's chunks with a head count the line cannot divide.
        with pytest.raises(ValueError) as local:
            ulysses_attention(*(a[:, :, :4] for a in t), mesh)
        assert str(local.value) == str(jerr.value)


def test_dispatch_raises_for_indivisible_heads_as_jax_does():
    q, k, v = _qkv(h=6, s=16)
    j_mesh = j_make_mesh({"data": 2, "seq": N}, devices=jax.devices()[:8])
    with jattention.sequence_parallel(j_mesh, method="ulysses"):
        with pytest.raises(ValueError, match="ulysses") as jerr:
            jattention.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    mesh = make_mesh({"data": 2, "seq": N}, world=8, device="cpu")
    with attention.sequence_parallel(mesh, method="ulysses"):
        with pytest.raises(ValueError, match="ulysses") as err:
            attention.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert str(err.value) == str(jerr.value)


def test_dispatch_routes_the_site_through_ulysses(monkeypatch):
    lines = threading.local()
    monkeypatch.setattr(sequence, "sequence_line", lambda mesh, axis="seq": lines.line)
    calls = []
    orig = sequence.attend_on_line
    monkeypatch.setattr(sequence, "attend_on_line",
                        lambda *a, **k: calls.append(a[1]) or orig(*a, **k))
    qkv = _qkv(s=16, seed=5)
    want = _jax(qkv, None, True)[0]
    mesh = make_mesh({"seq": N}, world=N, device="cpu")

    def rank(line):
        lines.line = line
        return attention.dot_product_attention(*(torch.from_numpy(a) for a in qkv),
                                               causal=True).numpy()

    with attention.sequence_parallel(mesh, method="ulysses"):
        for got in run_line(N, rank):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert calls == ["ulysses"] * N

