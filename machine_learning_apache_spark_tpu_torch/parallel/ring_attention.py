"""Ring attention over the mesh's ``"seq"`` axis — the port of
``machine_learning_apache_spark_tpu/parallel/ring_attention.py``.

Q, K and V are split along the sequence over the ranks of a seq line.
Each rank keeps its Q chunk and attends, hop by hop, to the K/V chunks
that rotate around the line (``me → me + 1``, ``SeqLine.rotate``: every
rank posts its send and its receive at once, so the ring cannot
deadlock). After ``n`` hops every query row has seen every key chunk,
with one K/V chunk resident at a time.

The JAX ring runs the flash online-softmax recurrence with ``einsum``
inside a ``shard_map``. Here each computed hop is one launch of the flash
forward with its ``lse`` (``ops.hopper_attention.flash_attention_fwd``,
the Hopper kernel on the card, its plain version on the CPU), so no hop
holds its scores in memory; the hops are merged by their ``lse``:
``lse = logsumexp_i lse_i`` and ``out = Σ_i exp(lse_i − lse)·o_i``, the
recurrence's result. Rows whose merged ``lse`` is ``NEG_INF`` (no key
seen) give zeros, as the JAX ring's ``acc / l`` with ``l == 0`` does.

Causality is chunk by chunk, by global position, as in JAX: the hop
schedule starts at the rank's own chunk (the diagonal, the local
triangle: the kernel's ``causal`` with ``Sq == Sk``), a chunk behind is
attended unmasked, and a chunk wholly ahead is skipped: no launch. Per
rank and site, a causal ring launches ``r + 1`` of each kernel on rank
``r``; a full one ``n``. ``kv_valid`` chunks ride the ring with their K/V.

The backward (``RingAttention``) is the flash-2 one per hop, with the
**merged** ``lse`` and ``delta = rowsum(dO∘O)`` of the merged output:
each computed hop launches the dQ and the dK/dV kernels under the same
mask as its forward. dQ adds up locally; the dK/dV accumulators ride the
ring with their K/V chunk and reach home after ``n`` hops.

The per-hop math is plain functions on tensors (``hop_forward``,
``merge_hop``, ``finish_merge``, ``hop_backward``, ``hop_schedule``), so
a test can drive all ``n`` chunks in one process.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import (
    NEG_INF,
    _acc_dtype,
    _delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    kernel_layout_ok,
    launch_recording,
    recording_as,
)
from machine_learning_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS

DIAGONAL, BEHIND, FULL, AHEAD = "diagonal", "behind", "full", "ahead"


def hop_schedule(n: int, me: int, causal: bool) -> list[tuple[int, str]]:
    """``(src, kind)`` of each of the ``n`` hops of rank ``me``: after
    ``hop`` rotations the rank holds the chunk that started on ``me −
    hop``. Kinds: ``"full"`` (not causal), else ``"diagonal"`` (its own
    chunk), ``"behind"`` (unmasked) or ``"ahead"`` (skipped)."""
    out = []
    for hop in range(n):
        src = (me - hop) % n
        kind = FULL if not causal else DIAGONAL if src == me else BEHIND if src < me else AHEAD
        out.append((src, kind))
    return out


def hop_forward(q, k, v, kv_valid, kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One computed hop: ``(out, lse)`` of the flash forward of the local
    queries over one K/V chunk, causal only on the diagonal."""
    return flash_attention_fwd(q, k, v, causal=kind == DIAGONAL, kv_valid=kv_valid,
                               return_lse=True)


def merge_hop(acc, out: torch.Tensor, lse: torch.Tensor):
    """``(out, lse)`` of the hops so far merged with one more hop's, in
    float32 (float64 for float64 inputs): ``lse' = logaddexp(lse_acc,
    lse)``, each output weighted by ``exp(lse_i − lse')``. ``acc`` None
    starts the merge."""
    out = out.to(_acc_dtype(out.dtype))
    if acc is None:
        return out, lse
    a_out, a_lse = acc
    new = torch.logaddexp(a_lse, lse)
    merged = a_out * torch.exp(a_lse - new)[..., None] + out * torch.exp(lse - new)[..., None]
    return merged, new


def finish_merge(acc, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The merged ``(out, lse)``: rows that saw no key give zeros and
    ``lse = NEG_INF``; ``out`` in ``dtype``, ``lse`` float32."""
    out, lse = acc
    dead = lse <= NEG_INF * 0.5
    out = torch.where(dead[..., None], 0.0, out)
    lse = torch.where(dead, NEG_INF, lse)
    return out.to(dtype), lse.contiguous()


def hop_backward(q, k, v, d_out, lse, delta, kv_valid, kind: str):
    """``(dq, dk, dv)`` of one computed hop from the merged ``lse`` and
    ``delta``: the dQ and dK/dV kernels under the hop's mask."""
    diag = kind == DIAGONAL
    dq = flash_attention_bwd_dq(q, k, v, d_out, lse, delta, causal=diag, kv_valid=kv_valid)
    dk, dv = flash_attention_bwd_dkv(q, k, v, d_out, lse, delta, causal=diag, kv_valid=kv_valid)
    return dq, dk, dv


def ring_forward(line, q, k, v, kv_valid, causal: bool):
    """The ring's forward on this rank: ``(out, lse)`` of the local queries
    over every chunk of the line. The next chunk's rotation is posted
    before the hop's launch, so it travels while the hop computes."""
    acc = None
    blk = (k, v) if kv_valid is None else (k, v, kv_valid)
    schedule = hop_schedule(line.size, line.index, causal)
    for hop, (_, kind) in enumerate(schedule):
        pending = None
        if hop < line.size - 1:
            kv = torch.stack(blk[:2])
            pending = line.rotate(kv, *blk[2:])
        if kind != AHEAD:
            acc = merge_hop(acc, *hop_forward(q, blk[0], blk[1], blk[2] if len(blk) > 2 else None, kind))
        if pending is not None:
            got = pending()
            blk = (got[0][0], got[0][1], *got[1:])
    return finish_merge(acc, q.dtype)


def ring_backward(line, q, k, v, kv_valid, out, lse, d_out, causal: bool):
    """The ring's backward on this rank: ``(dq, dk, dv)`` of its chunks.
    The K/V chunk (with its ``kv_valid``) goes on around the line as in the
    forward, posted before the hop's launches; its dK/dV accumulators
    follow it after them, and after ``n`` rotations they are home."""
    delta = _delta(out, d_out)
    acc = _acc_dtype(q.dtype)
    dq = torch.zeros(q.shape, dtype=acc, device=q.device)
    dk = torch.zeros(k.shape, dtype=acc, device=k.device)
    dv = torch.zeros_like(dk)
    blk = (k, v) if kv_valid is None else (k, v, kv_valid)
    schedule = hop_schedule(line.size, line.index, causal)
    for hop, (_, kind) in enumerate(schedule):
        pending = line.rotate(torch.stack(blk[:2]), *blk[2:]) if hop < line.size - 1 else None
        if kind != AHEAD:
            g_q, g_k, g_v = hop_backward(q, blk[0], blk[1], d_out, lse, delta,
                                         blk[2] if len(blk) > 2 else None, kind)
            dq += g_q
            dk += g_k
            dv += g_v
        dk, dv = line.rotate(torch.stack((dk, dv)), tag=2)()[0]
        if pending is not None:
            got = pending()
            blk = (got[0][0], got[0][1], *got[1:])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring over ``line`` as an autograd ``Function``: the forward
    saves the local chunks, the merged output and its ``lse`` when a
    gradient is wanted; the backward is ``ring_backward``. ``kv_valid``
    takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, line, causal, with_grad):
        out, lse = ring_forward(line, q, k, v, kv_valid, causal)
        if with_grad:
            ctx.save_for_backward(q, k, v, kv_valid, out, lse)
            ctx.line, ctx.causal = line, causal
            # The backward runs on autograd's device thread: it counts its
            # launches as this thread records them (FlashAttention's rule).
            ctx.recording = launch_recording()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        if d_out.device.type == "cuda" and not kernel_layout_ok(d_out):
            d_out = d_out.clone(memory_format=torch.contiguous_format)
        with recording_as(ctx.recording):
            dq, dk, dv = ring_backward(ctx.line, q, k, v, kv_valid, out, lse, d_out, ctx.causal)
        return dq, dk, dv, None, None, None, None


def ring_on_line(line, q, k, v, *, causal=False, kv_valid=None) -> torch.Tensor:
    """Ring attention of this rank's chunks on ``line`` (any object with
    ``size``, ``index`` and ``rotate``)."""
    with_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return RingAttention.apply(q, k, v, kv_valid, line, causal, with_grad)


def ring_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mesh,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
    seq_axis: str = SEQ_AXIS,
    batch_axis: str | None = DATA_AXIS,
) -> torch.Tensor:
    """Sequence-parallel attention of this rank's chunks ``[b, H, S/n, d]``
    (and ``kv_valid`` ``[b, S/n]``, True = attendable) over its line of
    ``seq_axis`` — the JAX ``ring_attention``'s ``shard_map`` body: returns
    this rank's output chunk. Self-attention shapes only (q, k and v
    alike). ``batch_axis`` names the data axis, whose rows the rank
    already holds. Differentiable in q, k and v; fully padded rows give
    zeros. ``parallel.sequence.sequence_parallel_attention`` runs it on
    whole, replicated tensors."""
    from machine_learning_apache_spark_tpu_torch.parallel.sequence import (
        check_shapes,
        sequence_line,
    )

    del batch_axis
    check_shapes("ring", query, key, value, kv_valid, 1, seq_axis, whole=False)
    return ring_on_line(sequence_line(mesh, seq_axis), query, key, value,
                        causal=causal, kv_valid=kv_valid)
