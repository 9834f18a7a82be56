"""Ulysses sequence parallelism — head↔sequence all-to-alls over the
mesh's ``"seq"`` axis; the port of
``machine_learning_apache_spark_tpu/parallel/ulysses_attention.py``.

The same placement as ``ring_attention`` (each rank of a seq line holds
its sequence chunk ``[b, H, S/n, d]`` of q, k and v), another exchange:
one ``all_to_all`` turns the chunk into ``[b, H/n, S, d]`` — this rank's
head group over the whole sequence — the rank runs ordinary full-length
attention on its H/n heads, and one inverse ``all_to_all`` brings the
output back to its chunk. q goes alone and k, v stacked in one exchange,
as in ``_ulysses_shard_fn``: three exchanges a call. ``kv_valid`` is
all-gathered to ``[b, S]``. Needs ``num_heads % n == 0``.

The inner attention is ``ops.hopper_attention.flash_attention`` (the
autograd ``Function`` over the Hopper forward and both backward kernels
on the card, their plain versions on the CPU), never
``dot_product_attention``, whose active ``sequence_parallel`` context
would send it back here. It gives zeros for fully padded rows, the JAX
module's convention.

The exchanges are autograd ``Function``s whose backward is the inverse
exchange (``_SeqToHeads``, ``_HeadsToSeq``), over ``SeqLine.all_to_all``
(``dist.all_to_all_single``; CUDA tensors staged through pinned host
memory over gloo).
"""

from __future__ import annotations

import torch

from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import flash_attention
from machine_learning_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS


def seq_to_heads(line, t: torch.Tensor) -> torch.Tensor:
    """``[..., H, S/n, d]`` (this rank's sequence chunk, every head) →
    ``[..., H/n, S, d]`` (this rank's head group, the whole sequence)."""
    n = line.size
    *lead, h, c, d = t.shape
    parts = t.reshape(*lead, n, h // n, c, d).movedim(-4, 0).contiguous()
    got = line.all_to_all(parts)  # [n (sequence chunk), *lead, H/n, c, d]
    return got.movedim(0, -3).reshape(*lead, h // n, n * c, d)


def heads_to_seq(line, t: torch.Tensor) -> torch.Tensor:
    """The inverse: ``[..., H/n, S, d]`` → ``[..., H, S/n, d]``."""
    n = line.size
    *lead, h, s, d = t.shape
    parts = t.reshape(*lead, h, n, s // n, d).movedim(-3, 0).contiguous()
    got = line.all_to_all(parts)  # [n (head group), *lead, H/n, S/n, d]
    return got.movedim(0, -4).reshape(*lead, n * h, s // n, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, t):
        ctx.line = line
        return seq_to_heads(line, t)

    @staticmethod
    def backward(ctx, grad):
        return None, heads_to_seq(ctx.line, grad)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, t):
        ctx.line = line
        return heads_to_seq(line, t)

    @staticmethod
    def backward(ctx, grad):
        return None, seq_to_heads(ctx.line, grad)


def ulysses_on_line(line, q, k, v, *, causal=False, kv_valid=None) -> torch.Tensor:
    """Ulysses attention of this rank's chunks on ``line`` (any object with
    ``size``, ``index``, ``all_to_all`` and ``all_gather``)."""
    q_h = _SeqToHeads.apply(line, q)
    kv_h = _SeqToHeads.apply(line, torch.stack([k, v]))
    valid = None
    if kv_valid is not None:
        # Per-key validity over the WHOLE gathered sequence.
        got = line.all_gather(kv_valid)  # [n, b, S/n]
        valid = got.movedim(0, 1).reshape(kv_valid.shape[0], -1)
    out = flash_attention(q_h, kv_h[0], kv_h[1], causal=causal, kv_valid=valid)
    return _HeadsToSeq.apply(line, out)


def ulysses_attention(
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
    (and ``kv_valid`` ``[b, S/n]``) over its line of ``seq_axis`` through
    head↔sequence all-to-alls — the JAX ``ulysses_attention``'s
    ``shard_map`` body: returns this rank's output chunk, the same as
    ``ring_attention`` gives. ``num_heads`` must divide over the line.
    Differentiable in q, k and v; fully padded rows give zeros."""
    from machine_learning_apache_spark_tpu_torch.parallel.sequence import (
        check_shapes,
        sequence_line,
    )

    del batch_axis
    line = sequence_line(mesh, seq_axis)
    check_shapes("ulysses", query, key, value, kv_valid, line.size, seq_axis, whole=False)
    return ulysses_on_line(line, query, key, value, causal=causal, kv_valid=kv_valid)
