"""The mesh's ``"seq"`` axis: its line, its collectives and the glue that
puts ring or Ulysses attention under the model's attention sites.

The JAX package shards only the attention of a ``sequence_parallel``
step: every tensor outside it is global and replicated over ``"seq"``,
and ``shard_map`` hands each device its sequence chunk of q, k and v and
gathers the output back. The port mirrors that. Every rank of a seq line
holds the whole activations; at an attention site
(``sequence_parallel_attention``, which ``ops.attention.
dot_product_attention`` calls under an active ``sequence_parallel``
context) each rank

1. **slices** its chunk ``[b, H, S/n, d]`` of q, k and v (``_Chunks``),
2. runs the mechanism on the chunks — ``parallel.ring_attention`` (K/V
   chunks rotate around the line) or ``parallel.ulysses_attention``
   (head↔sequence all-to-alls) — and
3. **all-gathers** the output chunks over the line (``_Gathered``).

The loss after the site is computed identically on every rank of the
line, so each rank's cotangent of the gathered output is the whole one:
the gather's backward takes this rank's slice of it and adds nothing up
(a sum would count it n times). The slice's backward all-gathers the
chunk gradients into the full dQ, dK and dV (each rank's chunk of dK/dV
has every rank's queries summed in already, by the mechanism). Every
parameter's gradient is then the same bits on every rank of the line:
DDP, the loss-weight sums and the replica check stay the data axis's.

Every rank of a line must make the same dispatch decisions and the same
collectives in the same order: work that only some ranks run (a BLEU
decode on rank 0) must run outside the context.

``SeqLine`` is this rank's line of the axis: its ranks, its ring
neighbours, its process group, the collectives the mechanisms use
(``rotate``, ``all_to_all``, ``all_gather``) and their host-timed totals
(``SPComms``: ``comms.sp_ring``, ``comms.sp_a2a``, ``comms.sp_gather``
spans with bytes). Over gloo a CUDA tensor is staged through pinned host
memory, as the pipeline's hops are: gloo cannot send a CUDA tensor point
to point (``tools/torch_pp_probe.py``); the copies are inside the timed
windows.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    TimedCollectives,
    process_count,
)

METHODS = ("ring", "ulysses")


class SPComms(TimedCollectives):
    """Host-timed collectives of the seq line: the ring's K/V (and, in the
    backward, dK/dV) rotations, Ulysses' all-to-alls and the sites'
    all-gathers, each step's window per kind and the bytes sent."""

    KINDS = ("sp_ring", "sp_a2a", "sp_gather")
    STEPS = "sp_steps"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous host tensor a gloo message can carry: a CUDA
    tensor copied into pinned memory (the copy waits for its producers), a
    bool tensor viewed as bytes."""
    t = t.detach().contiguous()
    if t.is_cuda:
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        t = staged
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _host_like(t: torch.Tensor) -> torch.Tensor:
    """An empty host tensor to receive ``t``'s like (pinned for a CUDA
    tensor, bytes for a bool one)."""
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    return torch.empty(t.shape, dtype=dtype, pin_memory=t.is_cuda)


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received host tensor as ``like``'s dtype, on ``like``'s device."""
    if like.dtype == torch.bool:
        host = host.view(torch.bool)
    return host.to(like.device, non_blocking=True) if like.is_cuda else host


class SeqLine:
    """This rank's line of the mesh's ``axis``: ``size`` ranks, this one at
    ``index``, the global ranks of the line (``ranks``) and its ring
    neighbours (``next`` receives from this rank, ``prev`` sends to it),
    the line's process group (None when the line is the whole gang), and
    the collectives over it, timed into ``comms``. One per mesh shape
    (``sequence_line``)."""

    def __init__(self, mesh, axis: str = SEQ_AXIS):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)
        self.index = mesh.index(axis)
        self.ranks = mesh.axis_ranks(axis)
        self.prev, self.next = mesh.ring_neighbours(axis)
        self.group = mesh.group(axis)
        self.comms = SPComms()

    def restart_comms(self) -> None:
        """Start new totals: a fit's own."""
        self.comms = SPComms()

    def rotate(self, *tensors: torch.Tensor, tag: int = 0) -> Callable[[], list[torch.Tensor]]:
        """Post each tensor to ``next`` and a receive of its like from
        ``prev``, all at once (so the ring cannot deadlock), and return the
        wait: it gives the received tensors, on the tensors' device. Each
        tensor is its own message, tagged ``tag`` + its position (messages
        in flight together need distinct tags)."""
        sent, bufs, works = [], [], []
        for i, t in enumerate(tensors):
            host = _to_host(t)
            buf = _host_like(t)
            sent.append(host)
            bufs.append(buf)
            works.append(dist.isend(host, self.next, group=self.group, tag=tag + i))
            works.append(dist.irecv(buf, self.prev, group=self.group, tag=tag + i))
        nbytes = sum(h.numel() * h.element_size() for h in sent)

        def wait_all(works=works, sent=sent):
            # ``sent`` holds the host buffers until their sends complete.
            for w in works:
                w.wait()

        wait = self.comms.timed("sp_ring", wait_all, nbytes)

        def received() -> list[torch.Tensor]:
            wait()
            return [_back(b, t) for b, t in zip(bufs, tensors)]

        return received

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[n, ...]``: part ``j`` goes to the line's ``j``-th rank;
        part ``j`` of the result came from it."""
        host = _to_host(x)
        out = _host_like(x)

        def call():
            dist.all_to_all_single(out, host, group=self.group)

        self.comms.timed("sp_a2a", call, host.numel() * host.element_size())()
        return _back(out, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` in line order."""
        host = _to_host(x)
        parts = [_host_like(x) for _ in range(self.size)]

        def call():
            dist.all_gather(parts, host, group=self.group)

        self.comms.timed("sp_gather", call, host.numel() * host.element_size())()
        return _back(torch.stack(parts), x)

    def __repr__(self) -> str:
        return f"SeqLine(size={self.size}, index={self.index})"


_LINES: dict = {}


def sequence_line(mesh, axis: str = SEQ_AXIS) -> SeqLine:
    """The ``SeqLine`` of ``mesh``'s shape (shared by every mesh of that
    shape, as their process groups are)."""
    key = (mesh.size, tuple(mesh.shape.items()), axis)
    if key not in _LINES:
        _LINES[key] = SeqLine(mesh, axis)
    return _LINES[key]


def rows_per_process(mesh, batch_axis: str = DATA_AXIS) -> int:
    """The rows of ``batch_axis`` one process holds: 1 in a gang (each rank
    its own shard of the batch); the whole axis for a mesh laid over one
    process, as the JAX mesh lays every device of a host. The dispatch's
    "the batch fills the data axis" test divides a batch by it."""
    return max(mesh.axis_size(batch_axis) // process_count(), 1)


def check_shapes(method: str, query, key, value, kv_valid, n: int,
                 seq_axis: str = SEQ_AXIS, *, whole: bool = True) -> None:
    """The JAX mechanisms' ``ValueError``s, their words: q/k/v of one
    shape, ``S`` divisible by the line's ``n`` ranks (for ``whole``
    tensors; a rank's chunk is one part already), ``H`` too for Ulysses,
    ``kv_valid`` ``[B, S]``."""
    if query.shape != key.shape or key.shape != value.shape:
        raise ValueError(
            f"{method} attention is self-attention-shaped: q/k/v must match, "
            f"got {tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if whole and query.shape[2] % n:
        raise ValueError(
            f"sequence length {query.shape[2]} not divisible by {seq_axis}={n}"
        )
    if method == "ulysses" and query.shape[1] % n:
        raise ValueError(
            f"ulysses needs num_heads ({query.shape[1]}) divisible by "
            f"{seq_axis}={n}; use ring attention for this head count"
        )
    if kv_valid is not None and tuple(kv_valid.shape) != (query.shape[0], query.shape[2]):
        raise ValueError(
            f"kv_valid must be [batch={query.shape[0]}, seq={query.shape[2]}], "
            f"got {tuple(kv_valid.shape)}"
        )


class _Chunks(torch.autograd.Function):
    """This rank's sequence chunks of whole tensors ``[b, H, S, d]``; the
    backward all-gathers the chunks' gradients (one stacked message) into
    whole ones."""

    @staticmethod
    def forward(ctx, line, *tensors):
        ctx.line = line
        c = tensors[0].shape[2] // line.size
        return tuple(t.narrow(2, line.index * c, c).contiguous() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        line = ctx.line
        like = next(g for g in grads if g is not None)
        stacked = torch.stack([torch.zeros_like(like) if g is None else g for g in grads])
        whole = line.all_gather(stacked)  # [n, k, b, H, c, d]
        n, k, b, h, c, d = whole.shape
        return None, *(whole[:, i].movedim(0, 2).reshape(b, h, n * c, d) for i in range(k))


class _Gathered(torch.autograd.Function):
    """The whole ``[b, H, S, d]`` from every rank's chunk; the backward
    keeps this rank's slice of the cotangent (every rank's is the whole
    one)."""

    @staticmethod
    def forward(ctx, line, chunk):
        ctx.line = line
        whole = line.all_gather(chunk)  # [n, b, H, c, d]
        n, b, h, c, d = whole.shape
        return whole.movedim(0, 2).reshape(b, h, n * c, d)

    @staticmethod
    def backward(ctx, grad):
        line = ctx.line
        c = grad.shape[2] // line.size
        return None, grad.narrow(2, line.index * c, c).contiguous()


def chunk_of(line, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (no gradient path)."""
    c = t.shape[dim] // line.size
    return t.narrow(dim, line.index * c, c).contiguous()


def attend_on_line(line, method: str, query, key, value, *, causal=False, kv_valid=None):
    """``method``'s attention of whole, replicated ``[b, H, S, d]`` tensors
    on ``line``: the chunks, the mechanism, the gather. Every rank of the
    line returns the same bits."""
    from machine_learning_apache_spark_tpu_torch.parallel.ring_attention import ring_on_line
    from machine_learning_apache_spark_tpu_torch.parallel.ulysses_attention import ulysses_on_line

    q, k, v = _Chunks.apply(line, query, key, value)
    valid = None if kv_valid is None else chunk_of(line, kv_valid, 1)
    mechanism = ring_on_line if method == "ring" else ulysses_on_line
    return _Gathered.apply(line, mechanism(line, q, k, v, causal=causal, kv_valid=valid))


def sequence_parallel_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mesh,
    *,
    method: str = "ring",
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
    seq_axis: str = SEQ_AXIS,
    batch_axis: str | None = DATA_AXIS,
) -> torch.Tensor:
    """Attention of whole ``[b, H, S, d]`` tensors, replicated over this
    rank's line of ``seq_axis``, through ``method`` (``"ring"`` or
    ``"ulysses"``) on the line — what an attention site runs under
    ``sequence_parallel``. The JAX mechanisms' ``ValueError``s first, on
    the whole shapes. ``batch_axis`` names the data axis, whose rows this
    rank already holds. Returns the whole output, the same bits on every
    rank of the line; differentiable in q, k and v."""
    del batch_axis
    if method not in METHODS:
        raise ValueError(f"method must be 'ring' or 'ulysses', got {method!r}")
    check_shapes(method, query, key, value, kv_valid, mesh.axis_size(seq_axis), seq_axis)
    return attend_on_line(sequence_line(mesh, seq_axis), method, query, key, value,
                          causal=causal, kv_valid=kv_valid)
