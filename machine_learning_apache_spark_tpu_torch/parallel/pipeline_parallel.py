"""Pipeline parallelism over the mesh's ``"pipeline"`` axis — the port of
``machine_learning_apache_spark_tpu/parallel/pipeline_parallel.py``.

The JAX package writes a GPipe schedule as one SPMD program: every device
runs ``M + S − 1`` ticks of a ``lax.scan``, stage ``s`` applying itself
at tick ``t`` to microbatch ``t − s`` and handing its activation on by a
single-hop ``ppermute``. In that form each device also computes the
warm-up and drain ticks, whose results it throws away, and the ring's
wrap-around hop carries garbage back to stage 0.

Here a stage is a process. Each rank runs **only its own stage**
(``stage_params[stage]``) on the M microbatches in order, receiving each
from stage ``s − 1`` and sending its result to stage ``s + 1`` as a
point-to-point message: there are no garbage ticks and no wrap-around
hop. The schedule is the same GPipe one: stage ``s`` starts microbatch
``m`` once ``s − 1`` has finished it, so the line idles ``(S − 1)`` of
``M + S − 1`` ticks in the forward and again in the backward.

The hops are autograd ``Function``s, so the backward runs the reverse
schedule by itself:

- ``_Recv`` (stage ``s > 0``): receives microbatch ``m`` from ``s − 1``;
  its backward sends the cotangent back to ``s − 1``;
- ``_Send`` (stage ``s < S − 1``): sends microbatch ``m`` to ``s + 1``
  and returns an empty token; its backward receives the cotangent from
  ``s + 1``;
- ``_Broadcast``: the last stage's outputs to every rank of the line,
  which makes the result replicated as the JAX one is. Every rank then
  computes the same loss from it, so every rank's cotangent is the whole
  one: the backward keeps the last stage's and adds nothing up (a sum
  would count it S times). The tokens of this rank's sends are its
  inputs, so a loss's backward reaches every stage's work;
- ``_SumOverLine``: an ``aux`` tensor that needs a gradient (the
  decoder ring's encoder memory) is read by every stage, each for its own
  layers, so each rank's cotangent is a part: the backward sums them over
  the line, the transpose of the JAX replicated ``in_spec``.

The input ``x`` is read by stage 0 alone: its gradient is stage 0's, and
zero on the other stages (their sum is the JAX gradient). A stage's
parameters get gradients only on the ranks of that stage; the training
step's gradient sync (``GradSync``) takes each parameter's gradient from
the stage that owns it (``Parameter.pp_stage``, set here for every
tensor of a per-stage entry). A tensor of the stacked form holds every
stage: each rank's gradient of it is nonzero only in its own stage's
slice, so it is tagged ``STACKED`` and the sync adds every rank's up.
An untagged parameter (the embeddings, the head) is stage 0's.

Every rank posts its hops in one order: microbatch ``0, …, M − 1`` in the
forward and ``M − 1, …, 0`` in the backward (autograd runs the nodes of
one device in reverse creation order, so the last microbatch's subgraph
finishes before the one before it starts). Sends are asynchronous and
waited for at the end of the ring's forward or backward. Over gloo a
CUDA tensor is staged through pinned host memory for a hop: the copy,
the message and the copy back are inside the hop's timed window.

Every hop is host-timed into the line's ``PPComms`` (``comms.pp_send``,
``comms.pp_recv``, ``comms.pp_bcast``, ``comms.pp_allreduce`` spans: the
count, the bytes, the window per step).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PIPELINE_AXIS,
    TimedCollectives,
)


# ``Parameter.pp_stage`` of a tensor of the stacked form: every stage's.
STACKED = "stacked"


class PPComms(TimedCollectives):
    """Host-timed pipeline hops: sends (issue to completion), receives,
    the output broadcasts and the aux gradients' sums, each step's window
    per kind and the bytes."""

    KINDS = ("pp_send", "pp_recv", "pp_bcast", "pp_allreduce")
    STEPS = "pp_steps"


class PipelineLine:
    """This rank's line of the mesh's pipeline axis: ``size`` stages, this
    rank at ``stage``, its neighbours' global ranks, and the hops between
    them (timed into ``comms``). One per mesh shape
    (``pipeline_line``)."""

    def __init__(self, mesh, axis: str = PIPELINE_AXIS):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)
        self.stage = mesh.index(axis)
        self.ranks = mesh.axis_ranks(axis)
        self.comms = PPComms()
        self._pending: list[Callable] = []

    def restart_comms(self) -> None:
        """Start new totals: a fit's own."""
        self.comms = PPComms()

    def send(self, t: torch.Tensor, to: int) -> None:
        """Post ``t`` to stage ``to`` without waiting (``flush`` waits)."""
        host = t.detach().contiguous()
        if host.is_cuda:
            staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            staged.copy_(host)
            host = staged
        nbytes = host.numel() * host.element_size()
        start = self.comms.timed("pp_send", lambda: None, nbytes)
        work = dist.isend(host, self.ranks[to])

        def done(host=host):
            work.wait()
            start()

        self._pending.append(done)

    def recv(self, shape, dtype: torch.dtype, device: torch.device, frm: int) -> torch.Tensor:
        """The tensor stage ``frm`` sent, on ``device``."""
        host = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
        nbytes = host.numel() * host.element_size()

        def call():
            dist.recv(host, self.ranks[frm])

        self.comms.timed("pp_recv", call, nbytes)()
        return host.to(device, non_blocking=True) if device.type == "cuda" else host

    def flush(self) -> None:
        """Wait for every send posted so far."""
        pending, self._pending = self._pending, []
        for done in pending:
            done()

    def broadcast_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` overwritten in place by the last stage's."""
        nbytes = t.numel() * t.element_size()
        self.comms.timed(
            "pp_bcast",
            lambda: self.mesh.broadcast_(t, src=self.size - 1, axis=self.axis),
            nbytes,
        )()
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the line (in float32 for a narrower
        dtype)."""
        work = t if t.dtype in (torch.float32, torch.float64) else t.float()
        self.comms.timed(
            "pp_allreduce", lambda: self.mesh.all_reduce_(work, axis=self.axis),
            work.numel() * work.element_size(),
        )()
        if work is not t:
            t.copy_(work)
        return t

    def __repr__(self) -> str:
        return f"PipelineLine(size={self.size}, stage={self.stage})"


_LINES: dict = {}


def pipeline_line(mesh, axis: str = PIPELINE_AXIS) -> PipelineLine:
    """The ``PipelineLine`` of ``mesh``'s shape (shared by every mesh of
    that shape, as their process groups are)."""
    key = (mesh.size, tuple(mesh.shape.items()), axis)
    if key not in _LINES:
        _LINES[key] = PipelineLine(mesh, axis)
    return _LINES[key]


# -- the hops as autograd Functions ---------------------------------------------


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, shape, dtype, device, anchor):
        ctx.line = line
        return line.recv(shape, dtype, device, line.stage - 1)

    @staticmethod
    def backward(ctx, grad):
        line = ctx.line
        line.send(grad, line.stage - 1)
        return None, None, None, None, grad.new_zeros(0)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, out):
        ctx.line, ctx.shape, ctx.dtype, ctx.device = line, out.shape, out.dtype, out.device
        line.send(out, line.stage + 1)
        return out.new_zeros(0)

    @staticmethod
    def backward(ctx, grad):
        line = ctx.line
        return None, line.recv(ctx.shape, ctx.dtype, ctx.device, line.stage + 1)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, out, like, *tokens):
        line.flush()
        ctx.line, ctx.n_tokens = line, len(tokens)
        buf = out.detach().clone() if out is not None else torch.empty_like(like)
        return line.broadcast_last(buf)

    @staticmethod
    def backward(ctx, grad):
        # Every rank's cotangent is the whole one (each computes the same
        # loss from the replicated output): the last stage keeps its own.
        mine = grad if ctx.line.stage == ctx.line.size - 1 else None
        zeros = [grad.new_zeros(0) for _ in range(ctx.n_tokens)]
        return None, mine, None, *zeros


class _SumOverLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, a):
        ctx.line = line
        return a.view_as(a)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.line.sum_(grad.clone(memory_format=torch.contiguous_format))


class _Flushed(torch.autograd.Function):
    """Identity on stage ``s > 0``'s anchor whose backward waits for the
    ring's backward sends: it runs once every microbatch's ``_Recv``
    has sent its cotangent."""

    @staticmethod
    def forward(ctx, line, anchor):
        ctx.line = line
        return anchor.view_as(anchor)

    @staticmethod
    def backward(ctx, grad):
        ctx.line.flush()
        return None, grad


# -- the schedule -----------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _index(tree, i: int):
    """``tree`` with every tensor leaf indexed at ``i`` on its leading dim."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree


def _stage_count(stage_params) -> set:
    """The leading stage dim(s) of ``stage_params``: a list, tuple or
    ``nn.ModuleList`` holds one entry per stage; a dict holds tensors
    whose leading dim is the stage."""
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        return {len(stage_params)} if len(stage_params) else set()
    return {leaf.shape[0] for leaf in _leaves(stage_params)}


def _stage_of(stage_params, stage: int):
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        return stage_params[stage]
    return _index(stage_params, stage)


def _tag_stages(stage_params) -> None:
    """Mark each tensor of ``stage_params`` with the stage that owns its
    gradient (``Tensor.pp_stage``, which ``GradSync`` reads): entry
    ``s``'s tensors (a module's parameters) with ``s``, the tensors of the
    stacked form with ``STACKED``."""
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        for s, part in enumerate(stage_params):
            for p in part.parameters() if isinstance(part, nn.Module) else _leaves(part):
                p.pp_stage = s
    else:
        for leaf in _leaves(stage_params):
            leaf.pp_stage = STACKED


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh,
    *,
    n_micro: int | None = None,
    axis: str = PIPELINE_AXIS,
    aux=None,
    aux_replicated=None,
) -> torch.Tensor:
    """Run ``x`` through the ``S`` stages of ``stage_fn`` in sequence,
    pipelined over the mesh's ``axis`` — the JAX ``pipeline_apply``'s
    contract, one stage per rank.

    - ``stage_fn(params, x) -> y`` with ``y.shape == x.shape`` (the
      homogeneous stack); with ``aux`` or ``aux_replicated``,
      ``stage_fn(params, x, aux_m, rep_m, stage_id, tick)``, where
      ``aux_m`` / ``rep_m`` are the current microbatch's slices and
      ``tick`` is ``m + stage_id``, the GPipe tick of microbatch ``m``.
    - ``stage_params``: one entry per stage — a list, tuple or
      ``nn.ModuleList`` (entry ``s`` is stage ``s``'s: a module, or a
      dict of tensors), or a dict of tensors whose leading dim is the
      stage (JAX's stacked form). This rank uses only its own stage's.
      Each tensor is tagged with the stage that owns its gradient, for
      ``fit``'s sync: give the parameters themselves (a stacked tensor
      built from several parameters carries the tag, they do not).
    - ``x``: ``[batch, ...]``, this data replica's rows, the same on every
      rank of the line; split into ``n_micro`` microbatches (default S).
    - ``aux``: per-example tensors ``[batch, ...]`` (masks, the encoder
      memory), split with ``x``; one that needs a gradient gets the sum
      of every stage's.
    - ``aux_replicated``: per-microbatch constants, leaves ``[n_micro,
      ...]``. Under a data axis microbatch ``m`` is this replica's
      ``m``-th slice of its rows; JAX's is the ``m``-th slice of the
      global batch, cut over the replicas.

    Composes with a ``"data"`` axis: each data replica pipelines its own
    rows (the samplers split the batch before the step, so the JAX check
    that a microbatch divides over the data axis is the check that this
    replica's rows divide into ``n_micro``). Any other axis larger than 1
    raises the JAX package's ``ValueError``, as do a batch that does not
    divide, a stage count other than S and empty ``stage_params``.

    Returns ``stage_fn^S(x)`` on every rank of the line."""
    n_stages = mesh.axis_size(axis)
    n_micro = n_micro or n_stages
    batch = x.shape[0]
    if batch % n_micro:
        data = mesh.axis_size(DATA_AXIS)
        where = f" (this data replica's rows of {batch * data})" if data > 1 else ""
        raise ValueError(f"batch {batch}{where} not divisible by n_micro={n_micro}")
    leading = _stage_count(stage_params)
    if not leading:
        raise ValueError("stage_params is empty")
    if leading != {n_stages}:
        raise ValueError(f"stage_params leading dim(s) {leading} != {n_stages} stages")
    unsupported = [a for a in mesh.axis_names if a not in (axis, DATA_AXIS) and mesh.shape[a] > 1]
    if unsupported:
        raise ValueError(
            f"pipeline_apply supports only {axis!r}×{DATA_AXIS!r} meshes; "
            f"got extra nontrivial axes {unsupported}"
        )
    _tag_stages(stage_params)
    with_aux = aux is not None or aux_replicated is not None
    line = pipeline_line(mesh, axis)
    stage, last = line.stage, n_stages - 1
    params = _stage_of(stage_params, stage)
    micro = batch // n_micro
    if aux is not None:
        aux = tuple(
            _SumOverLine.apply(line, a) if a.requires_grad and n_stages > 1 else a
            for a in aux
        )
        aux_ms = [tuple(a[m * micro:(m + 1) * micro] for a in aux) for m in range(n_micro)]
    shape = (micro, *x.shape[1:])
    anchor = None
    if stage > 0:
        # A leaf that needs a gradient, so that received activations do:
        # the backward then reaches this stage's work.
        anchor = _Flushed.apply(line, x.new_zeros(0).requires_grad_())
    outs, tokens = [], []
    for m in range(n_micro):
        if stage == 0:
            h = x[m * micro:(m + 1) * micro]
        else:
            h = _Recv.apply(line, shape, x.dtype, x.device, anchor)
        if with_aux:
            out = stage_fn(
                params, h, aux_ms[m] if aux is not None else None,
                _index(aux_replicated, m) if aux_replicated is not None else None,
                stage, m + stage,
            )
        else:
            out = stage_fn(params, h)
        if stage == last:
            outs.append(out)
        else:
            tokens.append(_Send.apply(line, out))
    if n_stages == 1:
        return torch.cat(outs) if n_micro > 1 else outs[0]
    return _Broadcast.apply(line, torch.cat(outs) if stage == last else None, x.detach(), *tokens)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The share of GPipe ticks a stage idles: ``(S − 1) / (M + S − 1)``."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


class GradSync(TimedCollectives):
    """The gradient sync of a training step on a pipeline mesh: one
    all-reduce over the whole mesh of a flat buffer in which each rank
    puts the gradients of the parameters its stage owns
    (``Parameter.pp_stage``; untagged ones are stage 0's) and of the
    stacked ones (``STACKED``: its own stage's slice, zeros in the
    others'), and zeros for the rest, divided by the data axis's size
    (DDP's mean of the ranks' loss-weighted gradients). Every rank then
    holds the same gradient of every parameter. Timed as
    ``comms.allreduce`` (the keys of the DDP hook's ``GradientComms``)."""

    KINDS = ("allreduce",)
    STEPS = "allreduce_steps"

    def __init__(self, mesh, axis: str = PIPELINE_AXIS):
        super().__init__()
        self.mesh = mesh
        self.stage = mesh.index(axis)
        self.replicas = mesh.axis_size(DATA_AXIS)

    @torch.no_grad()
    def sync_(self, params: list) -> None:
        """Every parameter's ``grad`` replaced by the mesh's sum."""
        sizes = [p.numel() for p in params]
        flat = torch.zeros(sum(sizes), dtype=torch.float32, device=params[0].device)
        offset = 0
        for p, n in zip(params, sizes):
            if p.grad is not None and getattr(p, "pp_stage", 0) in (self.stage, STACKED):
                flat[offset:offset + n] = p.grad.reshape(-1)
            offset += n
        flat.div_(self.replicas)
        self.timed("allreduce", lambda: self.mesh.all_reduce_(flat),
                   flat.numel() * flat.element_size())()
        offset = 0
        for p, n in zip(params, sizes):
            g = flat[offset:offset + n].view_as(p).to(p.dtype)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            offset += n


__all__ = [
    "GradSync",
    "PPComms",
    "PipelineLine",
    "STACKED",
    "bubble_fraction",
    "pipeline_apply",
    "pipeline_line",
]
