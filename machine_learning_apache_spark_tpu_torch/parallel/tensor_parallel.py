"""Tensor parallelism over the mesh's ``"model"`` axis — the port of
``machine_learning_apache_spark_tpu/parallel/tensor_parallel.py``.

The JAX package annotates every Flax weight with *logical* axis names
(``("embed", "heads")`` on the attention projections, ``("embed",
"mlp")`` / ``("mlp", "embed")`` on the FFN, ``("embed", "vocab")`` on the
LM head), maps them onto mesh axes (``DEFAULT_RULES``), places the
parameters accordingly and lets XLA insert the collectives. Eager
PyTorch propagates no sharding, so here the same annotations (the
port's ``Dense(axes=, parts=)``: the Flax kernel's ``[in, out]`` names
and the fused projections its output holds) decide which slice
of each weight a rank keeps (``shard_params``), and the collectives are
scheduled by hand, Megatron-style (arxiv 1909.08053), in two autograd
``Function``s over this rank's line of the model axis:

- ``copy_to_model``: identity forward, all-reduce of the gradient
  backward — in front of a **column-parallel** projection (the output dim
  sharded: ``("embed", "heads"|"mlp"|"vocab")``), whose input every model
  rank holds whole;
- ``reduce_from_model``: all-reduce forward, identity backward — after a
  **row-parallel** projection (the input dim sharded: ``("heads"|"mlp",
  "embed")``), whose partial products sum to the full one; its bias is
  added once, after the sum.

A column projection's bias is sharded with its output dim; LayerNorms
and embeddings stay replicated. A fused projection (``qkv`` ``[d, 3d]``,
``kv`` ``[d, 2d]``) is sliced per part: each rank keeps columns ``[r·d/M,
(r+1)·d/M)`` of each third (half), its own heads of q, k and v, so every
rank runs attention alone on ``H/M`` heads. (XLA lays the fused kernel
out contiguously and reshards behind ``jnp.split``; the math is the
same.) A dim the axis cannot divide is replicated, loudly, with the JAX
package's warning (``_divisible_sharding``).

The LM head's vocab-sharded logits go to the vocab-parallel
cross-entropy (``train.losses.vocab_parallel_token_cross_entropy``); an
MLP whose last layer is column-parallel gathers its outputs
(``gather_from_model``) before the loss.

Every model-axis all-reduce is host-timed into the model's
``TPComms`` (``comms.tp_allreduce`` spans: count, bytes, the window per
step). ``with_sharding_constraint`` has no eager counterpart — an
activation here lies where the code puts it — and is not ported.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn

from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    TimedCollectives,
)
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Logical axis name -> mesh axis name (None = replicated on that dim): the
# JAX package's rules. ``embed`` stays replicated: d_model is the
# contracting dim everywhere, so sharding it would force an all-reduce per
# matmul; sharding heads/mlp/vocab gives the column→row pairing with one
# all-reduce per block.
DEFAULT_RULES: dict[str, str | None] = {
    "embed": None,
    "heads": MODEL_AXIS,
    "mlp": MODEL_AXIS,
    "vocab": MODEL_AXIS,
    "batch": DATA_AXIS,
    "seq": SEQ_AXIS,
    "expert": EXPERT_AXIS,
}


def logical_to_mesh_spec(spec, mesh, rules: Mapping[str, str | None] | None = None) -> tuple:
    """Translate a spec of logical names (a tuple, one entry per dim) into
    mesh axis names. Logical names with no rule, rules mapping to
    ``None``, and mesh axes not on this mesh all become unsharded dims, so
    the same annotated model runs unchanged on a pure-data mesh."""
    rules = dict(DEFAULT_RULES if rules is None else rules)

    def translate(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            axes = tuple(a for a in (translate(e) for e in entry) if a is not None)
            return axes if axes else None
        mesh_axis = rules.get(entry)
        if mesh_axis is None or mesh_axis not in mesh.axis_names:
            return None
        return mesh_axis

    return tuple(translate(e) for e in spec)


# -- the model axis and its collectives ----------------------------------------


class TPComms(TimedCollectives):
    """Host-timed model-axis all-reduces: each from its call to its
    return (``comms.tp_allreduce`` spans), each step's window from the
    first call to the last return, and the bytes."""

    KINDS = ("tp_allreduce",)
    STEPS = "tp_allreduce_steps"


class ModelAxis:
    """This rank's line of the mesh's model axis: ``size`` ranks, this one
    at ``index``, and the collectives over them (timed into ``comms``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.axis_size(MODEL_AXIS)
        self.index = mesh.index(MODEL_AXIS)
        self.comms = TPComms()

    def restart_comms(self) -> None:
        """Start new totals: a fit's own, or none left open by an
        evaluation."""
        self.comms = TPComms()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) in place over the line, in float32 for
        a narrower dtype; timed."""
        if self.size == 1:
            return t
        work = t if t.dtype in (torch.float32, torch.float64, torch.int64) else t.float()
        self.comms.timed(
            "tp_allreduce", lambda: self.mesh.all_reduce_(work, op=op, axis=MODEL_AXIS),
            work.numel() * work.element_size(),
        )()
        if work is not t:
            t.copy_(work)
        return t

    def pieces(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` of the line, in index order (one
        ``all_gather_into_tensor``, which gloo takes for CUDA tensors)."""
        if self.size == 1:
            return [t]
        out = torch.empty(self.size * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1), group=self.mesh.group(MODEL_AXIS))
        return list(out.view(self.size, *t.shape).unbind(0))

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's ``t``s concatenated along ``dim`` in index order."""
        return torch.cat(self.pieces(t), dim=dim) if self.size > 1 else t

    def __repr__(self) -> str:
        return f"ModelAxis(size={self.size}, index={self.index})"


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return axis.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        i, w = ctx.axis.index, ctx.width
        return grad[..., i * w:(i + 1) * w].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model axis."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model axis; the gradient passed through."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The ranks' last-dim slices concatenated; the gradient sliced back."""
    return _GatherFromModel.apply(x, axis)


class LinearShard:
    """A sharded linear layer's forward: ``mode`` ``"column"`` (its output
    dim sharded: the input copied to the model axis, the sharded bias
    added) or ``"row"`` (its input dim sharded: the partial product
    reduced over the model axis, then the full bias added once). The
    layer's ``compute(x, bias)`` does the arithmetic in its dtype."""

    def __init__(self, mode: str, axis: ModelAxis):
        self.mode = mode
        self.axis = axis

    def __call__(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "column":
            return layer.compute(copy_to_model(x, self.axis), with_bias=True)
        y = reduce_from_model(layer.compute(x, with_bias=False), self.axis)
        return y + layer.bias.to(y.dtype)


# -- placing a module's parameters ---------------------------------------------


def _divisible(size: int, ways: int, parts: int, name: str, dim: int, entry) -> bool:
    """Whether ``size`` (``parts`` fused parts) divides ``ways`` ways —
    else the JAX package's warning, and the dim stays replicated."""
    if (size // parts) % ways == 0 and size % parts == 0:
        return True
    log.warning(
        "%s dim %d (size %d) does not divide mesh axis %r (%d ways); "
        "replicating that dim instead of sharding",
        name or "param", dim, size, entry, ways,
    )
    return False


def shard_slice(full: torch.Tensor, dim: int, parts: int, index: int, ways: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``full`` along ``dim``: its ``1/ways`` of
    each of the ``parts`` fused parts, concatenated."""
    chunks = full.chunk(parts, dim=dim)
    return torch.cat([c.chunk(ways, dim=dim)[index] for c in chunks], dim=dim)


def unshard(pieces: list[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """Inverse of ``shard_slice`` over every rank's piece (index order)."""
    per = [p.chunk(parts, dim=dim) for p in pieces]
    return torch.cat([torch.cat([q[k] for q in per], dim=dim) for k in range(parts)], dim=dim)


def _layer_spec(module: nn.Module, mesh, rules, name: str) -> tuple[str | None, int]:
    """A linear layer's placement: ``("column" | "row" | None, parts)``.
    The annotation is the Flax kernel's ``[in, out]``; torch's weight is
    ``[out, in]``."""
    names = getattr(module, "logical_axes", None)
    if names is None:
        return None, 1
    parts = getattr(module, "fused_parts", 1)
    spec = logical_to_mesh_spec(names, mesh, rules)
    ways = mesh.axis_size(MODEL_AXIS)
    if spec[1] == MODEL_AXIS and _divisible(module.weight.shape[0], ways, parts, f"{name}/kernel", 1, MODEL_AXIS):
        return "column", parts
    if spec[0] == MODEL_AXIS and _divisible(module.weight.shape[1], ways, 1, f"{name}/kernel", 0, MODEL_AXIS):
        return "row", 1
    return None, 1


def _mark(p: torch.Tensor, axis: ModelAxis, dim: int, parts: int) -> None:
    p.tp_axis, p.tp_dim, p.tp_parts = axis, dim, parts


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model`` holds a model-axis shard (``shard_params`` ran)."""
    return getattr(model, "tp_axis", None) is not None


@torch.no_grad()
def shard_params(model: nn.Module, mesh, rules: Mapping[str, str | None] | None = None) -> nn.Module:
    """Keep only this rank's slice of every annotated weight of ``model``
    (in place: each ``Parameter`` keeps its identity, so an optimizer
    built over it stays valid) and switch its layers to the sharded
    forward. Every model rank must call this on the same full weights.
    A mesh whose model axis is 1 changes nothing. Returns ``model``."""
    if is_sharded(model) or mesh.axis_size(MODEL_AXIS) <= 1:
        return model
    axis = ModelAxis(mesh)
    for m in model.modules():
        check = getattr(m, "tp_check", None)
        if check is not None:
            check(axis.size)
    for name, m in model.named_modules():
        mode, parts = _layer_spec(m, mesh, rules, name)
        if mode is None:
            continue
        if mode == "column":
            m.weight.data = shard_slice(m.weight.data, 0, parts, axis.index, axis.size).contiguous()
            m.bias.data = shard_slice(m.bias.data, 0, parts, axis.index, axis.size).contiguous()
            _mark(m.weight, axis, 0, parts)
            _mark(m.bias, axis, 0, parts)
        else:
            m.weight.data = shard_slice(m.weight.data, 1, 1, axis.index, axis.size).contiguous()
            _mark(m.weight, axis, 1, 1)
        m.tp = LinearShard(mode, axis)
    for m in model.modules():
        hook = getattr(m, "tp_sharded", None)
        if hook is not None:
            hook(axis)
    model.tp_axis = axis
    return model


def gather_full(p: torch.Tensor, value: torch.Tensor | None = None) -> torch.Tensor:
    """``value`` (default: the parameter ``p`` itself; e.g. its gradient)
    in ``p``'s unsharded layout: gathered over the model axis when ``p``
    is a shard, else as it is."""
    value = p.detach() if value is None else value
    axis = getattr(p, "tp_axis", None)
    if axis is None:
        return value
    return unshard(axis.pieces(value), p.tp_dim, p.tp_parts)


@torch.no_grad()
def gather_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded ``model``: each sharded
    parameter all-gathered over the model axis and put back in the
    unsharded layout (exact copies: bit for bit the weights a full load
    holds), every other entry as it is. Loads into the unsharded model."""
    out = dict(model.state_dict())
    for name, p in model.named_parameters():
        out[name] = gather_full(p)
    return out


def global_sq_norm(params: list, grads: list) -> torch.Tensor:
    """The squared global norm of ``grads`` over the whole model: a
    sharded leaf's squares summed over the model axis, a replicated
    leaf's counted once (with no shard, the plain sum of squares)."""
    sharded, replicated, axis = [], [], None
    for p, g in zip(params, grads):
        a = getattr(p, "tp_axis", None)
        (sharded if a is not None else replicated).append(g)
        axis = axis or a
    if not sharded:
        return sum(torch.sum(torch.square(g)) for g in grads)
    part = sum(torch.sum(torch.square(g)) for g in sharded).reshape(1).float()
    total = axis.all_reduce_(part)[0]
    if replicated:
        total = total + sum(torch.sum(torch.square(g)) for g in replicated)
    return total


def shard_state(state, mesh, rules: Mapping[str, str | None] | None = None, *, zero1: bool = False):
    """Place a ``TrainState`` per its model's annotations: the model
    sharded over the model axis (``shard_params``), each optimizer moment
    and accumulator sliced as its parameter is, every other leaf as it is
    — the JAX ``shard_state``. On a pure data mesh nothing moves.

    ``zero1=True`` further shards the optimizer moments over the
    ``"data"`` axis on their leading dim (``parallel.zero.shard_moments``,
    ZeRO stage 1 on top of the replicated step); it needs a data axis
    larger than 1, as the JAX function does."""
    if zero1 and mesh.axis_size(DATA_AXIS) <= 1:
        raise ValueError(
            f"zero1=True requires a mesh with a >1 {DATA_AXIS!r} axis; got "
            f"mesh shape {dict(mesh.shape)}"
        )
    model = state.model
    if not is_sharded(model) and mesh.axis_size(MODEL_AXIS) > 1:
        full_shapes = {id(p): tuple(p.shape) for p in model.parameters()}
        shard_params(model, mesh, rules)
        with torch.no_grad():
            for p in model.parameters():
                axis = getattr(p, "tp_axis", None)
                if axis is None:
                    continue
                for key, value in list(state.optimizer.state.get(p, {}).items()):
                    if isinstance(value, torch.Tensor) and tuple(value.shape) == full_shapes[id(p)]:
                        state.optimizer.state[p][key] = shard_slice(
                            value, p.tp_dim, p.tp_parts, axis.index, axis.size
                        ).contiguous()
            if state.acc_grads is not None:
                state.acc_grads = [
                    shard_slice(a, p.tp_dim, p.tp_parts, p.tp_axis.index, p.tp_axis.size).contiguous()
                    if getattr(p, "tp_axis", None) is not None else a
                    for p, a in zip(state.params, state.acc_grads)
                ]
    state.mesh = mesh
    if zero1:
        from machine_learning_apache_spark_tpu_torch.parallel.zero import shard_moments

        state = shard_moments(state, mesh)
    return state


__all__ = [
    "DEFAULT_RULES",
    "LinearShard",
    "ModelAxis",
    "TPComms",
    "copy_to_model",
    "gather_from_model",
    "gather_full",
    "gather_params",
    "global_sq_norm",
    "is_sharded",
    "logical_to_mesh_spec",
    "reduce_from_model",
    "shard_params",
    "shard_slice",
    "shard_state",
    "unshard",
]
