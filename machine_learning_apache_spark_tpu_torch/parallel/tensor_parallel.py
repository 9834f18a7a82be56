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

The same placement covers the expert axis: an MoE layer's ``param_axes``
name ``"expert"`` on the leading dim of ``w_up``/``w_down`` (and
``"mlp"`` on their hidden dim), so under ``model × expert`` such a leaf
is sliced on two axes at once. Its mark lists both (``p.shards``), and
``gather_full``, ``shard_state`` and ``global_sq_norm`` read each entry
(``parallel.expert_parallel`` holds the expert line's collectives).

Every model-axis all-reduce is host-timed into the model's
``TPComms`` (``comms.tp_allreduce`` spans: count, bytes, the window per
step). ``with_sharding_constraint`` has no eager counterpart — an
activation here lies where the code puts it — and is not ported.
"""

from __future__ import annotations

from typing import Mapping

import torch
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


class AxisLine:
    """This rank's line of one mesh axis (``AXIS``): ``size`` ranks, this
    one at ``index``, and the collectives over them, each all-reduce
    timed into ``comms`` (a ``COMMS``, under the kind ``KIND``).
    ``ModelAxis`` and ``parallel.expert_parallel.ExpertAxis`` are its
    two lines."""

    AXIS = ""
    KIND = ""
    COMMS = TimedCollectives

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.axis_size(self.AXIS)
        self.index = mesh.index(self.AXIS)
        self.comms = self.COMMS()

    def restart_comms(self) -> None:
        """Start new totals: a fit's own, or none left open by an
        evaluation."""
        self.comms = self.COMMS()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) in place over the line, in float32 for
        a narrower dtype; timed."""
        if self.size == 1:
            return t
        work = t if t.dtype in (torch.float32, torch.float64, torch.int64) else t.float()
        self.comms.timed(
            self.KIND, lambda: self.mesh.all_reduce_(work, op=op, axis=self.AXIS),
            work.numel() * work.element_size(),
        )()
        if work is not t:
            t.copy_(work)
        return t

    def pieces(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` of the line, in index order."""
        if self.size == 1:
            return [t]
        return list(self.mesh.all_gather(t, self.AXIS).unbind(0))

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's ``t``s concatenated along ``dim`` in index order."""
        return torch.cat(self.pieces(t), dim=dim) if self.size > 1 else t

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={self.size}, index={self.index})"


class ModelAxis(AxisLine):
    """This rank's line of the mesh's model axis (``comms.tp_allreduce``)."""

    AXIS, KIND, COMMS = MODEL_AXIS, "tp_allreduce", TPComms


class _CopyToLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromLine(torch.autograd.Function):
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
    return _CopyToLine.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model axis; the gradient passed through."""
    return _ReduceFromLine.apply(x, axis)


def sum_over_line(x: torch.Tensor, line: AxisLine) -> torch.Tensor:
    """``x`` summed over ``line``, the gradient summed over it too: the
    adjoint of a sum that every rank of the line goes on to use."""
    return _CopyToLine.apply(_ReduceFromLine.apply(x, line), line)


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


def _mark(p: torch.Tensor, line: AxisLine, dim: int, parts: int) -> None:
    """Record on ``p`` that it holds ``line``'s slice along ``dim`` (of
    each of ``parts`` fused parts): ``p.shards`` lists every such
    ``(line, dim, parts)`` in the order they were taken."""
    p.shards = (*getattr(p, "shards", ()), (line, dim, parts))


def local_slice(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``full`` (a tensor of ``p``'s unsharded
    shape: an optimizer moment, an accumulator) as ``p``'s marks took
    ``p``'s."""
    for line, dim, parts in getattr(p, "shards", ()):
        full = shard_slice(full, dim, parts, line.index, line.size)
    return full.contiguous()


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model`` holds a model- or expert-axis shard
    (``shard_params`` ran)."""
    return (getattr(model, "tp_axis", None) is not None
            or getattr(model, "ep_axis", None) is not None)


def model_lines(model: nn.Module) -> list:
    """The model's own axis lines (its ``ModelAxis`` and ``ExpertAxis``,
    once sharded), whose collectives it times."""
    return [a for a in (getattr(model, "tp_axis", None), getattr(model, "ep_axis", None))
            if a is not None]


def _mesh_lines(mesh) -> dict:
    """``{axis: line}`` for the mesh's model and expert axes larger than 1."""
    from machine_learning_apache_spark_tpu_torch.parallel.expert_parallel import ExpertAxis

    return {line.AXIS: line(mesh) for line in (ModelAxis, ExpertAxis)
            if mesh.axis_size(line.AXIS) > 1}


@torch.no_grad()
def shard_params(model: nn.Module, mesh, rules: Mapping[str, str | None] | None = None) -> nn.Module:
    """Keep only this rank's slice of every annotated weight of ``model``
    (in place: each ``Parameter`` keeps its identity, so an optimizer
    built over it stays valid) and switch its layers to the sharded
    forward. Every rank must call this on the same full weights.

    A linear layer's annotation (``Dense(axes=)``) shards it over the
    model axis, column- or row-parallel. A module's ``param_axes``
    (``{name: logical axes}``, e.g. the MoE's ``("expert", "embed",
    "mlp")`` on ``w_up``) slices each dim of that parameter whose logical
    name the rules map to a mesh axis larger than 1 — the expert axis, the
    model axis, or both at once. Then each module's ``tp_sharded(model
    line)`` and ``ep_sharded(expert line)`` hooks run. A mesh whose model
    and expert axes are 1 changes nothing. Returns ``model``."""
    lines = _mesh_lines(mesh)
    if is_sharded(model) or not lines:
        return model
    axis = lines.get(MODEL_AXIS)
    if axis is not None:
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
    for name, m in model.named_modules():
        for pname, logical in getattr(m, "param_axes", {}).items():
            p = getattr(m, pname)
            for dim, entry in enumerate(logical_to_mesh_spec(logical, mesh, rules)):
                line = lines.get(entry)
                if line is None or not _divisible(
                        p.shape[dim], line.size, 1, f"{name}/{pname}", dim, entry):
                    continue
                p.data = shard_slice(p.data, dim, 1, line.index, line.size).contiguous()
                _mark(p, line, dim, 1)
    for hook_name, line in (("tp_sharded", axis), ("ep_sharded", lines.get(EXPERT_AXIS))):
        if line is None:
            continue
        for m in model.modules():
            hook = getattr(m, hook_name, None)
            if hook is not None:
                hook(line)
    model.tp_axis = axis
    model.ep_axis = lines.get(EXPERT_AXIS)
    return model


def gather_full(p: torch.Tensor, value: torch.Tensor | None = None) -> torch.Tensor:
    """``value`` (default: the parameter ``p`` itself; e.g. its gradient)
    in ``p``'s unsharded layout: gathered over each axis ``p`` is sharded
    on, in turn, when it is a shard, else as it is."""
    value = p.detach() if value is None else value
    for line, dim, parts in reversed(getattr(p, "shards", ())):
        value = unshard(line.pieces(value), dim, parts)
    return value


@torch.no_grad()
def gather_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded ``model``: each sharded
    parameter all-gathered over its axes and put back in the unsharded
    layout (exact copies: bit for bit the weights a full load holds),
    every other entry as it is. Loads into the unsharded model."""
    out = dict(model.state_dict())
    for name, p in model.named_parameters():
        out[name] = gather_full(p)
    return out


def global_sq_norm(params: list, grads: list) -> torch.Tensor:
    """The squared global norm of ``grads`` over the whole model: each
    leaf's squares summed over exactly the axes its parameter is sharded
    on (the leaves of one set of axes together: one all-reduce per axis
    of the set), a replicated leaf's counted once (with no shard, the
    plain sum of squares)."""
    groups: dict = {}
    for p, g in zip(params, grads):
        lines = tuple(line for line, _, _ in getattr(p, "shards", ()))
        groups.setdefault(tuple(line.AXIS for line in lines), (lines, []))[1].append(g)
    if set(groups) <= {()}:
        return sum(torch.sum(torch.square(g)) for g in grads)
    total = None
    for key in sorted(k for k in groups if k):
        lines, members = groups[key]
        part = sum(torch.sum(torch.square(g)) for g in members).reshape(1).float()
        for line in lines:
            part = line.all_reduce_(part)
        total = part[0] if total is None else total + part[0]
    if () in groups:
        total = total + sum(torch.sum(torch.square(g)) for g in groups[()][1])
    return total


def shard_state(state, mesh, rules: Mapping[str, str | None] | None = None, *, zero1: bool = False):
    """Place a ``TrainState`` per its model's annotations: the model
    sharded over the model and expert axes (``shard_params``), each
    optimizer moment and accumulator sliced as its parameter is, every
    other leaf as it is — the JAX ``shard_state``. On a pure data mesh
    nothing moves.

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
    if not is_sharded(model) and _mesh_lines(mesh):
        full_shapes = {id(p): tuple(p.shape) for p in model.parameters()}
        shard_params(model, mesh, rules)
        with torch.no_grad():
            for p in model.parameters():
                if not getattr(p, "shards", ()):
                    continue
                for key, value in list(state.optimizer.state.get(p, {}).items()):
                    if isinstance(value, torch.Tensor) and tuple(value.shape) == full_shapes[id(p)]:
                        state.optimizer.state[p][key] = local_slice(p, value)
            if state.acc_grads is not None:
                state.acc_grads = [local_slice(p, a) if getattr(p, "shards", ()) else a
                                   for p, a in zip(state.params, state.acc_grads)]
    state.mesh = mesh
    if zero1:
        from machine_learning_apache_spark_tpu_torch.parallel.zero import shard_moments

        state = shard_moments(state, mesh)
    return state


__all__ = [
    "DEFAULT_RULES",
    "AxisLine",
    "LinearShard",
    "ModelAxis",
    "TPComms",
    "copy_to_model",
    "gather_from_model",
    "gather_full",
    "gather_params",
    "global_sq_norm",
    "is_sharded",
    "local_slice",
    "logical_to_mesh_spec",
    "model_lines",
    "reduce_from_model",
    "shard_params",
    "shard_slice",
    "shard_state",
    "sum_over_line",
    "unshard",
]
