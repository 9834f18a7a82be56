"""The mesh — a named-axes view of the process group; the port of
``machine_learning_apache_spark_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over the devices of a slice
and compiles the collectives into the step. Here a gang is N processes
with one device each (``launcher.coordinator``), joined by a
``torch.distributed`` process group, and the mesh names its axes:

- ``"data"``     — batch-sharded data parallelism (the reference's DDP, C11);
- ``"model"``, ``"seq"``, ``"pipeline"``, ``"expert"`` — the JAX package's
  other axes. Only size 1 is ported: a larger one raises
  ``NotImplementedError`` naming ROADMAP A4's item.

Each rank's ``DistributedSampler`` already gives it its slice of the
global batch, so ``shard_batch`` only moves this rank's batch onto its
device; ``replicate`` is a broadcast from rank 0. The collectives
(``Mesh.all_reduce_``, ``Mesh.broadcast_``) take host and device tensors
under either backend: gloo stages a CUDA tensor through host memory
itself, and a host tensor under NCCL is staged through the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn

from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPELINE_AXIS = "pipeline"
EXPERT_AXIS = "expert"

_CANONICAL_ORDER = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

#: The ROADMAP items that port each non-data axis.
_AXIS_ITEMS = {
    MODEL_AXIS: "A4: parallel/tensor_parallel.py",
    SEQ_AXIS: "A4: ring_attention.py and ulysses_attention.py",
    PIPELINE_AXIS: "A4: pipeline_parallel.py",
    EXPERT_AXIS: "A4: the MoE experts' mesh axis",
}


def process_count() -> int:
    """The gang's world size (``jax.process_count()``'s counterpart): the
    process group's size, 1 outside a gang."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the gang, 0 outside one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _run_collective(tensor: torch.Tensor, call) -> None:
    """Run ``call(t)`` (an in-place collective) on ``tensor`` where the
    group's backend can take it: gloo takes host and CUDA tensors alike
    (it stages a CUDA tensor through pinned host memory itself); NCCL
    reduces device memory only, so a host tensor is staged through this
    rank's card."""
    if not tensor.is_cuda and dist.get_backend() == "nccl":
        staged = tensor.to(torch.device("cuda", torch.cuda.current_device()))
        call(staged)
        tensor.copy_(staged.cpu())
    else:
        call(tensor)


class Mesh:
    """A named-axes view of the process group: ``shape`` (axis → size, in
    canonical order), ``axis_names``, ``size`` (the product, the world
    size) and this process's ``rank``. ``device`` is this rank's device:
    the coordinator's choice in a gang, else the one given (default: the
    card, which raises without one)."""

    def __init__(self, axes: Mapping[str, int], device: str | torch.device | None = None):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self._device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return process_index()

    @property
    def device(self) -> torch.device:
        from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
            current_device,
        )

        gang = current_device()
        if gang is not None:
            return gang
        return resolve_device(self._device)

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) ``tensor`` in place over every rank of the mesh;
        a no-op for a mesh of one."""
        if self.size > 1:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            _run_collective(tensor, lambda t: dist.all_reduce(t, op=red))
        return tensor

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``tensor`` in place with rank ``src``'s; a no-op for a
        mesh of one."""
        if self.size > 1:
            _run_collective(tensor, lambda t: dist.broadcast(t, src=src))
        return tensor

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(
    axes: Mapping[str, int] | None = None,
    *,
    world: int | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """Build a mesh from an axis-name → size mapping over the ``world``
    processes of the gang (default: the process group's size).

    Size ``0`` or ``-1`` on at most one axis means "all remaining
    processes"; no axes means a pure data-parallel mesh over all of them.
    The shape errors are the JAX package's ``ValueError``s. An axis other
    than ``"data"`` larger than 1 raises ``NotImplementedError`` naming
    the ROADMAP item that ports it."""
    n = process_count() if world is None else world
    axes = dict(axes or {DATA_AXIS: n})

    wildcard = [k for k, v in axes.items() if v in (0, -1)]
    if len(wildcard) > 1:
        raise ValueError(f"at most one wildcard axis, got {wildcard}")
    fixed = math.prod(v for v in axes.values() if v not in (0, -1))
    if wildcard:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        axes[wildcard[0]] = n // fixed
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh {axes} does not cover {n} devices")

    for name, size in axes.items():
        if name != DATA_AXIS and size > 1:
            item = _AXIS_ITEMS.get(name, "A4 (distributed)")
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size} is not ported yet "
                f"(ROADMAP queue {item})"
            )
    names = sorted(
        axes.keys(),
        key=lambda a: _CANONICAL_ORDER.index(a) if a in _CANONICAL_ORDER else 0,
    )
    return Mesh({a: axes[a] for a in names}, device=device)


def data_parallel_mesh(n: int | None = None, *, device: str | torch.device | None = None) -> Mesh:
    """The parity mesh: one axis ``"data"`` over n (default: all)
    processes — the reference's N gloo ranks (SURVEY.md §2.4). Asking
    for more processes than the gang has raises the JAX package's
    ``ValueError``."""
    world = None if n is None else min(n, process_count())
    return make_mesh({DATA_AXIS: 0 if n is None else n}, world=world, device=device)


def data_model_mesh(model: int, data: int | None = None) -> Mesh:
    """The hybrid ``data × model`` mesh; a ``"model"`` axis larger than 1
    is ROADMAP A4's tensor-parallel item and raises."""
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    return make_mesh({DATA_AXIS: 0 if data is None else data, MODEL_AXIS: model})


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: ``spec`` names the mesh axis each
    leading dimension is split over (``()`` = replicated) — the
    ``NamedSharding`` of the JAX package as a plain description."""

    mesh: Mesh
    spec: tuple[str, ...] = ()


def batch_sharding(mesh: Mesh, *, axis: str = DATA_AXIS) -> Sharding:
    """Dim 0 split over the data axis — the ``DistributedSampler``
    partitioning (``distributed_cnn.py:112-119``)."""
    return Sharding(mesh, (axis,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Whole replicas on every rank (``DDP(model)``,
    ``distributed_cnn.py:156``)."""
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch, *, axis: str = DATA_AXIS):
    """This rank's slice of the global batch onto its device: the rank's
    ``DistributedSampler`` already chose the rows, so this is the copy
    (pinned, non-blocking for the card; token ids as int64)."""
    del axis
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    return to_device(batch, mesh.device)


def replicate(mesh: Mesh, tree):
    """Make every rank hold rank 0's values: each tensor of ``tree`` (an
    ``nn.Module``'s parameters and buffers, a list, tuple or dict of
    tensors, or one tensor) is broadcast from rank 0 in place. Returns
    ``tree``."""
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t.data if isinstance(t, nn.Parameter) else t, src=0)
    return tree
