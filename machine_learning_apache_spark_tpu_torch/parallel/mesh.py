"""The mesh — a named-axes view of the process group; the port of
``machine_learning_apache_spark_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over the devices of a slice
and compiles the collectives into the step. Here a gang is N processes
with one device each (``launcher.coordinator``), joined by a
``torch.distributed`` process group, and the mesh names its axes:

- ``"data"``     — batch-sharded data parallelism (the reference's DDP, C11);
- ``"model"``    — tensor parallelism (``parallel.tensor_parallel``): each
  rank holds its slice of every annotated weight;
- ``"pipeline"`` — pipeline parallelism (``parallel.pipeline_parallel``):
  each rank runs one stage of a layer stack on every microbatch;
- ``"seq"``      — sequence parallelism (``parallel.sequence``): the ranks
  of a seq line hold the same activations and split each attention site's
  sequence between them (ring or Ulysses attention) under
  ``ops.attention.sequence_parallel``. It composes with ``"data"``,
  ``"model"`` and ``"expert"`` (a seq line for each of their coordinates,
  the attention on each model rank's heads); beside ``"pipeline"`` it
  raises the JAX recipe's ``ValueError``;
- ``"expert"``   — expert parallelism (``parallel.expert_parallel``): each
  rank of an expert line holds its share of every MoE layer's experts and
  runs their FFNs on the rows the line holds alike.

Ranks lie on the mesh as the JAX mesh lays devices: the axes in
canonical order, ``data`` outermost and ``model`` innermost, so on a
``data × model`` mesh rank = ``data_index · M + model_index``, on a
``data × pipeline`` one rank = ``data_index · S + stage``, on a
``data × seq`` one rank = ``data_index · N + seq_index``, on a
``data × expert × model`` one rank = ``(data_index · N + expert_index) ·
M + model_index`` and on a ``data × seq × model`` one rank =
``(data_index · N + seq_index) · M + model_index``. A mesh of
several processes builds one process group per line of each axis (the
ranks that share every other coordinate) when it is made: every rank
calls ``dist.new_group`` for every group, in one fixed order, as
``torch.distributed`` requires; meshes of one shape share their groups.

Each rank's ``DistributedSampler`` already gives it its slice of the
global batch, so ``shard_batch`` only moves this rank's batch onto its
device; ``replicate`` is a broadcast from the first rank of each data
line. The collectives (``Mesh.all_reduce_``, ``Mesh.broadcast_``) run
over the whole gang or, given ``axis=``, over this rank's line of that
axis; they take host and device tensors under either backend: gloo
stages a CUDA tensor through host memory itself, and a host tensor under
NCCL is staged through the card.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Mapping

import torch
import torch.distributed as dist
from torch import nn

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPELINE_AXIS = "pipeline"
EXPERT_AXIS = "expert"

_CANONICAL_ORDER = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

#: The axes a mesh may hold larger than 1.
_PORTED_AXES = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

#: Process groups per (world, mesh shape): built once, shared by every
#: mesh of that shape.
_GROUPS: dict = {}


def process_count() -> int:
    """The gang's world size (``jax.process_count()``'s counterpart): the
    process group's size, 1 outside a gang."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the gang, 0 outside one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _coords(rank: int, shape: Mapping[str, int]) -> dict[str, int]:
    """``rank``'s coordinate on each axis of ``shape`` (canonical order,
    the last axis innermost)."""
    out = {}
    for name in reversed(tuple(shape)):
        out[name] = rank % shape[name]
        rank //= shape[name]
    return {a: out[a] for a in shape}


def _line_ranks(shape: Mapping[str, int], axis: str, at: Mapping[str, int]) -> list[int]:
    """The ranks along ``axis`` through the coordinates ``at`` (every
    other axis fixed), in axis order."""
    names = tuple(shape)
    ranks = []
    for i in range(shape[axis]):
        point = dict(at, **{axis: i})
        r = 0
        for a in names:
            r = r * shape[a] + point[a]
        ranks.append(r)
    return ranks


def _axis_groups(shape: Mapping[str, int]) -> dict:
    """``{axis: (group, ranks)}`` for this rank's line of each axis larger
    than 1 and smaller than the world. Every group of every axis is made
    here, by every rank, in one order (axes canonical, lines by their
    first rank): ``dist.new_group`` is collective over the whole gang."""
    world = math.prod(shape.values())
    key = (world, tuple(shape.items()))
    if key not in _GROUPS:
        out = {}
        for axis, size in shape.items():
            if size <= 1 or size == world:
                continue
            lines = sorted({
                tuple(_line_ranks(shape, axis, _coords(r, shape))) for r in range(world)
            })
            for line in lines:
                group = dist.new_group(list(line))
                if process_index() in line:
                    out[axis] = (group, list(line))
        _GROUPS[key] = out
    return _GROUPS[key]


def _run_collective(tensor: torch.Tensor, call) -> None:
    """Run ``call(t)`` (an in-place collective) on ``tensor`` where the
    group's backend can take it: gloo takes host and CUDA tensors alike
    (it stages a CUDA tensor through pinned host memory itself); NCCL
    reduces device memory only, so a host tensor is staged through this
    rank's card."""
    if not tensor.is_cuda and dist.get_backend() == "nccl":
        staged = tensor.to(torch.device("cuda", torch.cuda.current_device()))
        call(staged)
        # mlspark-lint: ok recompile-device-get -- a gang's collective; a gang's steps run eagerly (StepDispatch.group), never captured
        tensor.copy_(staged.cpu())
    else:
        call(tensor)


class TimedCollectives:
    """Host-timed collectives of the ``KINDS`` a subclass names: each from
    its issue to the return of its wait (a ``comms.<kind>`` span; gloo's
    handles have no completion callback, so a collective that finished
    earlier is read at its wait), each step's window per kind from the
    first issue to the last wait's return, and the bytes. ``end_step()``
    closes a step; ``stats()`` gives the totals, the steps under
    ``STEPS``."""

    KINDS: tuple = ()
    STEPS = "steps"

    def __init__(self):
        self._lock = threading.Lock()
        self.steps = 0
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.seconds = dict.fromkeys(self.KINDS, 0.0)
        self.window = dict.fromkeys(self.KINDS, 0.0)
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self._first: dict = dict.fromkeys(self.KINDS)
        self._last = dict.fromkeys(self.KINDS, 0.0)

    def timed(self, kind: str, wait: Callable, nbytes: int) -> Callable:
        """``wait`` (the completion of a collective issued now, or a
        blocking collective itself) timed from now to its first return;
        returns the timed wait."""
        # mlspark-lint: ok recompile-time -- a gang's collective; a gang's steps run eagerly (StepDispatch.group), never captured
        t0 = time.perf_counter()
        with self._lock:
            if self._first[kind] is None:
                self._first[kind] = t0
        done = []

        def timed_wait():
            wait()
            if done:
                return
            done.append(True)
            t1 = time.perf_counter()  # mlspark-lint: ok recompile-time -- as t0 above
            with self._lock:
                self.calls[kind] += 1
                self.seconds[kind] += t1 - t0
                self.bytes[kind] += nbytes
                self._last[kind] = max(self._last[kind], t1)
            telemetry.get_log().emit(
                "span_end", f"comms.{kind}", value=t1 - t0, attrs={"bytes": nbytes}
            )

        return timed_wait

    def end_step(self) -> None:
        with self._lock:
            self.steps += 1
            for kind in self.KINDS:
                if self._first[kind] is not None:
                    self.window[kind] += self._last[kind] - self._first[kind]
                self._first[kind] = None

    def emit_counters(self) -> None:
        """One ``comms.<kind>_calls``, one ``comms.<kind>_bytes`` and one
        ``comms.<kind>_window_seconds`` counter event per kind with the
        steps so far, which the gang report's comms section turns into
        per-step figures."""
        if not self.steps:
            return
        log = telemetry.get_log()
        for kind in self.KINDS:
            attrs = {"steps": self.steps}
            log.emit("counter", f"comms.{kind}_calls", value=self.calls[kind], attrs=attrs)
            log.emit("counter", f"comms.{kind}_bytes", value=self.bytes[kind], attrs=attrs)
            log.emit("counter", f"comms.{kind}_window_seconds", value=self.window[kind], attrs=attrs)

    def stats(self) -> dict:
        out = {self.STEPS: self.steps}
        for kind in self.KINDS:
            out |= {
                f"{kind}_calls": self.calls[kind],
                f"{kind}_seconds": self.seconds[kind],
                f"{kind}_bytes": self.bytes[kind],
                f"{kind}_window_seconds": self.window[kind],
                f"{kind}_ms_per_step": 1e3 * self.window[kind] / max(self.steps, 1),
            }
        return out


class Mesh:
    """A named-axes view of the process group: ``shape`` (axis → size, in
    canonical order), ``axis_names``, ``size`` (the product, the world
    size), this process's ``rank`` and its ``coords`` (axis → index).
    ``device`` is this rank's device: the coordinator's choice in a gang,
    else the one given (default: the card, which raises without one).
    ``group(axis)`` / ``axis_ranks(axis)`` name this rank's line of an
    axis: its process group (None for the whole gang) and its ranks."""

    def __init__(self, axes: Mapping[str, int], device: str | torch.device | None = None):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self._device = device
        self._groups = {}
        if self.size > 1 and process_count() == self.size:
            self._groups = _axis_groups(self.shape)

    @property
    def coords(self) -> dict[str, int]:
        return _coords(self.rank, self.shape)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 on an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def ring_neighbours(self, axis: str) -> tuple[int, int]:
        """``(prev, next)``: the global ranks before and after this one on
        its line of ``axis``, the line closed into a ring."""
        ranks, i = self.axis_ranks(axis), self.index(axis)
        return ranks[(i - 1) % len(ranks)], ranks[(i + 1) % len(ranks)]

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's line of ``axis``."""
        if axis not in self.shape:
            return [self.rank]
        return _line_ranks(self.shape, axis, self.coords)

    def group(self, axis: str | None = None):
        """The process group of this rank's line of ``axis``: None (the
        default group) for the whole gang or an axis that spans it."""
        if axis is None or self.axis_size(axis) == self.size:
            return None
        if self.axis_size(axis) <= 1:
            raise ValueError(f"axis {axis!r} of size 1 has no group")
        return self._groups[axis][0]

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

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum",
                    axis: str | None = None) -> torch.Tensor:
        """Sum (or max) ``tensor`` in place over every rank of the mesh,
        or over this rank's line of ``axis``; a no-op over one rank."""
        n = self.size if axis is None else self.axis_size(axis)
        if n > 1:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            group = self.group(axis)
            _run_collective(tensor, lambda t: dist.all_reduce(t, op=red, group=group))
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``tensor`` of this rank's line of ``axis``, stacked
        in index order (``[n, *tensor.shape]``; one
        ``all_gather_into_tensor``, which gloo takes for CUDA tensors)."""
        n = self.axis_size(axis)
        if n == 1:
            return tensor[None]
        out = torch.empty(n * tensor.numel(), dtype=tensor.dtype, device=tensor.device)
        dist.all_gather_into_tensor(out, tensor.reshape(-1).contiguous(), group=self.group(axis))
        return out.view(n, *tensor.shape)

    def broadcast_(self, tensor: torch.Tensor, src: int = 0,
                   axis: str | None = None) -> torch.Tensor:
        """Overwrite ``tensor`` in place with rank ``src``'s (with ``axis``:
        with the ``src``-th rank's of this rank's line of it); a no-op over
        one rank."""
        n = self.size if axis is None else self.axis_size(axis)
        if n > 1:
            group = self.group(axis)
            root = src if axis is None else self.axis_ranks(axis)[src]
            _run_collective(tensor, lambda t: dist.broadcast(t, src=root, group=group))
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
    The shape errors are the JAX package's ``ValueError``s. A ``"seq"``
    axis beside a ``"pipeline"`` one raises the JAX recipe's
    ``ValueError`` (the pipeline composes with data parallelism only); an
    axis name the port does not know, larger than 1, raises
    ``NotImplementedError``."""
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

    if axes.get(SEQ_AXIS, 1) > 1 and axes.get(PIPELINE_AXIS, 1) > 1:
        raise ValueError(
            f"pipeline_parallel={axes[PIPELINE_AXIS]} composes with data parallelism "
            f"only; incompatible settings: {{'sequence_parallel': {axes[SEQ_AXIS]}}}"
        )
    for name, size in axes.items():
        if name not in _PORTED_AXES and size > 1:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size} is not ported yet "
                f"(ROADMAP queue A4 (distributed))"
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
    """The hybrid 2-D mesh: ``data × model`` with ``model`` innermost
    (canonical axis order), the layout ``fit(dp_mode="zero1")`` composes
    ZeRO-1 and tensor parallelism over. ``data=None`` spreads whatever
    processes remain after the model axis."""
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
    """Make every rank hold the values of the first rank of its data
    line (rank 0 on a pure data mesh; on a ``data × model`` mesh the
    rank of data index 0 with this rank's model index, whose tensor
    shards are this rank's): each tensor of ``tree`` (an ``nn.Module``'s
    parameters and buffers, a list, tuple or dict of tensors, or one
    tensor) is broadcast in place. Returns ``tree``."""
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
            mesh.broadcast_(t.data if isinstance(t, nn.Parameter) else t, src=0,
                            axis=DATA_AXIS)
    return tree
