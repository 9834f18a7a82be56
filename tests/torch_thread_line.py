"""A seq line of ``n`` threads in one process, for the port's sequence
parallelism tests: each thread is one rank of the line and runs the same
code a gang rank runs (``parallel.sequence.attend_on_line`` and the
mechanisms under it) over ``ThreadLine``, whose ``rotate``,
``all_to_all`` and ``all_gather`` pass tensors between the threads as
``SeqLine``'s pass them between processes. ``run_mesh`` runs a whole
mesh of threads the same way: each thread gets a ``ThreadMesh``, which
answers what the port's axis lines (``tensor_parallel.ModelAxis``,
``expert_parallel.ExpertAxis``) ask of a ``parallel.mesh.Mesh``. Like
the port, this module imports torch, never JAX.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Callable

import torch

from machine_learning_apache_spark_tpu_torch.parallel.mesh import _coords, _line_ranks

_TIMEOUT = 60.0


class _Fabric:
    """The threads' mailboxes (one queue per sender, receiver and tag) and
    a barrier for the collectives."""

    def __init__(self, n: int):
        self.n = n
        self.boxes: dict = {}
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(n, timeout=_TIMEOUT)
        self.slots: list = [None] * n

    def box(self, key) -> queue.Queue:
        with self.lock:
            return self.boxes.setdefault(key, queue.Queue())


class ThreadLine:
    """Rank ``index`` of a line of ``fabric.n`` threads, with ``SeqLine``'s
    collectives (no timing)."""

    def __init__(self, fabric: _Fabric, index: int):
        self.fabric = fabric
        self.size = fabric.n
        self.index = index

    def rotate(self, *tensors: torch.Tensor, tag: int = 0) -> Callable[[], list[torch.Tensor]]:
        nxt, prev = (self.index + 1) % self.size, (self.index - 1) % self.size
        for i, t in enumerate(tensors):
            self.fabric.box((self.index, nxt, tag + i)).put(t.detach().clone())

        def received() -> list[torch.Tensor]:
            return [self.fabric.box((prev, self.index, tag + i)).get(timeout=_TIMEOUT)
                    for i in range(len(tensors))]

        return received

    def _everyone(self, x: torch.Tensor) -> list[torch.Tensor]:
        fab = self.fabric
        fab.barrier.wait()
        fab.slots[self.index] = x.detach().clone()
        fab.barrier.wait()
        got = list(fab.slots)
        fab.barrier.wait()
        return got

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        got = self._everyone(x)
        return torch.stack([got[j][self.index] for j in range(self.size)])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._everyone(x))


def _run(n: int, fn: Callable[[int], object], abort: Callable[[], None]) -> list:
    """``fn(i)`` in ``n`` threads; their results in rank order. The first
    exception raised in a thread is raised here (``abort`` releases the
    others)."""
    results: list = [None] * n
    errors: list = []

    def rank(i: int) -> None:
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            abort()

    threads = [threading.Thread(target=rank, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_TIMEOUT * 4)
    if errors:
        raise errors[0]
    return results


def run_line(n: int, fn: Callable[[ThreadLine], object]) -> list:
    """``fn(line)`` in ``n`` threads, one rank of the line each; their
    results in rank order. The first exception raised in a thread is
    raised here."""
    fabric = _Fabric(n)
    return _run(n, lambda i: fn(ThreadLine(fabric, i)), fabric.barrier.abort)


class _Grid:
    """A mesh's lines: one ``_Fabric`` per line of each axis, made on
    first use."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.fabrics: dict = {}
        self.lock = threading.Lock()

    def fabric(self, ranks: tuple) -> _Fabric:
        with self.lock:
            return self.fabrics.setdefault(ranks, _Fabric(len(ranks)))

    def abort(self) -> None:
        with self.lock:
            for fabric in self.fabrics.values():
                fabric.barrier.abort()


class ThreadMesh:
    """Rank ``rank`` of a mesh of threads: ``parallel.mesh.Mesh``'s
    ``shape``, ``axis_names``, ``coords``, ``index``, ``axis_size`` and its
    collectives over this rank's line of an axis (or the whole mesh), the
    reductions summed in index order."""

    device = torch.device("cpu")

    def __init__(self, grid: _Grid, rank: int):
        self.grid = grid
        self.shape = grid.shape
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.size = math.prod(self.shape.values())

    @property
    def coords(self) -> dict:
        return _coords(self.rank, self.shape)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _line(self, axis: str | None) -> ThreadLine:
        ranks = (tuple(range(self.size)) if axis is None
                 else tuple(_line_ranks(self.shape, axis, self.coords)))
        return ThreadLine(self.grid.fabric(ranks), ranks.index(self.rank))

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum",
                    axis: str | None = None) -> torch.Tensor:
        got = torch.stack(self._line(axis)._everyone(tensor))
        tensor.copy_(got.sum(0) if op == "sum" else got.max(0).values)
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        return self._line(axis).all_gather(tensor)


def run_mesh(shape: dict, fn: Callable[[ThreadMesh], object]) -> list:
    """``fn(mesh)`` in one thread per rank of a mesh of ``shape`` (axis →
    size, canonical order); their results in rank order. The first
    exception raised in a thread is raised here."""
    grid = _Grid(shape)
    return _run(math.prod(shape.values()), lambda i: fn(ThreadMesh(grid, i)), grid.abort)
