"""A seq line of ``n`` threads in one process, for the port's sequence
parallelism tests: each thread is one rank of the line and runs the same
code a gang rank runs (``parallel.sequence.attend_on_line`` and the
mechanisms under it) over ``ThreadLine``, whose ``rotate``,
``all_to_all`` and ``all_gather`` pass tensors between the threads as
``SeqLine``'s pass them between processes. Like the port, this module
imports torch, never JAX.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import torch

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


def run_line(n: int, fn: Callable[[ThreadLine], object]) -> list:
    """``fn(line)`` in ``n`` threads, one rank of the line each; their
    results in rank order. The first exception raised in a thread is
    raised here."""
    fabric = _Fabric(n)
    results: list = [None] * n
    errors: list = []

    def rank(i: int) -> None:
        try:
            results[i] = fn(ThreadLine(fabric, i))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            fabric.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_TIMEOUT * 4)
    if errors:
        raise errors[0]
    return results
