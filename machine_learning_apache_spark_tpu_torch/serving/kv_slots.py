"""Fixed-pool KV slot manager — bounded in-flight decode state.

Each in-flight request owns one slot of decode-cache capacity for the
duration of its batch (Ragged Paged Attention's slot discipline, at batch
granularity: the engine's KV caches are per-batch scan state, so a slot
here is the *right to occupy a cache row*, and the pool bound is the hard
ceiling on concurrently-decoding requests). Slots free on EOS — every
completed row — and on deadline expiry of a request that died holding
one; an exhausted pool makes the batcher's next batch wait instead of
oversubscribing device memory.

The pool is a condition-backed free list with owner tracking, so a crash
path can free by request id without knowing which slot it held, plus the
occupancy/high-water counters the metrics ledger reports.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque


class KVSlotPool:
    def __init__(self, num_slots: int, *, clock=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._cond = threading.Condition()
        self._free = list(range(num_slots - 1, -1, -1))  # stack, slot 0 first
        self._owner_of_slot: dict[int, int] = {}
        self._slots_of_owner: dict[int, list[int]] = {}
        # FIFO ticket queue for blocking acquirers: a waiter may only take
        # capacity when its ticket is at the head, so a large all-or-nothing
        # batch cannot be starved by a stream of small batches arriving
        # later and skimming slots as they free.
        self._tickets: deque[int] = deque()
        self._next_ticket = itertools.count()
        self.total_acquired = 0
        self.total_released = 0
        self.high_water = 0

    # -- acquisition ---------------------------------------------------------
    def try_acquire(self, owner_id: int) -> int | None:
        """One slot for ``owner_id``, or None if the pool is dry. Yields
        to queued blocking acquirers — a non-blocking grab must not skim
        a slot an earlier ``acquire_many`` is waiting on."""
        with self._cond:
            if not self._free or self._tickets:
                return None
            return self._take_locked(owner_id)

    def acquire_many(
        self, owner_ids: list[int], timeout: float | None = None
    ) -> list[int] | None:
        """Slots for a whole batch, all-or-nothing; blocks up to
        ``timeout`` for enough capacity. All-or-nothing keeps a formed
        batch indivisible — partial grants would strand requests that the
        batcher already removed from the queue. Grants are FIFO in arrival
        order: a waiter only takes slots once every earlier waiter has
        been served, so a full-pool batch eventually drains instead of
        being starved by smaller batches slipping in behind it."""
        if len(owner_ids) > self.num_slots:
            raise ValueError(
                f"batch of {len(owner_ids)} can never fit a pool of "
                f"{self.num_slots} slots"
            )
        ticket = next(self._next_ticket)
        with self._cond:
            self._tickets.append(ticket)
            try:
                ok = self._cond.wait_for(
                    lambda: (
                        self._tickets[0] == ticket
                        and len(self._free) >= len(owner_ids)
                    ),
                    timeout,
                )
                if not ok:
                    return None
                return [self._take_locked(o) for o in owner_ids]
            finally:
                self._tickets.remove(ticket)
                self._cond.notify_all()

    def _take_locked(self, owner_id: int) -> int:
        slot = self._free.pop()
        self._owner_of_slot[slot] = owner_id
        self._slots_of_owner.setdefault(owner_id, []).append(slot)
        self.total_acquired += 1
        self.high_water = max(self.high_water, self.in_use)
        return slot

    # -- release -------------------------------------------------------------
    def release(self, slot: int) -> None:
        with self._cond:
            owner = self._owner_of_slot.pop(slot, None)
            if owner is None:
                raise ValueError(f"slot {slot} is not held")
            owned = self._slots_of_owner.get(owner, [])
            if slot in owned:
                owned.remove(slot)
                if not owned:
                    del self._slots_of_owner[owner]
            self._free.append(slot)
            self.total_released += 1
            self._cond.notify_all()

    def release_owner(self, owner_id: int) -> int:
        """Free every slot held by ``owner_id`` (EOS or deadline death);
        returns how many were freed. Idempotent — a request that never
        got a slot frees zero."""
        with self._cond:
            owned = self._slots_of_owner.pop(owner_id, [])
            for slot in owned:
                del self._owner_of_slot[slot]
                self._free.append(slot)
            self.total_released += len(owned)
            if owned:
                self._cond.notify_all()
            return len(owned)

    # -- introspection -------------------------------------------------------
    @property
    def in_use(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        """In-use fraction of the pool, 0.0–1.0."""
        return self.in_use / self.num_slots

    def holder(self, slot: int) -> int | None:
        with self._cond:
            return self._owner_of_slot.get(slot)
