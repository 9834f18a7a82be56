"""Paged KV pool — block-table memory management for ragged serving.

The padded engine's ``KVSlotPool`` hands out whole cache *rows*; this
module manages the same capacity at **page** granularity (the Ragged
Paged Attention discipline, arxiv 2604.15464): the device holds one big
page store ``[layers, 2, num_pages, page_size, d_model]`` and every
in-flight request owns a *list* of page ids — its block table — that
grows one page at a time as decode crosses page boundaries and is freed
on EOS or deadline expiry via the owner id, exactly like the slot pool.

Two things a row pool cannot do become natural here:

- **Prefix sharing** — pages are refcounted, so N requests with the same
  prompt can point their block tables at one physical copy of the prefix
  KV. ``PrefixCache`` below keeps completed prompts' pages alive under a
  cache-owned reference (LRU, evicted under pressure) so a repeat prompt
  skips its prefill entirely.
- **Ragged occupancy** — a short request holds few pages and a long one
  many, so the pool bound is a *token* budget, not a requests × max_len
  rectangle.

Page id 0 is reserved as the **null page**: block tables are padded with
0, the kernel/scatter paths may harmlessly read/write it, and it is
never allocated. Grants are FIFO in arrival order (ticket queue), the
same starvation fix ``KVSlotPool.acquire_many`` carries.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict, deque
from typing import Sequence

#: Reserved page id: block-table padding. Never allocated, never freed;
#: scatter/gather paths may touch it freely.
NULL_PAGE = 0


def prefix_digest(key: Sequence[int]) -> str:
    """Stable, transport-safe digest of a prefix-cache key (the prompt's
    token ids). The cache itself keys on ``tuple(ids)``; anything that
    has to ship residency over the wire — ``PrefixCache.stats()`` on
    ``/statusz``, the fleet router's affinity table — uses this digest
    instead, so two processes agree on identity without exchanging the
    ids themselves. blake2b, not ``hash()``: Python's per-process hash
    randomization would break exactly the cross-process agreement this
    exists for. Non-int elements (tests key caches with sentinel
    strings) stringify as-is — identical bytes to ``int()`` coercion
    for the production token-id case, numpy scalars included."""
    raw = ",".join(str(t) for t in key).encode("utf-8")
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


class KVPagePool:
    """Refcounted free-list allocator over page ids ``1..num_pages-1``.

    Owners are any hashable id (request ids, ``("prefix", key)`` for
    cache-held references). A page is freed when its refcount reaches
    zero; ``release_owner`` drops every reference an owner holds, so the
    crash/expiry path needs only the request id.
    """

    def __init__(self, num_pages: int, *, page_bytes: int | None = None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}"
            )
        if page_bytes is not None and page_bytes < 1:
            raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
        self.num_pages = num_pages
        self.capacity = num_pages - 1  # allocatable pages
        #: Device bytes one page actually costs (payload + any
        #: quantization scales) — set by the owner so occupancy and
        #: high-water readings convert honestly to bytes regardless of
        #: the store dtype. None = owner never told us.
        self.page_bytes = page_bytes
        self._cond = threading.Condition()
        self._free = list(range(num_pages - 1, 0, -1))  # stack, page 1 on top
        self._refs: dict[int, int] = {}
        self._pages_of_owner: dict[object, list[int]] = {}
        self._tickets: deque[int] = deque()
        self._next_ticket = itertools.count()
        self.total_acquired = 0
        self.total_released = 0
        self.high_water = 0

    # -- acquisition ---------------------------------------------------------
    def try_acquire(self, n: int, owner: object) -> list[int] | None:
        """``n`` fresh pages (refcount 1) for ``owner``, or None if the
        pool can't satisfy it right now. Yields to queued blocking
        acquirers so it can't starve an earlier ``acquire``."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        with self._cond:
            if self._tickets or len(self._free) < n:
                return None
            return self._take_locked(n, owner)

    def acquire(
        self, n: int, owner: object, timeout: float | None = None
    ) -> list[int] | None:
        """Blocking all-or-nothing grant of ``n`` pages, FIFO-fair in
        arrival order (ticket queue — same fairness contract as
        ``KVSlotPool.acquire_many``)."""
        if n > self.capacity:
            raise ValueError(
                f"request for {n} pages can never fit a pool of "
                f"{self.capacity} allocatable pages"
            )
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        ticket = next(self._next_ticket)
        with self._cond:
            self._tickets.append(ticket)
            try:
                ok = self._cond.wait_for(
                    lambda: (
                        self._tickets[0] == ticket and len(self._free) >= n
                    ),
                    timeout,
                )
                if not ok:
                    return None
                return self._take_locked(n, owner)
            finally:
                self._tickets.remove(ticket)
                self._cond.notify_all()

    def _take_locked(self, n: int, owner: object) -> list[int]:
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        if pages:
            self._pages_of_owner.setdefault(owner, []).extend(pages)
        self.total_acquired += n
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def add_ref(self, pages: list[int], owner: object) -> None:
        """Take an additional reference on already-allocated ``pages``
        under ``owner`` — the prefix-sharing primitive. The pages stay
        allocated until *every* holder (and the cache) releases."""
        with self._cond:
            for p in pages:
                if p == NULL_PAGE or p not in self._refs:
                    raise ValueError(f"page {p} is not allocated")
            for p in pages:
                self._refs[p] += 1
            if pages:
                self._pages_of_owner.setdefault(owner, []).extend(pages)

    # -- release -------------------------------------------------------------
    def release_owner(self, owner: object) -> int:
        """Drop every reference ``owner`` holds (EOS, expiry, crash);
        returns how many pages were actually freed (refcount hit zero).
        Idempotent — an owner with no references frees zero."""
        with self._cond:
            pages = self._pages_of_owner.pop(owner, [])
            freed = self._drop_refs_locked(pages)
            if freed:
                self._cond.notify_all()
            return freed

    def _drop_refs_locked(self, pages: list[int]) -> int:
        freed = 0
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed += 1
        self.total_released += freed
        return freed

    # -- introspection -------------------------------------------------------
    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        """Allocated fraction of the pool, 0.0-1.0."""
        return self.in_use / self.capacity

    @property
    def bytes_in_use(self) -> int | None:
        """Actual device bytes of allocated pages — dtype-aware (int8
        payload + scale planes count what they really cost), or None
        when the owner never declared ``page_bytes``."""
        return None if self.page_bytes is None else (
            self.in_use * self.page_bytes
        )

    @property
    def bytes_high_water(self) -> int | None:
        return None if self.page_bytes is None else (
            self.high_water * self.page_bytes
        )

    @property
    def bytes_capacity(self) -> int | None:
        return None if self.page_bytes is None else (
            self.capacity * self.page_bytes
        )

    def refcount(self, page: int) -> int:
        with self._cond:
            return self._refs.get(page, 0)

    def pages_of(self, owner: object) -> list[int]:
        with self._cond:
            return list(self._pages_of_owner.get(owner, []))


class PrefixCache:
    """LRU cache of prompt-prefix KV pages, keyed by token ids.

    An entry's pages carry one cache-owned reference (owner
    ``("prefix", key)``), so they survive the request that prefilled
    them. ``get`` attaches a requester reference on hit — a shared
    prefix is never freed while any attached request is decoding, and an
    evicted entry's pages only return to the pool once the last attached
    request releases. Single-writer discipline (the engine's decode
    thread) but locked anyway for introspection from other threads.
    """

    def __init__(self, pool: KVPagePool, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.pool = pool
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, dict] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def owner_for(key: tuple) -> tuple:
        return ("prefix", key)

    def contains(self, key: tuple) -> bool:
        """Side-effect-free membership probe — no ref attached, no LRU
        bump, no hit/miss accounting. For admission-cost estimation only;
        racy by nature (an entry can be evicted before ``get``), so
        callers must treat a True as a hint, never a reservation."""
        with self._lock:
            return key in self._entries

    def get(self, key: tuple, owner: object) -> dict | None:
        """On hit: attach ``owner`` to the entry's pages and return the
        entry ``{"pages": [...], **meta}``; on miss return None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        self.pool.add_ref(entry["pages"], owner)
        return entry

    def put(self, key: tuple, pages: list[int], **meta) -> bool:
        """Adopt freshly-prefixed ``pages`` into the cache under a
        cache-owned reference. Returns False (no ref taken) when the
        cache is disabled or the key is already present."""
        if self.capacity == 0:
            return False
        with self._lock:
            if key in self._entries:
                return False
        self.pool.add_ref(pages, self.owner_for(key))
        with self._lock:
            # Digest computed once at adoption: stats() is scraped on
            # every /statusz poll and must not re-hash the whole cache.
            self._entries[key] = {
                "pages": list(pages), "digest": prefix_digest(key), **meta
            }
            self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            if not self.evict_one():
                break
        return True

    def evict_one(self) -> bool:
        """Drop the LRU entry's cache reference; its pages free once no
        request still holds them. False when the cache is empty."""
        with self._lock:
            if not self._entries:
                return False
            key, _entry = self._entries.popitem(last=False)
            self.evictions += 1
        self.pool.release_owner(self.owner_for(key))
        return True

    def evict_until_free(self, n_pages: int) -> None:
        """Shed LRU entries until the pool has ``n_pages`` free or the
        cache is empty — the admission path's pressure valve."""
        while self.pool.free < n_pages:
            if not self.evict_one():
                return

    def flush(self) -> int:
        """Drop every entry (quarantine path: the page store is being
        reset, so cached contents are invalid). Returns entries dropped."""
        n = 0
        while self.evict_one():
            n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self, *, max_digests: int = 64) -> dict:
        """Counters plus a bounded residency digest — the fleet router's
        affinity source of truth (scraped off ``/statusz``). Digests are
        MRU-first and capped at ``max_digests`` so a big cache can't
        bloat every scrape; the count of digests *not* listed rides
        along so a consumer can tell "bounded view" from "everything"."""
        with self._lock:
            lookups = self.hits + self.misses
            digests = [
                e["digest"] for e in reversed(self._entries.values())
            ][:max_digests]
            resident_pages = sum(
                len(e["pages"]) for e in self._entries.values()
            )
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / lookups, 4) if lookups else None,
                "resident_pages": resident_pages,
                "resident_bytes": (
                    None if self.pool.page_bytes is None
                    else resident_pages * self.pool.page_bytes
                ),
                "resident_digests": digests,
                "digests_truncated": max(0, len(self._entries) - len(digests)),
            }
