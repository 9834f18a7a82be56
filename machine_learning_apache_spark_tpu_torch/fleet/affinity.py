"""Prefix-cache affinity table — which replica already holds this prompt
(the port of ``machine_learning_apache_spark_tpu/fleet/affinity.py``).

The paged runtime's ``PrefixCache`` (``serving/kv_pages.py``) keys on
``tuple(token_ids)`` and a hit admits at zero prefill cost; across a
fleet that economics only survives if repeat prompts land on the replica
that paid for the prefill. This table maps
``prefix_digest(ids) -> ranks`` from two sources with different
latencies:

- **Routing memory** (instant): every dispatch records "digest went to
  rank" with an LRU bound + TTL. This is what makes the *second* request
  for a prompt stick before any scrape has run.
- **Scraped residency** (authoritative): each scrape tick replaces a
  rank's resident set with the digests its ``/statusz``
  ``prefix_cache.resident_digests`` actually reports. This corrects the
  routing memory's lies — evictions, replica restarts (a restarted
  replica scrapes back with an empty set and silently loses every stale
  claim) — at scrape-interval granularity.

``candidates(digest)`` is the union; the router intersects it with the
healthy set and falls back to least-loaded when it comes up empty.
Stdlib-only; the digest function itself lives in ``serving.kv_pages``
(the cache side must agree with the router side by construction).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from machine_learning_apache_spark_tpu_torch.serving.kv_pages import prefix_digest

__all__ = ["AffinityTable", "prefix_digest"]


class AffinityTable:
    """Thread-safe digest → candidate-ranks map."""

    def __init__(
        self,
        *,
        memory_capacity: int = 4096,
        memory_ttl_s: float = 60.0,
        clock=time.monotonic,
    ):
        if memory_capacity < 0:
            raise ValueError(
                f"memory_capacity must be >= 0, got {memory_capacity}"
            )
        self.memory_capacity = memory_capacity
        self.memory_ttl_s = memory_ttl_s
        self.clock = clock
        self._lock = threading.Lock()
        # digest -> {rank: last_routed_t} (LRU over digests)
        self._memory: OrderedDict[str, dict[int, float]] = OrderedDict()
        # rank -> frozenset of scraped resident digests
        self._resident: dict[int, frozenset] = {}

    # -- writers -------------------------------------------------------------
    def note_routed(self, digest: str | None, rank: int) -> None:
        """Routing memory: ``digest`` was just dispatched to ``rank`` —
        by the time any response returns, that replica's cache holds (or
        is prefilling) the prefix."""
        if digest is None or self.memory_capacity == 0:
            return
        now = self.clock()
        with self._lock:
            entry = self._memory.get(digest)
            if entry is None:
                entry = self._memory[digest] = {}
            entry[rank] = now
            self._memory.move_to_end(digest)
            while len(self._memory) > self.memory_capacity:
                self._memory.popitem(last=False)

    def observe_scrape(self, rank: int, digests) -> None:
        """Authoritative residency for one rank — *replaces* the rank's
        previous set (an absent digest was evicted; an empty set after a
        restart revokes everything)."""
        with self._lock:
            self._resident[rank] = frozenset(digests)

    def forget_rank(self, rank: int) -> None:
        """Rank left the fleet (killed / drained): drop its residency
        and purge it from routing memory so dead ranks never surface as
        candidates."""
        with self._lock:
            self._resident.pop(rank, None)
            for entry in self._memory.values():
                entry.pop(rank, None)

    # -- readers -------------------------------------------------------------
    def candidates(self, digest: str | None) -> set[int]:
        """Ranks believed to hold ``digest``: scraped residency ∪
        unexpired routing memory."""
        if digest is None:
            return set()
        now = self.clock()
        out: set[int] = set()
        with self._lock:
            for rank, resident in self._resident.items():
                if digest in resident:
                    out.add(rank)
            entry = self._memory.get(digest)
            if entry:
                expired = [
                    r for r, t in entry.items()
                    if now - t > self.memory_ttl_s
                ]
                for r in expired:
                    del entry[r]
                if not entry:
                    self._memory.pop(digest, None)
                out.update(entry)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "memory_digests": len(self._memory),
                "memory_capacity": self.memory_capacity,
                "ranks_with_residency": sorted(self._resident),
                "resident_digests": {
                    r: len(d) for r, d in sorted(self._resident.items())
                },
            }
