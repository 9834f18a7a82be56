"""Continuous batcher — shape-bucketed batch formation with a max-wait.

The serving engine's throughput comes from batching; its latency bound
comes from NOT batching too patiently. This module owns that trade. It
reuses the training data layer's bucketing rule (``data.bucketing.
assign_buckets``) so serving traffic lands on the same padded-shape grid
the rest of the repo compiles for: every formed batch has shape
``[max_batch, boundary]`` for some configured boundary, which means a
finite set of XLA programs, all precompilable at warmup, zero recompiles
in steady state.

Formation policy (the standard continuous-batching compromise):

- a bucket that can fill ``max_batch`` ships immediately (throughput);
- otherwise, once the OLDEST pending request has waited ``max_wait_s``,
  the bucket containing it ships partially filled (tail latency) —
  max-wait is measured against the head-of-line request, so no request
  waits more than ``max_wait_s`` for co-batching beyond its own decode;
- ties prefer the fullest bucket among those holding overdue requests.

The batcher is the queue's single consumer and blocks on the queue's
condition, waking on arrivals or timeout.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.bucketing import assign_buckets
from machine_learning_apache_spark_tpu_torch.serving.queue import (
    RequestQueue,
    ServeRequest,
)


@dataclasses.dataclass
class Batch:
    """A formed batch: requests plus the padded width they share."""

    bucket: int
    boundary: int
    requests: list[ServeRequest]

    def __len__(self) -> int:
        return len(self.requests)


class Batcher:
    def __init__(
        self,
        queue: RequestQueue,
        *,
        boundaries: Sequence[int] = (16, 32, 64),
        max_batch: int = 8,
        max_wait_s: float = 0.02,
    ):
        if not boundaries:
            raise ValueError("need at least one bucket boundary")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.queue = queue
        self.boundaries = tuple(sorted(boundaries))
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s

    def bucket_of(self, ids: Sequence[int]) -> int:
        """Bucket index for one request's token row — the same smallest-
        boundary-that-fits rule training batches use."""
        return int(assign_buckets(np.asarray([len(ids)]), self.boundaries)[0])

    def _groups(
        self, pending: list[ServeRequest]
    ) -> dict[int, list[ServeRequest]]:
        groups: dict[int, list[ServeRequest]] = {}
        for r in pending:
            groups.setdefault(self.bucket_of(r.ids), []).append(r)
        return groups

    def _pick_locked(self, now: float) -> Batch | None:
        """One formation attempt over current pending state (queue cond
        held). Returns a batch or None if policy says keep waiting."""
        pending = self.queue.pending_locked()
        if not pending:
            return None
        groups = self._groups(pending)
        # Full bucket → ship (oldest-first within the bucket is free:
        # pending is FIFO, so groups preserve arrival order).
        for b, members in sorted(groups.items()):
            if len(members) >= self.max_batch:
                chosen = members[: self.max_batch]
                self.queue.take_locked(chosen)
                for r in chosen:
                    r.trace.mark("batched", now, bucket=b, full=True)
                return Batch(b, self.boundaries[b], chosen)
        # Head-of-line overdue → ship its bucket, partial.
        oldest = pending[0]
        if now - oldest.submit_time >= self.max_wait_s:
            overdue_buckets = {
                b
                for b, members in groups.items()
                if any(now - r.submit_time >= self.max_wait_s for r in members)
            }
            b = max(overdue_buckets, key=lambda k: len(groups[k]))
            chosen = groups[b][: self.max_batch]
            self.queue.take_locked(chosen)
            for r in chosen:
                r.trace.mark("batched", now, bucket=b, full=False)
            return Batch(b, self.boundaries[b], chosen)
        return None

    def next_batch(self, timeout: float | None = None) -> Batch | None:
        """Block until a batch forms (or ``timeout`` elapses → None).

        Expired requests are swept on every wake so a deadline that
        passes mid-wait fails fast instead of riding into a batch.
        """
        clock = self.queue.clock
        give_up = None if timeout is None else clock() + timeout
        with self.queue.cond:
            while True:
                now = clock()
                self.queue._expire_locked(now)
                batch = self._pick_locked(now)
                if batch is not None:
                    return batch
                # Sleep until: new arrival (notify), the head-of-line
                # request's max-wait maturing, or the caller's timeout.
                waits = []
                if give_up is not None:
                    if now >= give_up:
                        return None
                    waits.append(give_up - now)
                pending = self.queue.pending_locked()
                if pending:
                    waits.append(
                        max(
                            self.max_wait_s
                            - (now - pending[0].submit_time),
                            0.0,
                        )
                    )
                self.queue.cond.wait(min(waits) if waits else None)


class TokenBudgetBatcher:
    """Admission picker for the **paged** engine — continuous batching's
    half of the chunked-prefill compromise.

    The paged engine has no shape buckets to fill and no reason to wait:
    a free row should start decoding the oldest pending request *now*.
    What it must ration is **prefill work per decode iteration** — each
    admission runs an encode of the request's chunk-padded prompt, and
    admitting an unbounded burst between two launches would stall every
    in-flight row's next token behind a wall of prefill (the head-of-line
    blocking chunked prefill exists to prevent). So one ``take`` returns
    the longest FIFO prefix of pending requests whose summed chunk-padded
    prompt cost fits ``token_budget`` (the head request is always
    granted — a budget smaller than one prompt must not wedge the queue),
    capped at ``max_requests`` (the engine's free rows).

    Strictly FIFO: a large prompt at the head is never skipped in favour
    of cheaper ones behind it — the same no-starvation contract the page
    and slot pools enforce with ticket queues.
    """

    def __init__(self, queue: RequestQueue, *, chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.queue = queue
        self.chunk = chunk

    def cost(self, ids: Sequence[int]) -> int:
        """Prefill cost of one request: its prompt length rounded up to
        the chunk grid — what the compiled prefill program computes."""
        n = max(len(ids), 1)
        return ((n + self.chunk - 1) // self.chunk) * self.chunk

    def take(
        self,
        *,
        max_requests: int,
        token_budget: int,
        timeout: float = 0.0,
        cost_fn=None,
    ) -> list[ServeRequest]:
        """FIFO-prefix take under the budget; blocks up to ``timeout``
        while the queue is empty (expired requests are swept on every
        wake, same as ``Batcher``). Returns [] on timeout or when
        ``max_requests`` is 0.

        ``cost_fn(request) -> int`` overrides the chunk-grid default —
        the engine uses it to price prefix-cache hits at zero, since a
        hit attaches pages without running any prefill program and so
        cannot stall in-flight rows (the thing the budget exists to
        prevent)."""
        if max_requests <= 0:
            return []
        clock = self.queue.clock
        give_up = clock() + timeout
        with self.queue.cond:
            while True:
                now = clock()
                self.queue._expire_locked(now)
                pending = self.queue.pending_locked()
                if pending:
                    chosen: list[ServeRequest] = []
                    spent = 0
                    for r in pending:
                        if len(chosen) >= max_requests:
                            break
                        c = (
                            cost_fn(r) if cost_fn is not None
                            else self.cost(r.ids)
                        )
                        if chosen and spent + c > token_budget:
                            break
                        chosen.append(r)
                        spent += c
                    self.queue.take_locked(chosen)
                    for r in chosen:
                        r.trace.mark("batched", now, budget_spent=spent)
                    return chosen
                remaining = give_up - now
                if remaining <= 0:
                    return []
                self.queue.cond.wait(remaining)
