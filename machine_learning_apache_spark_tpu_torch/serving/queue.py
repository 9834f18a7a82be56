"""Bounded admission queue — the front door of the serving engine.

Every serving system needs a place where load exceeding capacity becomes
an explicit, bounded decision instead of unbounded memory growth and
silent tail-latency collapse. ``RequestQueue`` is that place: admission
is refused with a ``Backpressure`` carrying a ``retry_after`` hint once
depth hits the bound (the client-visible contract of an HTTP 429), and
requests that outlive their deadline while still queued are failed with
``DeadlineExceeded`` rather than decoded into a response nobody is
waiting for — dead work is the first thing an overloaded server must
shed.

The queue is thread-safe and condition-backed: producers are caller
threads (``ServingEngine.submit``), the single consumer is the batcher,
which waits on the queue's condition for work. ``note_serviced`` feeds an
EWMA of observed service time back from the engine so ``retry_after``
tracks the server's actual drain rate instead of a constant.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Sequence

from machine_learning_apache_spark_tpu_torch.telemetry import events as telemetry_events
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as telemetry_trace,
)

_REQUEST_IDS = itertools.count()
_TRACE_IDS = itertools.count()


def _new_trace_id() -> str:
    """Process-unique, gang-disambiguated request identity: the id a batch
    span records, a flight dump carries, and /statusz exemplars key on."""
    rank = telemetry_events._env_rank()
    prefix = f"r{rank}-" if rank is not None else ""
    return f"{prefix}{os.getpid():x}-{next(_TRACE_IDS):x}"


class RequestTrace:
    """One request's stitched timeline across threads: submit (caller) →
    batch/admit (worker) → first token → retire, as ``(name, t, attrs)``
    marks on the monotonic clock, plus a decode-launch counter (launches
    are counted, not itemized — a long generation spans dozens).

    Deliberately lock-free: marks are appended by one thread at a time
    (the request moves queue → worker, never concurrently), and readers
    (``/statusz`` exemplars, flight dumps) copy the append-only list.

    When a distributed trace context (``telemetry.tracectx``) is active
    on the submitting thread, the trace **adopts** its 128-bit trace id
    — so the id a replica returns in its 200 payload, the id the batch
    span links, and the id the router minted are all the same string —
    and keeps the context (``ctx``) so worker-thread emissions (the
    ``serving.request`` annotation) can re-activate it.
    """

    __slots__ = ("trace_id", "marks", "launches", "ctx")

    def __init__(self, trace_id: str | None = None, *, ctx=None):
        if ctx is None:
            ctx = telemetry_trace.current()
        self.ctx = ctx
        if trace_id is None:
            trace_id = ctx.trace_id if ctx is not None else _new_trace_id()
        self.trace_id = trace_id
        self.marks: list[tuple] = []
        self.launches = 0

    def mark(self, name: str, t: float, **attrs) -> None:
        self.marks.append((name, t, attrs or None))

    def note_launch(self, n: int = 1) -> None:
        self.launches += n

    def t(self, name: str) -> float | None:
        """Timestamp of the first mark named ``name`` (None if absent)."""
        for mark_name, t, _ in list(self.marks):
            if mark_name == name:
                return t
        return None

    def attrs(self, name: str) -> dict:
        for mark_name, _, attrs in list(self.marks):
            if mark_name == name:
                return attrs or {}
        return {}

    def breakdown(self) -> dict:
        """Queue-wait / TTFT / service / total durations derived from the
        marks — where this request's latency actually went."""
        t_submit = self.t("submit")
        t_admit = self.t("admit")
        t_first = self.t("first_token")
        t_done = self.t("complete") or self.t("failed") or self.t("expire")
        out: dict = {"trace_id": self.trace_id, "launches": self.launches}
        admit_attrs = self.attrs("admit")
        if "kind" in admit_attrs:
            out["prefill"] = admit_attrs["kind"]
        if "prefill_tokens" in admit_attrs:
            out["prefill_tokens"] = admit_attrs["prefill_tokens"]
        if t_submit is not None:
            if t_admit is not None:
                out["queue_wait_s"] = round(t_admit - t_submit, 6)
            if t_first is not None:
                out["ttft_s"] = round(t_first - t_submit, 6)
            if t_done is not None:
                out["total_s"] = round(t_done - t_submit, 6)
        if t_admit is not None and t_done is not None:
            out["service_s"] = round(t_done - t_admit, 6)
        return out

    def timeline(self) -> list[dict]:
        """The marks as dicts, with times relative to submit (JSON-ready
        — what a flight dump's quarantined-request section carries)."""
        marks = list(self.marks)
        t0 = marks[0][1] if marks else 0.0
        out = []
        for name, t, attrs in marks:
            d = {"event": name, "t_s": round(t - t0, 6)}
            if attrs:
                d.update(attrs)
            out.append(d)
        return out

    def to_dict(self) -> dict:
        return {**self.breakdown(), "timeline": self.timeline()}


class Backpressure(RuntimeError):
    """Admission refused: queue at capacity. ``retry_after`` (seconds) is
    the server's estimate of when capacity frees — the 429 Retry-After."""

    def __init__(self, depth: int, retry_after: float):
        super().__init__(
            f"queue at capacity (depth={depth}); retry after "
            f"~{retry_after:.3f}s"
        )
        self.depth = depth
        self.retry_after = retry_after


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before a result was produced."""


@dataclasses.dataclass
class ServeRequest:
    """One in-flight translation request.

    ``ids`` is the ragged (unpadded) token-id row — the bucketing key and
    the payload the batcher pads. ``deadline`` is an absolute monotonic
    time or None. The ``future`` resolves to the detokenized string (or
    an exception); timestamps feed the metrics ledger.
    """

    text: str
    ids: list[int]
    submit_time: float
    deadline: float | None = None
    id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    future: Future = dataclasses.field(default_factory=Future)
    # Stamped by the engine: when this request's first token became
    # available (padded path: batch decode emits all tokens at once, so
    # TTFT and decode-done coincide; paged path: end of the launch that
    # produced the first emit).
    decode_done_time: float | None = None
    # Stamped by the paged engine when the request leaves the queue for a
    # cache row (queue-wait measurement point).
    admit_time: float | None = None
    slot: int | None = None
    # SLO service class ("interactive" / "batch"); None for untiered
    # direct submissions. Feeds the per-tier deadline-miss burn gauges.
    tier: str | None = None
    # The distributed-tracing identity + timeline: assigned at submit,
    # marked at every stage transition, surfaced as /statusz exemplars
    # and in quarantine flight dumps.
    trace: RequestTrace = dataclasses.field(default_factory=RequestTrace)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def result(self, timeout: float | None = None) -> str:
        """Block for the translation (or re-raise its failure)."""
        return self.future.result(timeout)


class RequestQueue:
    """FIFO of pending ``ServeRequest``s with bounded depth and deadline
    hygiene. All mutation happens under one condition variable, shared
    with the batcher (``cond``) so arrival wakes a waiting consumer."""

    def __init__(
        self,
        max_depth: int,
        *,
        default_deadline_s: float | None = None,
        clock=time.monotonic,
        on_expire=None,
        on_slo=None,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.default_deadline_s = default_deadline_s
        self.clock = clock
        # Observer for in-queue deadline deaths (the engine wires the
        # metrics ledger here so queue-level expiry is not invisible).
        self.on_expire = on_expire
        # Per-request SLO observer ``fn(tier, missed)`` — an in-queue
        # expiry is a deadline miss by definition, so the burn-rate
        # gauges must see it even though the engine never did.
        self.on_slo = on_slo
        self.cond = threading.Condition()
        self._pending: list[ServeRequest] = []
        # EWMA of per-request service time (seconds), fed by the engine;
        # seeds the retry_after estimate before any batch has completed.
        self._service_time_ewma = 0.05
        self.rejected = 0
        self.expired = 0

    # -- producer side -------------------------------------------------------
    def submit(
        self,
        text: str,
        ids: Sequence[int],
        *,
        deadline_s: float | None = None,
        tier: str | None = None,
    ) -> ServeRequest:
        """Admit a request or raise ``Backpressure``. Expired entries are
        purged first so a burst of dead requests can't hold the door shut
        against live ones."""
        now = self.clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        with self.cond:
            self._expire_locked(now)
            if len(self._pending) >= self.max_depth:
                self.rejected += 1
                # Cold path (admission already refused): the event is a
                # breadcrumb for the flight recorder, not a hot-loop cost.
                telemetry_events.annotate(
                    "serving.queue.reject", depth=len(self._pending)
                )
                raise Backpressure(
                    len(self._pending),
                    self._service_time_ewma * (len(self._pending) + 1),
                )
            req = ServeRequest(
                text=text,
                ids=list(ids),
                submit_time=now,
                deadline=None if deadline_s is None else now + deadline_s,
                tier=tier,
            )
            req.trace.mark("submit", now, depth=len(self._pending))
            self._pending.append(req)
            self.cond.notify_all()
            return req

    # -- consumer side (call with ``cond`` held) -----------------------------
    def pending_locked(self) -> list[ServeRequest]:
        """Live pending requests, FIFO. Caller holds ``cond``."""
        return list(self._pending)

    def take_locked(self, requests: Sequence[ServeRequest]) -> None:
        """Remove ``requests`` (a batcher's pick) from pending. Caller
        holds ``cond``."""
        chosen = {r.id for r in requests}
        self._pending = [r for r in self._pending if r.id not in chosen]

    def requeue_front(self, requests: Sequence[ServeRequest]) -> None:
        """Put admission-rollback requests back at the **head** of the
        queue in their original order (the paged engine took them but the
        page pool momentarily could not hold them). Deliberately exempt
        from the depth bound: these requests were already admitted once,
        and bouncing them now would turn a transient pool blip into
        client-visible rejections."""
        if not requests:
            return
        with self.cond:
            self._pending[:0] = list(requests)
            self.cond.notify_all()

    def _expire_locked(self, now: float) -> list[ServeRequest]:
        """Fail-and-drop every pending request whose deadline passed."""
        dead = [r for r in self._pending if r.expired(now)]
        if dead:
            self._pending = [r for r in self._pending if not r.expired(now)]
            self.expired += len(dead)
            for r in dead:
                r.trace.mark("expire", now)
                r.future.set_exception(
                    DeadlineExceeded(
                        f"request {r.id} expired after "
                        f"{now - r.submit_time:.3f}s in queue"
                    )
                )
            if self.on_expire is not None:
                self.on_expire(len(dead))
            if self.on_slo is not None:
                for r in dead:
                    self.on_slo(r.tier, True)
            telemetry_events.annotate(
                "serving.queue.expire", count=len(dead)
            )
        return dead

    def expire_overdue(self) -> int:
        """Public deadline sweep (the engine runs one per loop iteration);
        returns the number of requests dropped."""
        with self.cond:
            return len(self._expire_locked(self.clock()))

    def expire_now(self) -> int:
        """Immediate deadline sweep, callable from any thread — the
        batcher fires it when an admit round comes back empty, and the
        replica's ``/v1/cancel`` path fires it after force-expiring a
        queued request, so deadlines burn down even when no arriving
        traffic triggers the submit-side sweep. Wakes any consumer
        blocked in a timed wait so it re-evaluates the shrunken queue."""
        with self.cond:
            dead = self._expire_locked(self.clock())
            if dead:
                self.cond.notify_all()
            return len(dead)

    # -- feedback / introspection -------------------------------------------
    def note_serviced(self, n_requests: int, elapsed: float) -> None:
        """Engine feedback after each batch: fold observed per-request
        service time into the EWMA behind ``retry_after``."""
        if n_requests <= 0 or elapsed <= 0:
            return
        per_req = elapsed / n_requests
        with self.cond:
            self._service_time_ewma = (
                0.7 * self._service_time_ewma + 0.3 * per_req
            )

    @property
    def depth(self) -> int:
        with self.cond:
            return len(self._pending)

    def fail_all(self, exc: Exception) -> int:
        """Drain every pending request with ``exc`` (engine shutdown)."""
        with self.cond:
            dead, self._pending = self._pending, []
            for r in dead:
                r.future.set_exception(exc)
            self.cond.notify_all()
            return len(dead)
