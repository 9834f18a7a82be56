"""Serving metrics — the ledger a load balancer and an SRE both read.

Four kinds of signal, matching what the serving path actually controls:

- **admission counters** — submitted / completed / rejected / expired:
  the conservation law (submitted = completed + rejected + expired +
  in-flight) that makes lost requests visible;
- **latency histograms** — queue wait, TTFT (submit → decode done; batch
  decode emits all tokens at once, so first token and last coincide),
  total latency (submit → result set): the p50/p99 pair every latency
  SLO is written against;
- **utilization gauges** — queue depth, batch occupancy (filled rows /
  max_batch — padding waste), KV slot occupancy, sampled once per batch;
- **throughput** — generated tokens/sec over the serving window, the
  number the decode bench reports for one batch, measured here under
  concurrent load.

Histograms store raw samples (serving windows are minutes, not months —
a few thousand floats beat bucket-boundary error), and ``summary()``
returns one plain dict so `tools/serve_bench.py` can emit it verbatim
as a BENCH artifact. ``log_summary`` goes through ``utils.logging`` like
every other metric line in the repo.
"""

from __future__ import annotations

import collections
import math
import threading
import time

from machine_learning_apache_spark_tpu_torch.telemetry import (
    events as telemetry_events,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (
    registry as telemetry_registry,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as telemetry_trace,
)
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: How many slowest-request trace exemplars the ledger retains for
#: /statusz. Small on purpose: exemplars are a debugging entry point
#: ("which request was slow and where did its time go"), not a log.
_MAX_EXEMPLARS = 8

#: SLO burn-rate defaults: a 5-minute sliding window (the classic
#: fast-burn alert horizon) and an EWMA whose ~20-observation memory
#: answers "is it getting worse right now".
BURN_WINDOW_S = 300.0
BURN_ALPHA = 0.1


class ConservationError(AssertionError):
    """The serving admission ledger does not balance — a request was
    admitted and then lost without being completed, rejected, expired, or
    failed. This is the bug class the ledger exists to make impossible to
    miss."""


def percentile(samples: list[float], p: float) -> float | None:
    """Classic nearest-rank percentile (p in [0, 100]): the smallest
    sample with at least p% of the distribution at or below it. None on
    no samples."""
    if not samples:
        return None
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    ordered = sorted(samples)
    rank = max(0, math.ceil(p / 100 * len(ordered)) - 1)
    return ordered[rank]


class Histogram:
    """Thread-safe raw-sample histogram with percentile summaries."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._samples: list[float] = []

    def record(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, p: float) -> float | None:
        with self._lock:
            return percentile(self._samples, p)

    def summary(self) -> dict:
        with self._lock:
            s = list(self._samples)
        if not s:
            return {"count": 0}
        return {
            "count": len(s),
            "mean": sum(s) / len(s),
            "p50": percentile(s, 50),
            "p90": percentile(s, 90),
            "p99": percentile(s, 99),
            "max": max(s),
        }


class BurnRate:
    """Per-tier SLO burn gauge: what fraction of recently retired
    requests missed their deadline.

    Two views over the same observation stream, because one answers
    "how bad" and the other "which way is it going":

    - **window_rate** — miss fraction over a sliding ``window_s``-second
      window (deque of ``(ts, missed)``, pruned on write and read);
    - **ewma** — per-observation exponential average (``alpha``), the
      fast-burn trend an alert differentiates on.

    Thread-safe; observed from caller threads (rejects/expiry) and the
    decode worker (completions) concurrently. One instance per tier,
    shared shape between the serving ledger and the router ledger so the
    fleet scrape can roll replicas up without translation.
    """

    def __init__(
        self,
        *,
        window_s: float = BURN_WINDOW_S,
        alpha: float = BURN_ALPHA,
        clock=time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.window_s = window_s
        self.alpha = alpha
        self.clock = clock
        self._lock = threading.Lock()
        self._events: collections.deque[tuple[float, bool]] = (
            collections.deque()
        )
        self._ewma: float | None = None
        self._total = 0
        self._missed = 0

    def observe(self, missed: bool) -> None:
        now = self.clock()
        with self._lock:
            self._events.append((now, bool(missed)))
            self._prune_locked(now)
            self._total += 1
            self._missed += int(bool(missed))
            x = 1.0 if missed else 0.0
            self._ewma = (
                x if self._ewma is None
                else (1 - self.alpha) * self._ewma + self.alpha * x
            )

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def snapshot(self) -> dict:
        """One JSON-able reading: lifetime totals, windowed miss rate,
        and the EWMA trend (both None before any observation)."""
        now = self.clock()
        with self._lock:
            self._prune_locked(now)
            n = len(self._events)
            misses = sum(1 for _, m in self._events if m)
            return {
                "window_s": self.window_s,
                "window_count": n,
                "window_missed": misses,
                "window_rate": round(misses / n, 4) if n else None,
                "ewma": None if self._ewma is None else round(self._ewma, 4),
                "total": self._total,
                "missed": self._missed,
            }

    @property
    def ewma(self) -> float:
        with self._lock:
            return 0.0 if self._ewma is None else self._ewma


class ServingMetrics:
    """One instance per engine; every field is safe to bump from the
    submit path (caller threads) and the worker thread concurrently."""

    def __init__(self, *, clock=time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self.started_at = clock()
        # admission counters
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        # expired_in_flight ⊆ expired — requests reaped *mid-decode* by
        # the engine's between-launch deadline sweep (including remote
        # /v1/cancel force-expiry), as opposed to expiring in queue.
        # Dead work the cancellation path actually saved, made visible.
        self.expired_in_flight = 0
        self.failed = 0
        # containment counters (engine._quarantine / supervisor restart):
        # quarantined ⊆ failed — requests failed by a contained batch
        # fault; loop_restarts counts decode-loop deaths the supervisor
        # caught. Both 0 in a healthy window.
        self.quarantined = 0
        self.loop_restarts = 0
        # throughput
        self.batches = 0
        self.tokens_out = 0
        # padding-waste accounting: of every token slot the compiled
        # programs computed (prefill + decode), how many carried a real
        # token? The padded path pays rectangle slots (max_batch x
        # boundary, max_batch x max_new_tokens); the paged path pays
        # chunk-padded prefill and max_active x steps launches. The gap
        # is the waste the paged KV layer exists to shrink.
        self.real_tokens = 0
        self.padded_tokens = 0
        # latency histograms (seconds)
        self.queue_wait = Histogram("queue_wait_s")
        self.ttft = Histogram("ttft_s")
        self.total_latency = Histogram("total_latency_s")
        self.batch_latency = Histogram("batch_latency_s")
        # utilization gauges, sampled per batch
        self.batch_occupancy = Histogram("batch_occupancy")
        self.slot_occupancy = Histogram("slot_occupancy")
        self.queue_depth = Histogram("queue_depth")
        # slowest-request trace exemplars: list of (total_s, trace dict),
        # kept sorted slowest-first, capped at _MAX_EXEMPLARS.
        self._exemplars: list[tuple[float, dict]] = []
        # Per-tier SLO burn gauges, created on a tier's first observed
        # retirement. Each tier's EWMA is mirrored into the registry as
        # ``mlspark_serving_slo_burn_<tier>`` so /metrics exposes the
        # fast-burn signal with no extra registration step.
        self._burn: dict[str, BurnRate] = {}
        self._burn_gauges: dict[str, object] = {}
        # Mirror the admission counters into the process-global telemetry
        # registry (no-op singletons when MLSPARK_TELEMETRY=0). The registry
        # is cumulative across engines in one process — the Prometheus view;
        # this ledger stays per-engine.
        reg = telemetry_registry.get_registry()
        self._reg_counters = {
            name: reg.counter("serving", name)
            for name in (
                "submitted", "completed", "rejected", "expired", "failed",
                "quarantined", "loop_restarts", "batches", "tokens_out",
                "real_tokens", "padded_tokens",
            )
        }

    # -- event hooks ---------------------------------------------------------
    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
        self._reg_counters["submitted"].inc()

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1
        self._reg_counters["rejected"].inc()

    def on_expire(self, n: int = 1, *, in_flight: bool = False) -> None:
        with self._lock:
            self.expired += n
            if in_flight:
                self.expired_in_flight += n
        self._reg_counters["expired"].inc(n)

    def on_failure(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n
        self._reg_counters["failed"].inc(n)

    def on_quarantine(self, n: int = 1) -> None:
        with self._lock:
            self.quarantined += n
        self._reg_counters["quarantined"].inc(n)

    def on_loop_restart(self) -> None:
        with self._lock:
            self.loop_restarts += 1
        self._reg_counters["loop_restarts"].inc()

    def on_batch(
        self,
        *,
        n_requests: int,
        max_batch: int,
        decode_s: float,
        new_tokens: int,
        queue_depth: int,
        slot_occupancy: float,
    ) -> None:
        with self._lock:
            self.batches += 1
            self.tokens_out += new_tokens
        self._reg_counters["batches"].inc()
        self._reg_counters["tokens_out"].inc(new_tokens)
        self.batch_latency.record(decode_s)
        self.batch_occupancy.record(n_requests / max_batch)
        self.queue_depth.record(queue_depth)
        self.slot_occupancy.record(slot_occupancy)

    def on_token_slots(self, *, real: int, padded: int) -> None:
        """Account one program dispatch's token slots: ``padded`` slots
        computed, of which ``real`` carried live tokens (``real <=
        padded`` by construction). Cache-hit prefills compute nothing and
        contribute (0, 0)."""
        if real > padded:
            raise ValueError(
                f"real tokens ({real}) cannot exceed computed slots "
                f"({padded})"
            )
        with self._lock:
            self.real_tokens += real
            self.padded_tokens += padded
        self._reg_counters["real_tokens"].inc(real)
        self._reg_counters["padded_tokens"].inc(padded)
        # Event-stream mirror so the gang-level telemetry report
        # (telemetry.aggregate.serving_report) can compute waste across
        # ranks from merged rank files.
        if telemetry_events.enabled():
            log_ = telemetry_events.get_log()
            log_.emit("counter", "serving.tokens_real", value=float(real))
            log_.emit(
                "counter", "serving.tokens_padded", value=float(padded)
            )

    def on_complete(self, *, queue_wait: float, ttft: float, total: float) -> None:
        with self._lock:
            self.completed += 1
        self._reg_counters["completed"].inc()
        self.queue_wait.record(queue_wait)
        self.ttft.record(ttft)
        self.total_latency.record(total)

    def on_slo(self, tier: str | None, missed: bool) -> None:
        """Fold one retired request into its tier's deadline-miss burn
        gauge. ``tier=None`` (untiered direct submission) counts under
        ``interactive`` — the standalone engine's implicit class."""
        tier = tier or "interactive"
        with self._lock:
            burn = self._burn.get(tier)
            if burn is None:
                burn = self._burn[tier] = BurnRate(clock=self.clock)
                self._burn_gauges[tier] = (
                    telemetry_registry.get_registry().gauge(
                        "serving", f"slo_burn_{tier}"
                    )
                )
            gauge = self._burn_gauges[tier]
        burn.observe(missed)
        gauge.set(burn.ewma)

    def slo(self) -> dict:
        """Per-tier burn-gauge snapshots ({} before any observation) —
        the ``slo`` section /statusz and the fleet scrape read."""
        with self._lock:
            burns = dict(self._burn)
        return {tier: b.snapshot() for tier, b in sorted(burns.items())}

    def on_trace(self, req) -> None:
        """Fold one retired request's trace into the ledger: keep it if it
        is among the slowest seen (the /statusz exemplars), and mirror its
        latency breakdown into the event stream as a ``serving.request``
        annotation so gang-level reports can aggregate request latency
        across ranks from merged rank files. Emitted under the request's
        distributed trace context (when it has one) so the annotation
        stitches into the cross-process trace."""
        trace = getattr(req, "trace", None)
        if trace is None:
            return
        bd = trace.breakdown()
        total = bd.get("total_s")
        if total is None:
            return
        with self._lock:
            self._exemplars.append((total, trace.to_dict()))
            self._exemplars.sort(key=lambda e: e[0], reverse=True)
            del self._exemplars[_MAX_EXEMPLARS:]
        if telemetry_events.enabled():
            with telemetry_trace.use(getattr(trace, "ctx", None)):
                telemetry_events.get_log().emit(
                    "annotation", "serving.request", value=total, attrs=bd
                )

    def request_exemplars(self) -> list[dict]:
        """The slowest retired requests' trace dicts, slowest first."""
        with self._lock:
            return [dict(t) for _, t in self._exemplars]

    def ledger(self) -> dict:
        """One atomic read of the admission counters plus the derived
        ``in_flight`` — the /statusz view of the conservation law. Taken
        under the ledger lock so the equality holds even when scraped
        mid-decode (no counter can move between the reads)."""
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
                "failed": self.failed,
                "quarantined": self.quarantined,
                "loop_restarts": self.loop_restarts,
            }
        out["in_flight"] = (
            out["submitted"] - out["completed"] - out["rejected"]
            - out["expired"] - out["failed"]
        )
        return out

    # -- invariants ----------------------------------------------------------
    def check_conservation(self, *, in_flight: int = 0) -> dict:
        """Assert the admission conservation law::

            submitted == completed + rejected + expired + failed + in_flight

        Every admission attempt increments ``submitted`` (the engine counts
        BEFORE the queue decides), so each must end in exactly one terminal
        bucket — ``failed`` includes the quarantined and engine-stop
        failures. ``in_flight`` is the caller's count of requests still
        being worked (0 after a full drain). Raises ``ConservationError``
        with the full ledger on imbalance; returns the ledger otherwise.
        """
        with self._lock:
            ledger = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
                "failed": self.failed,
                "quarantined": self.quarantined,
                "in_flight": in_flight,
            }
        accounted = (
            ledger["completed"] + ledger["rejected"] + ledger["expired"]
            + ledger["failed"] + in_flight
        )
        if ledger["submitted"] != accounted:
            raise ConservationError(
                f"serving conservation violated: submitted "
                f"{ledger['submitted']} != completed + rejected + expired "
                f"+ failed + in_flight = {accounted} ({ledger})"
            )
        return ledger

    # -- reporting -----------------------------------------------------------
    @property
    def tokens_per_sec(self) -> float:
        elapsed = self.clock() - self.started_at
        return self.tokens_out / elapsed if elapsed > 0 else 0.0

    @property
    def padding_waste(self) -> float | None:
        """Fraction of computed token slots that carried padding, 0-1
        (None before any slots are accounted)."""
        with self._lock:
            if self.padded_tokens == 0:
                return None
            return 1.0 - self.real_tokens / self.padded_tokens

    def summary(self) -> dict:
        waste = self.padding_waste
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "expired": self.expired,
            "expired_in_flight": self.expired_in_flight,
            "failed": self.failed,
            "quarantined": self.quarantined,
            "loop_restarts": self.loop_restarts,
            "batches": self.batches,
            "tokens_out": self.tokens_out,
            "tokens_per_sec": round(self.tokens_per_sec, 1),
            "real_tokens": self.real_tokens,
            "padded_tokens": self.padded_tokens,
            "padding_waste": None if waste is None else round(waste, 4),
            "queue_wait_s": self.queue_wait.summary(),
            "ttft_s": self.ttft.summary(),
            "total_latency_s": self.total_latency.summary(),
            "batch_latency_s": self.batch_latency.summary(),
            "batch_occupancy": self.batch_occupancy.summary(),
            "slot_occupancy": self.slot_occupancy.summary(),
            "queue_depth": self.queue_depth.summary(),
            "slo": self.slo(),
        }

    def log_summary(self) -> dict:
        s = self.summary()
        log.info(
            "serving: %d completed / %d submitted (%d rejected, %d expired,"
            " %d failed) | %d batches, %d tokens @ %.1f tok/s | total p50 %s"
            " p99 %s | batch occupancy p50 %s | padding waste %s",
            s["completed"], s["submitted"], s["rejected"], s["expired"],
            s["failed"], s["batches"], s["tokens_out"], s["tokens_per_sec"],
            _fmt(s["total_latency_s"].get("p50")),
            _fmt(s["total_latency_s"].get("p99")),
            _fmt(s["batch_occupancy"].get("p50")),
            _fmt(s["padding_waste"]),
        )
        return s


def _fmt(v: float | None) -> str:
    return "n/a" if v is None else f"{v:.4f}"
