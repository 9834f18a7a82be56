"""Closed-loop fleet autoscaling — SLO burn drives replica count
(the port of ``machine_learning_apache_spark_tpu/fleet/autoscaler.py``).

The fleet grew every piece of the loop except the loop itself: per-tier
SLO burn gauges at router and replica layers, health-aware routing with
drain semantics and a conservation ledger, per-rank restart supervision
in ``ReplicaGang``. :class:`FleetAutoscaler` closes it — a control step
driven by ``ScrapeLoop`` snapshots that resizes the replica set the way
the elastic launcher's shrink resizes a training gang: deliberately, one rank at
a time, with every decision written down.

Control law (evaluated once per scrape tick):

- **Scale up** when any tier's fleet burn EWMA crosses ``burn_up`` *or*
  mean in-flight per healthy replica crosses ``queue_up``, sustained for
  ``hysteresis_ticks`` consecutive ticks, outside the post-action
  ``cooldown_s`` window, below ``max_replicas``. One rank per decision.
- **Scale down** when burn is under ``burn_down`` *and* queue depth is
  under ``queue_down``, with the same hysteresis/cooldown discipline,
  above ``min_replicas``, and at most one drain in flight. The *coldest*
  healthy replica (lowest in-flight) is marked draining: its ``/healthz``
  flips to 503/"draining", the router penalty-boxes it, it finishes its
  in-flight work and exits, and the gang scrubs its sidecars so
  discovery — and with it the router's affinity/penalty state — forgets
  the rank. While the drain runs, the batch tier's admission cap is shed
  (``drain_batch_shed``) so the shrinking fleet's headroom protects
  interactive traffic.
- **Observed scale-down**: a rank that exhausted its restart budget is
  already gone; the autoscaler reaps its sidecars, recomputes the
  target, and logs the decision — preemption is a scale-down event, not
  a failure (the serving twin of elastic-gang shrink-to-fit).

Every decision — including ones *blocked* by cooldown, hysteresis, or
the min/max clamps — is a ``fleet.autoscaler`` annotation carrying its
inputs (burn, queue depth, live count, target, action), so Perfetto /
``trace_report`` can show *why* the fleet resized.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from machine_learning_apache_spark_tpu_torch.fleet.scrape import (
    ReplicaSnapshot,
    fleet_slo_rollup,
)
from machine_learning_apache_spark_tpu_torch.telemetry import events as _events
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass(frozen=True)
class AutoscaleConfig:
    """The control law's knobs; :meth:`from_env` reads the
    ``MLSPARK_AUTOSCALE_*`` contract registered in ``utils/env.py``."""

    min_replicas: int = 1
    max_replicas: int = 8
    burn_up: float = 0.1
    burn_down: float = 0.01
    queue_up: float = 4.0
    queue_down: float = 1.0
    hysteresis_ticks: int = 2
    cooldown_s: float = 5.0
    drain_deadline_s: float = 30.0
    drain_batch_shed: float = 0.5

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.burn_down > self.burn_up:
            raise ValueError(
                f"burn_down ({self.burn_down}) must be <= burn_up "
                f"({self.burn_up}) — the hysteresis band would invert"
            )
        if self.queue_down > self.queue_up:
            raise ValueError(
                f"queue_down ({self.queue_down}) must be <= queue_up "
                f"({self.queue_up}) — the hysteresis band would invert"
            )
        if self.hysteresis_ticks < 1:
            raise ValueError(
                f"hysteresis_ticks must be >= 1, got "
                f"{self.hysteresis_ticks}"
            )
        if not 0.0 < self.drain_batch_shed <= 1.0:
            raise ValueError(
                f"drain_batch_shed must be in (0, 1], got "
                f"{self.drain_batch_shed}"
            )

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            min_replicas=envcfg.get_int("MLSPARK_AUTOSCALE_MIN_REPLICAS"),
            max_replicas=envcfg.get_int("MLSPARK_AUTOSCALE_MAX_REPLICAS"),
            burn_up=envcfg.get_float("MLSPARK_AUTOSCALE_BURN_UP"),
            burn_down=envcfg.get_float("MLSPARK_AUTOSCALE_BURN_DOWN"),
            queue_up=envcfg.get_float("MLSPARK_AUTOSCALE_QUEUE_UP"),
            queue_down=envcfg.get_float("MLSPARK_AUTOSCALE_QUEUE_DOWN"),
            hysteresis_ticks=envcfg.get_int(
                "MLSPARK_AUTOSCALE_HYSTERESIS_TICKS"
            ),
            cooldown_s=envcfg.get_float("MLSPARK_AUTOSCALE_COOLDOWN_S"),
            drain_deadline_s=envcfg.get_float(
                "MLSPARK_AUTOSCALE_DRAIN_DEADLINE_S"
            ),
            drain_batch_shed=envcfg.get_float(
                "MLSPARK_AUTOSCALE_DRAIN_BATCH_SHED"
            ),
        )


class FleetAutoscaler:
    """The control loop over a :class:`~machine_learning_apache_spark_tpu_torch.
    launcher.replica_gang.ReplicaGang` (or anything with its membership
    API: ``live_ranks`` / ``add_rank`` / ``retire_rank`` / ``reap_rank``
    and ``exhausted``/``retired`` sets).

    :meth:`observe` is the unit-testable control step — feed it a
    snapshot map, it applies the law and pulls the gang's levers.
    :meth:`attach` registers it as a ``ScrapeLoop`` observer so it rides
    the router's scrape tick; :meth:`start` falls back to its own
    polling thread when no loop is available.
    """

    def __init__(
        self,
        gang,
        *,
        config: AutoscaleConfig | None = None,
        admission=None,
        clock=time.monotonic,
    ):
        self.gang = gang
        self.config = config or AutoscaleConfig.from_env()
        self.admission = admission  # FleetAdmission, for drain-time shed
        self.clock = clock
        self._lock = threading.Lock()
        self._up_ticks = 0
        self._down_ticks = 0
        self._cooldown_until = 0.0
        self._draining: set[int] = set()
        self._reaped: set[int] = set()
        self._shed_active = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.observed_scale_downs = 0
        self.decisions: list[dict] = []
        self.last_signals: dict = {}

    # -- lifecycle -----------------------------------------------------------
    def attach(self, scrape_loop) -> "FleetAutoscaler":
        """Ride an existing ``ScrapeLoop``: one scrape tick = one control
        step, same snapshots the router dispatches on."""
        scrape_loop.add_observer(self.observe)
        return self

    def start(
        self, snapshot_source, *, interval: float = 0.5
    ) -> "FleetAutoscaler":
        """Standalone mode: poll ``snapshot_source()`` on ``interval``
        from a daemon thread (for drivers without a router)."""
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def _run() -> None:
            while not self._stop.is_set():
                try:
                    self.observe(snapshot_source())
                except Exception:
                    log.exception("autoscaler control step failed")
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=_run, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    # -- the control step ----------------------------------------------------
    def observe(self, snapshots: dict[int, ReplicaSnapshot]) -> dict:
        """One control step. Returns the signals it acted on (with the
        action taken) — the same payload every decision annotation
        carries."""
        with self._lock:
            signals = self._signals(snapshots)
            self.ticks += 1
            self._finish_drains(snapshots, signals)
            self._absorb_exhausted(signals)
            action = self._apply_law(snapshots, signals)
            signals["action"] = action
            self.last_signals = signals
        return signals

    # Callers hold ``self._lock`` for everything below.
    def _signals(self, snapshots: dict[int, ReplicaSnapshot]) -> dict:
        """Burn = worst tier EWMA across the fleet rollup; queue = mean
        in-flight per healthy replica. Draining replicas count toward
        neither — they're leaving, not load-bearing."""
        healthy = [
            s for s in snapshots.values() if s.healthy and not s.draining
        ]
        rollup = fleet_slo_rollup(snapshots)
        burn = max(
            (float(agg.get("max_ewma") or 0.0) for agg in rollup.values()),
            default=0.0,
        )
        loads = [s.load for s in healthy if s.load != float("inf")]
        queue_depth = (sum(loads) / len(loads)) if loads else 0.0
        live = sorted(self.gang.live_ranks())
        return {
            "burn": round(burn, 6),
            "queue_depth": round(queue_depth, 3),
            "healthy": len(healthy),
            "live": len(live),
            "draining": sorted(self._draining),
            "target": len(live),
        }

    def _finish_drains(
        self, snapshots: dict[int, ReplicaSnapshot], signals: dict
    ) -> None:
        """A draining rank that vanished from discovery (the gang scrubbed
        its sidecars after exit) has completed its retirement."""
        done = [
            r for r in self._draining
            if r not in snapshots or r in getattr(self.gang, "retired", ())
        ]
        for rank in done:
            self._draining.discard(rank)
            self.scale_downs += 1
            self._decide(
                "scale_down_complete", signals, rank=rank,
                target=signals["live"],
            )
        if not self._draining and self._shed_active:
            self._shed_active = False
            if self.admission is not None:
                try:
                    self.admission.unshed("batch")
                except Exception:
                    log.exception("batch unshed failed")

    def _absorb_exhausted(self, signals: dict) -> None:
        """Permanent rank death is an *observed* scale-down: reap the
        corpse's sidecars (discovery drops it, the router purges its
        routing state) and recompute the target. The ledger stays
        conserved — the victim's in-flight already terminated as
        failed/lost through the router's retry taxonomy."""
        exhausted = set(getattr(self.gang, "exhausted", ()))
        for rank in sorted(exhausted - self._reaped):
            if self.gang.reap_rank(rank):
                self._reaped.add(rank)
                self.observed_scale_downs += 1
                live = len(self.gang.live_ranks())
                target = max(self.config.min_replicas,
                             min(self.config.max_replicas, live))
                signals["live"] = live
                signals["target"] = target
                self._decide(
                    "observed_scale_down", signals, rank=rank,
                    target=target,
                )

    def _apply_law(
        self, snapshots: dict[int, ReplicaSnapshot], signals: dict
    ) -> str:
        cfg = self.config
        burn, queue = signals["burn"], signals["queue_depth"]
        live = signals["live"]
        hot = burn >= cfg.burn_up or queue >= cfg.queue_up
        cold = burn <= cfg.burn_down and queue <= cfg.queue_down
        if hot:
            self._up_ticks += 1
            self._down_ticks = 0
        elif cold:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = self._down_ticks = 0
            return "steady"
        now = self.clock()
        if hot:
            if self._up_ticks < cfg.hysteresis_ticks:
                return "hold_hysteresis"
            if now < self._cooldown_until:
                return self._decide("hold_cooldown", signals,
                                    target=live + 1)
            if live >= cfg.max_replicas:
                return self._decide("hold_at_max", signals, target=live)
            return self._scale_up(signals)
        if self._down_ticks < cfg.hysteresis_ticks:
            return "hold_hysteresis"
        if now < self._cooldown_until:
            return self._decide("hold_cooldown", signals, target=live - 1)
        if self._draining:
            return "hold_draining"  # one drain at a time
        if live <= cfg.min_replicas:
            return self._decide("hold_at_min", signals, target=live)
        return self._scale_down(snapshots, signals)

    def _scale_up(self, signals: dict) -> str:
        target = signals["live"] + 1
        try:
            rank = self.gang.add_rank()
        except Exception:
            log.exception("scale-up spawn failed")
            return self._decide("scale_up_failed", signals, target=target)
        self.scale_ups += 1
        self._cooldown_until = self.clock() + self.config.cooldown_s
        self._up_ticks = 0
        return self._decide("scale_up", signals, rank=rank, target=target)

    def _scale_down(
        self, snapshots: dict[int, ReplicaSnapshot], signals: dict
    ) -> str:
        target = signals["live"] - 1
        live = set(self.gang.live_ranks())
        # Coldest live replica: fewest requests in flight loses its job.
        candidates = sorted(
            (s for s in snapshots.values()
             if s.rank in live and s.healthy and not s.draining),
            key=lambda s: (s.load, s.rank),
        )
        if not candidates:
            return self._decide("hold_no_candidate", signals, target=target)
        if len(candidates) == 1:
            # Draining the only healthy replica would leave zero serving
            # capacity while warming/unhealthy ranks are still coming up
            # — hold until a second replica is healthy enough to carry
            # the load the victim gives back.
            return self._decide("hold_last_healthy", signals, target=target)
        victim = candidates[0].rank
        if not self.gang.retire_rank(
            victim, drain=True, deadline_s=self.config.drain_deadline_s
        ):
            return self._decide("hold_no_candidate", signals, target=target,
                                rank=victim)
        self._draining.add(victim)
        self._cooldown_until = self.clock() + self.config.cooldown_s
        self._down_ticks = 0
        if self.admission is not None and not self._shed_active:
            # Batch-first shedding: the drain temporarily removes a
            # replica's worth of capacity — take it out of the batch
            # tier's admission budget, never out of interactive's.
            try:
                self.admission.shed("batch", self.config.drain_batch_shed)
                self._shed_active = True
            except Exception:
                log.exception("batch shed failed")
        return self._decide(
            "scale_down_start", signals, rank=victim, target=target,
        )

    def _decide(self, action: str, signals: dict, **extra) -> str:
        """The decision log: one ``fleet.autoscaler`` annotation per
        decision, always carrying its inputs."""
        record = {
            "action": action,
            "burn": signals["burn"],
            "queue_depth": signals["queue_depth"],
            "healthy": signals["healthy"],
            "live": signals["live"],
            "target": extra.pop("target", signals["target"]),
            "wall": round(time.time(), 3),
            **extra,
        }
        self.decisions.append(record)
        try:
            _events.annotate("fleet.autoscaler", **record)
        except Exception:
            pass  # telemetry must never break the control loop
        log.info(
            "autoscale %s: burn=%.4f queue=%.2f live=%d target=%d %s",
            action, record["burn"], record["queue_depth"], record["live"],
            record["target"], extra or "",
        )
        return action

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "observed_scale_downs": self.observed_scale_downs,
                "draining": sorted(self._draining),
                "shed_active": self._shed_active,
                "decisions": len(self.decisions),
                "last": dict(self.last_signals),
                "config": {
                    "min_replicas": self.config.min_replicas,
                    "max_replicas": self.config.max_replicas,
                    "burn_up": self.config.burn_up,
                    "burn_down": self.config.burn_down,
                    "queue_up": self.config.queue_up,
                    "queue_down": self.config.queue_down,
                    "hysteresis_ticks": self.config.hysteresis_ticks,
                    "cooldown_s": self.config.cooldown_s,
                    "drain_deadline_s": self.config.drain_deadline_s,
                    "drain_batch_shed": self.config.drain_batch_shed,
                },
            }
