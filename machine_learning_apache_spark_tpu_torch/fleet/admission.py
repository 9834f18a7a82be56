"""SLO-tier admission — the fleet-level gate in front of every replica queue
(the port of ``machine_learning_apache_spark_tpu/fleet/admission.py``).

Each replica already carries its own ``RequestQueue`` with the
``Backpressure``/retry-after contract (``serving/queue.py``); this layer
adds what a *fleet* needs before a request is allowed to touch any
replica at all:

- **SLO tiers** — named service classes with their own default deadline
  and concurrency budget. ``interactive`` is small-budget/short-deadline
  (latency protected by never letting batch traffic monopolize the
  fleet); ``batch`` is big-budget/long-deadline. A tier at its
  concurrency budget rejects with the same retry-after shape the replica
  queue uses, so clients need one backoff discipline, not two.
- **Per-tenant quotas** — a cap on any single tenant's concurrent
  in-flight requests, so one noisy tenant exhausts its own quota, not
  the fleet.

Admission hands out a :class:`Lease`; the router releases it when the
request reaches any terminal state. retry-after is estimated from an
EWMA of observed service time (the same feedback idea as
``RequestQueue``): "one service-time per queued-ahead slot" — honest
enough to spread thundering herds.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from machine_learning_apache_spark_tpu_torch.serving.queue import Backpressure


class FleetBackpressure(Backpressure):
    """Fleet-level 429: the tier or tenant budget is exhausted. Subclass
    of the replica-queue ``Backpressure`` on purpose — callers already
    handling retry-after handle this one for free. ``scope`` says which
    budget pushed back ("tier:interactive", "tenant:acme")."""

    def __init__(self, depth: int, retry_after: float, scope: str):
        super().__init__(depth, retry_after)
        self.scope = scope

    def __str__(self) -> str:
        return (
            f"fleet admission rejected ({self.scope} at depth "
            f"{self.depth}); retry after {self.retry_after:.3f}s"
        )


@dataclass(frozen=True)
class SLOTier:
    """One service class. ``deadline_s`` is the default per-request
    deadline stamped on submission (a caller's explicit deadline wins);
    ``max_in_flight`` bounds the tier's concurrent admissions across the
    whole fleet."""

    name: str
    deadline_s: float
    max_in_flight: int

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(
                f"tier {self.name!r}: deadline_s must be > 0, "
                f"got {self.deadline_s}"
            )
        if self.max_in_flight < 1:
            raise ValueError(
                f"tier {self.name!r}: max_in_flight must be >= 1, "
                f"got {self.max_in_flight}"
            )


def default_tiers() -> dict[str, SLOTier]:
    """The stock two-tier policy, env-tunable without code
    (``MLSPARK_FLEET_<TIER>_DEADLINE_S`` / ``_MAX_IN_FLIGHT``)."""

    def _f(name: str, default: float) -> float:
        return float(os.environ.get(name, default))

    def _i(name: str, default: int) -> int:
        return int(os.environ.get(name, default))

    return {
        "interactive": SLOTier(
            "interactive",
            deadline_s=_f("MLSPARK_FLEET_INTERACTIVE_DEADLINE_S", 10.0),
            max_in_flight=_i("MLSPARK_FLEET_INTERACTIVE_MAX_IN_FLIGHT", 64),
        ),
        "batch": SLOTier(
            "batch",
            deadline_s=_f("MLSPARK_FLEET_BATCH_DEADLINE_S", 120.0),
            max_in_flight=_i("MLSPARK_FLEET_BATCH_MAX_IN_FLIGHT", 256),
        ),
    }


@dataclass
class Lease:
    """Proof of admission; release exactly once."""

    tier: str
    tenant: str | None
    deadline_s: float
    released: bool = False


class FleetAdmission:
    """Thread-safe tier + tenant budget keeper."""

    def __init__(
        self,
        tiers: dict[str, SLOTier] | None = None,
        *,
        tenant_max_in_flight: int | None = None,
        clock=None,
    ):
        import time

        self.tiers = dict(tiers) if tiers is not None else default_tiers()
        if not self.tiers:
            raise ValueError("at least one SLO tier is required")
        if tenant_max_in_flight is None:
            from machine_learning_apache_spark_tpu_torch.utils import env as envcfg

            tenant_max_in_flight = envcfg.get_int(
                "MLSPARK_FLEET_TENANT_MAX_IN_FLIGHT"
            )
        if tenant_max_in_flight is not None and tenant_max_in_flight < 1:
            raise ValueError(
                f"tenant_max_in_flight must be >= 1, got "
                f"{tenant_max_in_flight}"
            )
        self.tenant_max_in_flight = tenant_max_in_flight
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._tier_in_flight: dict[str, int] = {t: 0 for t in self.tiers}
        self._tenant_in_flight: dict[str, int] = {}
        # Temporary per-tier cap multipliers (0 < factor <= 1). The
        # autoscaler sheds the batch tier during a scale-down drain so
        # the shrinking fleet's headroom goes to interactive traffic.
        self._shed: dict[str, float] = {}
        # EWMA of observed fleet service time, seeding retry-after.
        self._service_ewma = 0.05
        self.admitted = 0
        self.rejected_tier = 0
        self.rejected_tenant = 0

    # -- the gate ------------------------------------------------------------
    def admit(
        self, *, tier: str = "interactive", tenant: str | None = None
    ) -> Lease:
        """Admit or raise :class:`FleetBackpressure` with a retry-after
        proportional to how oversubscribed the exhausted budget is."""
        slo = self.tiers.get(tier)
        if slo is None:
            raise ValueError(
                f"unknown SLO tier {tier!r} (have {sorted(self.tiers)})"
            )
        with self._lock:
            tier_depth = self._tier_in_flight[tier]
            cap = self._effective_cap_locked(tier, slo)
            if tier_depth >= cap:
                self.rejected_tier += 1
                raise FleetBackpressure(
                    tier_depth,
                    self._retry_after_locked(tier_depth, cap),
                    scope=f"tier:{tier}",
                )
            if tenant is not None and self.tenant_max_in_flight is not None:
                tdepth = self._tenant_in_flight.get(tenant, 0)
                if tdepth >= self.tenant_max_in_flight:
                    self.rejected_tenant += 1
                    raise FleetBackpressure(
                        tdepth,
                        self._retry_after_locked(
                            tdepth, self.tenant_max_in_flight
                        ),
                        scope=f"tenant:{tenant}",
                    )
            self._tier_in_flight[tier] = tier_depth + 1
            if tenant is not None:
                self._tenant_in_flight[tenant] = (
                    self._tenant_in_flight.get(tenant, 0) + 1
                )
            self.admitted += 1
        return Lease(tier=tier, tenant=tenant, deadline_s=slo.deadline_s)

    def release(self, lease: Lease, *, service_s: float | None = None) -> None:
        """Return the lease's budget; idempotent. ``service_s`` (time
        from dispatch to terminal state) feeds the retry-after EWMA."""
        with self._lock:
            if lease.released:
                return
            lease.released = True
            self._tier_in_flight[lease.tier] = max(
                0, self._tier_in_flight[lease.tier] - 1
            )
            if lease.tenant is not None:
                left = self._tenant_in_flight.get(lease.tenant, 0) - 1
                if left > 0:
                    self._tenant_in_flight[lease.tenant] = left
                else:
                    self._tenant_in_flight.pop(lease.tenant, None)
            if service_s is not None and service_s >= 0:
                self._service_ewma += 0.2 * (service_s - self._service_ewma)

    # -- shedding (the autoscaler's drain-time lever) ------------------------
    def shed(self, tier: str, factor: float) -> None:
        """Temporarily scale ``tier``'s concurrency cap by ``factor``
        (0 < factor <= 1). At most one shed per tier; re-shedding
        replaces the factor. The floor is a cap of 1 — shedding never
        closes a tier entirely."""
        if tier not in self.tiers:
            raise ValueError(
                f"unknown SLO tier {tier!r} (have {sorted(self.tiers)})"
            )
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"shed factor must be in (0, 1], got {factor}")
        with self._lock:
            self._shed[tier] = factor

    def unshed(self, tier: str) -> None:
        """Restore ``tier``'s full concurrency cap; idempotent."""
        with self._lock:
            self._shed.pop(tier, None)

    def _effective_cap_locked(self, tier: str, slo: SLOTier) -> int:
        factor = self._shed.get(tier)
        if factor is None:
            return slo.max_in_flight
        return max(1, int(slo.max_in_flight * factor))

    def _retry_after_locked(self, depth: int, cap: int) -> float:
        # One EWMA service-time per slot we'd have to wait for, floored
        # so clients can't spin: same shape as RequestQueue's estimate.
        over = max(1, depth - cap + 1)
        return max(0.01, self._service_ewma * over)

    # -- introspection -------------------------------------------------------
    def service_ewma(self) -> float:
        """The raw observed-service-time EWMA (seconds) — the router's
        hedge-delay basis: a hedge fires only once a dispatch has been
        outstanding noticeably longer than a typical request takes."""
        with self._lock:
            return self._service_ewma

    def stats(self) -> dict:
        with self._lock:
            return {
                "tiers": {
                    name: {
                        "in_flight": self._tier_in_flight[name],
                        "max_in_flight": slo.max_in_flight,
                        "effective_max_in_flight": (
                            self._effective_cap_locked(name, slo)
                        ),
                        "shed_factor": self._shed.get(name),
                        "deadline_s": slo.deadline_s,
                    }
                    for name, slo in self.tiers.items()
                },
                "tenants_active": len(self._tenant_in_flight),
                "tenant_max_in_flight": self.tenant_max_in_flight,
                "admitted": self.admitted,
                "rejected_tier": self.rejected_tier,
                "rejected_tenant": self.rejected_tenant,
                "service_ewma_s": round(self._service_ewma, 4),
            }
