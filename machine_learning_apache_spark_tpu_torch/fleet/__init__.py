"""fleet/ — multi-replica serving data plane: N engines, one front door;
the port of ``machine_learning_apache_spark_tpu/fleet``.

The serving engine (``serving/``) is a single process; the launcher
(``launcher/``) can spawn and supervise N of them; the observability
plane (``telemetry/http``) makes each one scrapeable. This package is
the layer that turns those N replicas into one service:

- :mod:`~.scrape` — the scrape data plane: per-replica ``/healthz`` +
  ``/statusz`` snapshots with retry/backoff, and a background :class:`~.scrape.ScrapeLoop`
  that follows replicas across restarts via their sidecar files;
- :mod:`~.affinity` — prefix-cache affinity: ``prefix_digest`` →
  candidate replicas, fed by routing memory and scraped residency;
- :mod:`~.admission` — SLO tiers (interactive vs batch deadlines) and
  per-tenant quotas on the ``Backpressure``/retry-after contract;
- :mod:`~.router` — health-aware dispatch (affinity-first, least-loaded
  fallback, round-robin baseline) that drains around 503s and keeps a
  conservation ledger over every routed request;
- :mod:`~.replica` — the per-rank data plane: ``POST /v1/generate``
  over one engine plus the delegated observability GET endpoints, and
  ``serve_replica`` as the launcher-gang worker body;
- :mod:`~.autoscaler` — the closed loop over all of the above:
  :class:`~.autoscaler.FleetAutoscaler` watches scrape snapshots and
  resizes the ``ReplicaGang`` (SLO burn / queue depth up, coldest-
  replica drain down, exhausted ranks absorbed as observed
  scale-downs), logging every decision as a ``fleet.autoscaler``
  annotation.

Replica gangs with *per-rank* restart (vs the Distributor's
all-or-nothing barrier semantics) live in
``launcher.replica_gang.ReplicaGang``. Env contract: ``MLSPARK_FLEET_*``
and ``MLSPARK_AUTOSCALE_*`` (``utils/env.py``). Each replica is one
process with one paged engine on the card (``MLSPARK_PLATFORM=cpu`` keeps
it on the host); the router, scrape plane and autoscaler are host code.
"""

from machine_learning_apache_spark_tpu_torch.fleet.admission import (
    FleetAdmission,
    FleetBackpressure,
    Lease,
    SLOTier,
    default_tiers,
)
from machine_learning_apache_spark_tpu_torch.fleet.affinity import (
    AffinityTable,
    prefix_digest,
)
from machine_learning_apache_spark_tpu_torch.fleet.autoscaler import (
    AutoscaleConfig,
    FleetAutoscaler,
)
from machine_learning_apache_spark_tpu_torch.fleet.replica import (
    ReplicaServer,
    serve_replica,
    write_fleet_sidecar,
)
from machine_learning_apache_spark_tpu_torch.fleet.router import (
    POLICIES,
    FleetRequestFailed,
    FleetRouter,
    FleetUnavailable,
    ReplicaClient,
    pick_replica,
)
from machine_learning_apache_spark_tpu_torch.fleet.scrape import (
    ReplicaSnapshot,
    ScrapeLoop,
    find_fleet_sidecars,
    scrape,
    snapshot_replica,
)

__all__ = [
    "AffinityTable",
    "AutoscaleConfig",
    "FleetAdmission",
    "FleetAutoscaler",
    "FleetBackpressure",
    "FleetRequestFailed",
    "FleetRouter",
    "FleetUnavailable",
    "Lease",
    "POLICIES",
    "ReplicaClient",
    "ReplicaServer",
    "ReplicaSnapshot",
    "SLOTier",
    "ScrapeLoop",
    "default_tiers",
    "find_fleet_sidecars",
    "pick_replica",
    "prefix_digest",
    "scrape",
    "serve_replica",
    "snapshot_replica",
    "write_fleet_sidecar",
]
