"""Scrape data plane — the fleet's live view of every replica; the port
of ``machine_learning_apache_spark_tpu/fleet/scrape.py``, with the same
sidecar names and payloads, so either package's tools read either
package's fleet.

One scrape over each rank's ``/healthz`` + ``/statusz``, as a reusable
data plane in two layers:

- :func:`scrape` / :func:`snapshot_replica` — one endpoint / one replica,
  with **retry + backoff** baked in. The sidecar-discovery race lives
  here: a replica writes its ``fleet_rank<k>.json`` (or
  ``http_rank<k>.json``) sidecar in the same instant its server binds,
  so a scraper that reads the sidecar a moment early gets connection-
  refused once — that must read as "try again shortly", never as a
  cached "unreachable".
- :class:`ScrapeLoop` — a daemon thread that re-discovers sidecars and
  re-snapshots every replica on an interval, maintaining the
  ``{rank: ReplicaSnapshot}`` map the router's dispatch decisions read.
  Discovery is re-run every tick on purpose: a restarted replica comes
  back on a *new* ephemeral port and overwrites its sidecar, and the
  loop must follow it there without being told.

Everything here is stdlib-only — a router process never needs torch
imported.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

SIDECAR_RE = re.compile(r"(?:fleet|http)_rank(\d+)\.json$")


def scrape(
    port: int,
    path: str,
    timeout: float = 2.0,
    *,
    retries: int = 0,
    backoff: float = 0.1,
) -> dict | None:
    """GET one endpoint off a replica's local plane; None on failure (a
    dead replica must not kill the whole table). A 503 body is still a
    payload — that's ``/healthz`` saying "degraded", which the caller
    wants verbatim. ``retries`` re-attempts connection-level failures
    with exponential backoff (the sidecar-before-bind race shows up as
    exactly one connection-refused); HTTP-level errors don't retry —
    the server answered, so there is nothing to wait out."""
    url = f"http://127.0.0.1:{port}{path}"
    delay = backoff
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode("utf-8"))
            except Exception:
                return None
        except Exception:
            if attempt == retries:
                return None
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
    return None


def find_fleet_sidecars(directory: str) -> dict[int, dict]:
    """``{rank: payload}`` for every ``fleet_rank<k>.json`` /
    ``http_rank<k>.json`` in a directory, fleet sidecars winning when a
    rank has both (the data-plane port serves the observability
    endpoints too, and it's the one the router must judge healthy)."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(directory, "*_rank*.json"))):
        m = SIDECAR_RE.search(os.path.basename(path))
        if not m:
            continue
        rank = int(m.group(1))
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue  # torn write — next tick gets it
        if not (isinstance(payload, dict) and "port" in payload):
            continue
        is_fleet = os.path.basename(path).startswith("fleet_")
        if is_fleet or rank not in out:
            payload = dict(payload)
            payload["kind"] = "fleet" if is_fleet else "http"
            out[rank] = payload
    return dict(sorted(out.items()))


@dataclass
class ReplicaSnapshot:
    """One replica's scraped state — everything dispatch needs, nothing
    it has to re-parse. ``healthy`` means "accepts new requests":
    /healthz answered 200. A degraded (503) or unreachable replica keeps
    its last-known load fields so operators can still see it, but the
    router sends it nothing."""

    rank: int
    port: int
    healthy: bool = False
    status: str = "unreachable"  # ok | degraded | draining | unreachable
    queue_depth: int | None = None
    in_flight: int | None = None
    active_rows: int | None = None
    tokens_per_sec: float | None = None
    tokens_out: int | None = None
    completed: int | None = None
    occupancy: float | None = None
    # Per-tier SLO burn snapshots from the replica's serving metrics
    # ({tier: {"ewma": ..., "window_rate": ..., ...}}) — the raw material
    # for :func:`fleet_slo_rollup`.
    slo: dict = field(default_factory=dict)
    prefix_digests: frozenset = frozenset()
    prefix_stats: dict = field(default_factory=dict)
    scraped_at: float = 0.0
    consecutive_failures: int = 0

    @property
    def draining(self) -> bool:
        """Deliberately refusing new work while it retires its in-flight
        (the autoscaler's scale-down protocol). Unhealthy for dispatch —
        the router must not send it anything — but *not* a failure
        signal: a draining replica answered its scrape, so it never
        burns the unreachable grace, and membership accounting counts it
        as a live, leaving rank rather than a dead one."""
        return self.status == "draining"

    @property
    def load(self) -> float:
        """Least-loaded score: requests this replica already owes work
        for. in_flight (queued + decoding) when the serving section
        answered; a replica that exposes no serving section scores by
        queue_depth alone; unknown sorts last."""
        if self.in_flight is not None:
            return float(self.in_flight)
        if self.queue_depth is not None:
            return float(self.queue_depth)
        return float("inf")


def snapshot_replica(
    rank: int,
    port: int,
    *,
    timeout: float = 2.0,
    retries: int = 2,
) -> ReplicaSnapshot:
    """Scrape one replica's ``/healthz`` + ``/statusz`` into a snapshot."""
    snap = ReplicaSnapshot(rank=rank, port=port, scraped_at=time.monotonic())
    health = scrape(port, "/healthz", timeout=timeout, retries=retries)
    if health is None:
        return snap
    snap.status = health.get("status") or "unreachable"
    snap.healthy = snap.status == "ok"
    status = scrape(port, "/statusz", timeout=timeout)
    sections = (status or {}).get("sections") or {}
    serving = sections.get("serving")
    if isinstance(serving, dict) and "error" not in serving:
        snap.queue_depth = serving.get("queue_depth")
        ledger = serving.get("ledger") or {}
        snap.in_flight = ledger.get("in_flight")
        snap.completed = ledger.get("completed")
        metrics = serving.get("metrics") or {}
        snap.tokens_per_sec = metrics.get("tokens_per_sec")
        snap.tokens_out = metrics.get("tokens_out")
        slo = metrics.get("slo")
        if isinstance(slo, dict):
            snap.slo = slo
        pool = serving.get("page_pool") or {}
        snap.occupancy = pool.get("mem_occupancy") or pool.get("occupancy")
        snap.active_rows = pool.get("active_rows")
    prefix = sections.get("prefix_cache")
    if isinstance(prefix, dict) and "error" not in prefix:
        snap.prefix_stats = {
            k: prefix.get(k)
            for k in ("entries", "hits", "misses", "evictions", "hit_rate")
        }
        snap.prefix_digests = frozenset(
            prefix.get("resident_digests") or ()
        )
    return snap


def fleet_slo_rollup(
    snapshots: dict[int, ReplicaSnapshot],
) -> dict[str, dict]:
    """Fold per-replica SLO burn snapshots into one fleet-wide view per
    tier. Rates are **count-weighted** (a replica that served 10× the
    requests moves the fleet rate 10× as much — an unweighted mean would
    let an idle replica's clean 0.0 mask a busy replica's burn); the
    EWMA column takes the fleet max, because burn alerts care about the
    worst replica, not the average one."""
    out: dict[str, dict] = {}
    for snap in snapshots.values():
        for tier, s in (snap.slo or {}).items():
            if not isinstance(s, dict):
                continue
            agg = out.setdefault(tier, {
                "window_count": 0, "window_missed": 0,
                "total": 0, "missed": 0, "max_ewma": 0.0,
                "replicas": 0,
            })
            agg["window_count"] += int(s.get("window_count") or 0)
            agg["window_missed"] += int(s.get("window_missed") or 0)
            agg["total"] += int(s.get("total") or 0)
            agg["missed"] += int(s.get("missed") or 0)
            agg["max_ewma"] = max(
                agg["max_ewma"], float(s.get("ewma") or 0.0)
            )
            agg["replicas"] += 1
    for agg in out.values():
        n = agg["window_count"]
        agg["window_rate"] = (
            round(agg["window_missed"] / n, 6) if n else 0.0
        )
        agg["max_ewma"] = round(agg["max_ewma"], 6)
    return dict(sorted(out.items()))


class ScrapeLoop:
    """Background scrape plane over a sidecar directory.

    Re-discovers ``fleet_rank<k>.json`` sidecars and snapshots every
    replica each ``interval``; :meth:`snapshots` hands the router a
    consistent copy. A replica that fails to answer keeps its previous
    load fields (stale beats blank) but flips unhealthy after
    ``unreachable_after`` consecutive failures — one lost scrape on a
    busy host must not drain a healthy replica.
    """

    def __init__(
        self,
        directory: str,
        *,
        interval: float = 0.5,
        timeout: float = 2.0,
        unreachable_after: int = 2,
        on_snapshot=None,
    ):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.directory = directory
        self.interval = interval
        self.timeout = timeout
        self.unreachable_after = max(1, int(unreachable_after))
        self.on_snapshot = on_snapshot
        # Extra observers (autoscaler, tests) ride the same tick as the
        # router's on_snapshot callback; each is isolated — one raising
        # observer must not starve the others or kill the plane.
        self._observers: list = []
        self._lock = threading.Lock()
        self._snapshots: dict[int, ReplicaSnapshot] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ScrapeLoop":
        if self._thread is not None:
            raise RuntimeError("scrape loop already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-scrape", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def __enter__(self) -> "ScrapeLoop":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the loop ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.interval)

    def tick(self) -> dict[int, ReplicaSnapshot]:
        """One full discovery + scrape pass (also callable inline — the
        tests and the router's synchronous warm-up use it directly)."""
        sidecars = find_fleet_sidecars(self.directory)
        fresh: dict[int, ReplicaSnapshot] = {}
        for rank, side in sidecars.items():
            snap = snapshot_replica(
                rank, int(side["port"]), timeout=self.timeout, retries=1
            )
            with self._lock:
                prev = self._snapshots.get(rank)
            if snap.status == "unreachable" and prev is not None:
                snap.consecutive_failures = prev.consecutive_failures + 1
                if snap.consecutive_failures < self.unreachable_after:
                    # Grace window: keep last-known state (still
                    # unhealthy for *new* dispatch only once the window
                    # closes — see healthy flip below).
                    snap.status = prev.status
                    snap.healthy = prev.healthy
                snap.queue_depth = prev.queue_depth
                snap.in_flight = prev.in_flight
                snap.tokens_per_sec = prev.tokens_per_sec
                snap.tokens_out = prev.tokens_out
                snap.completed = prev.completed
                snap.occupancy = prev.occupancy
                snap.slo = prev.slo
                snap.prefix_digests = prev.prefix_digests
                snap.prefix_stats = prev.prefix_stats
            fresh[rank] = snap
        with self._lock:
            self._snapshots = fresh
            self.ticks += 1
            observers = list(self._observers)
        for obs in ([self.on_snapshot] if self.on_snapshot else []) + observers:
            try:
                obs(dict(fresh))
            except Exception:
                pass  # observer must never kill the plane
        return fresh

    def add_observer(self, fn) -> None:
        """Register an extra per-tick observer (called with a copy of the
        fresh snapshot map, after ``on_snapshot``)."""
        with self._lock:
            self._observers.append(fn)

    # -- consumers -----------------------------------------------------------
    def snapshots(self) -> dict[int, ReplicaSnapshot]:
        with self._lock:
            return dict(self._snapshots)

    def wait_for_replicas(self, n: int, timeout: float = 60.0) -> bool:
        """Block until ``n`` replicas scrape healthy (fleet start-up
        barrier). Ticks inline so callers don't race the interval."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            healthy = [
                s for s in self.tick().values() if s.healthy
            ]
            if len(healthy) >= n:
                return True
            time.sleep(min(self.interval, 0.2))
        return False

    def rows(self) -> list[dict]:
        """Status rows in the gang-status table shape —
        feeds ``telemetry.aggregate.render_status_markdown`` and the
        bench's per-replica skew report."""
        out = []
        for rank, s in sorted(self.snapshots().items()):
            out.append({
                "rank": rank,
                "port": s.port,
                "status": s.status,
                "queue_depth": s.queue_depth,
                "in_flight": s.in_flight,
                "tokens_per_sec": s.tokens_per_sec,
                "occupancy": s.occupancy,
                "prefix_entries": s.prefix_stats.get("entries"),
                "prefix_hit_rate": s.prefix_stats.get("hit_rate"),
                "slo": {
                    tier: (v or {}).get("ewma")
                    for tier, v in sorted((s.slo or {}).items())
                },
            })
        return out
