"""Fleet router — health-aware, affinity-first dispatch over N replicas
(the port of ``machine_learning_apache_spark_tpu/fleet/router.py``).

The decision core, :func:`pick_replica`, is a pure function over
``{rank: ReplicaSnapshot}`` so every policy is unit-testable on
synthetic snapshots, no sockets involved:

- ``round_robin`` — cycle the healthy set (the baseline the affinity
  gate of the fleet bench measures against);
- ``least_loaded`` — min in-flight over healthy replicas;
- ``affinity`` (default) — prefer healthy replicas the
  :class:`~machine_learning_apache_spark_tpu_torch.fleet.affinity.AffinityTable`
  says already hold the prompt's prefix (least-loaded among them),
  falling back to least-loaded overall.

**Load, unlike the JAX router's.** The load :class:`FleetRouter` hands
``pick_replica`` is, per replica, the larger of its scraped load and the
dispatches this router sent it that have not been answered yet; the pick
and its dispatch are counted under one lock hold. A scraped load is
stale within a scrape, so the JAX router, which reads the scraped load
alone, sends a burst between two scrapes to one replica (ties go to the
lowest rank), and a replica the autoscaler adds may get no request at
all. Counting the router's own dispatches is exact and spreads the
burst.

:class:`FleetRouter` wraps the decision in the full dispatch loop:
admission (SLO tiers + tenant quotas) → pick → POST → and *drain-around*
on refusals. The retry taxonomy is the whole fault story:

- **connection refused / 503** — the request never entered that
  replica's queue; safe to retry on the next-best replica, and the
  refusing rank goes into a penalty box until a scrape sees ``/healthz``
  recover.
- **429** — the replica queue pushed back; try the others, and if every
  replica pushes back, surface one ``FleetBackpressure`` with the max
  retry-after (the fleet really is full).
- **connection lost mid-request / 5xx** — the request may have been
  decoding; it is *not* silently retried (that is the "only the killed
  replica's in-flight is lost" conservation story) and counts failed.
- **504** — the deadline expired inside the replica; terminal as
  ``expired`` (the engine already booked the same outcome).

**Straggler hedging** (Dean & Barroso, "The Tail at Scale"; off by
default, ``MLSPARK_FLEET_HEDGE``): when a dispatch on an eligible tier
is still outstanding after the hedge delay (a multiple of the admission
layer's service-time EWMA), the router issues ONE duplicate to a second
healthy replica — never the same rank. First response wins; the loser
is reaped through ``POST /v1/cancel``, keyed by the router-minted trace
id both attempts shared. A hedge is only ever issued while the primary
is still *in flight* — a terminal lost/5xx never spawns a new attempt
(lost-is-lost holds), though an already-in-flight hedge may still save
the request. ``hedged`` and ``cancelled`` are attempt-level side
counters, deliberately outside the conservation law: a hedged request
still lands in exactly one terminal bucket.

Every terminal outcome lands in the router ledger, which obeys the same
conservation law as the engine's: submitted == completed + rejected +
unavailable + failed + expired. ``check_conservation`` raises otherwise.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import queue as _pyqueue
import threading
import time
import urllib.error
import urllib.request

from machine_learning_apache_spark_tpu_torch.fleet.admission import (
    FleetAdmission,
    FleetBackpressure,
)
from machine_learning_apache_spark_tpu_torch.fleet.affinity import AffinityTable
from machine_learning_apache_spark_tpu_torch.fleet.scrape import (
    ReplicaSnapshot,
    ScrapeLoop,
    fleet_slo_rollup,
)
from machine_learning_apache_spark_tpu_torch.serving.metrics import BurnRate
from machine_learning_apache_spark_tpu_torch.serving.queue import DeadlineExceeded
from machine_learning_apache_spark_tpu_torch.telemetry import events as _events
from machine_learning_apache_spark_tpu_torch.telemetry import (
    registry as _registry,
)
from machine_learning_apache_spark_tpu_torch.telemetry import spans as _spans
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as _tracectx,
)
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

POLICIES = ("affinity", "least_loaded", "round_robin")

#: Affinity is load-bounded: a warm (prefix-resident) replica is
#: preferred only while its scraped load is within this many requests of
#: the least-loaded healthy replica. Unbounded affinity pins traffic:
#: after a failover every digest's routing memory points at the
#: survivor, and a restarted replica would never see a request again —
#: cache residency must lose to a big enough load gap.
AFFINITY_LOAD_SLACK = 2.0


class FleetUnavailable(RuntimeError):
    """No healthy replica could take the request."""


class FleetRequestFailed(RuntimeError):
    """The request was dispatched and lost (replica died mid-decode) or
    the decode itself failed — not retried, by design."""

    def __init__(self, msg: str, *, rank: int | None = None,
                 status: int | None = None):
        super().__init__(msg)
        self.rank = rank
        self.status = status


def pick_replica(
    snapshots: dict[int, ReplicaSnapshot],
    *,
    policy: str = "affinity",
    candidates: set[int] | None = None,
    exclude: set[int] | None = None,
    rr_state: itertools.count | None = None,
) -> int | None:
    """The dispatch decision, pure over snapshots. ``candidates`` is the
    affinity table's claim for this prompt; ``exclude`` is ranks already
    tried this request. Unhealthy replicas are never picked — that *is*
    the 503-draining property. Returns a rank or None."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (pick from {POLICIES})")
    exclude = exclude or set()
    healthy = sorted(
        r for r, s in snapshots.items() if s.healthy and r not in exclude
    )
    if not healthy:
        return None
    if policy == "round_robin":
        i = next(rr_state) if rr_state is not None else 0
        return healthy[i % len(healthy)]
    coldest = min(healthy, key=lambda r: (snapshots[r].load, r))
    if policy == "affinity" and candidates:
        warm = [r for r in healthy if r in candidates]
        if warm:
            best = min(warm, key=lambda r: (snapshots[r].load, r))
            if snapshots[best].load <= (
                snapshots[coldest].load + AFFINITY_LOAD_SLACK
            ):
                return best
    return coldest


class ReplicaClient:
    """Blocking HTTP client for one dispatch attempt. Separates
    connection-establishment failures (safe to retry elsewhere) from
    mid-request losses (not safe — the work may be half done)."""

    @staticmethod
    def generate(
        port: int,
        text: str,
        *,
        deadline_s: float | None,
        tier: str,
        tenant: str | None,
        timeout: float,
        traceparent: str | None = None,
    ) -> tuple[str, int | None, dict]:
        """Returns ``(kind, http_status, payload)`` with kind in
        {"ok", "refused", "backpressure", "failed", "lost", "expired"}.
        ``traceparent`` (when tracing is on and the request was sampled)
        rides as the W3C header so the replica joins the trace."""
        body = json.dumps({
            "text": text,
            "deadline_s": deadline_s,
            "tier": tier,
            "tenant": tenant,
        }).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if traceparent is not None:
            headers["traceparent"] = traceparent
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=body,
            headers=headers,
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return "ok", resp.status, json.loads(
                    resp.read().decode("utf-8")
                )
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode("utf-8"))
            except Exception:
                payload = {}
            if e.code == 429:
                return "backpressure", 429, payload
            if e.code == 503:
                return "refused", 503, payload
            if e.code == 504:
                # The deadline expired inside the replica — the engine
                # booked ``expired``; mirror the taxonomy, still terminal.
                return "expired", 504, payload
            # 400/500: the replica answered — the request itself is
            # terminal there; retrying would double-spend decode work.
            return "failed", e.code, payload
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None), ConnectionRefusedError):
                # Never reached a socket: replica dead or restarting.
                return "refused", None, {"error": repr(e)}
            return "lost", None, {"error": repr(e)}
        except Exception as e:  # noqa: BLE001 — socket reset mid-read etc.
            return "lost", None, {"error": repr(e)}

    @staticmethod
    def cancel(port: int, trace_id: str, *, timeout: float = 5.0) -> bool:
        """Best-effort loser reap after a hedge race: ``POST /v1/cancel``
        keyed by the router-minted trace id. False on any failure — a
        cancel that misses only wastes the loser's remaining decode."""
        body = json.dumps({"trace_id": trace_id}).encode("utf-8")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/cancel",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
            return bool(payload.get("cancelled"))
        except Exception:  # noqa: BLE001 — best-effort by contract
            return False


class FleetRouter:
    """N replicas, one front door.

    ``key_fn(text) -> digest`` supplies the prefix-affinity key (wire it
    to ``serving.prefix_digest`` over the same tokenizer the replicas
    run — see ``tools/torch_fleet_bench.make_key_fn``); None disables
    affinity for that
    request. ``snapshot_source`` defaults to a background
    :class:`ScrapeLoop` over ``directory`` but tests inject a plain
    callable returning synthetic snapshots."""

    def __init__(
        self,
        directory: str | None = None,
        *,
        policy: str | None = None,
        key_fn=None,
        admission: FleetAdmission | None = None,
        affinity: AffinityTable | None = None,
        snapshot_source=None,
        scrape_interval: float | None = None,
        request_timeout_s: float = 120.0,
        clock=time.monotonic,
        hedge: bool | None = None,
        hedge_tiers=None,
        hedge_delay_factor: float | None = None,
        hedge_min_delay_s: float | None = None,
    ):
        from machine_learning_apache_spark_tpu_torch.utils import env as envcfg

        if policy is None:
            policy = envcfg.get_str("MLSPARK_FLEET_POLICY")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} (pick from {POLICIES}; check "
                "MLSPARK_FLEET_POLICY)"
            )
        if snapshot_source is None and directory is None:
            raise ValueError(
                "pass a sidecar directory (scrape-loop mode) or an "
                "explicit snapshot_source"
            )
        if scrape_interval is None:
            scrape_interval = envcfg.get_float(
                "MLSPARK_FLEET_SCRAPE_INTERVAL"
            )
        self.policy = policy
        self.key_fn = key_fn
        self.clock = clock
        self.request_timeout_s = request_timeout_s
        # Straggler hedging (arg > env > default; off by default so the
        # plain dispatch path is byte-for-byte what it always was).
        if hedge is None:
            hedge = envcfg.get_bool("MLSPARK_FLEET_HEDGE")
        if hedge_tiers is None:
            hedge_tiers = envcfg.get_str("MLSPARK_FLEET_HEDGE_TIERS")
        if isinstance(hedge_tiers, str):
            hedge_tiers = tuple(
                t.strip() for t in hedge_tiers.split(",") if t.strip()
            )
        if hedge_delay_factor is None:
            hedge_delay_factor = envcfg.get_float(
                "MLSPARK_FLEET_HEDGE_DELAY_FACTOR"
            )
        if hedge_min_delay_s is None:
            hedge_min_delay_s = envcfg.get_float(
                "MLSPARK_FLEET_HEDGE_MIN_DELAY_S"
            )
        self.hedge = bool(hedge)
        self.hedge_tiers = tuple(hedge_tiers)
        self.hedge_delay_factor = float(hedge_delay_factor)
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self.admission = admission or FleetAdmission()
        self.affinity = affinity or AffinityTable()
        self._scrape: ScrapeLoop | None = None
        if snapshot_source is None:
            self._scrape = ScrapeLoop(
                directory,
                interval=scrape_interval,
                on_snapshot=self._on_scrape,
            )
            snapshot_source = self._scrape.snapshots
        self._snapshot_source = snapshot_source
        self._rr = itertools.count()
        self._lock = threading.Lock()
        # Dispatches sent to each rank and not answered yet: what a rank
        # owes this router between two scrapes, counted into its load.
        self._dispatched: dict[int, int] = {}  # guarded-by: self._lock
        # Penalty box: rank -> monotonic time of last refusal. A boxed
        # rank is skipped until a scrape reports it healthy again (the
        # scrape loop is the source of recovery truth).
        self._down: dict[int, float] = {}
        # Ranks present in the last scrape — the diff against each fresh
        # tick identifies vanished ranks whose routing state must purge.
        self._seen_ranks: set[int] = set()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0      # fleet admission / all-replica backpressure
        self.unavailable = 0   # no healthy replica reachable
        self.failed = 0        # dispatched and lost / decode failure
        self.expired = 0       # deadline burned down (locally or 504)
        self.retries = 0
        # Attempt-level hedging counters, outside the conservation law:
        # a hedged request still retires in exactly one terminal bucket.
        self.hedged = 0        # duplicate dispatches issued
        self.cancelled = 0     # loser reaps sent via /v1/cancel
        self._per_replica: dict[int, dict] = {}
        # Per-tier SLO burn gauges over *routed* outcomes: a request
        # "missed" unless it completed within its deadline — rejected,
        # unavailable, and failed dispatches all burn budget, because the
        # client's SLO does not care which layer dropped the ball.
        self._burn: dict[str, BurnRate] = {}
        self._reg = _registry.get_registry()
        self._counters = {
            name: self._reg.counter("fleet", name)
            for name in ("submitted", "completed", "rejected",
                         "unavailable", "failed", "expired", "retries",
                         "hedged", "cancelled")
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._scrape is not None:
            self._scrape.start()
        return self

    def stop(self) -> None:
        if self._scrape is not None:
            self._scrape.stop()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_for_replicas(self, n: int, timeout: float = 120.0) -> bool:
        if self._scrape is None:
            return len([
                s for s in self._snapshot_source().values() if s.healthy
            ]) >= n
        return self._scrape.wait_for_replicas(n, timeout=timeout)

    # -- scrape feedback -----------------------------------------------------
    def _on_scrape(self, snapshots: dict[int, ReplicaSnapshot]) -> None:
        """Scrape tick: refresh affinity residency, let recovered
        replicas out of the penalty box, and purge *all* routing state
        for ranks that vanished from discovery — a retired rank's stale
        penalty-box or affinity entry must not shadow a future rank
        reusing the slot."""
        with self._lock:
            for rank, snap in snapshots.items():
                if snap.healthy:
                    self._down.pop(rank, None)
            gone = [r for r in self._down if r not in snapshots]
            for r in gone:
                self._down.pop(r, None)
            vanished = [
                r for r in self._seen_ranks if r not in snapshots
            ]
            self._seen_ranks = set(snapshots)
        for r in vanished:
            self.affinity.forget_rank(r)
        for rank, snap in snapshots.items():
            if snap.healthy:
                self.affinity.observe_scrape(rank, snap.prefix_digests)
            else:
                self.affinity.forget_rank(rank)

    def _pick(
        self, digest, exclude: set[int],
    ) -> tuple[dict[int, ReplicaSnapshot], int | None]:
        """``pick_replica`` over the usable snapshots (the penalty box
        left out), each replica's load raised to this router's dispatches
        to it not answered yet; the picked rank's count goes up in the
        same lock hold, so simultaneous submits see each other's picks.
        Every pick that returns a rank is paired with one ``_attempt``,
        which takes the count back down. Returns the snapshots the pick
        read and the rank (None: nothing usable)."""
        snaps = self._snapshot_source()
        candidates = self.affinity.candidates(digest)
        with self._lock:
            usable = {
                r: self._with_dispatched(s)
                for r, s in snaps.items() if r not in self._down
            }
            rank = pick_replica(
                usable,
                policy=self.policy,
                candidates=candidates,
                exclude=exclude,
                rr_state=self._rr,
            )
            if rank is not None:
                self._dispatched[rank] = self._dispatched.get(rank, 0) + 1
        return usable, rank

    def _with_dispatched(self, snap: ReplicaSnapshot) -> ReplicaSnapshot:
        # mlspark-lint: holds self._lock -- called in _pick's lock hold
        owed = self._dispatched.get(snap.rank, 0)
        if owed > snap.load:
            return dataclasses.replace(snap, in_flight=owed)
        return snap

    def _box(self, rank: int) -> None:
        with self._lock:
            self._down[rank] = self.clock()

    # -- the dispatch loop ---------------------------------------------------
    def submit(
        self,
        text: str,
        *,
        tier: str = "interactive",
        tenant: str | None = None,
        deadline_s: float | None = None,
    ) -> dict:
        """Route one request to completion. Returns the replica's 200
        payload. Raises :class:`FleetBackpressure` (whole fleet at
        capacity / quota exhausted), :class:`FleetUnavailable` (no
        healthy replica), :class:`FleetRequestFailed` (dispatched and
        lost or decode-failed — the non-retried taxonomy), or
        :class:`~machine_learning_apache_spark_tpu_torch.serving.queue.
        DeadlineExceeded` (budget burned down before dispatch, or the
        replica 504'd — outcome ``expired`` either way).

        Distributed tracing: the router is where a request's trace is
        **minted** (head-sampled once, here). The whole dispatch lives
        under a ``fleet.submit`` span; each dispatch attempt gets a
        ``fleet.attempt`` child span and a fresh child span id sent as
        the ``traceparent`` header — so a 503-drained attempt and its
        successful retry land as siblings under one trace, each joined
        to its replica-side spans by a distinct cross-process edge."""
        t0 = self.clock()
        self._bump("submitted")
        try:
            lease = self.admission.admit(tier=tier, tenant=tenant)
        except FleetBackpressure:
            self._bump("rejected")
            raise
        ctx = _tracectx.mint()
        digest = None
        retries = 0
        outcome, out_rank, status = "failed", None, None
        deadline = deadline_s if deadline_s is not None else lease.deadline_s
        with _tracectx.use(ctx), _spans.span("fleet.submit", tier=tier):
            try:
                if self.key_fn is not None:
                    try:
                        digest = self.key_fn(text)
                    except Exception:
                        digest = None
                tried: set[int] = set()
                backpressure: FleetBackpressure | None = None
                while True:
                    # Pre-dispatch deadline check: a request that burned
                    # its whole budget cycling the retry/penalty-box loop
                    # fails HERE as expired — dispatching with a negative
                    # remaining budget would only make a replica decode
                    # tokens nobody is still waiting for.
                    remaining = deadline - (self.clock() - t0)
                    if remaining <= 0:
                        outcome = "expired"
                        self._bump("expired")
                        raise DeadlineExceeded(
                            f"deadline of {deadline:.3f}s elapsed before "
                            f"dispatch (retries={retries})"
                        )
                    snaps, rank = self._pick(digest, tried)
                    if rank is None:
                        if backpressure is not None:
                            outcome = "rejected"
                            self._bump("rejected")
                            raise backpressure
                        outcome = "unavailable"
                        self._bump("unavailable")
                        raise FleetUnavailable(
                            f"no healthy replica (tried {sorted(tried)})"
                        )
                    tried.add(rank)
                    snap = snaps[rank]
                    if self.hedge and tier in self.hedge_tiers:
                        rank, kind, status, payload = self._dispatch_hedged(
                            rank, snap, text, remaining=remaining,
                            tier=tier, tenant=tenant, ctx=ctx,
                            digest=digest, tried=tried,
                        )
                    else:
                        rank, kind, status, payload = self._attempt(
                            rank, snap.port, text, budget=remaining,
                            tier=tier, tenant=tenant, ctx=ctx,
                        )
                    if kind == "ok":
                        self.affinity.note_routed(digest, rank)
                        self._note(rank, "completed")
                        outcome, out_rank = "completed", rank
                        self._bump("completed")
                        return payload
                    if kind == "refused":
                        # 503 / connection refused: never entered the
                        # queue. Box the rank (scrape recovery lets it
                        # back) and drain to the next-best replica.
                        self._box(rank)
                        self.affinity.forget_rank(rank)
                        self._note(rank, "refused")
                        retries += 1
                        self._bump("retries")
                        continue
                    if kind == "backpressure":
                        self._note(rank, "backpressure")
                        ra = (payload or {}).get("retry_after") or 0.05
                        if backpressure is None or ra > backpressure.retry_after:
                            backpressure = FleetBackpressure(
                                (payload or {}).get("depth", 0), ra,
                                scope=f"replica:{rank}",
                            )
                        retries += 1
                        self._bump("retries")
                        continue
                    if kind == "expired":
                        # The replica's engine reaped the request at its
                        # deadline (504): terminal, same outcome bucket
                        # as the local pre-dispatch expiry.
                        self._note(rank, "expired")
                        outcome, out_rank = "expired", rank
                        self._bump("expired")
                        raise DeadlineExceeded(
                            f"request expired on replica {rank}: "
                            f"{(payload or {}).get('error')}"
                        )
                    # "lost" or "failed": terminal, not retried.
                    self._note(rank, "lost" if kind == "lost" else "failed")
                    outcome, out_rank = kind, rank
                    self._bump("failed")
                    if kind == "lost":
                        # The socket died under a dispatched request —
                        # treat the rank as down for new traffic too.
                        self._box(rank)
                    raise FleetRequestFailed(
                        f"request {kind} on replica {rank} "
                        f"(status={status}): {(payload or {}).get('error')}",
                        rank=rank, status=status,
                    )
            finally:
                total = self.clock() - t0
                self.admission.release(lease, service_s=total)
                self._observe_slo(
                    tier, outcome != "completed" or total > deadline
                )
                _events.annotate(
                    "fleet.request",
                    outcome=outcome, replica=out_rank, tier=tier,
                    tenant=tenant, retries=retries, total_s=round(total, 6),
                    status=status,
                )

    # -- dispatch attempts ---------------------------------------------------
    def _attempt(
        self, rank: int, port: int, text: str, *, budget: float,
        tier: str, tenant: str | None, ctx,
    ) -> tuple[int, str, int | None, dict]:
        """One wire dispatch under its own ``fleet.attempt`` span.
        ``budget`` is the request's *remaining* deadline — what the
        replica gets as ``deadline_s``, so a late retry or a hedge is
        granted only the time actually left. Runs on the submit thread
        (plain path) or a hedge worker thread (the ``use(ctx)`` wrap is
        what keeps the worker's events on the request's trace). Takes
        back the dispatch count ``_pick`` added for ``rank``."""
        try:
            self._note(rank, "dispatched")
            # One child span id per attempt: the replica records it as
            # remote_parent, which is how the merged view attaches each
            # replica's spans to the right attempt.
            attempt = _tracectx.child(ctx)
            attempt_attrs = {"replica": rank}
            if attempt is not None:
                attempt_attrs["ctx_span"] = attempt.span_id
            with _tracectx.use(ctx), _spans.span("fleet.attempt",
                                                 **attempt_attrs):
                kind, status, payload = ReplicaClient.generate(
                    port, text,
                    deadline_s=budget, tier=tier, tenant=tenant,
                    timeout=min(self.request_timeout_s, budget + 30.0),
                    traceparent=(
                        None if attempt is None
                        else _tracectx.to_traceparent(attempt)
                    ),
                )
            return rank, kind, status, payload
        finally:
            with self._lock:
                self._dispatched[rank] -= 1

    def _dispatch_hedged(
        self, rank: int, snap, text: str, *, remaining: float,
        tier: str, tenant: str | None, ctx, digest, tried: set[int],
    ) -> tuple[int, str, int | None, dict]:
        """One dispatch round with straggler hedging: launch the primary,
        and if it is still outstanding after the hedge delay, launch ONE
        duplicate on a different healthy rank. First ``ok`` wins and the
        loser is reaped via ``/v1/cancel``; with no winner the two
        outcomes reduce to a single result for the caller's taxonomy
        (terminal > backpressure > refused — a terminal sibling must
        dominate, or the retry loop would replay half-done work)."""
        t_call = self.clock()
        results: _pyqueue.Queue = _pyqueue.Queue()
        outstanding: dict[int, int] = {}  # rank -> port

        def run(a_rank: int, a_port: int, budget: float) -> None:
            try:
                results.put(self._attempt(
                    a_rank, a_port, text, budget=budget,
                    tier=tier, tenant=tenant, ctx=ctx,
                ))
            except Exception as e:  # noqa: BLE001 — an attempt must report
                results.put((a_rank, "lost", None, {"error": repr(e)}))

        def spawn(a_rank: int, a_port: int, budget: float) -> None:
            outstanding[a_rank] = a_port
            threading.Thread(
                target=run, args=(a_rank, a_port, budget),
                name=f"fleet-hedge-{a_rank}", daemon=True,
            ).start()

        spawn(rank, snap.port, remaining)
        delay = max(
            self.hedge_min_delay_s,
            self.hedge_delay_factor * self.admission.service_ewma(),
        )
        try:
            res = results.get(timeout=min(delay, max(remaining, 0.01)))
            # Primary answered inside the hedge delay: no hedge, and the
            # result (of whatever kind) follows the plain taxonomy.
            outstanding.pop(res[0], None)
            return res
        except _pyqueue.Empty:
            pass
        # Primary still out past the delay: presume straggler, hedge
        # once. Never the same rank (exclude everything tried); a hedge
        # is issued only while the primary is in flight — a terminal
        # result never spawns one, so lost-is-lost survives.
        snaps, h_rank = self._pick(digest, set(tried) | set(outstanding))
        if h_rank is not None:
            tried.add(h_rank)
            self._bump("hedged")
            self._note(h_rank, "hedged")
            _events.annotate(
                "fleet.hedge", primary=rank, hedge=h_rank, tier=tier,
                delay_s=round(delay, 4),
            )
            spawn(
                h_rank, snaps[h_rank].port,
                max(remaining - (self.clock() - t_call), 0.01),
            )
        collected: list[tuple[int, str, int | None, dict]] = []
        while outstanding:
            wait_s = max(
                remaining - (self.clock() - t_call), 0.0
            ) + 35.0  # outlast every attempt's own socket timeout
            try:
                res = results.get(timeout=wait_s)
            except _pyqueue.Empty:
                # Unreachable in practice (attempts time out first);
                # declare the stragglers lost rather than hang forever.
                for d_rank in list(outstanding):
                    outstanding.pop(d_rank)
                    collected.append((
                        d_rank, "lost", None,
                        {"error": "hedge wait timed out"},
                    ))
                break
            outstanding.pop(res[0], None)
            if res[1] == "ok":
                # First response wins. Reap the still-running loser, and
                # book any already-arrived non-ok sibling so the
                # per-replica taxonomy stays truthful.
                for l_rank, l_port in outstanding.items():
                    self._cancel_loser(l_rank, l_port, ctx)
                for c in collected:
                    self._absorb_hedge_result(c)
                return res
            collected.append(res)
        severity = {
            "lost": 0, "failed": 0, "expired": 0,
            "backpressure": 1, "refused": 2,
        }
        collected.sort(key=lambda c: severity.get(c[1], 0))
        head, rest = collected[0], collected[1:]
        for c in rest:
            self._absorb_hedge_result(c)
        return head

    def _absorb_hedge_result(
        self, res: tuple[int, str, int | None, dict]
    ) -> None:
        """Book a hedge sibling's non-winning, non-returned outcome:
        per-replica taxonomy and penalty-box effects still apply, but it
        contributes no request-level terminal bucket — that is its
        sibling's job, and the conservation law demands exactly one."""
        r_rank, kind, _status, _payload = res
        if kind == "refused":
            self._box(r_rank)
            self.affinity.forget_rank(r_rank)
            self._note(r_rank, "refused")
        elif kind == "backpressure":
            self._note(r_rank, "backpressure")
        elif kind == "lost":
            self._box(r_rank)
            self._note(r_rank, "lost")
        elif kind in ("failed", "expired"):
            self._note(r_rank, kind)

    def _cancel_loser(self, rank: int, port: int, ctx) -> None:
        """The race is decided: reap the outstanding duplicate so it
        stops burning pages and launch slots. Fire-and-forget on a
        helper thread — the winner's response must not wait on the
        loser's socket. With tracing off there is no shared trace-id
        key, so the loser simply runs out its own clock (correctness is
        unaffected; only the dead-work savings are forfeited)."""
        if ctx is None:
            return
        self._note(rank, "cancelled")
        self._bump("cancelled")
        threading.Thread(
            target=ReplicaClient.cancel, args=(port, ctx.trace_id),
            name=f"fleet-cancel-{rank}", daemon=True,
        ).start()

    # -- accounting ----------------------------------------------------------
    def _observe_slo(self, tier: str, missed: bool) -> None:
        """Fold one request outcome into the router-side burn gauge for
        its tier. Router semantics are stricter than the replica's: a
        request burns budget unless it **completed within deadline** —
        rejections, unavailability, and failed dispatches all count,
        because the client experienced a miss either way."""
        tier = tier or "interactive"
        with self._lock:
            burn = self._burn.get(tier)
            if burn is None:
                burn = self._burn[tier] = BurnRate()
        burn.observe(missed)
        _registry.get_registry().gauge(
            "fleet", f"slo_burn_{tier}"
        ).set(burn.ewma)

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        self._counters[name].inc()

    def _note(self, rank: int, event: str) -> None:
        with self._lock:
            row = self._per_replica.setdefault(rank, {
                "dispatched": 0, "completed": 0, "refused": 0,
                "backpressure": 0, "failed": 0, "lost": 0,
                "expired": 0, "hedged": 0, "cancelled": 0,
            })
            row[event] = row.get(event, 0) + 1

    def ledger(self) -> dict:
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "unavailable": self.unavailable,
                "failed": self.failed,
                "expired": self.expired,
                # Attempt-level hedge taxonomy — informational, outside
                # the conservation sum (a hedged request still lands in
                # exactly one terminal bucket above).
                "hedged": self.hedged,
                "cancelled": self.cancelled,
            }
        out["in_flight"] = (
            out["submitted"] - out["completed"] - out["rejected"]
            - out["unavailable"] - out["failed"] - out["expired"]
        )
        return out

    def check_conservation(self, *, in_flight: int = 0) -> dict:
        """Router-side conservation law — every submitted request is
        accounted for in exactly one terminal counter."""
        ledger = self.ledger()
        if ledger["in_flight"] != in_flight:
            raise AssertionError(
                f"fleet conservation violated: expected in_flight="
                f"{in_flight}, ledger says {ledger}"
            )
        return ledger

    def stats(self) -> dict:
        with self._lock:
            per_replica = {r: dict(v) for r, v in self._per_replica.items()}
            down = sorted(self._down)
            slo = {tier: b.snapshot() for tier, b in sorted(self._burn.items())}
        return {
            "policy": self.policy,
            "ledger": self.ledger(),
            "retries": self.retries,
            "per_replica": per_replica,
            "down": down,
            # Router-observed burn (every routed outcome) next to the
            # scrape-side rollup of what each replica's engine saw —
            # disagreement between the two is itself a signal (e.g. the
            # router burning on "unavailable" while replicas look clean).
            "slo": slo,
            "slo_fleet": fleet_slo_rollup(self._snapshot_source()),
            "admission": self.admission.stats(),
            "affinity": self.affinity.stats(),
        }
