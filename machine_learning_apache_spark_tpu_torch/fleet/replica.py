"""Replica data plane — one serving engine behind one HTTP front door
(the port of ``machine_learning_apache_spark_tpu/fleet/replica.py``).

Each fleet rank runs a :class:`ReplicaServer` around its
``ServingEngine``: ``POST /v1/generate`` maps the engine's request
contract onto HTTP status codes the router can dispatch around —

- **200** — translation complete; body carries text, trace id, token
  count.
- **429** — the replica queue pushed back (``Backpressure``); body and
  ``Retry-After`` header carry the queue's own estimate. The router may
  try another replica.
- **503** — the engine is degraded (mid-quarantine) or stopping; the
  router must *drain* around this replica until ``/healthz`` recovers.
- **504** — the request's deadline expired inside this replica.
- **500** — the decode step itself failed (``InternalError``).

``POST /v1/cancel`` is the hedging router's remote reap: keyed by the
router-minted trace id (the one the traceparent header carried in and
the engine's ``RequestTrace`` adopted), it force-expires the matching
in-flight request — still-queued work dies in the next queue sweep,
mid-decode work at the engine's next between-launch deadline sweep,
freeing its KV pages and launch slot. The abandoned handler thread then
answers 504 to a caller that already took the winning response.

The handler is also the application point for the ``wire`` fault family
(``utils.faults.wire_fault``): delay / black-hole / torn-response /
corrupt-body / slow-drip, matched by deterministic (rank,
request-ordinal) coordinates — the router's retry taxonomy drilled at
the exact layer it claims to handle.

The same server answers the observability plane's GET endpoints
(``/healthz``, ``/statusz``, ``/metrics``, ``/flightz``) by delegating
to ``telemetry.http``'s payload functions, so the router's scrape loop
judges the *data-plane* socket — a replica whose server wedged can't
look healthy through a separate port.

Discovery follows the telemetry sidecar idiom: the bound port lands in
``fleet_rank<k>.json`` (``MLSPARK_FLEET_DIR``, defaulting to the
telemetry dir). :func:`serve_replica` is the launcher-gang worker body:
build engine, serve, poll for the ``fleet_stop`` marker, drain, report.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from machine_learning_apache_spark_tpu_torch.serving.queue import (
    Backpressure,
    DeadlineExceeded,
)
from machine_learning_apache_spark_tpu_torch.telemetry import events as _events
from machine_learning_apache_spark_tpu_torch.telemetry import http as _thttp
from machine_learning_apache_spark_tpu_torch.telemetry import spans as _spans
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as _tracectx,
)
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils import faults as _faults
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Router-visible generate timeout padding beyond the request deadline.
RESULT_GRACE_S = 10.0
#: A draining replica keeps its data plane up (answering 503) until a
#: scrape has read "draining" off its ``/healthz`` and then this long, so
#: that a router dispatching on its last "ok" snapshot meets a 503 it
#: retries elsewhere, never a closed socket (a lost request). The JAX
#: replica closes as soon as its in-flight reaches 0.
DRAIN_SEEN_GRACE_S = 1.0
STOP_MARKER = "fleet_stop"


def fleet_sidecar_name(rank: int) -> str:
    return f"fleet_rank{rank}.json"


def drain_marker_name(rank: int) -> str:
    """Per-rank drain marker: the autoscaler (via ``ReplicaGang.
    retire_rank``) drops this file in the fleet dir to tell exactly one
    replica to stop accepting work, finish its in-flight, and exit. The
    JSON body carries the drain ``deadline`` (epoch seconds) past which
    the replica exits regardless."""
    return f"fleet_drain_rank{rank}"


def write_fleet_sidecar(
    port: int, directory: str | None = None, rank: int | None = None
) -> str | None:
    """Publish the data-plane port for the router's discovery — same
    atomic tmp+replace discipline as ``telemetry.http.write_port_sidecar``."""
    d = directory or fleet_dir()
    if not d:
        return None
    if rank is None:
        r = _events._env_rank()
        rank = 0 if r is None else r
    path = os.path.join(d, fleet_sidecar_name(rank))
    payload = {
        "port": port,
        "rank": rank,
        "pid": os.getpid(),
        "wall": round(time.time(), 3),
    }
    try:
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def fleet_dir() -> str | None:
    """Where fleet sidecars and the stop marker live:
    ``MLSPARK_FLEET_DIR`` > telemetry dir."""
    return envcfg.get_str("MLSPARK_FLEET_DIR") or _events.telemetry_dir()


class _ReplicaHandler(BaseHTTPRequestHandler):
    server_version = "mlspark-fleet-replica"

    def log_message(self, *args) -> None:  # noqa: ARG002 — not log spam
        pass

    # -- data plane ----------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 — http.server API
        owner: ReplicaServer = self.server.replica  # type: ignore[attr-defined]
        if self.path == "/v1/cancel":
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length).decode("utf-8"))
                trace_id = body["trace_id"]
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": f"bad request body: {e!r}"})
                return
            code, payload = owner.cancel(trace_id)
            self._reply(code, payload)
            return
        if self.path != "/v1/generate":
            self._reply(404, {"error": f"no endpoint {self.path!r}"})
            return
        # Wire fault injection happens HERE, at the socket, before the
        # engine sees anything: the ordinal is this server's zero-based
        # exchange count, so a drill pins a fault to exactly one exchange
        # on exactly one rank.
        ordinal = owner.next_wire_ordinal()
        spec = _faults.wire_fault(rank=owner.rank, req=ordinal)
        if spec is not None:
            owner.note_wire_fault(spec, ordinal)
            if spec.action == "delay" and spec.ms:
                time.sleep(spec.ms / 1000.0)
            elif spec.action == "blackhole":
                # Swallow the exchange: drain the request so the client
                # isn't stuck writing, answer nothing, hang up. The
                # router classifies this "lost" — terminal, no replay.
                length = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(length)
                self.close_connection = True
                return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length).decode("utf-8"))
            text = body["text"]
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": f"bad request body: {e!r}"})
            return
        code, payload = owner.generate(
            text,
            deadline_s=body.get("deadline_s"),
            tier=body.get("tier"),
            tenant=body.get("tenant"),
            traceparent=self.headers.get("traceparent"),
        )
        headers = {}
        if code == 429 and payload.get("retry_after") is not None:
            headers["Retry-After"] = f"{payload['retry_after']:.3f}"
        if spec is not None and spec.action in ("torn", "corrupt", "drip"):
            self._reply_wire(spec, code, payload, headers)
            return
        self._reply(code, payload, headers)

    # -- observability plane (delegated) -------------------------------------
    def do_GET(self) -> None:  # noqa: N802 — http.server API
        try:
            if self.path.startswith("/metrics"):
                self._reply_raw(
                    200, _thttp.metrics_text(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif self.path.startswith("/healthz"):
                payload, healthy = _thttp.healthz()
                owner: ReplicaServer = self.server.replica  # type: ignore[attr-defined]
                if owner.draining:
                    # Drain outranks the engine's own verdict: the scrape
                    # plane must see "draining" (a deliberate, live exit)
                    # rather than "degraded" (a failure), so membership
                    # accounting doesn't count the retirement as an
                    # outage.
                    owner.note_drain_seen()
                    payload = dict(payload)
                    payload["status"] = "draining"
                    healthy = False
                self._reply(200 if healthy else 503, payload)
            elif self.path.startswith("/flightz"):
                self._reply(200, _thttp.flightz())
            elif self.path.startswith("/tracez"):
                m = re.search(r"(?:^|[?&])id=([0-9a-fA-F]+)", self.path)
                self._reply(
                    200, _thttp.tracez(m.group(1).lower() if m else None)
                )
            elif self.path.startswith("/statusz") or self.path == "/":
                self._reply(200, _thttp.statusz())
            else:
                self._reply(404, {"error": f"no endpoint {self.path!r}"})
        except Exception as e:  # noqa: BLE001 — a scrape must not kill the thread
            self._reply(500, {"error": repr(e)})

    # -- plumbing ------------------------------------------------------------
    def _reply(
        self, code: int, payload: dict, headers: dict | None = None
    ) -> None:
        self._reply_raw(
            code, json.dumps(payload) + "\n", "application/json", headers
        )

    def _reply_raw(
        self,
        code: int,
        body: str,
        ctype: str,
        headers: dict | None = None,
    ) -> None:
        data = body.encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up — its in-flight request, its loss

    def _reply_wire(
        self, spec, code: int, payload: dict, headers: dict | None = None
    ) -> None:
        """Deliver a real response through an injected wire fault —
        the response-side half of the ``wire`` family."""
        data = (json.dumps(payload) + "\n").encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if spec.action == "torn":
                # Full Content-Length, half a body, then hang up: the
                # client sees a short read — indistinguishable from a
                # replica dying mid-response ("lost", terminal).
                self.wfile.write(data[: max(1, len(data) // 2)])
                self.wfile.flush()
                self.close_connection = True
            elif spec.action == "corrupt":
                # Right length, unparseable content: the router's JSON
                # decode fails — also "lost", also terminal.
                self.wfile.write(b"#" * (len(data) - 1) + b"\n")
            elif spec.action == "drip":
                # Trickle the body out over ~spec.ms total — the slow
                # response a hedge should beat without any hard failure.
                chunks = [data[i:i + 16] for i in range(0, len(data), 16)]
                pause = (spec.ms / 1000.0) / max(1, len(chunks))
                for chunk in chunks:
                    self.wfile.write(chunk)
                    self.wfile.flush()
                    time.sleep(pause)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up — its in-flight request, its loss


class _ReplicaHTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5. Routed requests arrive in
    # bursts (the router's least-loaded pick herds onto one replica between
    # scrapes); past the backlog the kernel drops their SYNs and each
    # waits a 1 s retransmit. The JAX replica keeps the default.
    request_queue_size = 128
    daemon_threads = True


class ReplicaServer:
    """The HTTP front door over one started ``ServingEngine``."""

    def __init__(
        self,
        engine,
        *,
        rank: int | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
        health_fn=None,
    ):
        self.engine = engine
        r = _events._env_rank()
        self.rank = rank if rank is not None else (0 if r is None else r)
        # Injectable health for tests; production uses the engine's own
        # /healthz verdict (worker alive + quarantine recovered).
        self._health_fn = health_fn or (
            lambda: engine._health_snapshot().get("healthy", False)
        )
        self._httpd = _ReplicaHTTPServer((host, port), _ReplicaHandler)
        self._httpd.replica = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self.sidecar_path: str | None = None
        self._lock = threading.Lock()
        self._draining = False
        self._drain_seen_at: float | None = None
        self.requests = 0
        self.completed = 0
        self.rejected = 0
        self.refused_503 = 0
        self.failed = 0
        self.expired = 0
        self.cancelled = 0
        self.wire_faults = 0
        self._wire_ordinal = 0
        # trace_id -> in-flight ServeRequest: the /v1/cancel key space.
        # Entries live exactly as long as a handler thread waits on the
        # engine future — insert after submit, pop in its finally.
        self._inflight: dict[str, object] = {}

    @property
    def draining(self) -> bool:
        return self._draining

    def next_wire_ordinal(self) -> int:
        """Zero-based ordinal of the next ``/v1/generate`` exchange —
        the ``req`` coordinate wire fault specs match against."""
        with self._lock:
            n = self._wire_ordinal
            self._wire_ordinal += 1
            return n

    def note_wire_fault(self, spec, ordinal: int) -> None:
        with self._lock:
            self.wire_faults += 1
        _events.annotate(
            "fleet.wire_fault", rank=self.rank, action=spec.action,
            req=ordinal, key=spec.key,
        )

    def cancel(self, trace_id: str) -> tuple[int, dict]:
        """Remote reap (the hedging router's loser-cancellation path):
        force-expire the in-flight request carrying this router-minted
        trace id by pulling its deadline to *now*. Still-queued work dies
        in the immediate queue sweep; mid-decode work at the engine's
        next between-launch deadline sweep — either way its pages and
        slot free, the engine ledger books ``expired``, and the waiting
        handler thread answers 504 to a caller that no longer cares."""
        with self._lock:
            req = self._inflight.get(trace_id)
        if req is None:
            return 404, {
                "cancelled": False,
                "rank": self.rank,
                "error": "no in-flight request with that trace id",
            }
        req.deadline = self.engine.clock()
        with self._lock:
            self.cancelled += 1
        self.engine.queue.expire_now()
        _events.annotate(
            "fleet.replica_cancel", rank=self.rank, trace_id=trace_id
        )
        return 200, {
            "cancelled": True, "rank": self.rank, "trace_id": trace_id,
        }

    def note_drain_seen(self) -> None:
        """A ``/healthz`` answered "draining": a scraper now knows."""
        with self._lock:
            if self._drain_seen_at is None:
                self._drain_seen_at = time.monotonic()

    def drain_seen_for(self) -> float:
        """Seconds since a scrape first read "draining" (0 before)."""
        with self._lock:
            seen = self._drain_seen_at
        return 0.0 if seen is None else time.monotonic() - seen

    def set_draining(self, flag: bool = True) -> None:
        """Flip the front door to refuse-new-work mode: ``/healthz``
        answers 503 with status "draining" and ``generate`` refuses with
        503, while already-accepted requests run to completion."""
        if flag and not self._draining:
            _events.annotate("fleet.replica_draining", rank=self.rank,
                             port=self.port)
        self._draining = bool(flag)

    # -- lifecycle -----------------------------------------------------------
    def start(self, *, directory: str | None = None) -> "ReplicaServer":
        if self._thread is not None:
            raise RuntimeError("replica server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name=f"fleet-replica-{self.rank}",
            daemon=True,
        )
        self._thread.start()
        self.sidecar_path = write_fleet_sidecar(
            self.port, directory=directory, rank=self.rank
        )
        _events.beacon_update(fleet_port=self.port)
        _events.annotate("fleet.replica_started", rank=self.rank,
                         port=self.port)
        return self

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._httpd.shutdown()
        t.join(10.0)
        self._httpd.server_close()
        self._thread = None
        if self.sidecar_path:
            try:
                os.unlink(self.sidecar_path)
            except OSError:
                pass

    def __enter__(self) -> "ReplicaServer":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path (handler threads call in) ------------------------------
    def generate(
        self,
        text: str,
        *,
        deadline_s: float | None = None,
        tier: str | None = None,
        tenant: str | None = None,
        traceparent: str | None = None,
    ) -> tuple[int, dict]:
        """One routed request, handler thread. The router's traceparent
        header (when present and well-formed) re-activates its trace on
        this thread for the whole replica-side lifetime: the
        ``fleet.replica`` span records this hop (``remote_parent`` is
        the router attempt's span id — the cross-process edge
        ``traceview`` draws a flow arrow over), and the engine adopts
        the context at submit so the queue/decode spans stitch in."""
        ctx = _tracectx.parse_traceparent(traceparent)
        attrs = {"rank": self.rank, "tier": tier}
        if ctx is not None:
            attrs["remote_parent"] = ctx.span_id
        with _tracectx.use(ctx), _spans.span("fleet.replica", **attrs):
            return self._generate_inner(
                text, deadline_s=deadline_s, tier=tier, tenant=tenant
            )

    def _generate_inner(
        self,
        text: str,
        *,
        deadline_s: float | None,
        tier: str | None,
        tenant: str | None,
    ) -> tuple[int, dict]:
        with self._lock:
            self.requests += 1
        if self._draining:
            with self._lock:
                self.refused_503 += 1
            return 503, {
                "error": "replica draining",
                "rank": self.rank,
            }
        if not self._healthy():
            # Drain signal: degraded replicas refuse *before* the queue,
            # so a quarantined engine's backlog drains while new traffic
            # flows to healthy replicas.
            with self._lock:
                self.refused_503 += 1
            return 503, {
                "error": "replica degraded",
                "rank": self.rank,
            }
        try:
            req = self.engine.submit(text, deadline_s=deadline_s, tier=tier)
        except Backpressure as e:
            with self._lock:
                self.rejected += 1
            return 429, {
                "error": "backpressure",
                "retry_after": e.retry_after,
                "depth": e.depth,
                "rank": self.rank,
            }
        except ValueError as e:
            with self._lock:
                self.failed += 1
            return 400, {"error": str(e), "rank": self.rank}
        except RuntimeError as e:  # EngineStopped / not started
            with self._lock:
                self.refused_503 += 1
            return 503, {"error": repr(e), "rank": self.rank}
        trace_id = req.trace.trace_id
        with self._lock:
            self._inflight[trace_id] = req
        timeout = (deadline_s or 120.0) + RESULT_GRACE_S
        try:
            out = req.result(timeout=timeout)
        except DeadlineExceeded as e:
            # Deadline burn-down or a remote /v1/cancel — either way the
            # engine booked ``expired``; mirror that here, not ``failed``.
            with self._lock:
                self.expired += 1
            return 504, {"error": str(e), "rank": self.rank,
                         "trace_id": trace_id}
        except Exception as e:  # noqa: BLE001 — InternalError, stop, timeout
            with self._lock:
                self.failed += 1
            return 500, {"error": repr(e), "rank": self.rank,
                         "trace_id": trace_id}
        finally:
            with self._lock:
                self._inflight.pop(trace_id, None)
        with self._lock:
            self.completed += 1
        return 200, {
            "text": out,
            "rank": self.rank,
            "trace_id": req.trace.trace_id,
            "tier": tier,
            "tenant": tenant,
            "tokens": len(self.engine.translator.trg_pipe.ragged([out])[0]),
        }

    def _healthy(self) -> bool:
        try:
            return bool(self._health_fn())
        except Exception:
            return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "rank": self.rank,
                "port": self.port,
                "requests": self.requests,
                "completed": self.completed,
                "rejected": self.rejected,
                "refused_503": self.refused_503,
                "failed": self.failed,
                "expired": self.expired,
                "cancelled": self.cancelled,
                "wire_faults": self.wire_faults,
            }


def serve_replica(
    translator,
    engine_knobs: dict | None = None,
    *,
    rank: int | None = None,
    directory: str | None = None,
    port: int | None = None,
    max_s: float = 3600.0,
    poll_s: float = 0.1,
) -> dict:
    """Gang-worker body: start engine + data plane, publish the sidecar,
    serve until the driver drops a ``fleet_stop`` marker in the fleet
    dir (or ``max_s`` passes), then drain and report. Importable by
    reference — the replica-gang launch mode runs exactly this.

    Engine knobs resolve arg > env > default inside ``translator.serve``
    — so a fleet driver can set a replica's KV discipline either
    explicitly (``engine_knobs={"kv_mode": ..., "kv_dtype": ...}``) or
    through the Distributor env contract (``MLSPARK_SERVE_KV_MODE`` /
    ``MLSPARK_SERVE_KV_DTYPE`` exported to every rank).

    The translator must sit on :func:`replica_device` — the card unless
    ``MLSPARK_PLATFORM=cpu`` — or this raises before anything serves."""
    device = replica_device()
    if translator.device.type != device.type:
        raise ValueError(
            f"fleet replica serves on {device} (MLSPARK_PLATFORM="
            f"{envcfg.get_str('MLSPARK_PLATFORM')!r}) but the translator is "
            f"on {translator.device}; build it with device=replica_device()"
        )
    d = directory or fleet_dir() or "."
    if port is None:
        port = envcfg.get_int("MLSPARK_FLEET_PORT")
    knobs = dict(engine_knobs or {})
    engine = translator.serve(start=False, **knobs)
    stop_marker = os.path.join(d, STOP_MARKER)
    with engine:
        server = ReplicaServer(engine, rank=rank, port=port)
        server.start(directory=d)
        drain_marker = os.path.join(d, drain_marker_name(server.rank))
        try:
            _events.beacon_update(phase="serving")
            deadline = time.monotonic() + max_s
            while time.monotonic() < deadline:
                if os.path.exists(stop_marker):
                    break
                if not server.draining and os.path.exists(drain_marker):
                    # Retirement order from the autoscaler: refuse new
                    # work, let in-flight finish, stay up until a scrape
                    # has seen the drain (DRAIN_SEEN_GRACE_S), then exit —
                    # or exit at the marker's wall-clock deadline,
                    # whichever first.
                    server.set_draining(True)
                if server.draining:
                    in_flight = engine.metrics.ledger().get("in_flight") or 0
                    seen = server.drain_seen_for()
                    if in_flight <= 0 and seen >= DRAIN_SEEN_GRACE_S:
                        break
                    if time.time() >= _read_drain_deadline(drain_marker):
                        break
                time.sleep(poll_s)
            stats = server.stats()
        finally:
            server.stop()
        ledger = engine.metrics.ledger()
    if server.draining:
        _events.annotate("fleet.replica_retired", rank=server.rank,
                         in_flight=ledger.get("in_flight"))
    return {"server": stats, "ledger": ledger, "drained": server.draining}


def replica_device():
    """The ``torch.device`` a replica serves on: the card, unless
    ``MLSPARK_PLATFORM=cpu`` (``ReplicaGang(platform="cpu")`` sets it)
    keeps the replica on the host. Where the card is asked for and there
    is none this raises, naming the device: a replica never serves from
    the host unasked. torch loads here, not at import, so a router
    process never needs it."""
    from machine_learning_apache_spark_tpu_torch.utils.device import (
        resolve_device,
    )

    platform = envcfg.get_str("MLSPARK_PLATFORM")
    try:
        return resolve_device("cpu" if platform == "cpu" else None)
    except RuntimeError as e:
        raise RuntimeError(
            f"fleet replica: MLSPARK_PLATFORM={platform!r} asks for the card "
            f"(device 'cuda') and none is available; set MLSPARK_PLATFORM="
            f"cpu (ReplicaGang(platform='cpu')) to serve from the host ({e})"
        ) from e


def _read_drain_deadline(path: str) -> float:
    """Wall-clock deadline carried by a drain marker; ``inf`` when the
    marker is empty or torn (the in-flight-zero exit still applies, and
    the gang's supervisor holds its own kill backstop)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        return float(payload["deadline"])
    except (OSError, ValueError, KeyError, TypeError):
        return float("inf")
