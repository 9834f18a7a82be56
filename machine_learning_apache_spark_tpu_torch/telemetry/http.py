"""Live observability plane — per-process HTTP endpoints over telemetry;
the port of ``machine_learning_apache_spark_tpu/telemetry/http.py``.

JSONL exports, merged reports and flight dumps are post-hoc — readable
only after the process is done (or dead). This module answers "what is this replica doing *right now*": a background
stdlib HTTP server exposing the process's live state on five endpoints,
the per-replica signal a least-loaded router or an SRE dashboard scrapes
(Prometheus conventions on ``/metrics``, JSON everywhere else):

- ``/metrics`` — the registry's Prometheus text exposition plus any
  registered **live gauges** (serving queue depth, page-pool occupancy —
  values that exist as object state, not counters, and must be sampled
  at scrape time);
- ``/healthz`` — liveness + health checks: process uptime, beacon
  (heartbeat) age, and every registered health provider's verdict.
  HTTP 200 when all healthy, 503 when any check fails (the quarantine /
  dead-worker signal a load balancer ejects on);
- ``/statusz`` — one JSON snapshot of everything: build + MLSPARK_*
  config, registry summaries, health, and every registered status
  section (the serving engine contributes its ledger, page-pool stats,
  and slowest-request trace exemplars);
- ``/flightz`` — the event-ring tail, i.e. the flight recorder's view
  without waiting for a crash;
- ``/tracez`` — the event ring's traces (``telemetry.traceview``), or one
  stitched tree with ``?id=<trace id>``.

Env contract: ``MLSPARK_TELEMETRY_HTTP`` is the port (0 = ephemeral);
unset means no server and **zero threads**. ``MLSPARK_TELEMETRY=0``
wins over everything — the whole plane stays dark. On startup the bound
port is written to a ``http_rank<k>.json`` sidecar in the telemetry dir
(discovery for ``tools/gang_status.py``) and into the process beacon
(so heartbeat payloads carry it too).

stdlib-only, like every telemetry module: importable before torch. Providers are called from scrape threads — they
must be thread-safe and non-blocking (every registered callable is
guarded; a raising provider becomes an ``"error"`` section, never a
dead endpoint).
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events
from machine_learning_apache_spark_tpu_torch.telemetry import registry as _registry

ENV_TELEMETRY_HTTP = "MLSPARK_TELEMETRY_HTTP"

#: How many trailing events ``/flightz`` returns (same order of magnitude
#: as a flight dump; ``?n=`` overrides up to the ring size).
FLIGHTZ_TAIL = 256

SIDECAR_RE = re.compile(r"http_rank(\d+)\.json$")

_STATE_LOCK = threading.Lock()
_SERVER: "TelemetryHTTPServer | None" = None  # guarded-by: _STATE_LOCK
_STARTED_AT = time.monotonic()

# Provider registries (shared across the process, like the metrics
# registry): name -> zero-arg callable. Status providers return a JSON-able
# dict (one /statusz section each); health providers return a dict whose
# "healthy" key drives the /healthz verdict; gauge providers return a float
# sampled per /metrics scrape, keyed by full Prometheus metric name.
# Scrape paths copy the dict under the lock, then call providers unlocked.
_STATUS_PROVIDERS: dict[str, Callable[[], dict]] = {}  # guarded-by: _STATE_LOCK
_HEALTH_PROVIDERS: dict[str, Callable[[], dict]] = {}  # guarded-by: _STATE_LOCK
_GAUGE_PROVIDERS: dict[str, Callable[[], float]] = {}  # guarded-by: _STATE_LOCK


# -- provider registration -----------------------------------------------------
def register_status_provider(name: str, fn: Callable[[], dict]) -> None:
    """Contribute a ``/statusz`` section: ``fn()`` -> JSON-able dict,
    called at scrape time. Re-registering a name replaces it (engines are
    sequential within a process; last one wins)."""
    with _STATE_LOCK:
        _STATUS_PROVIDERS[name] = fn


def register_health_provider(name: str, fn: Callable[[], dict]) -> None:
    """Contribute a ``/healthz`` check: ``fn()`` -> dict with a boolean
    ``"healthy"`` key (absent counts as healthy). Any unhealthy check
    turns the endpoint 503."""
    with _STATE_LOCK:
        _HEALTH_PROVIDERS[name] = fn


def register_live_gauge(
    scope: str, name: str, fn: Callable[[], float]
) -> str:
    """Contribute a gauge sampled at every ``/metrics`` scrape (for state
    that lives in objects, not counters: queue depth, pool occupancy).
    Returns the full Prometheus metric name used."""
    full = _registry._sanitize(f"mlspark_{scope}_{name}")
    with _STATE_LOCK:
        _GAUGE_PROVIDERS[full] = fn
    return full


def unregister_provider(name: str) -> None:
    """Drop a status/health provider and any ``mlspark_<name>_*`` live
    gauges (engine stop path)."""
    prefix = _registry._sanitize(f"mlspark_{name}_")
    with _STATE_LOCK:
        _STATUS_PROVIDERS.pop(name, None)
        _HEALTH_PROVIDERS.pop(name, None)
        for key in [k for k in _GAUGE_PROVIDERS if k.startswith(prefix)]:
            del _GAUGE_PROVIDERS[key]


# -- endpoint payloads (plain functions: testable without a socket) ------------
def metrics_text() -> str:
    """``/metrics`` body: registry exposition + live gauge samples."""
    text = _registry.get_registry().to_prometheus_text()
    rank = _events._env_rank()
    labels = f'{{rank="{rank}"}}' if rank is not None else ""
    with _STATE_LOCK:
        gauges = dict(_GAUGE_PROVIDERS)
    lines: list[str] = []
    for full, fn in sorted(gauges.items()):
        try:
            value = float(fn())
        except Exception:  # noqa: BLE001 — one bad gauge must not kill the scrape
            continue
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{labels} {value:g}")
    return text + ("\n".join(lines) + "\n" if lines else "")


def healthz() -> tuple[dict, bool]:
    """``/healthz`` payload and overall verdict. Always includes process
    liveness basics; health providers add their checks."""
    beacon = _events.beacon()
    now = time.monotonic()
    heartbeat_age = (
        round(now - beacon["ts"], 3) if beacon.get("ts") is not None else None
    )
    checks: dict[str, dict] = {}
    with _STATE_LOCK:
        providers = dict(_HEALTH_PROVIDERS)
    healthy = True
    for name, fn in sorted(providers.items()):
        try:
            check = dict(fn())
        except Exception as e:  # noqa: BLE001 — a raising check is an unhealthy check
            check = {"healthy": False, "error": repr(e)}
        checks[name] = check
        healthy = healthy and bool(check.get("healthy", True))
    payload = {
        "status": "ok" if healthy else "degraded",
        "pid": os.getpid(),
        "rank": _events._env_rank(),
        "uptime_s": round(now - _STARTED_AT, 3),
        "heartbeat_age_s": heartbeat_age,
        "phase": beacon.get("phase"),
        "step": beacon.get("step"),
        "checks": checks,
    }
    return payload, healthy


def statusz() -> dict:
    """``/statusz`` payload: the one-stop JSON snapshot."""
    health, _ = healthz()
    payload = {
        "artifact": "statusz",
        "pid": os.getpid(),
        "rank": _events._env_rank(),
        "wall": round(time.time(), 3),
        "uptime_s": round(time.monotonic() - _STARTED_AT, 3),
        "build": _build_info(),
        "config": {
            k: v for k, v in sorted(os.environ.items())
            if k.startswith("MLSPARK_")
        },
        "beacon": _events.beacon(),
        "health": health,
        "registry": _registry.get_registry().snapshot(),
        "sections": {},
    }
    with _STATE_LOCK:
        providers = dict(_STATUS_PROVIDERS)
    for name, fn in sorted(providers.items()):
        try:
            payload["sections"][name] = fn()
        except Exception as e:  # noqa: BLE001 — one bad section, not a dead endpoint
            payload["sections"][name] = {"error": repr(e)}
    return payload


def flightz(n: int = FLIGHTZ_TAIL) -> dict:
    """``/flightz`` payload: the live event-ring tail."""
    log = _events.get_log()
    events = [ev.to_dict() for ev in log.tail(n)]
    return {
        "artifact": "flightz",
        "rank": _events._env_rank(),
        "pid": os.getpid(),
        "event_count": len(events),
        "dropped": log.dropped,
        "events": events,
    }


def tracez(trace_id: str | None = None) -> dict:
    """``/tracez`` payload: distributed-trace view over this process's
    live event ring — trace summaries, or one stitched tree with
    ``?id=<trace id>``. Single-process by nature (the ring is local);
    the cross-process merge reads the rank exports
    (``traceview.load_dir``)."""
    # Lazy import: traceview pulls aggregate; the HTTP plane must stay
    # importable (and cheap) for processes that never serve a trace.
    from machine_learning_apache_spark_tpu_torch.telemetry import (
        traceview as _traceview,
    )

    log = _events.get_log()
    events = [ev.to_dict() for ev in log.snapshot()]
    payload = _traceview.tracez_payload(events, trace_id)
    payload["rank"] = _events._env_rank()
    payload["pid"] = os.getpid()
    return payload


def _build_info() -> dict:
    info = {"python": sys.version.split()[0]}
    # sys.modules peek, never an import: /statusz must not be the thing
    # that drags torch into a process that has not loaded it yet.
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        info["torch"] = getattr(torch_mod, "__version__", None)
    return info


# -- the server ----------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    server_version = "mlspark-telemetry"

    def log_message(self, *args) -> None:  # noqa: ARG002 — scrapes aren't log spam
        pass

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                self._reply(200, metrics_text(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                payload, healthy = healthz()
                self._reply_json(200 if healthy else 503, payload)
            elif path in ("/statusz", "/"):
                self._reply_json(200, statusz())
            elif path == "/flightz":
                n = FLIGHTZ_TAIL
                m = re.search(r"(?:^|&)n=(\d+)", query)
                if m:
                    n = max(1, int(m.group(1)))
                self._reply_json(200, flightz(n))
            elif path == "/tracez":
                m = re.search(r"(?:^|&)id=([0-9a-fA-F]+)", query)
                self._reply_json(
                    200, tracez(m.group(1).lower() if m else None)
                )
            else:
                self._reply_json(404, {"error": f"no endpoint {path!r}"})
        except Exception:  # noqa: BLE001 — a scrape must never kill the thread
            self._reply_json(
                500, {"error": traceback.format_exc(limit=4)}
            )

    def _reply_json(self, code: int, payload: dict) -> None:
        self._reply(code, json.dumps(payload) + "\n", "application/json")

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-reply — its problem, not ours


class TelemetryHTTPServer:
    """One process's observability server: a ``ThreadingHTTPServer`` on a
    daemon thread (daemon handler threads too — scrapes never block
    process exit)."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self.sidecar_path: str | None = None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mlspark-telemetry-http",
            daemon=True,
        )

    def start(self) -> "TelemetryHTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        if self.sidecar_path:
            try:
                os.unlink(self.sidecar_path)
            except OSError:
                pass

    def url(self, path: str = "/") -> str:
        return f"http://127.0.0.1:{self.port}{path}"


# -- sidecar discovery ---------------------------------------------------------
def sidecar_name(rank: int) -> str:
    return f"http_rank{rank}.json"


def write_port_sidecar(
    port: int, directory: str | None = None, rank: int | None = None
) -> str | None:
    """Publish the bound port for discovery (``tools/gang_status.py``
    scans these): ``http_rank<k>.json`` in the telemetry dir. Returns the
    path, or None when no directory is configured."""
    d = directory or _events.telemetry_dir()
    if not d:
        return None
    if rank is None:
        r = _events._env_rank()
        rank = 0 if r is None else r
    path = os.path.join(d, sidecar_name(rank))
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


def find_port_sidecars(directory: str) -> dict[int, dict]:
    """``{rank: sidecar payload}`` for every ``http_rank<k>.json`` in a
    directory (torn/unreadable files skipped)."""
    out: dict[int, dict] = {}
    for path in glob.glob(os.path.join(directory, "http_rank*.json")):
        m = SIDECAR_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict) and "port" in payload:
            out[int(m.group(1))] = payload
    return dict(sorted(out.items()))


# -- process-global lifecycle --------------------------------------------------
def http_port_from_env() -> int | None:
    """The configured port, or None when the plane is off (unset, empty,
    or unparseable ``MLSPARK_TELEMETRY_HTTP``)."""
    # Direct read by design: telemetry is stdlib-only by contract;
    # utils.env would cycle via utils.profiling (see events._env_rank).
    # mlspark-lint: ok env-direct-read -- stdlib-only module, see above
    raw = os.environ.get(ENV_TELEMETRY_HTTP)
    if raw is None or not raw.strip():
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    return port if 0 <= port <= 65535 else None


def start_http_server(
    port: int | None = None,
    *,
    directory: str | None = None,
    rank: int | None = None,
) -> TelemetryHTTPServer | None:
    """Idempotently start the process-global server. With ``port=None``
    the env contract decides: no ``MLSPARK_TELEMETRY_HTTP`` -> no server,
    no thread. ``MLSPARK_TELEMETRY=0`` always means no server. Returns
    the (possibly pre-existing) server, or None when disabled."""
    global _SERVER
    if not _events.enabled():
        return None
    if port is None:
        port = http_port_from_env()
        if port is None:
            return None
    with _STATE_LOCK:
        if _SERVER is not None:
            return _SERVER
        server = TelemetryHTTPServer(port=port).start()
        # Sidecar before publication: once `_SERVER` is visible, a
        # concurrent stop_http_server() may swap it out and call
        # server.stop() — which unlinks `sidecar_path`. Assigning the
        # sidecar after publishing leaves a window where stop() sees
        # None and the file leaks past the server's death
        # (the JAX package's race tests run start/stop against this).
        server.sidecar_path = write_port_sidecar(
            server.port, directory=directory, rank=rank
        )
        _SERVER = server
    # The beacon carries the port so heartbeat payloads double as
    # discovery when no telemetry dir is configured.
    _events.beacon_update(http_port=server.port)
    _events.annotate("telemetry.http_started", port=server.port)
    return server


def get_http_server() -> TelemetryHTTPServer | None:
    with _STATE_LOCK:
        return _SERVER


def stop_http_server() -> None:
    global _SERVER
    with _STATE_LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.stop()


def reset() -> None:
    """Stop the server and drop every provider — test hook, called from
    ``telemetry.reset()``."""
    stop_http_server()
    with _STATE_LOCK:
        _STATUS_PROVIDERS.clear()
        _HEALTH_PROVIDERS.clear()
        _GAUGE_PROVIDERS.clear()


__all__ = [
    "ENV_TELEMETRY_HTTP",
    "FLIGHTZ_TAIL",
    "TelemetryHTTPServer",
    "find_port_sidecars",
    "flightz",
    "get_http_server",
    "healthz",
    "http_port_from_env",
    "metrics_text",
    "register_health_provider",
    "register_live_gauge",
    "register_status_provider",
    "reset",
    "sidecar_name",
    "start_http_server",
    "statusz",
    "stop_http_server",
    "tracez",
    "unregister_provider",
    "write_port_sidecar",
]
