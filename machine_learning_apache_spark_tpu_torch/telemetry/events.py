"""Typed in-process event log — the substrate every telemetry signal rides.

One process, one bounded, lock-protected log of ``Event`` records. Every
other telemetry surface is a view over it: ``spans`` appends span
start/stop pairs, ``registry`` can annotate metric updates, the flight
``recorder`` dumps its tail at the moment of a failure, and ``aggregate``
merges the per-rank JSONL exports into a gang-wide timeline.

Design constraints (why this module looks the way it does):

- **stdlib-only.** The launcher's runner and the fault-injection layer
  touch telemetry before the JAX platform is settled; nothing here may
  import jax (or anything that does).
- **Bounded.** The log is a ring (``collections.deque`` with ``maxlen``):
  a week-long serving process must not grow without bound, and the
  newest events are exactly what a flight recorder wants anyway.
  ``dropped`` counts evictions so truncation is visible, never silent.
- **Zero-cost when disabled.** ``MLSPARK_TELEMETRY=0`` makes ``enabled()``
  False; every instrumentation point checks it first and the no-op path
  allocates nothing (module-level singletons, one boolean read).

Timestamps: ``ts`` is ``time.monotonic()`` (ordering/durations within a
process), ``wall`` is ``time.time()`` (rough cross-rank alignment in
merged reports — heartbeat files already rely on wall mtimes the same
way).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time

ENV_TELEMETRY = "MLSPARK_TELEMETRY"
ENV_TELEMETRY_DIR = "MLSPARK_TELEMETRY_DIR"
ENV_MAX_EVENTS = "MLSPARK_TELEMETRY_EVENTS"

#: The event vocabulary. Everything in the log is one of these.
KINDS = ("span_start", "span_end", "counter", "gauge", "annotation")

_DEFAULT_MAX_EVENTS = 65536


def _env_rank() -> int | None:
    """This process's gang rank (``MLSPARK_PROCESS_ID``), or None outside
    a gang — same convention as ``utils.faults``."""
    # Direct read by design: telemetry is stdlib-only by contract (module
    # docstring); utils.env pulls the jax-importing utils package and a
    # telemetry->utils import would also cycle through
    # utils.profiling->telemetry.spans. Names stay registered.
    # mlspark-lint: ok env-direct-read -- stdlib-only module, see above
    v = os.environ.get("MLSPARK_PROCESS_ID")
    try:
        return int(v) if v is not None else None
    except ValueError:
        return None


@dataclasses.dataclass
class Event:
    """One telemetry record. ``span``/``parent`` are span ids for the
    span_start/span_end pair; ``value`` carries counter increments, gauge
    levels, and span durations (seconds, on span_end); ``trace`` is the
    distributed trace id stamped when a ``telemetry.tracectx`` context
    was active on the emitting thread."""

    kind: str
    name: str
    ts: float
    wall: float
    rank: int | None
    pid: int
    span: int | None = None
    parent: int | None = None
    value: float | None = None
    attrs: dict | None = None
    trace: str | None = None

    def to_dict(self) -> dict:
        d = {
            "kind": self.kind,
            "name": self.name,
            "ts": round(self.ts, 6),
            "wall": round(self.wall, 6),
            "rank": self.rank,
            "pid": self.pid,
        }
        if self.span is not None:
            d["span"] = self.span
        if self.parent is not None:
            d["parent"] = self.parent
        if self.value is not None:
            d["value"] = self.value
        if self.attrs:
            d["attrs"] = self.attrs
        if self.trace is not None:
            d["trace"] = self.trace
        return d


# -- distributed-trace thread slot --------------------------------------------
# The active TraceContext lives HERE (not in tracectx) so ``emit`` can
# stamp events with one thread-local read and tracectx can import events
# without a cycle. ``telemetry.tracectx.use`` is the only writer.
_TRACE_TLS = threading.local()


def current_trace():
    """The TraceContext active on this thread, or None."""
    return getattr(_TRACE_TLS, "ctx", None)


def set_current_trace(ctx) -> None:
    """Install (or, with None, clear) this thread's active trace context
    — called by ``telemetry.tracectx.use``, not by instrumentation."""
    _TRACE_TLS.ctx = ctx


class EventLog:
    """Lock-protected bounded ring of ``Event``s with JSONL export."""

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: collections.deque[Event] = collections.deque(
            maxlen=max_events
        )
        self.dropped = 0  # evicted-by-the-ring count (visible truncation)

    def emit(
        self,
        kind: str,
        name: str,
        *,
        span: int | None = None,
        parent: int | None = None,
        value: float | None = None,
        attrs: dict | None = None,
    ) -> Event:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r} (expected {KINDS})")
        ctx = getattr(_TRACE_TLS, "ctx", None)
        ev = Event(
            kind=kind,
            name=name,
            ts=time.monotonic(),
            wall=time.time(),
            rank=_env_rank(),
            pid=os.getpid(),
            span=span,
            parent=parent,
            value=value,
            attrs=attrs,
            trace=None if ctx is None else ctx.trace_id,
        )
        with self._lock:
            if len(self._events) == self.max_events:
                self.dropped += 1
            self._events.append(ev)
        return ev

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> list[Event]:
        with self._lock:
            if n >= len(self._events):
                return list(self._events)
            return list(
                itertools.islice(
                    self._events, len(self._events) - n, len(self._events)
                )
            )

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export_jsonl(self, path: str) -> int:
        """Write every buffered event as one JSON line; returns the count.
        Atomic replace so a killed process can't leave a half-file for the
        merge step to choke on."""
        events = self.snapshot()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(ev.to_dict()) + "\n")
        os.replace(tmp, path)
        return len(events)


class _NoopEventLog:
    """The disabled-mode stand-in: same surface, no storage, no allocation
    per call beyond the call itself."""

    max_events = 0
    dropped = 0

    def emit(self, *a, **kw) -> None:  # noqa: ARG002
        return None

    def __len__(self) -> int:
        return 0

    def snapshot(self) -> list:
        return []

    def tail(self, n: int) -> list:  # noqa: ARG002
        return []

    def clear(self) -> None:
        pass

    def export_jsonl(self, path: str) -> int:  # noqa: ARG002
        return 0


NOOP_LOG = _NoopEventLog()

# -- process-global state ------------------------------------------------------
_ENABLED: bool | None = None  # None = not yet read from the environment
_LOG: EventLog | None = None
_STATE_LOCK = threading.Lock()


def enabled() -> bool:
    """Is telemetry on? Defaults to ON; ``MLSPARK_TELEMETRY=0`` (or
    ``false``/``off``) turns every instrumentation point into a no-op.
    The env read is cached — instrumented hot paths pay one global load."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get(ENV_TELEMETRY, "1").strip().lower() not in (  # mlspark-lint: ok env-direct-read -- stdlib-only module, see _env_rank
            "0", "false", "off", "no",
        )
    return _ENABLED


def set_enabled(value: bool | None) -> None:
    """Override (or, with None, re-arm the env read of) the enabled flag —
    the test hook; production processes configure via the environment."""
    global _ENABLED
    _ENABLED = value


def get_log():
    """The process-global event log (``NOOP_LOG`` when disabled)."""
    global _LOG
    if not enabled():
        return NOOP_LOG
    if _LOG is None:
        with _STATE_LOCK:
            if _LOG is None:
                try:
                    max_events = int(
                        os.environ.get(ENV_MAX_EVENTS, _DEFAULT_MAX_EVENTS)  # mlspark-lint: ok env-direct-read -- stdlib-only module, see _env_rank
                    )
                except ValueError:
                    max_events = _DEFAULT_MAX_EVENTS
                _LOG = EventLog(max_events=max_events)
    return _LOG


def reset() -> None:
    """Drop all global telemetry state (log, enabled cache, beacon) —
    test hook, also re-arms the env reads for a forked/spawned child."""
    global _ENABLED, _LOG
    with _STATE_LOCK:
        _ENABLED = None
        _LOG = None
    with _BEACON_LOCK:
        _BEACON.clear()


def telemetry_dir() -> str | None:
    """Where rank exports and flight dumps land (``MLSPARK_TELEMETRY_DIR``);
    None means nothing is written to disk."""
    return os.environ.get(ENV_TELEMETRY_DIR) or None  # mlspark-lint: ok env-direct-read -- stdlib-only module, see _env_rank


def annotate(name: str, **attrs) -> None:
    """Point-in-time annotation event (no duration) — breadcrumbs for the
    flight recorder ("gang teardown begins", "quarantining batch 7")."""
    if not enabled():
        return
    get_log().emit("annotation", name, attrs=attrs or None)


# -- the process beacon --------------------------------------------------------
# A tiny "what am I doing right now" dict (phase, step, http_port, ...)
# that long-running loops update and liveness surfaces read: the runner's
# heartbeat thread folds it into each beat's JSON payload (via a
# sys.modules peek — no import), and /healthz reports its age. Always on,
# independent of the enabled() flag: it is liveness state, not telemetry
# (one dict update under a lock, no thread, no ring growth).
_BEACON_LOCK = threading.Lock()
_BEACON: dict = {}


def beacon_update(**fields) -> None:
    """Merge ``fields`` into the beacon and stamp the update time
    (``ts`` monotonic, ``wall`` wall-clock)."""
    with _BEACON_LOCK:
        _BEACON.update(fields)
        _BEACON["ts"] = time.monotonic()
        _BEACON["wall"] = time.time()


def beacon() -> dict:
    """A copy of the current beacon ({} before any update)."""
    with _BEACON_LOCK:
        return dict(_BEACON)


__all__ = [
    "ENV_MAX_EVENTS",
    "ENV_TELEMETRY",
    "ENV_TELEMETRY_DIR",
    "Event",
    "EventLog",
    "KINDS",
    "NOOP_LOG",
    "annotate",
    "beacon",
    "beacon_update",
    "current_trace",
    "enabled",
    "get_log",
    "reset",
    "set_current_trace",
    "set_enabled",
    "telemetry_dir",
]
