"""Distributed trace context — one id for a request's whole life.

The span layer (``telemetry.spans``) is strictly per-process: span ids
are thread-local integers, meaningful only inside one rank. This module
adds the cross-process half: a **trace context** — 128-bit trace id +
64-bit span id, W3C ``traceparent``-compatible — that travels with a
request across the router → replica → engine hops, so the gang-merged
view (``telemetry.traceview``) can stitch every process's spans into one
timeline.

Model (deliberately small):

- :func:`mint` creates a fresh sampled context — or ``None`` when
  tracing is off (``MLSPARK_TRACE=0``), telemetry is off, or the
  head-based sampler (``MLSPARK_TRACE_SAMPLE``, default 1.0) says no.
  "No context" is the zero-cost path: nothing downstream stamps
  anything.
- :func:`use` activates a context on the current thread for a ``with``
  block; every event emitted inside (spans, counters, annotations)
  carries ``trace=<trace_id>``. ``use(None)`` is a no-op passthrough,
  so call sites never branch on sampling.
- :func:`child` derives a new span id under the same trace — one per
  dispatch attempt, so retries land as distinct cross-process edges.
- :func:`to_traceparent` / :func:`parse_traceparent` are the wire codec
  (``00-<32 hex trace>-<16 hex span>-<2 hex flags>``). The parser is
  garbage-tolerant: anything malformed yields ``None``, never an
  exception — a bad header must not fail a request.

Head-based sampling is the overhead story: the decision is made once at
``mint`` and inherited by every hop, so an unsampled request pays one
RNG draw and nothing else (BENCH_SERVE_r06 pins the sampled-path cost).

stdlib-only, like every telemetry module. The thread-local slot itself
lives in ``telemetry.events`` so ``EventLog.emit`` can stamp events
without a circular import.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from dataclasses import dataclass

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events

ENV_TRACE = "MLSPARK_TRACE"
ENV_TRACE_SAMPLE = "MLSPARK_TRACE_SAMPLE"

#: Values read as "off" — mirrors utils.env.FALSY (not imported: telemetry
#: stays stdlib-only and cycle-free).
_FALSY = ("0", "false", "off", "no", "")

_HEX = frozenset("0123456789abcdef")

_STATE_LOCK = threading.Lock()
_ENABLED: bool | None = None  # guarded-by: _STATE_LOCK
_SAMPLE: float | None = None  # guarded-by: _STATE_LOCK

#: Trace/span id randomness. A private Random instance (urandom-seeded)
#: so recipe code seeding the global ``random`` module for reproducible
#: data cannot make two requests share a trace id.
_RNG = random.Random()


@dataclass(frozen=True)
class TraceContext:
    """One hop's identity within a distributed trace: the shared 128-bit
    ``trace_id`` (32 lowercase hex), this hop's ``span_id`` (16 lowercase
    hex), and the W3C flags byte (bit 0 = sampled)."""

    trace_id: str
    span_id: str
    flags: int = 1

    @property
    def sampled(self) -> bool:
        return bool(self.flags & 1)


def new_trace_id() -> str:
    """A fresh non-zero 128-bit trace id, 32 lowercase hex chars."""
    while True:
        tid = f"{_RNG.getrandbits(128):032x}"
        if tid != "0" * 32:
            return tid


def new_span_id() -> str:
    """A fresh non-zero 64-bit span id, 16 lowercase hex chars."""
    while True:
        sid = f"{_RNG.getrandbits(64):016x}"
        if sid != "0" * 16:
            return sid


# -- the on/off and sampling knobs --------------------------------------------
def trace_enabled() -> bool:
    """Tracing is on unless ``MLSPARK_TRACE`` is falsy — and never on
    when telemetry itself is off (a trace nobody records is pure cost).
    The env parse is cached; ``reset()`` clears it."""
    global _ENABLED
    with _STATE_LOCK:
        if _ENABLED is None:
            # Direct read by design: telemetry is stdlib-only by contract
            # (utils.env would cycle); the name is still registered in
            # utils/env.py so the contract and docs cover it.
            # mlspark-lint: ok env-direct-read -- stdlib-only module
            value = os.environ.get(ENV_TRACE)
            _ENABLED = (
                value is None or value.strip().lower() not in _FALSY
            )
        enabled = _ENABLED
    return enabled and _events.enabled()


def sample_rate() -> float:
    """Head-sampling probability in [0, 1] (``MLSPARK_TRACE_SAMPLE``,
    default 1.0 — every request traced). Malformed values read as 1.0:
    a typo'd knob must not silently disable tracing."""
    global _SAMPLE
    with _STATE_LOCK:
        if _SAMPLE is None:
            # mlspark-lint: ok env-direct-read -- stdlib-only module
            value = os.environ.get(ENV_TRACE_SAMPLE)
            try:
                rate = 1.0 if value is None else float(value)
            except ValueError:
                rate = 1.0
            _SAMPLE = min(1.0, max(0.0, rate))
        return _SAMPLE


def reset() -> None:
    """Drop the cached env parses and any context leaked onto this
    thread — test hook, chained from ``telemetry.reset()``."""
    global _ENABLED, _SAMPLE
    with _STATE_LOCK:
        _ENABLED = None
        _SAMPLE = None
    _events.set_current_trace(None)


# -- minting and propagation --------------------------------------------------
def mint(*, sampled: bool | None = None) -> TraceContext | None:
    """A fresh root context for one request — or ``None`` when tracing
    is off or the head sampler declines (``sampled`` overrides the coin
    flip for tests and always-trace paths)."""
    if not trace_enabled():
        return None
    if sampled is None:
        rate = sample_rate()
        sampled = rate >= 1.0 or _RNG.random() < rate
    if not sampled:
        return None
    return TraceContext(new_trace_id(), new_span_id(), flags=1)


def child(ctx: TraceContext | None) -> TraceContext | None:
    """Same trace, fresh span id — one per dispatch attempt, so a retry
    is a distinct edge under the same trace. ``None`` passes through."""
    if ctx is None:
        return None
    return TraceContext(ctx.trace_id, new_span_id(), ctx.flags)


def current() -> TraceContext | None:
    """The context active on this thread, or None."""
    return _events.current_trace()


#: Unambiguous alias for the flat ``telemetry.*`` namespace re-export.
current_trace_context = current


@contextlib.contextmanager
def use(ctx: TraceContext | None):
    """Activate ``ctx`` on the current thread for the block: every event
    emitted inside carries its trace id. ``use(None)`` yields without
    touching thread state, so unsampled requests stay zero-cost."""
    if ctx is None:
        yield None
        return
    prev = _events.current_trace()
    _events.set_current_trace(ctx)
    try:
        yield ctx
    finally:
        _events.set_current_trace(prev)


# -- the wire codec -----------------------------------------------------------
def _hexfield(s: str, n: int) -> bool:
    return len(s) == n and all(c in _HEX for c in s)


def to_traceparent(ctx: TraceContext) -> str:
    """``00-<trace_id>-<span_id>-<flags>`` — the W3C traceparent form
    the router sends on ``POST /v1/generate``."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{ctx.flags & 0xFF:02x}"


def parse_traceparent(header: object) -> TraceContext | None:
    """Decode a traceparent header, tolerating garbage: any malformed,
    all-zero, or forbidden-version (``ff``) value yields ``None`` — a
    replica must serve the request either way."""
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if not _hexfield(version, 2) or version == "ff":
        return None
    if not _hexfield(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _hexfield(span_id, 16) or span_id == "0" * 16:
        return None
    if not _hexfield(flags, 2):
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


__all__ = [
    "ENV_TRACE",
    "ENV_TRACE_SAMPLE",
    "TraceContext",
    "child",
    "current",
    "current_trace_context",
    "mint",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "reset",
    "sample_rate",
    "to_traceparent",
    "trace_enabled",
    "use",
]
