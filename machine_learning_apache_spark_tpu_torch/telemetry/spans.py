"""Nested trace spans over the telemetry event log.

A span is a named, timed region: entering emits a ``span_start`` event,
leaving emits a ``span_end`` carrying the duration. Nesting is tracked
per-thread (a thread-local stack), so a ``train.step`` span opened inside
a ``train.epoch`` span records its parent id and the merged timeline
reconstructs the tree. The serving engine's decode thread and the
launcher's monitor thread each get their own stack — spans never
interleave across threads.

Zero-cost-when-disabled: ``span()`` returns one module-level no-op
context manager when telemetry is off — no object allocation per step,
no branches beyond a cached boolean.

This module is also the home of the repo's original timing vocabulary:
``Timer`` and ``timed_span`` moved here from ``utils.timing`` (which
re-exports them for back-compat). ``timed_span`` keeps its printed
``<label>: <sec> sec`` line and now additionally emits a span event when
telemetry is enabled, so ad-hoc timings land on the same timeline as
structured instrumentation.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events

# CPython's GIL makes next() on a shared count atomic — no lock needed.
_SPAN_IDS = itertools.count(1)

_TLS = threading.local()


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def current_span_id() -> int | None:
    """Id of the innermost open span on this thread, or None."""
    s = getattr(_TLS, "stack", None)
    return s[-1] if s else None


class _Span:
    """One open span. Context manager; re-entrant use is a bug (one span,
    one region)."""

    __slots__ = ("name", "attrs", "id", "parent", "_t0")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = attrs
        self.id = next(_SPAN_IDS)
        self.parent: int | None = None
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._t0 = time.perf_counter()
        _events.get_log().emit(
            "span_start", self.name,
            span=self.id, parent=self.parent, attrs=self.attrs,
        )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self._t0
        stack = _stack()
        # Pop back to (and including) this span: tolerates a leaked inner
        # span rather than corrupting every later parent attribution.
        while stack and stack[-1] != self.id:
            stack.pop()
        if stack:
            stack.pop()
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs or ())
            attrs["error"] = exc_type.__name__
        _events.get_log().emit(
            "span_end", self.name,
            span=self.id, parent=self.parent, value=dur, attrs=attrs,
        )


class _NoopSpan:
    """Disabled-mode span: a single module-level instance, nothing per call."""

    __slots__ = ()
    name = ""
    id = None
    parent = None
    attrs = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


def span(name: str, **attrs):
    """``with span("train.step", step=i):`` — time a region onto the event
    log. Returns the shared no-op when telemetry is disabled."""
    if not _events.enabled():
        return NOOP_SPAN
    return _Span(name, attrs or None)


def traced(name: str | None = None, **attrs):
    """Decorator form: ``@traced("serving.submit")`` (or bare ``@traced()``
    to use the function's qualified name)."""

    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _events.enabled():
                return fn(*args, **kwargs)
            with _Span(span_name, attrs or None):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# -- the repo's original timing vocabulary, re-homed ---------------------------


@dataclass
class Timer:
    """Start/stop wall-clock timer with rolling-span support.

    The reference repo self-times every training run with ``time.time()``
    pairs (19 sites; e.g. ``pytorch_multilayer_perceptron.py:98,118-120``)
    plus a rolling per-100-batch span
    (``pytorch_machine_translator.py:150,199-205``). This dataclass is the
    one structured implementation of that vocabulary; it stays pure
    (no event emission) so hot loops can lap it freely.
    """

    name: str = "train"
    _start: float = field(default_factory=time.perf_counter, repr=False)
    elapsed: float = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._start
        return self.elapsed

    def lap(self) -> float:
        """Elapsed since last start/lap; restarts the span (the reference's
        rolling 100-batch timer, ``pytorch_machine_translator.py:199-205``)."""
        now = time.perf_counter()
        span_ = now - self._start
        self._start = now
        return span_


@contextlib.contextmanager
def timed_span(label: str, emit=None):
    """``with timed_span("Training Time"):`` — prints ``<label>: <sec>`` on
    exit, the reference's universal metric line (SURVEY.md §6). When
    telemetry is enabled the region also lands on the event log as a span."""
    ctx = span(label)
    t = Timer(label).start()
    try:
        with ctx:
            yield t
    finally:
        t.stop()
        (emit or print)(f"{label}: {t.elapsed:.3f} sec")


__all__ = [
    "NOOP_SPAN",
    "Timer",
    "current_span_id",
    "span",
    "timed_span",
    "traced",
]
