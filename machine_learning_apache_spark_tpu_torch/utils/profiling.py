"""Profiling hooks over ``torch.profiler`` — the port of
``machine_learning_apache_spark_tpu/utils/profiling.py``.

The reference's only instrumentation is ``time.time()`` pairs; this keeps
the JAX package's vocabulary with ``torch.profiler`` underneath: a device
trace of a region or of a window of training steps, written as one Chrome
trace (``<pid>.<ms>.pt.trace.json``, readable by Perfetto, chrome://tracing
and TensorBoard's profiler plugin) into ``log_dir``, and named annotations
that label host regions inside the trace and, when telemetry is on, on the
event log.

The profiler records the host's operator calls and, on the card, its
kernels (CUPTI). A replayed CUDA graph shows as a graph launch; whether
its kernels show one by one depends on the torch build's CUPTI
(``PERF.md`` records what the smoke's traces hold at 1 and at 4 steps per
call). The device is synchronised before a trace stops, so the traced
work is in it.

Usage:
    with device_trace("/tmp/trace"):          # whole-region trace
        run_steps()

    fit(..., profile_dir="/tmp/trace")        # trace a step window mid-run

    with annotate("tokenize"):                # label host work in the trace
        pipe(texts)
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from machine_learning_apache_spark_tpu_torch.telemetry import spans as _spans
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _sync_device() -> None:
    """Wait for the work already queued on the card, so the trace stops
    after the traced work rather than while it is in flight."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _start_trace() -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof: profile, log_dir: str) -> str:
    """Stop ``prof`` after the device drains; write its Chrome trace into
    ``log_dir`` and return the file's path."""
    try:
        _sync_device()
    finally:
        prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed region into ``log_dir``; yields the profiler
    (``key_averages()`` and ``events()`` stay readable after the block)."""
    prof = _start_trace()
    try:
        yield prof
    finally:
        path = _stop_trace(prof, log_dir)
        log.info("profiler trace written to %s", path)


class _AnnotatedRegion:
    """A ``torch.profiler.record_function`` (the trace's timeline) paired
    with a telemetry span (the host event log): one entry point, the
    region shows up in both. The span is the shared no-op when telemetry
    is off."""

    __slots__ = ("_trace", "_span")

    def __init__(self, name: str, **kwargs):
        self._trace = record_function(name)
        self._span = _spans.span(name, **kwargs)

    def __enter__(self):
        self._span.__enter__()
        self._trace.__enter__()
        return self

    def __exit__(self, *exc):
        self._trace.__exit__(*exc)
        self._span.__exit__(*exc)


def annotate(name: str, **kwargs):
    """Named region on the trace timeline (and, when telemetry is on, a
    span on the event log)."""
    return _AnnotatedRegion(name, **kwargs)


def step_annotation(step: int):
    """Marks one training step on the trace timeline (``train_step#<n>``)."""
    return record_function(f"train_step#{step}")


class StepWindowTracer:
    """Trace a ``[start, stop)`` window of steps inside a long run: skip
    the first steps (the captures of a K-step run), take a few steady
    ones, stop before the trace grows large. ``log_dir`` None does
    nothing. ``close()`` stops a running trace; ``fit`` calls it in its
    ``finally``, so an exception inside the window never leaves the
    profiler running."""

    def __init__(self, log_dir: str | None, *, start: int = 2, stop: int = 5):
        if stop <= start:
            raise ValueError(f"empty trace window [{start}, {stop})")
        self.log_dir = log_dir
        self.start, self.stop = start, stop
        self.path: str | None = None
        self._prof: profile | None = None
        self._done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    def on_step(self, step: int) -> None:
        """Called with the step about to run. Boundary-crossing (``>=``),
        not equality: a K-step call advances the counter K at a time and
        must still enter and leave the window. The stop check applies only
        while tracing, so one stride over both boundaries still starts a
        trace (covering at least its own call; the next call ends it)."""
        if self.log_dir is None:
            return
        if self.active and step >= self.stop:
            self.close()
            return
        if not self.active and not self._done and step >= self.start:
            self._prof = _start_trace()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._done = True
        self.path = _stop_trace(prof, self.log_dir)
        log.info(
            "profiler trace (steps %d-%d) written to %s",
            self.start, self.stop, self.path,
        )
