"""telemetry/ — the observability core the serving slice emits through.

- :mod:`~.events` — lock-protected, bounded in-process event log
  (span start/stop, counter, gauge, annotation) with JSONL export;
- :mod:`~.spans` — nested trace spans (context manager + decorator);
- :mod:`~.registry` — process-global counters/gauges/histograms with
  ``snapshot()`` and Prometheus text export;
- :mod:`~.tracectx` — W3C-style trace contexts carried across threads.

``MLSPARK_TELEMETRY=0`` turns every entry point into a no-op singleton.
All submodules are stdlib-only. The HTTP server, flight recorder and
gang aggregation of the JAX package are not ported yet (ROADMAP).
"""

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events_mod
from machine_learning_apache_spark_tpu_torch.telemetry import (
    registry as _registry_mod,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as _tracectx_mod,
)
from machine_learning_apache_spark_tpu_torch.telemetry.events import (
    ENV_TELEMETRY,
    ENV_TELEMETRY_DIR,
    Event,
    EventLog,
    annotate,
    enabled,
    get_log,
    set_enabled,
    telemetry_dir,
)
from machine_learning_apache_spark_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)
from machine_learning_apache_spark_tpu_torch.telemetry.spans import (
    Timer,
    current_span_id,
    span,
    timed_span,
    traced,
)
from machine_learning_apache_spark_tpu_torch.telemetry.tracectx import (
    ENV_TRACE,
    ENV_TRACE_SAMPLE,
    TraceContext,
    trace_enabled,
)


def reset() -> None:
    """Drop ALL process-global telemetry state (event log, registry,
    cached enabled flag, trace-context caches) — test hook."""
    _tracectx_mod.reset()
    _events_mod.reset()
    _registry_mod.reset()


__all__ = [
    "ENV_TELEMETRY",
    "ENV_TELEMETRY_DIR",
    "ENV_TRACE",
    "ENV_TRACE_SAMPLE",
    "Event",
    "EventLog",
    "MetricsRegistry",
    "Timer",
    "TraceContext",
    "annotate",
    "current_span_id",
    "enabled",
    "get_log",
    "get_registry",
    "reset",
    "set_enabled",
    "span",
    "telemetry_dir",
    "timed_span",
    "trace_enabled",
    "traced",
]
