"""telemetry/ — the port of ``machine_learning_apache_spark_tpu/telemetry``.

One subsystem every layer reports into:

- :mod:`~.events` — lock-protected, bounded in-process event log
  (span start/stop, counter, gauge, annotation) with JSONL export;
- :mod:`~.spans` — nested trace spans (context manager + decorator);
- :mod:`~.registry` — process-global counters/gauges/histograms with
  ``snapshot()`` and Prometheus text export;
- :mod:`~.tracectx` — W3C-style trace contexts carried across threads;
- :mod:`~.aggregate` — merge per-rank ``telemetry_rank<k>.jsonl`` files
  into per-phase p50/p99 tables, a rank-skew (straggler) report and the
  comms rollup;
- :mod:`~.recorder` — flight recorder: dump the last ~512 events to
  ``flight_<rank>.json`` at the moment of failure;
- :mod:`~.traceview` — per-rank event exports stitched into request
  trees (loaded on demand, not here);
- :mod:`~.http` — the live plane (``/metrics``, ``/healthz``,
  ``/statusz``, ``/flightz``, ``/tracez``).

``MLSPARK_TELEMETRY=0`` turns every entry point into a no-op singleton;
``MLSPARK_TELEMETRY_DIR`` is where rank exports and flight dumps land.
All submodules are stdlib-only — importable before torch (the launcher's
runner does exactly that).
"""

from machine_learning_apache_spark_tpu_torch.telemetry import (
    aggregate as _aggregate_mod,
)
from machine_learning_apache_spark_tpu_torch.telemetry import events as _events_mod
from machine_learning_apache_spark_tpu_torch.telemetry import http as _http_mod
from machine_learning_apache_spark_tpu_torch.telemetry import (
    registry as _registry_mod,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as _tracectx_mod,
)
from machine_learning_apache_spark_tpu_torch.telemetry.aggregate import (
    merge_gang_dir,
    render_markdown,
    write_rank_file,
)
from machine_learning_apache_spark_tpu_torch.telemetry.events import (
    ENV_TELEMETRY,
    ENV_TELEMETRY_DIR,
    Event,
    EventLog,
    annotate,
    beacon,
    beacon_update,
    enabled,
    get_log,
    set_enabled,
    telemetry_dir,
)
from machine_learning_apache_spark_tpu_torch.telemetry.http import (
    ENV_TELEMETRY_HTTP,
    TelemetryHTTPServer,
    get_http_server,
    register_health_provider,
    register_live_gauge,
    register_status_provider,
    start_http_server,
    stop_http_server,
    unregister_provider,
)
from machine_learning_apache_spark_tpu_torch.telemetry.recorder import (
    FLIGHT_CAPACITY,
    dump_flight,
    flight_path,
    load_flight,
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
    current_trace_context,
    trace_enabled,
)


def reset() -> None:
    """Drop ALL process-global telemetry state (event log, registry,
    cached enabled flag, beacon, HTTP server + providers, trace-context
    caches) — test hook."""
    _http_mod.reset()
    _tracectx_mod.reset()
    _events_mod.reset()
    _registry_mod.reset()
    _aggregate_mod.clear_parse_cache()


__all__ = [
    "ENV_TELEMETRY",
    "ENV_TELEMETRY_DIR",
    "ENV_TELEMETRY_HTTP",
    "ENV_TRACE",
    "ENV_TRACE_SAMPLE",
    "Event",
    "EventLog",
    "FLIGHT_CAPACITY",
    "MetricsRegistry",
    "TelemetryHTTPServer",
    "Timer",
    "TraceContext",
    "annotate",
    "beacon",
    "beacon_update",
    "current_span_id",
    "current_trace_context",
    "dump_flight",
    "enabled",
    "flight_path",
    "get_http_server",
    "get_log",
    "get_registry",
    "load_flight",
    "merge_gang_dir",
    "register_health_provider",
    "register_live_gauge",
    "register_status_provider",
    "render_markdown",
    "reset",
    "set_enabled",
    "span",
    "start_http_server",
    "stop_http_server",
    "telemetry_dir",
    "timed_span",
    "trace_enabled",
    "traced",
    "unregister_provider",
    "write_rank_file",
]
