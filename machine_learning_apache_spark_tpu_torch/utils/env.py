"""Central ``MLSPARK_*`` environment contract — the env registry.

Every environment variable this package reads is declared here once,
with its type, default, subsystem, and a one-line description. Runtime
code resolves values through the typed accessors (``get_str`` /
``get_int`` / ``get_float`` / ``get_bool``) instead of raw ``os.environ``
reads, so a malformed value raises one uniform ``ValueError`` naming the
variable and its expected type.

The port declares only the variables its modules read; the names and
meanings are the JAX package's, so one environment drives either
package. Stdlib-only module body.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping, MutableMapping

__all__ = [
    "EnvVar",
    "REGISTRY",
    "register",
    "lookup",
    "registered_names",
    "is_set",
    "raw",
    "get_str",
    "get_int",
    "get_float",
    "get_bool",
    "put_into",
]

_UNSET = object()

#: Values ``get_bool`` reads as False; anything else set is True. Matches
#: the historical ``MLSPARK_TELEMETRY=0`` semantics in telemetry.events.
FALSY = ("0", "false", "off", "no", "")


@dataclass(frozen=True)
class EnvVar:
    """One declared environment variable: the contract row."""

    name: str
    type: str  # "str" | "int" | "float" | "bool" | "path" | "spec"
    default: Any
    subsystem: str
    description: str
    choices: tuple[str, ...] | None = None


REGISTRY: dict[str, EnvVar] = {}


def register(
    name: str,
    *,
    type: str,
    default: Any,
    subsystem: str,
    description: str,
    choices: tuple[str, ...] | None = None,
) -> EnvVar:
    """Declare one variable. Names must be unique and ``MLSPARK_``-prefixed."""
    if not name.startswith("MLSPARK_"):
        raise ValueError(f"env contract covers MLSPARK_* names only, got {name!r}")
    if name in REGISTRY:
        raise ValueError(f"duplicate env registration: {name}")
    if type not in ("str", "int", "float", "bool", "path", "spec"):
        raise ValueError(f"{name}: unknown type {type!r}")
    var = EnvVar(name, type, default, subsystem, description, choices)
    REGISTRY[name] = var
    return var


# -- the contract ------------------------------------------------------------

# core / platform bootstrap
register(
    "MLSPARK_PLATFORM", type="str", default=None, subsystem="core",
    description="Where a gang's ranks run: `cpu` (the host, gloo) or "
    "`cuda`; unset means the card. Set by Distributor(platform=...).",
)

# launcher / rendezvous / gang liveness (also read for the rank label in
# logs and telemetry, and by DistributedSampler for its default rank and
# world)
register(
    "MLSPARK_COORDINATOR", type="str", default=None, subsystem="launcher",
    description="Rendezvous coordinator `host:port` the launcher writes "
    "into every worker (maps onto torch.distributed.init_process_group "
    "over tcp://; MASTER_ADDR/MASTER_PORT are the torch-style aliases).",
)
register(
    "MLSPARK_GANG_ATTEMPT", type="int", default=0, subsystem="launcher",
    description="Which all-or-nothing gang restart attempt this worker "
    "belongs to (0 on the first launch).",
)
register(
    "MLSPARK_GANG_RUN", type="str", default=None, subsystem="launcher",
    description="Id of the Distributor.run call this worker belongs to, "
    "the same on every retried attempt. A recipe's checkpoints carry it, "
    "so a retried attempt finishes the interrupted run instead of "
    "training its epochs again.",
)
register(
    "MLSPARK_HEARTBEAT_FILE", type="path", default=None, subsystem="launcher",
    description="Per-rank heartbeat file the worker rewrites every "
    "interval; the GangMonitor's liveness signal (mtime) and "
    "gang-status payload (JSON content).",
)
register(
    "MLSPARK_HEARTBEAT_INTERVAL", type="float", default=1.0, subsystem="launcher",
    description="Seconds between heartbeat rewrites.",
)
register(
    "MLSPARK_NUM_PROCESSES", type="int", default=1, subsystem="launcher",
    description="Gang world size as this worker sees it (WORLD_SIZE "
    "analogue; shrinks under elastic resume).",
)
register(
    "MLSPARK_PROCESS_ID", type="int", default=0, subsystem="launcher",
    description="This worker's gang rank (RANK analogue); also the rank "
    "label telemetry and fault plans key on.",
)
register(
    "MLSPARK_ELASTIC", type="bool", default=False, subsystem="launcher",
    description="Set by Distributor(elastic=True): workers' fit() "
    "reshards old-topology checkpoints onto a shrunken mesh instead of "
    "refusing them (train/reshard.py).",
)

# session (SessionConfig fields read through ConfigBase.from_env's
# MLSPARK_ prefix; `mlspark-submit` writes these two)
register(
    "MLSPARK_APP_NAME", type="str", default="mlspark-tpu", subsystem="session",
    description="Session app name (`spark.app.name` analogue; set by "
    "`mlspark-submit --name`).",
)
register(
    "MLSPARK_EXECUTOR_INSTANCES", type="int", default=0, subsystem="session",
    description="Requested world size (`spark.executor.instances` "
    "analogue). 0 derives from the process group.",
)

# parallel / comms
register(
    "MLSPARK_DP_MODE", type="str", default="replicated", subsystem="parallel",
    description="Data-parallel update mode for fit() when dp_mode= is not "
    "passed.", choices=("replicated", "zero1"),
)
register(
    "MLSPARK_ZERO1_BUCKET_BYTES", type="int", default=4194304, subsystem="parallel",
    description="ZeRO-1 bucket size in bytes (the comm/compute overlap "
    "pipeline grain).",
)
register(
    "MLSPARK_ZERO1_OVERLAP", type="bool", default=True, subsystem="parallel",
    description="Per-bucket update/allgather overlap schedule on (default) "
    "or off (serial reference path; bit-identical either way).",
)
register(
    "MLSPARK_COMMS_DTYPE", type="str", default="float32", subsystem="parallel",
    description="ZeRO-1 wire dtype for reduce-scatter/allgather "
    "(sub-fp32 shrinks bytes; int8 uses EQuARX-style per-bucket scales).",
    choices=("float32", "bfloat16", "int8"),
)

# serving
register(
    "MLSPARK_SERVE_KV_MODE", type="str", default="paged", subsystem="serving",
    description="KV-cache discipline for ServingEngine when kv_mode= is "
    "not passed: `paged` (ragged paged attention, the default) or "
    "`padded` (the per-bucket rectangle path; beam engines always take it).",
    choices=("padded", "paged"),
)

register(
    "MLSPARK_SERVE_KV_DTYPE", type="str", default="float32", subsystem="serving",
    description="Paged KV store dtype: `float32`, or `int8` with "
    "per-page scales (paged+greedy only; padded/beam engines reject it).",
    choices=("float32", "int8"),
)

# data
register(
    "MLSPARK_NO_NATIVE_TEXT", type="bool", default=False, subsystem="data",
    description="Force the pure-Python tokenizer/vocab paths even when the "
    "native extension builds (bit-identical fallback; used by parity tests).",
)

# telemetry (read directly by the stdlib-only telemetry modules)
register(
    "MLSPARK_TELEMETRY", type="bool", default=True, subsystem="telemetry",
    description="Master switch; `0` makes every telemetry entry point a "
    "no-op singleton (zero cost, zero threads).",
)

register(
    "MLSPARK_TELEMETRY_DIR", type="path", default=None, subsystem="telemetry",
    description="Where rank JSONL exports, flight dumps, and port "
    "sidecars land; unset means no file exports.",
)

register(
    "MLSPARK_TELEMETRY_HTTP", type="int", default=None, subsystem="telemetry",
    description="Port for the per-process observability HTTP server "
    "(/metrics, /healthz, /statusz, /flightz); 0 = ephemeral; unset = no "
    "server, zero threads.",
)

register(
    "MLSPARK_TELEMETRY_EVENTS", type="int", default=4096, subsystem="telemetry",
    description="Flight-recorder event-ring capacity (events kept for "
    "/flightz and crash dumps).",
)

register(
    "MLSPARK_TRACE", type="bool", default=True, subsystem="telemetry",
    description="Distributed tracing switch: mint/propagate trace "
    "contexts across router -> replica -> engine hops (no-op whenever "
    "MLSPARK_TELEMETRY=0).",
)

register(
    "MLSPARK_TRACE_SAMPLE", type="float", default=1.0, subsystem="telemetry",
    description="Head-based trace sampling probability in [0, 1]; the "
    "decision is made once per request at the router/engine entry point "
    "and inherited by every hop.",
)

# ingest
register(
    "MLSPARK_INGEST_BUFFER", type="int", default=2, subsystem="ingest",
    description="Host-side prefetch depth in batches (0 = synchronous "
    "batch assembly).",
)
register(
    "MLSPARK_INGEST_DEVICE_PREFETCH", type="int", default=2, subsystem="ingest",
    description="Batches kept resident on-device ahead of consumption "
    "(double buffering at 2; 0 disables the device stage).",
)
register(
    "MLSPARK_INGEST_TAIL", type="str", default="pad", subsystem="ingest",
    description="Epoch-tail policy: `pad` (collective-safe wrap-pad) or "
    "`drop`.", choices=("pad", "drop"),
)
register(
    "MLSPARK_INGEST_CHUNK_LINES", type="int", default=1024, subsystem="ingest",
    description="Lines per parser call in the streaming file readers "
    "(native-parser batching grain).",
)

# fleet / multi-replica serving
register(
    "MLSPARK_FLEET_DIR", type="path", default=None, subsystem="fleet",
    description="Where fleet sidecars (`fleet_rank<k>.json`) and the "
    "`fleet_stop` marker live; defaults to the telemetry dir.",
)
register(
    "MLSPARK_FLEET_PORT", type="int", default=0, subsystem="fleet",
    description="Replica data-plane port (0 = ephemeral, the only sane "
    "choice for a local gang).",
)
register(
    "MLSPARK_FLEET_POLICY", type="str", default="affinity", subsystem="fleet",
    description="Router dispatch policy when policy= is not passed.",
    choices=("round_robin", "least_loaded", "affinity"),
)
register(
    "MLSPARK_FLEET_SCRAPE_INTERVAL", type="float", default=0.5, subsystem="fleet",
    description="Router scrape-loop period in seconds (replica /statusz "
    "polling).",
)
register(
    "MLSPARK_FLEET_TENANT_MAX_IN_FLIGHT", type="int", default=None, subsystem="fleet",
    description="Per-tenant in-flight admission quota (unset = no tenant "
    "quota).",
)
register(
    "MLSPARK_FLEET_INTERACTIVE_DEADLINE_S", type="float", default=10.0, subsystem="fleet",
    description="Default deadline for the `interactive` SLO tier.",
)
register(
    "MLSPARK_FLEET_INTERACTIVE_MAX_IN_FLIGHT", type="int", default=64, subsystem="fleet",
    description="In-flight cap for the `interactive` SLO tier.",
)
register(
    "MLSPARK_FLEET_BATCH_DEADLINE_S", type="float", default=120.0, subsystem="fleet",
    description="Default deadline for the `batch` SLO tier.",
)
register(
    "MLSPARK_FLEET_BATCH_MAX_IN_FLIGHT", type="int", default=256, subsystem="fleet",
    description="In-flight cap for the `batch` SLO tier.",
)
register(
    "MLSPARK_FLEET_HEDGE", type="bool", default=False, subsystem="fleet",
    description="Enable straggler hedging: after the hedge delay, the "
    "router issues a duplicate dispatch to a second healthy replica; "
    "first response wins, the loser is cancelled via /v1/cancel.",
)
register(
    "MLSPARK_FLEET_HEDGE_TIERS", type="str", default="interactive", subsystem="fleet",
    description="Comma-separated SLO tiers eligible for hedging "
    "(latency-sensitive tiers only by default; batch work rides the "
    "plain retry taxonomy).",
)
register(
    "MLSPARK_FLEET_HEDGE_DELAY_FACTOR", type="float", default=3.0, subsystem="fleet",
    description="Hedge delay as a multiple of the admission layer's "
    "observed service-time EWMA — a dispatch outstanding this much "
    "longer than typical is presumed straggling.",
)
register(
    "MLSPARK_FLEET_HEDGE_MIN_DELAY_S", type="float", default=0.05, subsystem="fleet",
    description="Floor on the hedge delay, so a cold or noisy EWMA "
    "cannot make every request fan out twice.",
)

# fleet autoscaling (closed loop: SLO burn / queue depth -> replica count)
register(
    "MLSPARK_AUTOSCALE_MIN_REPLICAS", type="int", default=1, subsystem="autoscale",
    description="Floor on the autoscaler's replica target; scale-down "
    "never drains below this.",
)
register(
    "MLSPARK_AUTOSCALE_MAX_REPLICAS", type="int", default=8, subsystem="autoscale",
    description="Ceiling on the autoscaler's replica target; scale-up "
    "never spawns past this.",
)
register(
    "MLSPARK_AUTOSCALE_BURN_UP", type="float", default=0.1, subsystem="autoscale",
    description="Scale up when any tier's SLO burn EWMA (scraped replica "
    "rollup or router-side gauge) is at/above this miss fraction.",
)
register(
    "MLSPARK_AUTOSCALE_BURN_DOWN", type="float", default=0.01, subsystem="autoscale",
    description="Burn EWMA must be at/below this before the load signal "
    "may vote to scale down (both signals must be cold).",
)
register(
    "MLSPARK_AUTOSCALE_QUEUE_UP", type="float", default=4.0, subsystem="autoscale",
    description="Scale up when mean in-flight per healthy replica is "
    "at/above this depth.",
)
register(
    "MLSPARK_AUTOSCALE_QUEUE_DOWN", type="float", default=1.0, subsystem="autoscale",
    description="Mean in-flight per healthy replica must be at/below "
    "this before a scale-down vote counts.",
)
register(
    "MLSPARK_AUTOSCALE_HYSTERESIS_TICKS", type="int", default=2, subsystem="autoscale",
    description="Consecutive scrape ticks a signal must hold before the "
    "autoscaler acts on it (one bad scrape cannot thrash the fleet).",
)
register(
    "MLSPARK_AUTOSCALE_COOLDOWN_S", type="float", default=5.0, subsystem="autoscale",
    description="Minimum seconds between autoscale actions (either "
    "direction); the anti-thrash backstop behind hysteresis.",
)
register(
    "MLSPARK_AUTOSCALE_DRAIN_DEADLINE_S", type="float", default=30.0, subsystem="autoscale",
    description="Seconds a draining replica gets to retire its in-flight "
    "work before it is torn down anyway.",
)
register(
    "MLSPARK_AUTOSCALE_DRAIN_BATCH_SHED", type="float", default=0.5, subsystem="autoscale",
    description="While a drain is in progress the batch tier's admission "
    "budget is multiplied by this factor (interactive is untouched) so "
    "shed capacity comes out of batch work first.",
)

# fault injection (read directly by the stdlib-only utils.faults)
register(
    "MLSPARK_FAULTS", type="spec", default=None, subsystem="faults",
    description="Fault-injection plan (semicolon-separated grammar, see "
    "utils/faults.py): which site fails, on which rank/world/occurrence, "
    "and how.",
)
register(
    "MLSPARK_FAULTS_DIR", type="path", default=None, subsystem="faults",
    description="Where fault-marker files are written (evidence that an "
    "injected fault fired, robust to the process dying mid-action).",
)


# -- typed accessors ----------------------------------------------------------
def lookup(name: str) -> EnvVar:
    """The declaration for ``name``; raises ``KeyError`` with the fix for
    unregistered names (the runtime mirror of the lint rule)."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not in the MLSPARK_* env contract; declare it in "
            "machine_learning_apache_spark_tpu_torch/utils/env.py"
        ) from None


def registered_names() -> frozenset[str]:
    return frozenset(REGISTRY)


def raw(name: str, environ: Mapping[str, str] | None = None) -> str | None:
    """The unparsed value, or None when unset. Registry-checked."""
    lookup(name)
    env = os.environ if environ is None else environ
    return env.get(name)


def is_set(name: str, environ: Mapping[str, str] | None = None) -> bool:
    return raw(name, environ) is not None


def _resolve_default(var: EnvVar, default: Any) -> Any:
    return var.default if default is _UNSET else default


def get_str(
    name: str, default: Any = _UNSET, environ: Mapping[str, str] | None = None
) -> str | None:
    var = lookup(name)
    v = raw(name, environ)
    if v is None:
        return _resolve_default(var, default)
    if var.choices is not None and v not in var.choices:
        raise ValueError(
            f"{name} must be one of {list(var.choices)}, got {v!r}"
        )
    return v


def get_int(
    name: str, default: Any = _UNSET, environ: Mapping[str, str] | None = None
) -> int | None:
    var = lookup(name)
    v = raw(name, environ)
    if v is None:
        return _resolve_default(var, default)
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def get_float(
    name: str, default: Any = _UNSET, environ: Mapping[str, str] | None = None
) -> float | None:
    var = lookup(name)
    v = raw(name, environ)
    if v is None:
        return _resolve_default(var, default)
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a float, got {v!r}") from None


def get_bool(
    name: str, default: Any = _UNSET, environ: Mapping[str, str] | None = None
) -> bool:
    """Truthy unless the value is one of :data:`FALSY` (case-insensitive);
    unset resolves the default."""
    var = lookup(name)
    v = raw(name, environ)
    if v is None:
        return bool(_resolve_default(var, default))
    return v.strip().lower() not in FALSY


def put_into(
    env: MutableMapping[str, str], name: str, value: Any
) -> MutableMapping[str, str]:
    """Write one contract variable into a (worker) env mapping — the
    launcher-side half of the contract. Registry-checked so a typo'd name
    fails at the driver, not as a silently ignored variable in the gang."""
    var = lookup(name)
    s = str(value)
    if var.choices is not None and s not in var.choices:
        raise ValueError(
            f"{name} must be one of {list(var.choices)}, got {value!r}"
        )
    env[name] = s
    return env
