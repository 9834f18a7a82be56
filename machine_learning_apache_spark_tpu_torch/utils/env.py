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

# launcher (read for the rank label in logs and telemetry)
register(
    "MLSPARK_PROCESS_ID", type="int", default=0, subsystem="launcher",
    description="This worker's gang rank (RANK analogue); also the rank "
    "label telemetry and fault plans key on.",
)

# serving
register(
    "MLSPARK_SERVE_KV_MODE", type="str", default="paged", subsystem="serving",
    description="KV-cache discipline for ServingEngine when kv_mode= is "
    "not passed: `paged` (ragged paged attention, the default) or "
    "`padded` (the per-bucket rectangle path; not ported yet, raises).",
    choices=("padded", "paged"),
)

register(
    "MLSPARK_SERVE_KV_DTYPE", type="str", default="float32", subsystem="serving",
    description="Paged KV store dtype: `float32`, or `int8` with "
    "per-page scales (paged+greedy only; padded/beam engines reject it).",
    choices=("float32", "int8"),
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
