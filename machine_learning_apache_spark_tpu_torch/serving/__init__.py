"""Request-level serving layer: a bounded admission queue (``queue``), a
token-budget admission picker (``batcher.TokenBudgetBatcher``), a
refcounted page pool and prefix cache (``kv_pages``), the row pool
(``kv_slots``), the latency/throughput ledger (``metrics``), the paged
decode runtime on the device (``paged_runtime``) and the engine that
drives them (``engine``). Entry point: ``Translator.serve()``.

The names load on first use, as ``launcher``'s do: the host-only modules
(``queue``, ``metrics``) import without torch, so the fleet's router and
the report tools (``telemetry.aggregate`` reads ``metrics``) start in a
fraction of a second.
"""

import importlib

_EXPORTS = {
    "Batch": "batcher",
    "Batcher": "batcher",
    "TokenBudgetBatcher": "batcher",
    "EngineStopped": "engine",
    "InternalError": "engine",
    "ServingEngine": "engine",
    "NULL_PAGE": "kv_pages",
    "KVPagePool": "kv_pages",
    "PrefixCache": "kv_pages",
    "prefix_digest": "kv_pages",
    "KVSlotPool": "kv_slots",
    "Histogram": "metrics",
    "ServingMetrics": "metrics",
    "PagedDecodeRuntime": "paged_runtime",
    "Backpressure": "queue",
    "DeadlineExceeded": "queue",
    "RequestQueue": "queue",
    "ServeRequest": "queue",
}


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)


__all__ = [
    "Backpressure",
    "Batch",
    "Batcher",
    "DeadlineExceeded",
    "EngineStopped",
    "Histogram",
    "InternalError",
    "KVPagePool",
    "KVSlotPool",
    "NULL_PAGE",
    "PagedDecodeRuntime",
    "PrefixCache",
    "RequestQueue",
    "ServeRequest",
    "ServingEngine",
    "ServingMetrics",
    "TokenBudgetBatcher",
    "prefix_digest",
]
