"""Request-level serving layer: a bounded admission queue (``queue``), a
token-budget admission picker (``batcher.TokenBudgetBatcher``), a
refcounted page pool and prefix cache (``kv_pages``), the row pool
(``kv_slots``), the latency/throughput ledger (``metrics``), the paged
decode runtime on the device (``paged_runtime``) and the engine that
drives them (``engine``). Entry point: ``Translator.serve()``.
"""

from machine_learning_apache_spark_tpu_torch.serving.batcher import (
    Batch,
    Batcher,
    TokenBudgetBatcher,
)
from machine_learning_apache_spark_tpu_torch.serving.engine import (
    EngineStopped,
    InternalError,
    ServingEngine,
)
from machine_learning_apache_spark_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    KVPagePool,
    PrefixCache,
    prefix_digest,
)
from machine_learning_apache_spark_tpu_torch.serving.kv_slots import KVSlotPool
from machine_learning_apache_spark_tpu_torch.serving.metrics import (
    Histogram,
    ServingMetrics,
)
from machine_learning_apache_spark_tpu_torch.serving.paged_runtime import (
    PagedDecodeRuntime,
)
from machine_learning_apache_spark_tpu_torch.serving.queue import (
    Backpressure,
    DeadlineExceeded,
    RequestQueue,
    ServeRequest,
)

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
