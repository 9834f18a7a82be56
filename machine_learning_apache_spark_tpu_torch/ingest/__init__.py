"""ingest/ — async streaming input pipeline (the Spark-ingestion layer);
the port of ``machine_learning_apache_spark_tpu/ingest``.

The reference's premise is Spark feeding accelerator training; this
subsystem is that layer: sharded streaming readers (``readers``, the
port's native C++ parsers with pure-Python fallbacks), online sequence
packing in the loader thread (``packing``), weighted deterministic
mixture sampling (``mixture``), and the bounded prefetch-to-device
pipeline that ties them together (``pipeline``) —
``fit(data=StreamingPipeline(...))`` trains with batch k+1 copied to the
card on a side stream while step k runs.

Env contract: ``MLSPARK_INGEST_*`` (``config``), plumbed through the
launcher via ``Distributor(ingest={...})``. Telemetry: the ``data.*``
span/counter family, which ``telemetry.aggregate.ingest_report`` folds
into an input-bound/compute-bound verdict.
"""

from machine_learning_apache_spark_tpu_torch.ingest.config import (
    IngestConfig,
    validate_ingest_knobs,
)
from machine_learning_apache_spark_tpu_torch.ingest.mixture import MixtureSampler
from machine_learning_apache_spark_tpu_torch.ingest.packing import OnlinePacker
from machine_learning_apache_spark_tpu_torch.ingest.pipeline import (
    StreamingPipeline,
    WORKER_PREFIX,
    rescatter_stream_state,
)
from machine_learning_apache_spark_tpu_torch.ingest.readers import (
    ArraySource,
    CallableSource,
    EncodedTextSource,
    LibsvmStreamSource,
    PairSource,
    TextLineSource,
)

__all__ = [
    "ArraySource",
    "CallableSource",
    "EncodedTextSource",
    "IngestConfig",
    "LibsvmStreamSource",
    "MixtureSampler",
    "OnlinePacker",
    "PairSource",
    "StreamingPipeline",
    "TextLineSource",
    "WORKER_PREFIX",
    "rescatter_stream_state",
    "validate_ingest_knobs",
]
