"""parallel — the mesh and data parallelism; the port of
``machine_learning_apache_spark_tpu/parallel``.

Data parallelism over a ``torch.distributed`` process group is what the
port runs (the reference's only strategy). The JAX package's ZeRO-1,
tensor, pipeline, ring and Ulysses parallelism are ROADMAP A4; a mesh
axis for them larger than 1 raises ``NotImplementedError``.
"""

from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import (
    assert_replicas_in_sync,
    make_data_parallel_eval_step,
    make_data_parallel_step,
    pad_batch_to_multiple,
    params_fingerprint,
)
from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQ_AXIS,
    Mesh,
    batch_sharding,
    data_model_mesh,
    data_parallel_mesh,
    make_mesh,
    process_count,
    process_index,
    replicate,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "PIPELINE_AXIS",
    "SEQ_AXIS",
    "assert_replicas_in_sync",
    "batch_sharding",
    "data_model_mesh",
    "data_parallel_mesh",
    "make_data_parallel_eval_step",
    "make_data_parallel_step",
    "make_mesh",
    "pad_batch_to_multiple",
    "params_fingerprint",
    "process_count",
    "process_index",
    "replicate",
    "replicated_sharding",
    "shard_batch",
]
