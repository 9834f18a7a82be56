"""parallel — the mesh and data parallelism; the port of
``machine_learning_apache_spark_tpu/parallel``.

Data parallelism over a ``torch.distributed`` process group (the
reference's only strategy): the replicated step (DDP) and ZeRO-1
(``parallel.zero``: reduce-scatter, the rank's shard updated,
all-gather); tensor parallelism over the mesh's ``"model"`` axis
(``parallel.tensor_parallel``, Megatron-style), alone or on a hybrid
``data × model`` mesh with either; pipeline parallelism over the
``"pipeline"`` axis (``parallel.pipeline_parallel``: GPipe over
point-to-point hops, one stage a rank; ``parallel.pipeline_transformer``
for the encoder-decoder Transformer), alone or on ``data × pipeline``;
sequence parallelism over the ``"seq"`` axis (``parallel.sequence``:
ring attention, ``parallel.ring_attention``, or Ulysses all-to-alls,
``parallel.ulysses_attention``, under ``ops.attention.
sequence_parallel``), alone or beside the data, model and expert axes
(on each model rank's heads); expert parallelism over the ``"expert"``
axis (``parallel.expert_parallel``: each rank of an expert line runs its
share of every MoE layer's experts), alone, on ``data × expert`` or
beside the model axis. A seq axis beside a pipeline axis raises the JAX
recipe's ``ValueError``.
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
from machine_learning_apache_spark_tpu_torch.parallel.expert_parallel import (
    EPComms,
    ExpertAxis,
    copy_to_expert,
    reduce_from_expert,
)
from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import pipeline_apply
from machine_learning_apache_spark_tpu_torch.parallel.ring_attention import ring_attention
from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_parallel_attention
from machine_learning_apache_spark_tpu_torch.parallel.ulysses_attention import ulysses_attention
from machine_learning_apache_spark_tpu_torch.parallel.pipeline_transformer import (
    pipeline_transformer_logits,
)
from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
    DEFAULT_RULES,
    gather_params,
    logical_to_mesh_spec,
    shard_params,
    shard_state,
)
from machine_learning_apache_spark_tpu_torch.parallel.zero import (
    COMMS_DTYPES,
    DEFAULT_BUCKET_BYTES,
    DP_MODES,
    Zero1Config,
    Zero1State,
    comms_bytes_per_step,
    init_sharded,
    make_flat_plan,
    make_zero1_step,
    opt_state_bytes,
    opt_state_bytes_per_chip,
    plan_layout,
    resolve_dp_mode,
    shard_optimizer_state,
)

__all__ = [
    "COMMS_DTYPES",
    "DEFAULT_RULES",
    "DEFAULT_BUCKET_BYTES",
    "DP_MODES",
    "DATA_AXIS",
    "EPComms",
    "EXPERT_AXIS",
    "ExpertAxis",
    "MODEL_AXIS",
    "Mesh",
    "Zero1Config",
    "Zero1State",
    "PIPELINE_AXIS",
    "SEQ_AXIS",
    "assert_replicas_in_sync",
    "batch_sharding",
    "comms_bytes_per_step",
    "copy_to_expert",
    "data_model_mesh",
    "data_parallel_mesh",
    "gather_params",
    "init_sharded",
    "logical_to_mesh_spec",
    "make_data_parallel_eval_step",
    "make_data_parallel_step",
    "make_flat_plan",
    "make_mesh",
    "make_zero1_step",
    "opt_state_bytes",
    "opt_state_bytes_per_chip",
    "pad_batch_to_multiple",
    "params_fingerprint",
    "pipeline_apply",
    "pipeline_transformer_logits",
    "plan_layout",
    "process_count",
    "process_index",
    "reduce_from_expert",
    "replicate",
    "replicated_sharding",
    "resolve_dp_mode",
    "ring_attention",
    "sequence_parallel_attention",
    "shard_batch",
    "shard_optimizer_state",
    "shard_params",
    "shard_state",
    "ulysses_attention",
]
