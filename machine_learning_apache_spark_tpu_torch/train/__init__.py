"""Training: losses, metrics, the optimizer chain, the loop, checkpoints
and their elastic reshard (the port of the JAX package's ``train/``)."""

from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from machine_learning_apache_spark_tpu_torch.train.loop import (
    FitResult,
    classification_loss,
    evaluate,
    fit,
    make_eval_step,
    make_multi_step,
    make_train_step,
    select_last_valid,
)
from machine_learning_apache_spark_tpu_torch.train.losses import (
    cross_entropy,
    masked_token_cross_entropy,
)
from machine_learning_apache_spark_tpu_torch.train.reshard import (
    BucketLayout,
    TopologyMismatch,
    elastic_restore,
    gather_spec,
    reshard_flat,
    reshard_flat_oracle,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import (
    Mean,
    MetricBundle,
    Sum,
    accuracy,
    logits_accuracy,
)
from machine_learning_apache_spark_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_schedule,
)

__all__ = [
    "BucketLayout",
    "CheckpointManager",
    "Mean",
    "MetricBundle",
    "Sum",
    "TopologyMismatch",
    "accuracy",
    "elastic_restore",
    "gather_spec",
    "logits_accuracy",
    "reshard_flat",
    "reshard_flat_oracle",
    "FitResult",
    "TrainState",
    "classification_loss",
    "cross_entropy",
    "evaluate",
    "fit",
    "load_params",
    "make_eval_step",
    "make_multi_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "masked_token_cross_entropy",
    "save_params",
    "select_last_valid",
]
