"""Attention, masks, positional encodings and the Hopper kernels."""

from machine_learning_apache_spark_tpu_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    ragged_paged_attention,
    scaled_dot_product_attention,
)
from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import (
    LAUNCHES,
    flash_attention,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "NEG_INF",
    "dot_product_attention",
    "flash_attention",
    "ragged_paged_attention",
    "reset_launches",
    "scaled_dot_product_attention",
]
