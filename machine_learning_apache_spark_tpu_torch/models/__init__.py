"""Model zoo of the port: the encoder-decoder MT Transformer."""

from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    greedy_translate,
)

__all__ = ["Transformer", "TransformerConfig", "greedy_translate"]
