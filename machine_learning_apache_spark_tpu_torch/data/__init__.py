"""Text pipeline and bucketing rule the serving slice needs."""

from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    PAD_ID,
    SOS_ID,
    UNK_ID,
    TextPipeline,
    Vocab,
)

__all__ = ["EOS_ID", "PAD_ID", "SOS_ID", "UNK_ID", "TextPipeline", "Vocab"]
