"""Ingestion (``frame``, ``libsvm``, ``reader``, ``datasets``), the text
pipeline, length bucketing, sequence packing, and the sampler and loader
of training."""

from machine_learning_apache_spark_tpu_torch.data.packing import (
    PackedPairs,
    pack_translation_pairs,
)
from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    PAD_ID,
    SOS_ID,
    UNK_ID,
    TextPipeline,
    Vocab,
)

__all__ = [
    "EOS_ID",
    "PAD_ID",
    "PackedPairs",
    "SOS_ID",
    "UNK_ID",
    "TextPipeline",
    "Vocab",
    "pack_translation_pairs",
]
