"""Model zoo of the port: the encoder-decoder MT Transformer and its
decoders (uncached greedy, KV-cache greedy, beam search, sampling)."""

from machine_learning_apache_spark_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
    beam_translate,
    greedy_translate,
    greedy_translate_cached,
    sample_translate,
)

__all__ = [
    "DecodeCache",
    "Transformer",
    "TransformerConfig",
    "beam_translate",
    "greedy_translate",
    "greedy_translate_cached",
    "sample_translate",
]
