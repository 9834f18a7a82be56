"""Model zoo of the port: the MLP, the TinyVGG CNN, the LSTM text
classifier, and the encoder-decoder MT Transformer with its decoders
(uncached greedy, KV-cache greedy, beam search, sampling) and its
mixture-of-experts FFN."""

from machine_learning_apache_spark_tpu_torch.models.cnn import (
    FashionMNISTModel,
    TinyVGG,
)
from machine_learning_apache_spark_tpu_torch.models.lstm import LSTMClassifier
from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
from machine_learning_apache_spark_tpu_torch.models.moe import MoEFeedForward
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
    "FashionMNISTModel",
    "LSTMClassifier",
    "MLP",
    "MoEFeedForward",
    "TinyVGG",
    "Transformer",
    "TransformerConfig",
    "beam_translate",
    "greedy_translate",
    "greedy_translate_cached",
    "sample_translate",
]
