"""mllib — the Spark-MLlib-parity baseline engine (reference C1); the port
of ``machine_learning_apache_spark_tpu/mllib``.

The reference's ``mllib_multilayer_perceptron_classifier.py`` trains a
JVM-native MLP with breeze L-BFGS and evaluates accuracy via
``MulticlassClassificationEvaluator``. This module provides the same
estimator/transformer/evaluator API over the port's compute path, with
optax's L-BFGS written out in torch (``mllib.lbfgs``).
"""

from machine_learning_apache_spark_tpu_torch.mllib.classifier import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
    PredictionFrame,
)
from machine_learning_apache_spark_tpu_torch.mllib.evaluation import (
    MulticlassClassificationEvaluator,
)

__all__ = [
    "MultilayerPerceptronClassifier",
    "MultilayerPerceptronClassificationModel",
    "MulticlassClassificationEvaluator",
    "PredictionFrame",
]
