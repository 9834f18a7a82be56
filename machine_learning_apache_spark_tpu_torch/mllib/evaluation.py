"""Evaluators — ``MulticlassClassificationEvaluator`` parity
(``mllib_multilayer_perceptron_classifier.py:44-48``); the port of
``machine_learning_apache_spark_tpu/mllib/evaluation.py`` (host numpy, as
there)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MulticlassClassificationEvaluator:
    metricName: str = "accuracy"

    def evaluate(self, frame) -> float:
        """``frame`` is a ``PredictionFrame`` (or anything with
        ``select("prediction", "label")``)."""
        if self.metricName not in ("accuracy", "f1"):
            raise ValueError(f"unknown metric {self.metricName!r}")
        preds, labels = frame.select("prediction", "label")
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        if self.metricName == "accuracy":
            return float((preds == labels).mean())
        if self.metricName == "f1":
            # macro-averaged F1 (MLlib's default f1 is weighted; macro is the
            # deliberate, documented choice here)
            scores = []
            for c in np.unique(labels):
                tp = ((preds == c) & (labels == c)).sum()
                fp = ((preds == c) & (labels != c)).sum()
                fn = ((preds != c) & (labels == c)).sum()
                denom = 2 * tp + fp + fn
                scores.append(2 * tp / denom if denom else 0.0)
            return float(np.mean(scores))
        raise AssertionError("unreachable: metricName validated above")
