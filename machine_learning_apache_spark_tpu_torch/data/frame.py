"""ArrayFrame — the minimal DataFrame stand-in at the ingestion boundary;
the port of ``machine_learning_apache_spark_tpu/data/frame.py``.

The reference's ingestion hands a Spark DataFrame upward, whose only consumed
operations are ``randomSplit`` (``mllib_multilayer_perceptron_classifier.py:27``),
``.toPandas()`` + per-row densify (``pytorch_multilayer_perceptron.py:56-66``),
and ``count``. ArrayFrame holds dense host arrays (features, labels) and
provides exactly that surface; "toPandas→stack" collapses into ``arrays()``
because data is already dense and columnar. ``random_split`` draws the
JAX package's permutation (numpy's ``default_rng(seed)``), so both
packages split a frame row for row alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArrayFrame:
    """Columnar (features, labels) with Spark-DataFrame-shaped helpers."""

    features: np.ndarray
    labels: np.ndarray

    def __post_init__(self) -> None:
        if len(self.features) != len(self.labels):
            raise ValueError(
                f"features/labels length mismatch: {len(self.features)} vs {len(self.labels)}"
            )

    def __len__(self) -> int:
        return len(self.labels)

    def count(self) -> int:
        return len(self)

    @property
    def num_features(self) -> int:
        return int(self.features.shape[-1])

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1 if len(self.labels) else 0

    def random_split(
        self, weights: list[float], seed: int = 0
    ) -> list["ArrayFrame"]:
        """``DataFrame.randomSplit(weights, seed)`` equivalent
        (``mllib_multilayer_perceptron_classifier.py:27`` uses
        ``[0.6, 0.4], seed=1234``): shuffle once, split by normalized
        weights."""
        total = float(sum(weights))
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        out: list[ArrayFrame] = []
        start = 0
        for i, w in enumerate(weights):
            if i == len(weights) - 1:
                stop = len(self)
            else:
                stop = start + int(round(len(self) * w / total))
            idx = perm[start:stop]
            out.append(ArrayFrame(self.features[idx], self.labels[idx]))
            start = stop
        return out

    randomSplit = random_split

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The Spark→tensor bridge endpoint (reference C10): dense float32
        features + int64 labels, ready for the device."""
        return (
            np.asarray(self.features, dtype=np.float32),
            np.asarray(self.labels, dtype=np.int64),
        )
