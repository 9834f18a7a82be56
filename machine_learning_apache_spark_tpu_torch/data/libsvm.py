"""libsvm format reader/writer — the port of
``machine_learning_apache_spark_tpu/data/libsvm.py``.

The reference ingests ``sample_multiclass_classification_data.txt`` via
``spark.read.format("libsvm").load(path)``
(``mllib_multilayer_perceptron_classifier.py:22-23``): lines of
``<label> <index>:<value> ...`` with 1-based sparse indices, materialized as
4-feature/3-class dense rows (``pytorch_multilayer_perceptron.py:56-66``).

Two host parsers, as in the JAX package: the C++ one (``native``'s
``libsvm_parser.cpp``, built at first use), picked automatically when it
builds, and the pure-Python one. Both give the same arrays.
"""

from __future__ import annotations

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.frame import ArrayFrame


def _parse_python(text: str) -> tuple[np.ndarray, np.ndarray, int]:
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_index = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        try:
            labels.append(float(parts[0]))
            row: list[tuple[int, float]] = []
            for item in parts[1:]:
                idx_s, val_s = item.split(":", 1)
                idx = int(idx_s)
                if idx < 1:
                    raise ValueError(f"libsvm indices are 1-based, got {idx}")
                row.append((idx, float(val_s)))
                max_index = max(max_index, idx)
            rows.append(row)
        except (ValueError, IndexError) as e:
            raise ValueError(f"malformed libsvm line {lineno}: {line!r}") from e
    n = len(rows)
    dense = np.zeros((n, max_index), dtype=np.float32)
    for i, row in enumerate(rows):
        for idx, val in row:
            dense[i, idx - 1] = val
    return dense, np.asarray(labels), max_index


def read_libsvm(
    path: str, *, num_features: int | None = None, use_native: bool | None = None
) -> ArrayFrame:
    """Read a libsvm file into a dense ArrayFrame.

    ``num_features`` pads/validates the feature dimension (Spark's
    ``numFeatures`` option). ``use_native=None`` picks the C++ parser when
    it builds and the Python one otherwise; ``True`` requires the C++ one
    (raising ``ImportError`` if it cannot be built), ``False`` takes the
    Python one."""
    if use_native is None or use_native:
        try:
            from machine_learning_apache_spark_tpu_torch.native import libsvm_native

            result = libsvm_native.parse_file(path)
        except (ImportError, OSError):
            if use_native:
                raise
            result = None
        if result is not None:
            features, labels = result
            return _finalize(features, labels, num_features)

    with open(path) as f:
        features, labels, _ = _parse_python(f.read())
    return _finalize(features, labels, num_features)


def _finalize(
    features: np.ndarray, labels: np.ndarray, num_features: int | None
) -> ArrayFrame:
    if num_features is not None:
        if features.shape[1] > num_features:
            raise ValueError(
                f"file has feature index {features.shape[1]} > num_features={num_features}"
            )
        if features.shape[1] < num_features:
            pad = np.zeros(
                (features.shape[0], num_features - features.shape[1]), np.float32
            )
            features = np.concatenate([features, pad], axis=1)
    # Labels in the MLlib sample are 0/1/2 floats; store as int64 class ids
    # (the bridge at pytorch_multilayer_perceptron.py:66 does .long()).
    return ArrayFrame(features.astype(np.float32), labels.astype(np.int64))


def write_libsvm(path: str, features: np.ndarray, labels: np.ndarray) -> None:
    """Write dense rows in libsvm format (1-based indices, zeros skipped)."""
    with open(path, "w") as f:
        for row, label in zip(np.asarray(features), np.asarray(labels)):
            items = " ".join(
                f"{i + 1}:{v:.6g}" for i, v in enumerate(row) if v != 0.0
            )
            lbl = f"{float(label):g}"
            f.write(f"{lbl} {items}\n".rstrip() + "\n")
