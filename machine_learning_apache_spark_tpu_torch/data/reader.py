"""Spark-style reader: ``DataReader().format("libsvm").load(path)`` — the
port of ``machine_learning_apache_spark_tpu/data/reader.py``.

Mirrors the ingestion call at ``mllib_multilayer_perceptron_classifier.py:22-23``.
Supported formats: ``libsvm`` (dense ArrayFrame), ``npz`` (features/labels
arrays saved by numpy), ``csv`` (last column = label) and ``image``
(FashionMNIST idx files, ``option("split", "train"|"test")``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.frame import ArrayFrame
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm


class DataReader:
    def __init__(self, session: Any = None) -> None:
        self._session = session
        self._format = "libsvm"
        self._options: dict[str, Any] = {}

    def format(self, fmt: str) -> "DataReader":
        self._format = fmt.lower()
        return self

    def option(self, key: str, value: Any) -> "DataReader":
        self._options[key.lower()] = value
        return self

    def load(self, path: str) -> ArrayFrame:
        if self._format == "libsvm":
            nf = self._options.get("numfeatures")
            return read_libsvm(path, num_features=int(nf) if nf else None)
        if self._format == "npz":
            data = np.load(path)
            return ArrayFrame(data["features"], data["labels"])
        if self._format == "csv":
            raw = np.loadtxt(path, delimiter=",", dtype=np.float32)
            return ArrayFrame(raw[:, :-1], raw[:, -1].astype(np.int64))
        if self._format == "image":
            from machine_learning_apache_spark_tpu_torch.data.datasets import (
                load_fashion_mnist,
            )

            split = str(self._options.get("split", "train")).lower()
            if split not in ("train", "test", "t10k"):
                raise ValueError(
                    f"image split must be 'train' or 'test', got {split!r}"
                )
            return load_fashion_mnist(path, train=split == "train")
        raise ValueError(f"unsupported format {self._format!r}")
