"""Streaming record sources — files in, records out, nothing materialized;
the port of ``machine_learning_apache_spark_tpu/ingest/readers.py``.

The reference's premise is Spark as the ingestion layer: executors stream
partitions of a distributed file set into the training process. The
``data/`` layer is the synchronous analogue (load everything, then
iterate); these sources are the streaming one. Each source is a
restartable iterable of *records* (small per-example tuples of numpy
rows) that a ``StreamingPipeline`` shards, batches, and prefetches — the
whole dataset is never resident on the host.

File-backed sources parse through the port's native C++ fast paths
(``native/libsvm_parser.cpp``, ``native/text_encode.cpp``) one chunk of
lines at a time, with the same pure-Python fallbacks the synchronous
readers use; the chunk grain keeps the per-call native overhead amortized
without giving up bounded memory.

``shard_files(rank, world)`` (on file-backed sources) returns a copy that
reads only ``paths[rank::world]`` — the Spark-partition-style I/O split.
Record counts per rank are then ragged; see ``ingest.pipeline`` for the
batch-count equalization contract.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np


def _as_paths(paths: str | Sequence[str]) -> list[str]:
    out = [paths] if isinstance(paths, str) else list(paths)
    if not out:
        raise ValueError("need at least one path")
    return out


class ArraySource:
    """In-memory rows as a record stream (the ``ArrayDataset`` analogue):
    record i is ``tuple(a[i] for a in arrays)``. The bench/test workhorse
    and the adapter for datasets that already fit in memory."""

    def __init__(self, *arrays: np.ndarray, name: str = "array") -> None:
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError(f"length mismatch: {[len(a) for a in arrays]}")
        self.arrays = tuple(np.asarray(a) for a in arrays)
        self.name = name

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __iter__(self) -> Iterator[tuple]:
        for i in range(len(self)):
            yield tuple(a[i] for a in self.arrays)


class PairSource:
    """Ragged (src_ids, trg_ids) pairs — the online-packing input. Pairs
    are lists of ints (e.g. ``TextPipeline.ragged`` output)."""

    def __init__(self, pairs: Sequence[tuple], name: str = "pairs") -> None:
        self.pairs = list(pairs)
        self.name = name

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[tuple]:
        for s, t in self.pairs:
            yield (list(s), list(t))


class LibsvmStreamSource:
    """Stream ``(features float32 [num_features], label int64)`` records
    from libsvm files, parsing ``chunk_lines`` lines at a time through the
    native parser (``native/libsvm_parser.cpp``) when it builds, else the
    pure-Python fallback — the same arrays either way.

    ``num_features`` is required: a streaming reader cannot discover the
    global max index without a full pass, and the static batch shape must
    be known up front (Spark's ``numFeatures`` option has the same role).
    A chunk containing an index above it raises, like ``read_libsvm``.
    """

    def __init__(
        self,
        paths: str | Sequence[str],
        *,
        num_features: int,
        chunk_lines: int = 1024,
        use_native: bool | None = None,
        name: str = "libsvm",
    ) -> None:
        if num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {num_features}")
        if chunk_lines < 1:
            raise ValueError(f"chunk_lines must be >= 1, got {chunk_lines}")
        self.paths = _as_paths(paths)
        self.num_features = num_features
        self.chunk_lines = chunk_lines
        self.use_native = use_native
        self.name = name

    def shard_files(self, rank: int, world: int) -> "LibsvmStreamSource":
        if world > len(self.paths):
            raise ValueError(
                f"cannot file-shard {len(self.paths)} file(s) over "
                f"{world} ranks (some ranks would read nothing)"
            )
        return LibsvmStreamSource(
            self.paths[rank::world],
            num_features=self.num_features,
            chunk_lines=self.chunk_lines,
            use_native=self.use_native,
            name=self.name,
        )

    def _parse_chunk(
        self, text: str, path: str, line_offset: int
    ) -> tuple[np.ndarray, np.ndarray]:
        parse_native = None
        if self.use_native is None or self.use_native:
            from machine_learning_apache_spark_tpu_torch.native import (
                NATIVE,
                libsvm_native,
            )

            try:
                NATIVE.load()  # built at first use; ImportError if it cannot be
                parse_native = libsvm_native.parse_text
            except (ImportError, OSError):
                if self.use_native:
                    raise
        try:
            if parse_native is not None:
                features, labels = parse_native(text)
            else:
                from machine_learning_apache_spark_tpu_torch.data.libsvm import (
                    _parse_python,
                )

                features, labels, _ = _parse_python(text)
        except ValueError as e:
            # Parser line numbers are chunk-relative; re-anchor to the file.
            raise ValueError(
                f"{path}: lines {line_offset + 1}.."
                f"{line_offset + len(text.splitlines())}: {e}"
            ) from e
        if features.shape[1] > self.num_features:
            raise ValueError(
                f"{path}: feature index {features.shape[1]} > "
                f"num_features={self.num_features}"
            )
        if features.shape[1] < self.num_features:
            pad = np.zeros(
                (features.shape[0], self.num_features - features.shape[1]),
                np.float32,
            )
            features = np.concatenate([features, pad], axis=1)
        return features.astype(np.float32), labels.astype(np.int64)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.int64]]:
        for path in self.paths:
            with open(path) as f:
                lineno = 0
                while True:
                    lines = []
                    for line in f:
                        lines.append(line)
                        if len(lines) >= self.chunk_lines:
                            break
                    if not lines:
                        break
                    features, labels = self._parse_chunk(
                        "".join(lines), path, lineno
                    )
                    lineno += len(lines)
                    for i in range(len(labels)):
                        yield (features[i], labels[i])


class TextLineSource:
    """Stream stripped, non-empty lines from text files. Pair with a
    ``transform`` on the pipeline (or ``EncodedTextSource`` below) to turn
    lines into model inputs."""

    def __init__(self, paths: str | Sequence[str], name: str = "text") -> None:
        self.paths = _as_paths(paths)
        self.name = name

    def shard_files(self, rank: int, world: int) -> "TextLineSource":
        if world > len(self.paths):
            raise ValueError(
                f"cannot file-shard {len(self.paths)} file(s) over "
                f"{world} ranks (some ranks would read nothing)"
            )
        return TextLineSource(self.paths[rank::world], name=self.name)

    def __iter__(self) -> Iterator[str]:
        for path in self.paths:
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield line


class EncodedTextSource:
    """Stream ``(token_ids int32 [fixed_len], label int64)`` records from
    raw texts, encoding ``chunk`` texts at a time through a fitted
    ``data.text.TextPipeline`` — which takes the native ``text_encode.cpp``
    fast path (``native.text_native``) when it builds. The streaming
    counterpart of calling the pipeline on the whole corpus at once."""

    def __init__(
        self,
        texts: Sequence[str],
        labels: Sequence[int] | np.ndarray,
        pipe,
        *,
        chunk: int = 256,
        name: str = "encoded_text",
    ) -> None:
        if len(texts) != len(labels):
            raise ValueError(
                f"texts/labels length mismatch: {len(texts)} vs {len(labels)}"
            )
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.texts = list(texts)
        self.labels = np.asarray(labels, dtype=np.int64)
        self.pipe = pipe
        self.chunk = chunk
        self.name = name

    def __len__(self) -> int:
        return len(self.texts)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.int64]]:
        for start in range(0, len(self.texts), self.chunk):
            batch = self.texts[start : start + self.chunk]
            ids = self.pipe(batch)
            for i in range(len(batch)):
                yield (ids[i], self.labels[start + i])


class CallableSource:
    """Adapter for an arbitrary restartable record stream: ``factory()``
    is called once per pass and must return a fresh iterator."""

    def __init__(self, factory: Callable[[], Iterator], name: str = "fn"):
        self.factory = factory
        self.name = name

    def __iter__(self) -> Iterator:
        return iter(self.factory())
