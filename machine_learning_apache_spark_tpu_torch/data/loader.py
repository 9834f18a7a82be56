"""Batch loader: host arrays → fixed-shape batches — the port of
``machine_learning_apache_spark_tpu/data/loader.py``.

Batches are numpy arrays stacked to static shapes (ragged tails drop or
stay, by ``drop_last``); ``train.loop`` moves them to the device. The
batch order is the JAX package's: ``default_rng(seed + epoch)``, so the
two packages see the same batches. A batch of integer indices is
gathered through the native threaded row-gather (``native.gather_rows``,
``batch_gather.cpp``; numpy fancy indexing where the library does not
build), as in the JAX loader.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.sampler import DistributedSampler
from machine_learning_apache_spark_tpu_torch.native import gather_rows


class ArrayDataset:
    """``TensorDataset`` equivalent (``pytorch_multilayer_perceptron.py:70``):
    parallel arrays indexed together."""

    def __init__(self, *arrays: np.ndarray) -> None:
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError(f"length mismatch: {[len(a) for a in arrays]}")
        self.arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, idx):
        if (
            isinstance(idx, np.ndarray)
            and idx.ndim == 1
            and np.issubdtype(idx.dtype, np.integer)
        ):
            # The loader's host hot path: the native threaded row-gather.
            return tuple(gather_rows(a, idx) for a in self.arrays)
        return tuple(a[idx] for a in self.arrays)


def random_split(
    dataset: ArrayDataset, lengths_or_fracs: Sequence[float], seed: int = 0
) -> list[ArrayDataset]:
    """``torch.utils.data.random_split`` equivalent
    (``pytorch_multilayer_perceptron.py:73`` does a 60/40 split).

    torch semantics for disambiguation: integer entries are absolute lengths,
    float entries are fractions — never guessed from the sum."""
    n = len(dataset)
    values = np.asarray(lengths_or_fracs)
    if np.issubdtype(values.dtype, np.integer):  # absolute lengths given
        sizes = values.astype(int)
        if sizes.sum() != n:
            raise ValueError(f"lengths {sizes.tolist()} != dataset size {n}")
    else:
        fracs = values.astype(np.float64)
        if fracs.sum() > 1.0 + 1e-9:
            raise ValueError(
                f"fractions {fracs.tolist()} sum to {fracs.sum()} > 1; pass "
                "integers for absolute lengths"
            )
        sizes = (fracs / fracs.sum() * n).astype(int)
        sizes[-1] = n - sizes[:-1].sum()
    perm = np.random.default_rng(seed).permutation(n)
    out, start = [], 0
    for s in sizes:
        idx = perm[start : start + s]
        out.append(ArrayDataset(*(a[idx] for a in dataset.arrays)))
        start += s
    return out


class DataLoader:
    """Minibatch iterator over an ArrayDataset.

    - ``sampler``: a DistributedSampler for rank-sliced epochs; otherwise an
      internal (optionally shuffled) full-range order.
    - ``drop_last=True`` keeps every batch the same shape.
    - ``collate``: optional ``fn(tuple_of_arrays) -> batch`` applied per
      batch on the host.
    - ``prefetch``: assemble up to N batches ahead on a background thread,
      overlapping host batch prep with the asynchronous device steps.
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        sampler: DistributedSampler | None = None,
        drop_last: bool = True,
        seed: int = 0,
        collate: Callable[[tuple], Any] | None = None,
        prefetch: int = 0,
    ) -> None:
        if shuffle and sampler is not None:
            raise ValueError(
                "shuffle and sampler are mutually exclusive; give the sampler "
                "shuffle=True instead"
            )
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self.seed = seed
        self.collate = collate
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _order(self) -> np.ndarray:
        if self.sampler is not None:
            return np.fromiter(iter(self.sampler), dtype=np.int64)
        if self.shuffle:
            return np.random.default_rng(self.seed + self._epoch).permutation(
                len(self.dataset)
            )
        return np.arange(len(self.dataset))

    def _batches(self) -> Iterator:
        order = self._order()
        stop = (
            len(order) - self.batch_size + 1 if self.drop_last else len(order)
        )
        for start in range(0, max(stop, 0), self.batch_size):
            batch = self.dataset[order[start : start + self.batch_size]]
            yield self.collate(batch) if self.collate else batch

    def __iter__(self) -> Iterator:
        if self.prefetch > 0:
            return _prefetch_iter(self._batches(), self.prefetch)
        return self._batches()

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


def _prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Pull ``it`` on a background thread into a bounded queue of
    ``depth`` batches. Worker exceptions re-raise at the consuming
    ``next()``; an abandoned consumer releases the worker within 100 ms."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            _put((_ERR, e))
        else:
            _put(_END)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        # Normal exhaustion, consumer exception, or abandonment: release
        # the worker and drop queued batches.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except _queue.Empty:
            pass
