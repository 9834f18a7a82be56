"""Distributed sampling — the port of ``machine_learning_apache_spark_tpu/data/sampler.py``.

The reference partitions data with ``DistributedSampler`` +
``sampler.set_epoch(epoch)`` (``distributed_cnn.py:112-119,168``) but
hardcodes ``num_replicas=2, rank=0`` on every rank (quirk Q3) so all ranks
read shard 0. Correct semantics here: every rank gets a disjoint slice of
an epoch-seeded permutation. There is no JAX process layout to ask: the
world and rank are passed in, or read from the launcher's
``MLSPARK_NUM_PROCESSES`` / ``MLSPARK_PROCESS_ID``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from machine_learning_apache_spark_tpu_torch.utils import env as _env


class DistributedSampler:
    """Epoch-seeded, rank-sliced index sampler.

    ``num_replicas``/``rank`` default to the launcher's environment;
    ``seed`` plus ``set_epoch`` reproduce torch's cross-epoch shuffling
    contract. ``drop_last=False`` pads by wrapping (torch's default) so
    every rank yields the same count — a collective-friendly invariant.
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int | None = None,
        rank: int | None = None,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        self.dataset_size = dataset_size
        self.num_replicas = (
            num_replicas if num_replicas is not None
            else _env.get_int("MLSPARK_NUM_PROCESSES")
        )
        self.rank = rank if rank is not None else _env.get_int("MLSPARK_PROCESS_ID")
        if not (0 <= self.rank < self.num_replicas):
            raise ValueError(f"rank {self.rank} outside [0, {self.num_replicas})")
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_size // self.num_replicas
        else:
            self.num_samples = -(-dataset_size // self.num_replicas)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the permutation for a new epoch (``sampler.set_epoch``,
        ``distributed_multilayer_perceptron.py:124``)."""
        self.epoch = epoch

    def _global_order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        total = self.num_samples * self.num_replicas
        if self.drop_last:
            order = order[:total]
        elif total > len(order):
            # Wrap as many times as needed (dataset may be smaller than the
            # replica count) so every rank yields exactly num_samples.
            order = np.resize(order, total)
        return order

    def __iter__(self) -> Iterator[int]:
        # Interleaved assignment (rank, rank+R, rank+2R, ...) like torch.
        return iter(self._global_order()[self.rank :: self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples
