"""Length bucketing — ragged text batching without wasted FLOPs; the port
of ``machine_learning_apache_spark_tpu/data/bucketing.py``.

The reference sidesteps raggedness by padding everything to one fixed length
(128 for AG_NEWS, exactly 200 for Multi30k — SURVEY.md §7 hard parts), so a
12-token sentence burns the same compute as a 200-token one. Bucketing pads
each batch to the smallest boundary that fits it: a handful of distinct
shapes (one program each), and the recurrence's or attention's work scales
with the bucket, not the corpus maximum.

``BucketByLengthLoader`` groups examples by length into boundary buckets,
shuffles within buckets per epoch (``set_epoch`` contract), and yields
``(ids[B, boundary], *extras)`` batches in a bucket-interleaved order —
the JAX loader's batches, order and padding, from the same seed.
``assign_buckets`` is also the serving batcher's rule for mapping a prompt
onto the configured boundaries.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.text import PAD_ID, PadToLength


def assign_buckets(
    lengths: np.ndarray, boundaries: Sequence[int]
) -> np.ndarray:
    """Index of the smallest boundary ≥ length; longer sequences land in the
    last bucket (and are truncated to it at padding time)."""
    boundaries = np.asarray(sorted(boundaries))
    return np.minimum(
        np.searchsorted(boundaries, np.asarray(lengths)),
        len(boundaries) - 1,
    )


class BucketByLengthLoader:
    """Minibatches of bucket-padded token ids (plus parallel extras).

    >>> loader = BucketByLengthLoader(pipe.ragged(texts), labels,
    ...                               batch_size=32,
    ...                               boundaries=(32, 64, 128))
    >>> for ids, lbls in loader: ...   # ids.shape[1] ∈ {32, 64, 128}

    ``drop_last=True`` drops each bucket's ragged tail so every batch of a
    bucket shares one shape. Batch order interleaves buckets
    deterministically per epoch (seeded), so training sees a mix of lengths
    rather than all-short-then-all-long.

    Sequences longer than the largest boundary are an error unless
    ``truncate_overlong=True`` (the same eos-clipping guard
    ``TextPipeline`` applies to ``fixed_len``).

    ``num_replicas``/``rank`` (default: the gang's process group — one
    process, rank 0 outside a gang) give each rank a disjoint per-epoch
    slice of every bucket, as ``DistributedSampler`` does.
    """

    def __init__(
        self,
        sequences: Sequence[Sequence[int]],
        *extras: np.ndarray,
        batch_size: int,
        boundaries: Sequence[int] = (32, 64, 128),
        pad_id: int = PAD_ID,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        truncate_overlong: bool = False,
        num_replicas: int | None = None,
        rank: int | None = None,
        lengths: Sequence[int] | None = None,
    ) -> None:
        if not boundaries:
            raise ValueError("need at least one bucket boundary")
        for e in extras:
            if len(e) != len(sequences):
                raise ValueError(
                    f"extra array length {len(e)} != {len(sequences)}"
                )
        self.sequences = [list(s) for s in sequences]
        self.extras = tuple(np.asarray(e) for e in extras)
        self.batch_size = batch_size
        self.boundaries = tuple(sorted(boundaries))
        self.pad_id = pad_id
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
            process_count,
            process_index,
        )

        self.num_replicas = (
            num_replicas if num_replicas is not None else process_count()
        )
        self.rank = rank if rank is not None else process_index()
        if not (0 <= self.rank < self.num_replicas):
            raise ValueError(f"rank {self.rank} outside [0, {self.num_replicas})")
        self._epoch = 0
        # ``lengths`` overrides the bucketing key (paired loaders bucket by
        # the max across their streams); padding still uses real row lengths.
        if lengths is not None and len(lengths) != len(self.sequences):
            raise ValueError(
                f"lengths ({len(lengths)}) != sequences ({len(self.sequences)})"
            )
        lengths = np.asarray(
            [len(s) for s in self.sequences] if lengths is None else lengths
        )
        longest = int(lengths.max(initial=0))
        if longest > self.boundaries[-1] and not truncate_overlong:
            raise ValueError(
                f"sequence of length {longest} exceeds the largest bucket "
                f"boundary {self.boundaries[-1]}; tokens (incl. eos) would "
                "be silently clipped — raise the boundary or pass "
                "truncate_overlong=True"
            )
        bucket_ids = assign_buckets(lengths, self.boundaries)
        self._buckets = [
            np.flatnonzero(bucket_ids == i) for i in range(len(self.boundaries))
        ]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _pad(self, idx: np.ndarray, width: int) -> np.ndarray:
        rows = PadToLength(width, self.pad_id)(
            [self.sequences[i] for i in idx]
        )
        return np.asarray(rows, dtype=np.int32)

    def _rank_slice(self, order: np.ndarray) -> np.ndarray:
        """This rank's share of one bucket's (permuted) members, padded by
        wrapping so every rank gets the same count — the equal-count
        invariant collectives depend on (``DistributedSampler`` semantics).
        The same seed on every rank keeps the slices consistent."""
        if len(order) == 0:
            return order
        per_rank = -(-len(order) // self.num_replicas)
        wrapped = np.resize(order, per_rank * self.num_replicas)
        return wrapped[self.rank :: self.num_replicas]

    def _schedule(self, epoch: int) -> list[tuple[int, np.ndarray]]:
        """One epoch's (bucket, example-indices) batch list — the single
        source of truth for __iter__/__len__/padding_efficiency."""
        rng = np.random.default_rng(self.seed + epoch)
        batches: list[tuple[int, np.ndarray]] = []
        for b, members in enumerate(self._buckets):
            order = rng.permutation(members) if self.shuffle else members
            order = self._rank_slice(order)
            stop = (
                len(order) - self.batch_size + 1
                if self.drop_last
                else len(order)
            )
            for start in range(0, max(stop, 0), self.batch_size):
                batches.append((b, order[start : start + self.batch_size]))
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return batches

    def __iter__(self):
        for b, idx in self._schedule(self._epoch):
            ids = self._pad(idx, self.boundaries[b])
            yield (ids, *(e[idx] for e in self.extras))

    def __len__(self) -> int:
        return len(self._schedule(self._epoch))

    @property
    def padding_efficiency(self) -> float:
        """Real tokens / padded slots over this epoch's actual batches —
        the FLOP-waste metric bucketing improves (1.0 = no padding)."""
        real = padded = 0
        for b, idx in self._schedule(self._epoch):
            width = self.boundaries[b]
            real += sum(min(len(self.sequences[i]), width) for i in idx)
            padded += len(idx) * width
        return real / padded if padded else 1.0


class BucketByLengthPairsLoader(BucketByLengthLoader):
    """Paired-stream bucketing for translation: each (src, trg) pair lands
    in the smallest boundary that fits ``max(len(src), len(trg) - 1)``, src
    pads to the boundary and trg to ``boundary + 1`` (so the teacher-forced
    decoder input ``trg[:, :-1]`` is boundary-wide) — the SURVEY.md §7
    recommendation: a few static shapes (one program per bucket) instead
    of corpus-max attention FLOPs on short sentence pairs.

    Yields ``(src_ids[B, b], trg_ids[B, b + 1], *extras)`` batches.
    """

    def __init__(
        self,
        src_sequences: Sequence[Sequence[int]],
        trg_sequences: Sequence[Sequence[int]],
        *extras: np.ndarray,
        **kwargs,
    ) -> None:
        if len(src_sequences) != len(trg_sequences):
            raise ValueError(
                f"{len(src_sequences)} src vs {len(trg_sequences)} trg rows"
            )
        self.trg_sequences = [list(t) for t in trg_sequences]
        kwargs.setdefault(
            "lengths",
            [
                max(len(s), len(t) - 1)
                for s, t in zip(src_sequences, trg_sequences)
            ],
        )
        super().__init__(src_sequences, *extras, **kwargs)

    def _pad_trg(self, idx: np.ndarray, width: int) -> np.ndarray:
        rows = PadToLength(width, self.pad_id)(
            [self.trg_sequences[i] for i in idx]
        )
        return np.asarray(rows, dtype=np.int32)

    def __iter__(self):
        for b, idx in self._schedule(self._epoch):
            width = self.boundaries[b]
            yield (
                self._pad(idx, width),
                self._pad_trg(idx, width + 1),
                *(e[idx] for e in self.extras),
            )

    @property
    def padding_efficiency(self) -> float:
        """Across BOTH streams (src slots + trg slots)."""
        real = padded = 0
        for b, idx in self._schedule(self._epoch):
            width = self.boundaries[b]
            for i in idx:
                real += min(len(self.sequences[i]), width)
                real += min(len(self.trg_sequences[i]), width + 1)
            padded += len(idx) * (2 * width + 1)
        return real / padded if padded else 1.0
