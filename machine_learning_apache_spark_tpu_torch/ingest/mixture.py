"""Weighted mixture sampling over named record sources; the port of
``machine_learning_apache_spark_tpu/ingest/mixture.py`` (a copy: it holds
no JAX).

Multi-task runs draw each record from one of several datasets with fixed
probabilities — the Spark-era analogue is a weighted union of DataFrames.
Determinism contract: the draw sequence is a pure function of the seed
and the sampler's captured state, so (a) every rank constructing the same
mixture sees the SAME global record stream (required by record-level
sharding — the pipeline filters that shared stream by index), and (b)
``state_dict()``/``load_state_dict()`` round-trips through the checkpoint
meta sidecar replay the identical batch sequence after ``fit(resume=True)``.

Source iterators persist across epochs and cycle on exhaustion (an
"epoch" is ``records_per_epoch`` draws, not a pass over any one source),
so the RNG state + per-source draw counts fully describe the stream
position.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np


class MixtureSampler:
    """Acts as a record source for ``StreamingPipeline``: one pass yields
    exactly ``records_per_epoch`` records, each drawn from a source chosen
    by a seeded RNG with the given weights.

    ``sources`` is name -> restartable iterable (any ``ingest.readers``
    source). ``weights`` aligns with the insertion order of ``sources``
    (uniform when None); they are normalized internally.
    """

    def __init__(
        self,
        sources: Mapping[str, object],
        weights: Sequence[float] | None = None,
        *,
        records_per_epoch: int,
        seed: int = 0,
        name: str = "mixture",
    ) -> None:
        if not sources:
            raise ValueError("need at least one source")
        if records_per_epoch < 1:
            raise ValueError(
                f"records_per_epoch must be >= 1, got {records_per_epoch}"
            )
        self.names = list(sources)
        self.sources = dict(sources)
        if weights is None:
            weights = [1.0] * len(self.names)
        if len(weights) != len(self.names):
            raise ValueError(
                f"{len(self.names)} sources but {len(weights)} weights"
            )
        w = np.asarray(weights, dtype=np.float64)
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"weights must be >= 0 with a positive sum: {w}")
        self.weights = w / w.sum()
        self.records_per_epoch = records_per_epoch
        self.seed = seed
        self.name = name
        self._rng = np.random.default_rng(seed)
        self._iters: dict[str, Iterator | None] = {n: None for n in self.names}
        self._draws = {n: 0 for n in self.names}
        self._cycles = {n: 0 for n in self.names}

    def _next_from(self, name: str):
        it = self._iters[name]
        if it is None:
            it = iter(self.sources[name])
        try:
            rec = next(it)
        except StopIteration:
            it = iter(self.sources[name])
            self._cycles[name] += 1
            try:
                rec = next(it)
            except StopIteration:
                raise ValueError(f"mixture source {name!r} is empty") from None
        self._iters[name] = it
        self._draws[name] += 1
        return rec

    def __iter__(self) -> Iterator:
        for _ in range(self.records_per_epoch):
            k = int(self._rng.choice(len(self.names), p=self.weights))
            yield self._next_from(self.names[k])

    # -- resume state --------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe stream position: RNG bit-generator state + per-source
        draw counts (the cursor each source iterator must be advanced to)."""
        return {
            "rng": self._rng.bit_generator.state,
            "draws": dict(self._draws),
            "cycles": dict(self._cycles),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict()`` capture: the RNG resumes mid-stream
        and each source iterator is fast-forwarded to its recorded cursor
        by replaying (and discarding) its draws — sources only need to be
        restartable, not seekable."""
        rng = np.random.default_rng(self.seed)
        rng.bit_generator.state = state["rng"]
        self._rng = rng
        self._iters = {n: None for n in self.names}
        self._draws = {n: 0 for n in self.names}
        self._cycles = {n: 0 for n in self.names}
        for name in self.names:
            for _ in range(int(state["draws"].get(name, 0))):
                self._next_from(name)
        # Replay reproduces the draw counts; cycles follow from them, but
        # trust the recorded value in case a source length changed (which
        # would be a caller bug — still, never resume with silently
        # inconsistent bookkeeping).
        recorded = state.get("cycles") or {}
        for name, cycles in recorded.items():
            if name in self._cycles and self._cycles[name] != cycles:
                raise ValueError(
                    f"mixture source {name!r} replayed {self._cycles[name]} "
                    f"cycle(s) but the checkpoint recorded {cycles} — source "
                    "contents changed since the checkpoint was written"
                )
