"""Online sequence packing — ``data.packing`` semantics, one pair at a time;
the port of ``machine_learning_apache_spark_tpu/ingest/packing.py`` (a
copy: it holds no JAX).

``data.packing.pack_translation_pairs`` packs a whole corpus in one call
(next-fit in corpus order). The streaming pipeline cannot afford the
whole corpus; this module re-expresses the SAME next-fit policy as an
incremental fold so the loader thread can pack as records arrive. The
parity contract — feeding a corpus through ``OnlinePacker`` yields
byte-identical rows, in order, to the one-shot call — is pinned by
``tests/test_torch_ingest.py`` against the port's one-shot packer and
the JAX package's.

A packed *row* is the 6-tuple ``(src, src_segments, src_positions, trg,
trg_segments, trg_positions)`` of int32 ``[length]`` vectors — one row of
the ``PackedPairs`` arrays; the pipeline stacks ``batch_size`` of them
into the static-shape batch the packed-transformer loss consumes.
"""

from __future__ import annotations

import numpy as np


class OnlinePacker:
    """Incremental next-fit packer over (src_ids, trg_ids) pairs.

    ``add(src, trg)`` returns a completed packed row whenever the open row
    flushes (the incoming pair did not fit), else None; ``flush()``
    returns the final open row (or None). Same drop rule as the one-shot
    packer: pairs with no attendable src or <2 trg tokens after truncation
    are dropped and counted in ``dropped_pairs``.
    """

    def __init__(
        self,
        *,
        src_len: int,
        trg_len: int,
        pad_id: int = 0,
        max_segments: int | None = None,
    ) -> None:
        if src_len < 1 or trg_len < 2:
            # trg needs >= 2 so teacher forcing has a scored position —
            # identical guard to pack_translation_pairs.
            raise ValueError(
                f"row budgets too small: src {src_len}, trg {trg_len}"
            )
        self.src_len = src_len
        self.trg_len = trg_len
        self.pad_id = pad_id
        self.max_segments = max_segments
        self._open_src: list[list[int]] = []
        self._open_trg: list[list[int]] = []
        self._used_s = 0
        self._used_t = 0
        self.pair_count = 0
        self.dropped_pairs = 0
        self.rows_emitted = 0
        self.packed_tokens = 0

    def _materialize(self) -> tuple[np.ndarray, ...]:
        row: list[np.ndarray] = []
        for ids_lists, length in (
            (self._open_src, self.src_len),
            (self._open_trg, self.trg_len),
        ):
            arr = np.full(length, self.pad_id, dtype=np.int32)
            seg = np.zeros(length, dtype=np.int32)
            pos = np.zeros(length, dtype=np.int32)
            cursor = 0
            for j, ids in enumerate(ids_lists, start=1):
                arr[cursor : cursor + len(ids)] = ids
                seg[cursor : cursor + len(ids)] = j
                pos[cursor : cursor + len(ids)] = np.arange(len(ids))
                cursor += len(ids)
            self.packed_tokens += cursor
            row += [arr, seg, pos]
        self.rows_emitted += 1
        return tuple(row)

    def _flush_open(self) -> tuple[np.ndarray, ...] | None:
        if not self._open_src:
            return None
        row = self._materialize()
        self._open_src, self._open_trg = [], []
        self._used_s = self._used_t = 0
        return row

    def add(self, src, trg) -> tuple[np.ndarray, ...] | None:
        s = list(src)[: self.src_len]
        t = list(trg)[: self.trg_len]
        if not s or len(t) < 2:
            self.dropped_pairs += 1
            return None
        full = (
            self._used_s + len(s) > self.src_len
            or self._used_t + len(t) > self.trg_len
            or (
                self.max_segments is not None
                and len(self._open_src) >= self.max_segments
            )
        )
        out = self._flush_open() if full else None
        self._open_src.append(s)
        self._open_trg.append(t)
        self._used_s += len(s)
        self._used_t += len(t)
        self.pair_count += 1
        return out

    def flush(self) -> tuple[np.ndarray, ...] | None:
        """End-of-stream: materialize and return the open row, if any."""
        return self._flush_open()

    @property
    def token_efficiency(self) -> float:
        """Non-pad fraction of the emitted token grid (matches the
        one-shot packer's definition over the same rows)."""
        grid = self.rows_emitted * (self.src_len + self.trg_len)
        return self.packed_tokens / grid if grid else 0.0
