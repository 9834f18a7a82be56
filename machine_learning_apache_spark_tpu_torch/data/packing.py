"""Sequence packing — several sentence pairs per row, zero cross-talk; the
port of ``machine_learning_apache_spark_tpu/data/packing.py`` (host numpy,
the same arrays, efficiencies and ``dropped_pairs``).

The reference pads every Multi30k pair to exactly 200x200
(``pytorch_machine_translator.py:70-98``); typical pairs are ~15 tokens, so
most of every attention matrix and LM-head matmul is pad work. Packing
fills the fixed row with SEVERAL pairs, separated by segment ids, and
trains on one static shape with almost no pad.

Correctness contract (``tests/test_torch_packing.py``): a pair packed into
segment *j* of a row sees exactly what it would see alone —
block-diagonal segment masks (``ops.masks.make_segment_mask``) confine
encoder self-, decoder self- (and causal) and cross-attention to the
pair's own tokens; position ids restart at 0 per segment so positional
encodings match the unpacked run; and the teacher-forcing loss mask drops
the boundary position where segment *j*'s last token would otherwise
"predict" segment *j+1*'s first (``recipes.translation``). The masks are
dense, so packed attention takes the plain path, not the flash kernel, as
it takes the fused-XLA path in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PackedPairs:
    """Fixed-shape packed arrays (all ``[rows, length]`` int32).

    ``*_segments``: 1..k per row, 0 = pad. ``*_positions``: within-segment
    offsets (0 for pad). ``pair_count``: total pairs packed;
    ``token_efficiency``: non-pad fraction of the packed token grid vs the
    one-pair-per-row layout's.
    """

    src: np.ndarray
    src_segments: np.ndarray
    src_positions: np.ndarray
    trg: np.ndarray
    trg_segments: np.ndarray
    trg_positions: np.ndarray
    pair_count: int
    token_efficiency: float
    unpacked_efficiency: float
    # Pairs excluded because truncation left no attendable src or no
    # scorable trg (<2 tokens). Can't trigger on the standard SOS/EOS
    # pipeline, but raw-id callers need the signal — silent corpus
    # shrinkage would otherwise only show as a reduced pair_count.
    dropped_pairs: int = 0

    def arrays(self) -> tuple[np.ndarray, ...]:
        return (
            self.src, self.src_segments, self.src_positions,
            self.trg, self.trg_segments, self.trg_positions,
        )


def pack_translation_pairs(
    src_rows: Sequence[Sequence[int]],
    trg_rows: Sequence[Sequence[int]],
    *,
    src_len: int,
    trg_len: int,
    pad_id: int = 0,
    max_segments: int | None = None,
) -> PackedPairs:
    """Greedily pack ragged (src, trg) id-list pairs into fixed rows.

    Next-fit in corpus order (deterministic, no reordering, earlier rows
    never revisited — simpler and more stream-friendly than first-fit, at
    some packing-density cost): a pair joins the open row only when BOTH
    its streams fit the remaining src/trg budgets (a pair must live in one
    row — its cross-attention needs its source alongside). Over-long
    streams are truncated to the row budget. ``max_segments`` caps pairs
    per row (None = unlimited).
    """
    if len(src_rows) != len(trg_rows):
        raise ValueError(
            f"src/trg pair count mismatch: {len(src_rows)} vs {len(trg_rows)}"
        )
    if src_len < 1 or trg_len < 2:
        # trg needs >= 2 so teacher forcing (input trg[:-1], labels trg[1:])
        # has at least one scored position.
        raise ValueError(f"row budgets too small: src {src_len}, trg {trg_len}")

    rows: list[tuple[list[list[int]], list[list[int]]]] = []
    open_src: list[list[int]] = []
    open_trg: list[list[int]] = []
    used_s = used_t = 0

    def flush():
        nonlocal open_src, open_trg, used_s, used_t
        if open_src:
            rows.append((open_src, open_trg))
        open_src, open_trg, used_s, used_t = [], [], 0, 0

    dropped = 0
    for s, t in zip(src_rows, trg_rows):
        s = list(s)[:src_len]
        t = list(t)[:trg_len]
        if not s or len(t) < 2:
            dropped += 1  # nothing attendable / nothing scorable
            continue
        full = (
            used_s + len(s) > src_len
            or used_t + len(t) > trg_len
            or (max_segments is not None and len(open_src) >= max_segments)
        )
        if full:
            flush()
        open_src.append(s)
        open_trg.append(t)
        used_s += len(s)
        used_t += len(t)
    flush()

    n = len(rows)
    out = PackedPairs(
        src=np.full((n, src_len), pad_id, dtype=np.int32),
        src_segments=np.zeros((n, src_len), dtype=np.int32),
        src_positions=np.zeros((n, src_len), dtype=np.int32),
        trg=np.full((n, trg_len), pad_id, dtype=np.int32),
        trg_segments=np.zeros((n, trg_len), dtype=np.int32),
        trg_positions=np.zeros((n, trg_len), dtype=np.int32),
        pair_count=sum(len(r[0]) for r in rows),
        token_efficiency=0.0,
        unpacked_efficiency=0.0,
        dropped_pairs=dropped,
    )
    tokens = 0
    for i, (srcs, trgs) in enumerate(rows):
        for stream, ids_lists in (("src", srcs), ("trg", trgs)):
            arr = getattr(out, stream)
            seg = getattr(out, f"{stream}_segments")
            pos = getattr(out, f"{stream}_positions")
            cursor = 0
            for j, ids in enumerate(ids_lists, start=1):
                arr[i, cursor : cursor + len(ids)] = ids
                seg[i, cursor : cursor + len(ids)] = j
                pos[i, cursor : cursor + len(ids)] = np.arange(len(ids))
                cursor += len(ids)
        tokens += sum(len(x) for x in srcs) + sum(len(x) for x in trgs)
    grid = n * (src_len + trg_len)
    out.token_efficiency = tokens / grid if grid else 0.0
    unpacked_grid = out.pair_count * (src_len + trg_len)
    out.unpacked_efficiency = tokens / unpacked_grid if unpacked_grid else 0.0
    return out
