"""Sinusoidal positional encoding.

The table is built in numpy exactly as the JAX package builds it (same
float32 formula, same channel interleave), once per ``(length, dim)``;
callers move it to their device once and keep it there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _table(length: int, dim: int) -> np.ndarray:
    # Same formula as transformer.py:33-42: even channels sin, odd cos, with
    # the 10000^(2i/d) frequency schedule.
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[: dim // 2])
    return table


def sinusoidal_encoding(
    length: int, dim: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """``[length, dim]`` sinusoidal table (``PositionalEncoding``,
    ``transformer.py:27-42``)."""
    return torch.as_tensor(_table(length, dim), dtype=dtype, device=device)
