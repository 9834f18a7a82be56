"""Length bucketing — the smallest-boundary-that-fits rule.

Only ``assign_buckets`` is here: the serving batcher needs it to map a
prompt onto the configured boundaries. The training loaders that also
use it come with the training slice.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


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
