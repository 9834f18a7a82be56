"""Translation datasets of the training slice — the port of
``synthetic_translation_pairs`` and ``load_multi30k`` from
``machine_learning_apache_spark_tpu/data/datasets.py``. The other loaders
(image, tabular, text classification) come with the other zoo recipes.
"""

from __future__ import annotations

import os

import numpy as np

_SRC_WORDS = (
    "man woman dog cat child house tree street ball book water sky bird car "
    "red green small big old young runs walks sees holds likes near under a the"
).split()
# Deterministic word-for-word mapping to a synthetic target language —
# learnable by a seq2seq model, Multi30k-shaped (en→de pairs,
# pytorch_machine_translator.py:14-17).
_TRG_MAP = {w: f"{w[::-1]}zn" for w in _SRC_WORDS}


def synthetic_translation_pairs(
    n: int = 2000, *, min_len: int = 4, max_len: int = 12, seed: int = 0
) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        length = rng.integers(min_len, max_len + 1)
        src_words = [str(rng.choice(_SRC_WORDS)) for _ in range(length)]
        trg_words = [_TRG_MAP[w] for w in src_words]
        pairs.append((" ".join(src_words), " ".join(trg_words)))
    return pairs


def load_multi30k(root: str, split: str = "train") -> list[tuple[str, str]]:
    """Multi30k from the torchtext parallel-file layout
    (``<root>/multi30k/<split>.en`` and ``.de``)."""
    en = os.path.join(root, "multi30k", f"{split}.en")
    de = os.path.join(root, "multi30k", f"{split}.de")
    if not (os.path.exists(en) and os.path.exists(de)):
        raise FileNotFoundError(
            f"multi30k files not found under {root!r}; "
            "use synthetic_translation_pairs offline"
        )
    with open(en) as fe, open(de) as fd:
        return list(zip((l.strip() for l in fe), (l.strip() for l in fd)))
