"""Dataset loaders — the port of
``machine_learning_apache_spark_tpu/data/datasets.py``: the reference's four
data families (SURVEY.md §1 L1).

Real-file loaders cover the formats the reference pulls via
torchvision/torchtext (FashionMNIST idx files, CIFAR-10 binary batches,
AG_NEWS csv, Multi30k parallel text); each has a clearly-named
*synthetic* generator with the same shape and a learnable structure, used
when the files are absent. Every function returns the JAX function's
arrays for the same files or seed: the generators draw from numpy's
``default_rng(seed)`` in the same order.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from machine_learning_apache_spark_tpu_torch.data.frame import ArrayFrame

# ---------------------------------------------------------------- image (idx)


def _read_idx(path: str) -> np.ndarray:
    """MNIST/FashionMNIST idx format (optionally .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_fashion_mnist(root: str, train: bool = True) -> ArrayFrame:
    """FashionMNIST from idx files under ``root`` — the torchvision layout
    (``pytorch_cnn.py:53-69``). Images come back ``[N, 28, 28, 1]`` float32 in
    [0, 1] (NHWC + the ``ToTensor()`` scaling), labels int64."""
    prefix = "train" if train else "t10k"
    candidates = [
        os.path.join(root, "FashionMNIST", "raw"),
        os.path.join(root, "fashion-mnist"),
        root,
    ]
    for base in candidates:
        for ext in ("", ".gz"):
            img_p = os.path.join(base, f"{prefix}-images-idx3-ubyte{ext}")
            lbl_p = os.path.join(base, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(img_p) and os.path.exists(lbl_p):
                images = _read_idx(img_p).astype(np.float32) / 255.0
                labels = _read_idx(lbl_p).astype(np.int64)
                return ArrayFrame(images[..., None], labels)
    raise FileNotFoundError(
        f"FashionMNIST idx files not found under {root!r}; "
        "use synthetic_image_classification for an offline stand-in"
    )


def synthetic_image_classification(
    n: int = 2048,
    *,
    height: int = 28,
    width: int = 28,
    channels: int = 1,
    num_classes: int = 10,
    seed: int = 0,
) -> ArrayFrame:
    """FashionMNIST-shaped learnable synthetic set: each class is a bright
    axis-aligned bar whose position/orientation encode the label, plus noise.
    A TinyVGG reaches high accuracy in a few epochs — the loss/accuracy
    *trajectory* contract of BASELINE.md without the download."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    images = rng.normal(0.1, 0.08, (n, height, width, channels)).astype(np.float32)
    band = max(2, height // num_classes)
    for i, lbl in enumerate(labels):
        if lbl % 2 == 0:  # horizontal bar at class-dependent row
            r = (lbl // 2) * band % (height - band)
            images[i, r : r + band, :, :] += 0.8
        else:  # vertical bar at class-dependent column
            c = (lbl // 2) * band % (width - band)
            images[i, :, c : c + band, :] += 0.8
    return ArrayFrame(np.clip(images, 0.0, 1.0), labels.astype(np.int64))


def load_cifar10(root: str, train: bool = True) -> ArrayFrame:
    """CIFAR-10 from the binary-version layout (``cifar-10-batches-bin/
    data_batch_{1..5}.bin`` + ``test_batch.bin``; each record is 1 label
    byte + 3072 CHW pixel bytes) — the BASELINE.json distributed-CNN
    workload shape. Images come back ``[N, 32, 32, 3]`` float32 in [0, 1]
    (NHWC + the ``ToTensor()`` scaling), labels int64."""
    candidates = [
        os.path.join(root, "cifar-10-batches-bin"),
        os.path.join(root, "CIFAR10", "cifar-10-batches-bin"),
        root,
    ]
    names = (
        [f"data_batch_{i}.bin" for i in range(1, 6)]
        if train
        else ["test_batch.bin"]
    )
    for base in candidates:
        paths = [os.path.join(base, n) for n in names]
        exists = [os.path.exists(p) for p in paths]
        if not any(exists):
            continue
        # Leading contiguous prefix only, loudly: real CIFAR-10 has 5 train
        # batches, and silently training on whatever subset survived an
        # interrupted download would misrepresent the run. (The committed
        # fixture intentionally ships just data_batch_1.bin.)
        k = 0
        while k < len(exists) and exists[k]:
            k += 1
        present = paths[:k]
        if not present:
            raise FileNotFoundError(
                f"{paths[0]} is missing but later batch files exist under "
                f"{base!r}; refusing a gapped CIFAR-10 read"
            )
        if train and (k < 5 or any(exists[k:])):
            from machine_learning_apache_spark_tpu_torch.utils.logging import (
                get_logger,
            )

            get_logger(__name__).warning(
                "loading %d of 5 CIFAR-10 train batches from %s (files "
                "beyond the leading prefix are missing or gapped)", k, base,
            )
        images, labels = [], []
        for p in present:
            raw = np.fromfile(p, dtype=np.uint8)
            if raw.size % 3073:
                raise ValueError(
                    f"{p}: size {raw.size} is not a whole number of "
                    "3073-byte CIFAR-10 records"
                )
            rec = raw.reshape(-1, 3073)
            labels.append(rec[:, 0].astype(np.int64))
            images.append(
                rec[:, 1:]
                .reshape(-1, 3, 32, 32)  # stored CHW
                .transpose(0, 2, 3, 1)  # → NHWC
                .astype(np.float32)
                / 255.0
            )
        return ArrayFrame(np.concatenate(images), np.concatenate(labels))
    raise FileNotFoundError(
        f"CIFAR-10 binary batches not found under {root!r}; use "
        "synthetic_image_classification(height=32, width=32, channels=3) "
        "for an offline stand-in"
    )


# ---------------------------------------------------------------- tabular


def synthetic_multiclass(
    n: int = 150, *, num_features: int = 4, num_classes: int = 3, seed: int = 0
) -> ArrayFrame:
    """The MLlib sample's shape (4 features, 3 classes,
    ``mllib_multilayer_perceptron_classifier.py:32``) as Gaussian class blobs
    — linearly separable enough that the 4-5-4-3 MLP reaches high accuracy
    with the reference recipe (SGD 0.03, 100 epochs)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    centers = rng.normal(0.0, 2.0, (num_classes, num_features))
    features = centers[labels] + rng.normal(0.0, 0.6, (n, num_features))
    return ArrayFrame(features.astype(np.float32), labels.astype(np.int64))


# ---------------------------------------------------------------- text (clf)

_TOPIC_WORDS = {
    0: "government election minister parliament treaty policy senate law".split(),
    1: "match team season coach player score league tournament".split(),
    2: "market shares profit revenue investor bank earnings trade".split(),
    3: "software chip research quantum network robot data science".split(),
}
_FILLER = "the a of and to in on with for said new over from".split()


def synthetic_text_classification(
    n: int = 2000, *, num_classes: int = 4, min_len: int = 8, max_len: int = 24,
    seed: int = 0,
) -> tuple[list[str], np.ndarray]:
    """AG_NEWS-shaped (4-class news text, ``pytorch_lstm.py:46-47``): raw
    strings whose topical vocabulary determines the label. Returned as
    (texts, labels) so the full tokenizer→vocab→transform pipeline (C13) is
    exercised on real strings."""
    if num_classes > len(_TOPIC_WORDS):
        raise ValueError(f"num_classes must be <= {len(_TOPIC_WORDS)}, got {num_classes}")
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    texts = []
    for lbl in labels:
        length = rng.integers(min_len, max_len + 1)
        words = [
            str(rng.choice(_TOPIC_WORDS[int(lbl)]))
            if rng.random() < 0.6
            else str(rng.choice(_FILLER))
            for _ in range(length)
        ]
        texts.append(" ".join(words))
    return texts, labels.astype(np.int64)


def load_ag_news(root: str, train: bool = True) -> tuple[list[str], np.ndarray]:
    """AG_NEWS from the torchtext csv layout (``class,title,description``),
    labels remapped 1-4 → 0-3."""
    path = os.path.join(root, "AG_NEWS", "train.csv" if train else "test.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; use synthetic_text_classification offline"
        )
    import csv

    texts, labels = [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            labels.append(int(row[0]) - 1)
            texts.append(" ".join(row[1:]))
    return texts, np.asarray(labels, dtype=np.int64)


# ---------------------------------------------------------------- translation

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
