"""Metrics — the port of ``machine_learning_apache_spark_tpu/train/metrics.py``.

The reference defines ``accuracy_fn`` (eq-count percentage) six separate times
(``pytorch_cnn.py:111-114`` et al.) and accumulates ``total_test_loss`` by
hand in every script. This module is the single implementation: tensor
metric functions plus tiny host-side accumulators. ``strip_special_ids``
and ``corpus_bleu`` are pure Python, copied as they are.
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter
from dataclasses import dataclass, field
from math import exp, log

import numpy as np
import torch


def accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Percentage of exact label matches — the reference ``accuracy_fn``
    (``pytorch_cnn.py:111-114``): ``eq(y_true, y_pred).sum() / len * 100``."""
    correct = torch.sum(y_true == y_pred)
    return correct / y_true.numel() * 100.0


def logits_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """softmax→argmax→accuracy, the reference eval pattern
    (``pytorch_multilayer_perceptron.py:135-139``). Softmax is monotonic so
    argmax of logits suffices."""
    return accuracy(labels, torch.argmax(logits, dim=-1))


def strip_special_ids(
    ids, *, pad_id: int = 0, sos_id: int = 1, eos_id: int = 2
) -> list[list[int]]:
    """Decoder output rows → clean token-id lists: drop the leading ``sos``,
    cut at the first ``eos``, drop pads — the form BLEU scores. ``ids`` is
    a 2-D array or tensor (a tensor is copied to the host)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    out = []
    for row in np.asarray(ids):
        toks = [int(t) for t in row]
        if toks and toks[0] == sos_id:
            toks = toks[1:]
        if eos_id in toks:
            toks = toks[: toks.index(eos_id)]
        out.append([t for t in toks if t != pad_id])
    return out


def corpus_bleu(
    candidates: list[list[int]],
    references: list[list[int]],
    *,
    max_n: int = 4,
    smooth: bool = True,
) -> float:
    """Corpus BLEU over token-id sequences (Papineni et al. 2002): clipped
    modified n-gram precisions (n ≤ ``max_n``) geometric-mean'd with a
    brevity penalty — the standard MT quality metric the reference's
    translation driver never computes (it reports loss only,
    ``pytorch_machine_translator.py:189``). Host-side, pure Python.

    ``smooth=True`` applies add-one smoothing (Lin & Och 2004 method 1 style)
    to zero higher-order counts so short corpora don't collapse to 0.
    """
    if len(candidates) != len(references):
        raise ValueError(
            f"{len(candidates)} candidates vs {len(references)} references"
        )
    if not candidates:
        return 0.0

    def ngrams(seq, n):
        return Counter(tuple(seq[i : i + n]) for i in range(len(seq) - n + 1))

    matched = [0] * max_n
    total = [0] * max_n
    cand_len = ref_len = 0
    for cand, ref in zip(candidates, references):
        cand_len += len(cand)
        ref_len += len(ref)
        for n in range(1, max_n + 1):
            cn, rn = ngrams(cand, n), ngrams(ref, n)
            total[n - 1] += max(len(cand) - n + 1, 0)
            matched[n - 1] += sum(min(c, rn[g]) for g, c in cn.items())
    precisions = []
    for m, t in zip(matched, total):
        if t == 0:
            precisions.append(None)  # no n-grams that long anywhere; skip
        elif m == 0:
            if not smooth:
                return 0.0
            precisions.append(1.0 / (2.0 * t))
        else:
            precisions.append(m / t)
    precisions = [p for p in precisions if p is not None]
    if not precisions:
        return 0.0
    geo = exp(sum(log(p) for p in precisions) / len(precisions))
    bp = 1.0 if cand_len > ref_len else exp(1.0 - ref_len / max(cand_len, 1))
    return bp * geo


@dataclass
class Sum:
    """Running sum — ``total_train_loss += loss`` (``pytorch_cnn.py:131``)."""

    total: float = 0.0
    count: int = 0

    def update(self, value, n: int = 1) -> None:
        self.total += float(value)
        self.count += n

    def compute(self) -> float:
        return self.total


@dataclass
class Mean(Sum):
    """Weighted running mean: ``update(value, n)`` treats ``value`` as a mean
    over ``n`` samples (n=1 for per-step scalars)."""

    def update(self, value, n: int = 1) -> None:
        self.total += float(value) * n
        self.count += n

    def compute(self) -> float:
        return self.total / max(self.count, 1)


class MetricsLogger:
    """Append-only JSONL metrics sink. Each ``write(record)`` appends one
    JSON line stamped with wall time."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)  # line-buffered

    def write(self, record: dict) -> None:
        self._fh.write(json.dumps({"ts": time.time(), **record}) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]


@dataclass
class MetricBundle:
    """Named accumulators with one ``log_line`` in the reference's print
    format (``distributed_cnn.py:188-191``)."""

    metrics: dict = field(default_factory=dict)

    def sum(self, name: str) -> Sum:
        m = self.metrics.setdefault(name, Sum())
        if type(m) is not Sum:
            raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def mean(self, name: str) -> Mean:
        m = self.metrics.setdefault(name, Mean())
        if not isinstance(m, Mean):
            raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def compute(self) -> dict:
        return {k: v.compute() for k, v in self.metrics.items()}

    def log_line(self) -> str:
        return " | ".join(f"{k}: {v:.5f}" for k, v in self.compute().items())
