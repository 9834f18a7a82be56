"""Loss functions — the port of ``machine_learning_apache_spark_tpu/train/losses.py``.

The reference uses ``nn.CrossEntropyLoss`` everywhere; the MT driver uses the
per-token variant with ``ignore_index=0, reduction='none'`` followed by a
manual pad-masked mean (``pytorch_machine_translator.py:125-126,182-188``).
Both shapes live here, once. Per-token losses are optax's
``softmax_cross_entropy_with_integer_labels``: ``logsumexp(logits) −
logits[label]``.

Logits in bf16 (a bf16 Transformer's) are widened to float32 first, so the
loss and its reduction are float32. The JAX package takes optax's loss in
the logits' dtype and returns a bf16 loss; the port keeps the softmax in
float32, as both frameworks' attention does (a standing difference,
ROADMAP queue C, of about one bf16 rounding of the loss).
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn


def _per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, reduction: str = "mean"
) -> torch.Tensor:
    """Softmax cross-entropy over integer labels — ``nn.CrossEntropyLoss``
    semantics (``pytorch_cnn.py:108``): ``reduction="mean"`` (default) or
    ``"none"`` for per-example losses (weighted-mean callers)."""
    per_example = _per_example(logits, labels)
    if reduction == "none":
        return per_example
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    return per_example.mean()


def masked_token_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, pad_id: int = 0
) -> torch.Tensor:
    """Pad-masked per-token CE: per-token losses where ``label != pad_id``,
    averaged over real tokens only, ``sum(per_tok·mask) / max(sum(mask),
    1)`` — the MT driver's ``ignore_index=0, reduction='none'`` + manual
    mask-mean (``pytorch_machine_translator.py:182-188``).

    ``logits``: [..., S, V]; ``labels``: [..., S]."""
    per_token = _per_example(logits, labels)
    mask = (labels != pad_id).to(per_token.dtype)
    return torch.sum(per_token * mask) / torch.clamp(torch.sum(mask), min=1.0)


def l2_regularization(
    params: nn.Module | Iterable[torch.Tensor], scale: float
) -> torch.Tensor:
    """``scale · Σ‖p‖²`` over a module's parameters or an iterable of
    tensors."""
    leaves = params.parameters() if isinstance(params, nn.Module) else params
    return scale * sum(torch.sum(torch.square(p)) for p in leaves)
