"""Loss functions — the port of ``machine_learning_apache_spark_tpu/train/losses.py``.

The reference uses ``nn.CrossEntropyLoss`` everywhere; the MT driver uses the
per-token variant with ``ignore_index=0, reduction='none'`` followed by a
manual pad-masked mean (``pytorch_machine_translator.py:125-126,182-188``).
Both shapes live here, once. Per-token losses are optax's
``softmax_cross_entropy_with_integer_labels``: ``logsumexp(logits) −
logits[label]``.

Under tensor parallelism the LM head's logits are vocab-sharded:
``vocab_parallel_token_cross_entropy`` takes this rank's columns and
returns the same per-token loss from three ``[B, S]`` all-reduces over the
model axis (max, sum of exponentials, the label's logit), never gathering
the ``[B, S, V]`` logits.

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
    return masked_mean(_per_example(logits, labels), labels, pad_id)


def masked_mean(per_token: torch.Tensor, labels: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """The mean of ``per_token`` over the positions whose label is not
    ``pad_id``: ``sum(per_tok·mask) / max(sum(mask), 1)``."""
    mask = (labels != pad_id).to(per_token.dtype)
    return torch.sum(per_token * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token softmax cross-entropy over vocab-sharded logits (Megatron's
    ``vocab_parallel_cross_entropy``): ``logsumexp − logits[label]`` with
    the max, the sum of exponentials and the label's logit all-reduced
    over the model axis, in float32. Columns at or past ``vocab_size``
    (the LM head's ``logit_pad``) are −inf. The gradient is the local
    softmax minus the local one-hot."""

    @staticmethod
    def forward(ctx, logits, labels, axis, start, vocab_size):
        x = logits.float()
        width = x.shape[-1]
        cols = torch.arange(start, start + width, device=x.device)
        x = x.masked_fill(cols >= vocab_size, float("-inf"))
        m = axis.all_reduce_(x.max(dim=-1).values.contiguous(), op="max")
        e = torch.exp(x - m[..., None])
        s = axis.all_reduce_(e.sum(dim=-1))
        local = labels.long() - start
        mine = (local >= 0) & (local < width)
        picked = torch.gather(x, -1, local.clamp(0, width - 1)[..., None])[..., 0]
        target = axis.all_reduce_(torch.where(mine, picked, 0.0))
        ctx.save_for_backward(e, s, local, mine)
        ctx.in_dtype = logits.dtype
        return torch.log(s) + m - target

    @staticmethod
    def backward(ctx, grad):
        e, s, local, mine = ctx.saved_tensors
        g = e / s[..., None]
        onehot = torch.zeros_like(g).scatter_(
            -1, local.clamp(0, g.shape[-1] - 1)[..., None], mine[..., None].to(g.dtype)
        )
        return ((g - onehot) * grad[..., None]).to(ctx.in_dtype), None, None, None, None


def vocab_parallel_token_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, axis, start: int, vocab_size: int
) -> torch.Tensor:
    """Per-token CE of vocab-sharded ``logits`` ``[..., V/M]`` (this rank's
    columns ``[start, start + V/M)`` of the padded head) against global
    ``labels``; ``axis`` is the ``tensor_parallel.ModelAxis``. Equals
    ``_per_example`` of the gathered, unpadded logits."""
    return _VocabParallelCE.apply(logits, labels, axis, start, vocab_size)


def l2_regularization(
    params: nn.Module | Iterable[torch.Tensor], scale: float
) -> torch.Tensor:
    """``scale · Σ‖p‖²`` over a module's parameters or an iterable of
    tensors."""
    leaves = params.parameters() if isinstance(params, nn.Module) else params
    return scale * sum(torch.sum(torch.square(p)) for p in leaves)
