"""Scaled dot-product attention — the model's attention entry points.

The reference's innermost compute (``scaled_dot_product``,
``transformer.py:12-25``) is QKᵀ/√d → mask → softmax → ·V, with boolean
masks (True = attendable) applied as ``where(mask, scores, -inf)`` before
the softmax, and independent query/key lengths.

- ``scaled_dot_product_attention`` — plain PyTorch over a dense mask;
- ``dot_product_attention`` — the model's dispatcher: a dense ``mask``
  takes the plain path (an arbitrary mask cannot stream through the
  blockwise kernel); structured ``causal`` + ``kv_valid`` masks go to
  ``flash_attention`` (the Hopper kernel on the card, its plain version
  on the CPU). Unlike the TPU gate there is no head-dim condition: every
  CUDA tensor takes the kernel;
- ``ragged_paged_attention`` — one decode step over a paged KV store
  (the Hopper kernel on the card, its plain version on the CPU).

The JAX package's ``sequence_parallel`` and ``attention_impl`` contexts
come with the distributed slice.
"""

from __future__ import annotations

import math

import torch

from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import (
    NEG_INF,
    flash_attention,
    ragged_paged_attention,
)
from machine_learning_apache_spark_tpu_torch.ops.masks import (
    combine_masks,
    make_causal_mask,
)

__all__ = [
    "NEG_INF",
    "dot_product_attention",
    "multi_head_attention_weights",
    "ragged_paged_attention",
    "scaled_dot_product_attention",
]


def multi_head_attention_weights(
    query: torch.Tensor,
    key: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``softmax(QKᵀ/√d)`` with boolean masking, in float32 — the first
    half of ``scaled_dot_product`` (``transformer.py:17-24``)."""
    scores = torch.matmul(query, key.transpose(-1, -2))
    scores = scores / math.sqrt(query.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1)
    return weights.to(query.dtype)


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    return_weights: bool = False,
):
    """Attention over ``[..., S, d]`` streams with a dense boolean
    ``mask`` broadcastable to ``[..., Sq, Sk]`` (True = attendable)."""
    weights = multi_head_attention_weights(query, key, mask)
    values = torch.matmul(weights, value)
    if return_weights:
        return values, weights
    return values


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatching attention used by the model: structured masks only →
    ``flash_attention``; a dense ``mask`` (combined with any structured
    one) → ``scaled_dot_product_attention``."""
    if mask is None:
        return flash_attention(
            query, key, value, causal=causal, kv_valid=kv_valid
        )
    if kv_valid is not None:
        mask = combine_masks(mask, kv_valid[:, None, None, :])
    if causal:
        mask = combine_masks(
            mask,
            make_causal_mask(query.shape[-2], key.shape[-2], device=query.device),
        )
    return scaled_dot_product_attention(query, key, value, mask)
