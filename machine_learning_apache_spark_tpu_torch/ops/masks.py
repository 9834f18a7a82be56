"""Attention mask builders.

Reference mask sites: look-ahead (causal) mask ``torch.tril(ones)==0`` unsqueezed
to ``[1,1,S,S]`` (``pytorch_machine_translator.py:102-104``) and padding masks
``(tensor != pad).unsqueeze(1).unsqueeze(2)`` (``pytorch_machine_translator.py:164-165``).

Convention here: boolean, ``True = position may be attended``. This is the
*inverse* of the reference's causal-mask polarity; the reference then applies
its mask additively (quirk Q9, SURVEY.md §2.5) which makes masking a near
no-op. The framework applies masks with ``where(mask, scores, -inf)`` — the
evident intent.
"""

from __future__ import annotations

import torch


def make_causal_mask(
    length: int, kv_length: int | None = None, *, device=None
) -> torch.Tensor:
    """``[1, 1, Sq, Sk]`` causal mask: query i may attend keys <= i.

    With ``kv_length != length`` the diagonal is bottom-right aligned (the
    KV-cache decode convention: the last query row sees every key),
    matching the flash kernel.
    """
    kv_length = length if kv_length is None else kv_length
    offset = kv_length - length
    ones = torch.ones((length, kv_length), dtype=torch.bool, device=device)
    return torch.tril(ones, diagonal=offset)[None, None, :, :]


def make_padding_mask(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """``[B, 1, 1, S]`` key-padding mask from token ids — broadcasts over
    heads and query positions."""
    return (tokens != pad_id)[:, None, None, :]


def make_attention_mask(
    query_valid: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """``[B, 1, Sq, Sk]`` mask from per-position validity vectors; query
    and key lengths may differ (quirk Q8, ``transformer.py:180-188``)."""
    return query_valid[:, None, :, None] & key_valid[:, None, None, :]


def make_segment_mask(
    query_segments: torch.Tensor, key_segments: torch.Tensor
) -> torch.Tensor:
    """``[B, 1, Sq, Sk]`` block-diagonal mask from per-token segment ids:
    a query attends only keys of the SAME nonzero segment (segment 0 is
    padding and attends nothing)."""
    q = query_segments[:, None, :, None]
    k = key_segments[:, None, None, :]
    return (q == k) & (q > 0) & (k > 0)


def combine_masks(*masks: torch.Tensor | None) -> torch.Tensor | None:
    """AND together broadcastable masks, skipping Nones (e.g. causal ∧ padding)."""
    present = [m for m in masks if m is not None]
    if not present:
        return None
    out = present[0]
    for m in present[1:]:
        out = out & m
    return out
