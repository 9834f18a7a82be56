"""Mixture-of-experts feed-forward — the port of
``machine_learning_apache_spark_tpu/models/moe.py``.

Switch-style top-1 routing with a static capacity and one-hot einsum
dispatch and combine, as the JAX module computes it:

- each sequence is its own routing group with ``capacity =
  max(ceil(capacity_factor * seq / num_experts), 1)`` slots per expert;
  a token past its expert's capacity is dropped (its output is zero and
  the layer's residual carries it);
- the router runs in float32 whatever the compute dtype; the expert is
  ``argmax`` of the router's softmax, the first maximum winning on ties
  in both frameworks; a token's slot is the exclusive running count of
  earlier same-expert tokens in its row;
- the dispatch and combine tensors are ``[B, S, E, C]``; the expert
  FFNs are one batched matmul pair over the leading expert axis;
- pad tokens (``valid`` False) take no slot and leave the aux statistics;
- the Switch load-balancing loss ``E * sum_e f_e * p_e`` (fraction of
  valid tokens routed to ``e`` before drops, times their mean router
  probability) is appended to the caller's ``aux`` list, where Flax sows
  it into the ``"losses"`` collection; ``recipes.translation`` adds
  ``moe_aux_weight`` times their mean to the task loss.

The einsums are ``torch.einsum`` (cuBLAS batched GEMMs on the card): the
JAX package computes them in XLA, outside any Pallas kernel. One-hots are
comparisons against ``arange``, so an index past the capacity gives an
all-zero row as ``jax.nn.one_hot`` does, with no bounds check and no host
sync; nothing in the forward reads a value back, so a CUDA graph can hold
it. Expert dropout draws from the caller's generator
(``models.transformer.Dropout``).

The parameters keep the Flax names and layout — ``router`` ``[d, E]``,
``w_up`` ``[E, d, f]``, ``w_down`` ``[E, f, d]`` — so the weight bridge
carries them as they are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Dropout,
    lecun_normal_,
)


class MoEFeedForward(nn.Module):
    """Drop-in replacement for the dense position-wise FFN: ``[B, S, d]``
    in and out, ``forward(x, dropout_rng, valid=, aux=)``."""

    def __init__(
        self,
        d_model: int,
        ffn_hidden: int,
        num_experts: int,
        capacity_factor: float = 1.25,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(d_model, num_experts))
        self.w_up = nn.Parameter(torch.empty(num_experts, d_model, ffn_hidden))
        self.w_down = nn.Parameter(torch.empty(num_experts, ffn_hidden, d_model))
        self.dropout = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's ``lecun_normal`` on each parameter, whose fan-in is every
        axis but the last (the expert axis counts, as in Flax)."""
        for w in (self.router, self.w_up, self.w_down):
            lecun_normal_(w, generator, fan_in=math.prod(w.shape[:-1]))

    def capacity(self, seq_len: int) -> int:
        """Slots per expert in each sequence's routing group."""
        return max(int(math.ceil(self.capacity_factor * seq_len / self.num_experts)), 1)

    def forward(
        self,
        x: torch.Tensor,
        dropout_rng=None,
        *,
        valid: torch.Tensor | None = None,
        aux: list | None = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        e = self.num_experts
        capacity = self.capacity(s)
        if valid is not None and tuple(valid.shape) != (b, s):
            raise ValueError(
                f"valid must be [batch={b}, seq={s}], got {tuple(valid.shape)}"
            )
        vf = (
            valid.float() if valid is not None
            else torch.ones((b, s), dtype=torch.float32, device=x.device)
        )

        # -- router (float32) ------------------------------------------------
        logits = torch.einsum("bsd,de->bse", x.float(), self.router.float())
        probs = torch.softmax(logits, dim=-1)  # [B, S, E]
        expert_idx = torch.argmax(probs, dim=-1)  # [B, S], the first max
        gate = probs.gather(-1, expert_idx[..., None])[..., 0] * vf

        # -- capacity assignment within each row -----------------------------
        experts = torch.arange(e, device=x.device)
        onehot = (expert_idx[..., None] == experts).float() * vf[..., None]
        position = (torch.cumsum(onehot, dim=1) - onehot) * onehot  # [B, S, E]
        pos_in_expert = position.sum(dim=-1).long()  # [B, S]
        keep = pos_in_expert < capacity
        gate = torch.where(keep, gate, 0.0)
        slots = (pos_in_expert[..., None] == torch.arange(capacity, device=x.device)).float()
        # [B, S, E, C]: token (b, s) -> (its expert, its slot)
        dispatch = onehot[..., None] * slots[:, :, None, :] * keep[..., None, None].float()

        # -- expert FFNs, batched over the expert axis -----------------------
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(self.dtype), x.to(self.dtype))
        h = torch.relu(torch.einsum("ebcd,edf->ebcf", expert_in, self.w_up.to(self.dtype)))
        h = self.dropout(h, dropout_rng)
        expert_out = torch.einsum("ebcf,efd->ebcd", h, self.w_down.to(self.dtype))

        # -- weighted combine -------------------------------------------------
        combine = dispatch * gate[..., None, None]
        out = torch.einsum("bsec,ebcd->bsd", combine.to(self.dtype), expert_out)

        # -- Switch load-balancing loss over valid tokens ---------------------
        if aux is not None:
            n_valid = vf.sum().clamp_min(1.0)
            frac_routed = onehot.sum(dim=(0, 1)) / n_valid  # f_e, before drops
            mean_prob = (probs * vf[..., None]).sum(dim=(0, 1)) / n_valid  # p_e
            aux.append(e * torch.sum(frac_routed * mean_prob))
        return out
