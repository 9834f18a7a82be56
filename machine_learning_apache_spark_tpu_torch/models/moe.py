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
carries them as they are, and their Flax logical axes (``param_axes``):
``tensor_parallel.shard_params`` slices the leading ``"expert"`` dim over
the mesh's expert axis and the ``"mlp"`` dim over its model axis.

Sharded (the ``ep_sharded`` / ``tp_sharded`` hooks), the router, its
softmax, the capacity assignment and the aux loss run replicated on
every rank of the line, exactly as unsharded. Rank ``r`` of an expert
line of N keeps experts ``[r·E/N, (r+1)·E/N)`` of the dispatch tensor
and of the weights and runs the batched FFN on them; under the model
axis it also keeps its ``f/M`` hidden columns of ``w_up`` and rows of
``w_down``, with ``copy_to_model`` before the up-projection and
``reduce_from_model`` after the down-projection. Its combine is then
summed over the expert line (``reduce_from_expert``). ``copy_to_expert``
wraps only the copy of ``x`` that feeds the dispatch einsum and the gate
as it enters the combine (``parallel.expert_parallel`` says why). The
expert dropout draws the whole ``[E, B, C, f]`` mask from the shared
generator and keeps this rank's slice.

In a data-parallel gang the load-balancing loss is the global batch's,
as in the JAX step over the whole batch: its statistics are summed over
the data line (``parallel.data_parallel.bind_batch_line``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Dropout,
    lecun_normal_,
)
from machine_learning_apache_spark_tpu_torch.parallel.expert_parallel import (
    copy_to_expert,
    reduce_from_expert,
)
from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
    sum_over_line,
)


class MoEFeedForward(nn.Module):
    """Drop-in replacement for the dense position-wise FFN: ``[B, S, d]``
    in and out, ``forward(x, dropout_rng, valid=, aux=)``."""

    #: The Flax params' logical axes, which ``shard_params`` reads.
    param_axes = {
        "router": ("embed", None),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }
    #: This rank's expert and model lines once sharded, and its data line
    #: in a data-parallel gang (``data_parallel.bind_batch_line``).
    ep = None
    tp = None
    batch_line = None

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

    def _sharded_on(self, line) -> bool:
        return any(owner is line for owner, _, _ in getattr(self.w_up, "shards", ()))

    def ep_sharded(self, axis) -> None:
        """Run on this rank's experts of the expert line ``axis``."""
        if self._sharded_on(axis):
            self.ep = axis
            self.dropout.shards += ((0, axis.index, axis.size),)

    def tp_sharded(self, axis) -> None:
        """Run on this rank's hidden columns of the model line ``axis``."""
        if self._sharded_on(axis):
            self.tp = axis
            self.dropout.shards += ((-1, axis.index, axis.size),)

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

        # -- router (float32), replicated on an expert line -------------------
        probs = self.route(x)  # [B, S, E]
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

        # -- expert FFNs, batched over this rank's experts --------------------
        x_in = x
        if self.ep is not None:
            dispatch = dispatch[:, :, self.ep.experts(e)]
            x_in = copy_to_expert(x, self.ep)
            gate = copy_to_expert(gate, self.ep)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(self.dtype), x_in.to(self.dtype))
        if self.tp is not None:
            expert_in = copy_to_model(expert_in, self.tp)
        h = torch.relu(torch.einsum("ebcd,edf->ebcf", expert_in, self.w_up.to(self.dtype)))
        h = self.dropout(h, dropout_rng)
        expert_out = torch.einsum("ebcf,efd->ebcd", h, self.w_down.to(self.dtype))
        if self.tp is not None:
            expert_out = reduce_from_model(expert_out, self.tp)

        # -- weighted combine -------------------------------------------------
        combine = dispatch * gate[..., None, None]
        out = torch.einsum("bsec,ebcd->bsd", combine.to(self.dtype), expert_out)
        if self.ep is not None:
            out = reduce_from_expert(out, self.ep)

        if aux is not None:
            aux.append(self.balance_loss(probs, onehot, vf))
        return out

    def route(self, x: torch.Tensor) -> torch.Tensor:
        """The router's softmax over the experts, in float32."""
        logits = torch.einsum("bsd,de->bse", x.float(), self.router.float())
        return torch.softmax(logits, dim=-1)

    def balance_loss(self, probs: torch.Tensor, onehot: torch.Tensor,
                     vf: torch.Tensor) -> torch.Tensor:
        """The Switch load-balancing loss over the valid tokens — of the
        global batch under a data line (``batch_line``): the routed counts,
        the probability sums and the valid count summed over it, the sum's
        cotangent summed back."""
        e = self.num_experts
        stats = torch.cat([onehot.sum(dim=(0, 1)), (probs * vf[..., None]).sum(dim=(0, 1)),
                           vf.sum().reshape(1)])
        if self.batch_line is not None:
            stats = sum_over_line(stats, self.batch_line)
        n_valid = stats[2 * e].clamp_min(1.0)
        frac_routed = stats[:e] / n_valid  # f_e, before drops
        mean_prob = stats[e:2 * e] / n_valid  # p_e
        return e * torch.sum(frac_routed * mean_prob)
