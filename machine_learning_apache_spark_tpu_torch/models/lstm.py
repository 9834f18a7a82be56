"""LSTM text classifier — the port of
``machine_learning_apache_spark_tpu/models/lstm.py``.

Reference: ``LSTM`` (``pytorch_lstm.py:94-119``, drifted duplicate
``distributed_lstm.py:110-135``): Embedding → 2-layer ``nn.LSTM``
(batch_first, dropout=0.5 between layers) → Linear head, with explicit
``(hidden, mem)`` state threading through ``forward`` and zero-init state per
batch (``pytorch_lstm.py:153-154``). Quirk Q10 is fixed as in the JAX model:
the head uses ``hidden_size`` and padding embeds are simply trained.

Each layer is written as the JAX one is, not as ``nn.LSTM``: its
parameters are one ``w_x [E, 4H]``, one ``w_h [H, 4H]`` and one ``bias
[4H]`` (gates split (i, f, g, o)), the input projection of the whole
sequence is one ``[B·S, E]×[E, 4H]`` matmul hoisted out of the
recurrence, and the recurrence runs per step ``gx[t] + h @ w_h`` and the
cell. Inter-layer dropout draws from the caller's generator (the
Transformer's ``Dropout``), never the global RNG — ``nn.LSTM``'s
``dropout=`` would. The token embedding's gradient is summed in an order
fixed by the ids (``EmbeddingLookup``), so training repeats bit for bit
on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Dropout,
    EmbeddingLookup,
    lecun_normal_,
)


class LSTMLayer(nn.Module):
    """One recurrent layer. Carries are ``(h, c)`` with shape
    ``[B, hidden]`` each; ``forward`` returns ``(ys [B, S, hidden],
    (h_n, c_n))``."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_x = nn.Parameter(torch.empty(in_dim, 4 * hidden_size))
        self.w_h = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.bias = nn.Parameter(torch.empty(4 * hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's: LeCun-normal ``w_x``, orthogonal ``w_h``, zero bias."""
        lecun_normal_(self.w_x, generator, fan_in=self.w_x.shape[0])
        nn.init.orthogonal_(self.w_h, generator=generator)
        self.bias.zero_()

    def forward(
        self, x: torch.Tensor,
        state: tuple[torch.Tensor, torch.Tensor] | None = None,
    ):
        batch, seq, in_dim = x.shape
        if state is None:
            h = x.new_zeros(batch, self.hidden_size)
            c = x.new_zeros(batch, self.hidden_size)
        else:
            h, c = state
        # The input projection for the whole sequence at once: one matmul
        # instead of S small ones inside the recurrence.
        gates_x = (x.reshape(batch * seq, in_dim) @ self.w_x + self.bias).view(
            batch, seq, -1
        )
        ys = []
        for t in range(seq):
            gates = gates_x[:, t] + h @ self.w_h
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)


class LSTMClassifier(nn.Module):
    """Embedding → stacked LSTM → Linear head (reference C8), named
    ``embedding``, ``lstm_{l}`` and ``head`` as in Flax.

    ``forward`` accepts and returns the explicit per-layer ``(h, c)``
    states the reference threads manually; ``None`` zero-initializes them
    (``pytorch_lstm.py:153-154``). Returns per-timestep logits ``[B, S,
    C]``; the classification recipe takes the last (or last valid)
    timestep. ``dropout_rng`` (a ``torch.Generator`` on the model's
    device) turns the inter-layer dropout on, as Flax's ``rngs=
    {"dropout": ...}`` with ``deterministic=False`` does.
    """

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 32,
        hidden_size: int = 32,
        num_classes: int = 4,
        num_layers: int = 2,
        dropout: float = 0.5,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_size = hidden_size
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.dropout = dropout
        with torch.device("meta"):
            self.embedding = nn.Embedding(vocab_size, embed_dim)
            for layer in range(num_layers):
                self.add_module(
                    f"lstm_{layer}",
                    LSTMLayer(embed_dim if layer == 0 else hidden_size, hidden_size),
                )
            self.head = nn.Linear(hidden_size, num_classes)
        self.drop = Dropout(dropout)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def config(self) -> dict:
        """The JAX module's fields, in its order."""
        return {
            "vocab_size": self.vocab_size,
            "embed_dim": self.embed_dim,
            "hidden_size": self.hidden_size,
            "num_classes": self.num_classes,
            "num_layers": self.num_layers,
            "dropout": self.dropout,
        }

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's initialisers: the embedding N(0, 1/embed_dim) (``nn.Embed``'s
        fan-in variance scaling), each layer's own, a LeCun-normal head."""
        generator = generator or torch.Generator().manual_seed(0)
        self.embedding.weight.normal_(0.0, self.embed_dim ** -0.5, generator=generator)
        for layer in range(self.num_layers):
            getattr(self, f"lstm_{layer}").reset_parameters(generator)
        lecun_normal_(self.head.weight, generator)
        self.head.bias.zero_()

    def forward(
        self,
        tokens: torch.Tensor,
        state: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
        *,
        dropout_rng: torch.Generator | None = None,
        return_state: bool = False,
    ):
        x = EmbeddingLookup.apply(self.embedding.weight, tokens)
        new_state = []
        for layer in range(self.num_layers):
            layer_state = state[layer] if state is not None else None
            x, s = getattr(self, f"lstm_{layer}")(x, layer_state)
            new_state.append(s)
            if layer < self.num_layers - 1:
                x = self.drop(x, dropout_rng)
        logits = self.head(x)
        if return_state:
            return logits, new_state
        return logits
