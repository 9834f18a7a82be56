"""Multilayer perceptron — the port of
``machine_learning_apache_spark_tpu/models/mlp.py``.

The reference defines this twice (``Multilayer_perceptor``,
``pytorch_multilayer_perceptron.py:33-42`` and
``distributed_multilayer_perceptron.py:44-53``): Linear stack with Sigmoid
between layers and no final activation. Layer spec follows MLlib's
full-topology convention ``layers=[in, hidden..., out]``
(``mllib_multilayer_perceptron_classifier.py:32`` uses ``[4, 5, 4, 3]``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch.models.transformer import Dense, lecun_normal_


class MLP(nn.Module):
    """``MLP(layers=(4, 5, 4, 3))`` — the reference MLP family (C2).

    ``layers[0]`` is the expected input width (validated), the rest are layer
    output widths; the layers are named ``dense_{i}`` as in Flax.
    ``activation`` sits between layers only; logits come out raw for a
    downstream softmax cross-entropy. Parameters are Flax's initialisers
    (LeCun-normal kernels, zero biases) drawn from ``generator`` (seeded 0
    when None), never from the global RNG.

    ``tp_rules=True`` annotates the kernels with logical axis names,
    alternating ``("embed", "mlp")`` / ``("mlp", "embed")`` (the
    column-then-row pairing), so ``parallel.tensor_parallel.shard_params``
    places them over a mesh ``"model"`` axis; a width the axis cannot
    divide stays replicated, loudly. A last layer that is column-parallel
    leaves its outputs sharded, and they are gathered before they leave.
    """

    def __init__(
        self,
        layers: Sequence[int] = (4, 5, 4, 3),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.sigmoid,
        tp_rules: bool = False,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.layers = tuple(layers)
        self.activation = activation
        self.tp_rules = tp_rules
        with torch.device("meta"):
            for i, (n_in, n_out) in enumerate(zip(self.layers[:-1], self.layers[1:])):
                names = (("embed", "mlp") if i % 2 == 0 else ("mlp", "embed")) if tp_rules else None
                self.add_module(f"dense_{i}", Dense(n_in, n_out, axes=names))
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def config(self) -> dict:
        """The JAX module's fields, in its order."""
        return {"layers": self.layers, "activation": self.activation, "tp_rules": self.tp_rules}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        generator = generator or torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()

    def forward(
        self, x: torch.Tensor, *, dropout_rng: torch.Generator | None = None
    ) -> torch.Tensor:
        # ``dropout_rng`` is accepted (and unused — no dropout here) so the
        # zoo shares one train/eval call signature.
        del dropout_rng
        if x.shape[-1] != self.layers[0]:
            raise ValueError(
                f"MLP expects {self.layers[0]} input features, got {x.shape[-1]}"
            )
        n = len(self.layers) - 1
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if i < n - 1:
                x = self.activation(x)
        last = getattr(self, f"dense_{n - 1}").tp
        if last is not None and last.mode == "column":
            from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
                gather_from_model,
            )

            x = gather_from_model(x, last.axis)
        return x
