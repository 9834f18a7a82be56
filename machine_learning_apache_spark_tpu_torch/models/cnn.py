"""TinyVGG-style CNN for FashionMNIST-class workloads — the port of
``machine_learning_apache_spark_tpu/models/cnn.py``.

Reference: ``FashionMNISTModel`` (``pytorch_cnn.py:12-49``, duplicated
``distributed_cnn.py:47-86``): two conv blocks of
[Conv3x3 s1 p1 → ReLU → Conv3x3 → ReLU → MaxPool2] then Flatten →
Linear(hidden·7·7 → classes), with ``input_shape=1, hidden_units=10``
(``pytorch_cnn.py:94-96``).

Layout: the API is NHWC, as the JAX model's and the datasets' (images
``[B, H, W, C]``). The convolutions run on an NCHW copy of the input
(cuDNN's idiom), and the feature map is permuted back to NHWC before the
flatten, so the classifier's input rows come in Flax's (h, w, c) order
and a Flax ``classifier`` kernel carries over unchanged. The copy is
what makes training repeat bit for bit on the card: on the channels-last
view of an NHWC tensor, cuDNN ran another forward engine inside a CUDA
graph capture than in eager execution (both deterministic, their sums
different in the last bits), while on NCHW tensors the two agree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from machine_learning_apache_spark_tpu_torch.models.transformer import add_bias, lecun_normal_


class TinyVGG(nn.Module):
    """Two-block VGG mini. Input ``[B, H, W, C]`` (NHWC), e.g. 28×28×1.

    Flax infers the input channels and the head's width at ``init`` from a
    sample input; a torch module is built with them, so ``input_shape``
    ``(H, W, C)`` gives them (default: FashionMNIST's 28×28×1). Any input
    with C channels and the same ``(H // 4) · (W // 4)`` runs, as in Flax.
    Convs ``block{b}_conv{c}`` and the ``classifier`` are named as in
    Flax. ``dtype`` is the compute dtype (float32 or bfloat16): the input,
    the convolutions and the classifier compute in it, with their float32
    parameters cast to it (Flax's ``param_dtype`` default), and the
    logits come back float32 so the loss never runs in half precision.
    Parameters are drawn from ``generator`` (LeCun-normal kernels over
    the 3·3·C_in fan-in, zero biases), never from the global RNG.
    """

    def __init__(
        self,
        hidden_units: int = 10,
        num_classes: int = 10,
        dtype: torch.dtype = torch.float32,
        *,
        input_shape: Sequence[int] = (28, 28, 1),
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.hidden_units = hidden_units
        self.num_classes = num_classes
        self.dtype = dtype
        height, width, channels = input_shape
        with torch.device("meta"):
            c_in = channels
            for block in range(2):
                for conv in range(2):
                    self.add_module(
                        f"block{block}_conv{conv}",
                        nn.Conv2d(c_in, hidden_units, 3, stride=1, padding=1),
                    )
                    c_in = hidden_units
            self.classifier = nn.Linear(
                hidden_units * (height // 4) * (width // 4), num_classes
            )
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def config(self) -> dict:
        """The JAX module's fields, in its order."""
        return {
            "hidden_units": self.hidden_units,
            "num_classes": self.num_classes,
            "dtype": self.dtype,
        }

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        generator = generator or torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator, fan_in=m.weight[0].numel())
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()

    def forward(
        self, x: torch.Tensor, *, dropout_rng: torch.Generator | None = None
    ) -> torch.Tensor:
        # Accepted for zoo-wide signature uniformity; TinyVGG has no dropout.
        del dropout_rng
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2).contiguous()  # NHWC → NCHW (see the module doc)
        for block in range(2):
            for conv in range(2):
                c = getattr(self, f"block{block}_conv{conv}")
                if dt == torch.float32:
                    x = c(x)
                else:  # the bias after the bf16 rounding, as Flax's Conv
                    x = add_bias(F.conv2d(x, c.weight.to(dt), padding=1), c.bias, dim=1)
                x = F.relu(x)
            x = F.max_pool2d(x, 2, 2)
        # Back to NHWC so the flatten is Flax's (h, w, c) order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if dt == torch.float32:
            return self.classifier(x)
        w, b = self.classifier.weight, self.classifier.bias
        return add_bias(F.linear(x, w.to(dt)), b).float()


# The reference's class name, for API-parity imports.
FashionMNISTModel = TinyVGG
