"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit ``device="cpu"`` they raise: a silent move to the
CPU would pass off host numbers as the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card (``cuda``); any explicit device is taken
    as given. Raises ``RuntimeError`` when the card is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host (plain PyTorch in place of the Hopper kernels)"
            )
        # The JAX reference computes in plain fp32; TF32 keeps ~3 decimal
        # digits and would make the card disagree with it. The flags are
        # process-wide, so set them wherever a card path starts.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's convolution backward may otherwise pick algorithms whose
        # sums depend on scheduling; a training run must repeat bit for bit
        # (K steps per call against one). No autotuning: the algorithm a
        # capture holds is the one eager execution runs.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev
