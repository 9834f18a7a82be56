"""Weight bridge: the JAX package's Flax parameter tree → the torch model.

``load_flax_params(model, params)`` takes the tree as nested dicts of numpy
arrays under Flax's own key names (``encoder/layer_0/self_attn/qkv/kernel``,
``…/ln1/scale``, ``encoder/embed/embed/embedding``, ``lm_head/bias``, …)
and fills the matching torch modules, name for name:

- a Flax ``Dense.kernel`` ``[in, out]`` becomes ``Linear.weight``
  ``[out, in]``; the fused ``qkv``/``kv`` column order is kept, so the
  split into thirds/halves and then into heads is the JAX model's;
- ``LayerNorm.scale``/``bias`` → ``weight``/``bias`` (the port's
  LayerNorms use Flax's epsilon, 1e-6);
- ``Embed.embedding`` → ``Embedding.weight``;
- ``lm_head`` keeps its ``logit_pad`` columns; ``Transformer.logits``
  slices them off as the JAX model does.

Every leaf of the tree must land on a parameter and every parameter must
be filled: a mismatch raises, naming the keys.

``random_flax_params(cfg, seed)`` makes such a tree with numpy from a seed
— random weights in Flax's layout, for runs that have no trained
checkpoint.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _flax_path(module_name: str) -> str:
    """``decoder.layers.0.cross_attn.kv`` → ``decoder/layer_0/cross_attn/kv``."""
    return re.sub(r"layers\.(\d+)", r"layer_\1", module_name).replace(".", "/")


@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Fill ``model`` (the port's ``Transformer``) from a Flax parameter
    tree of numpy arrays; returns the model."""
    flat = _flatten(params)
    used: set[str] = set()
    missing: list[str] = []

    def take(path: str, dest: torch.Tensor, transpose: bool = False) -> None:
        if path not in flat:
            missing.append(path)
            return
        arr = flat[path].T if transpose else flat[path]
        if tuple(arr.shape) != tuple(dest.shape):
            raise ValueError(
                f"{path}: Flax shape {flat[path].shape} does not fit torch "
                f"shape {tuple(dest.shape)}"
            )
        dest.copy_(torch.as_tensor(np.array(arr), dtype=dest.dtype))
        used.add(path)

    for name, mod in model.named_modules():
        base = _flax_path(name)
        if isinstance(mod, nn.Linear):
            take(f"{base}/kernel", mod.weight, transpose=True)
            take(f"{base}/bias", mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            take(f"{base}/scale", mod.weight)
            take(f"{base}/bias", mod.bias)
        elif isinstance(mod, nn.Embedding):
            take(f"{base}/embedding", mod.weight)
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise ValueError(
            f"Flax tree does not match the model: missing {missing}, "
            f"unused {unused}"
        )
    return model


def random_flax_params(cfg, seed: int) -> dict:
    """A Flax-layout parameter tree of numpy arrays for ``cfg`` (the
    port's or the JAX package's ``TransformerConfig``), drawn from
    ``numpy.random.default_rng(seed)``: LeCun-normal kernels, N(0, 0.02)
    embeddings and biases, LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.ffn_hidden

    def dense(n_in, n_out):
        return {
            "kernel": (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(n_out)).astype(np.float32),
        }

    def ln():
        return {
            "scale": (1.0 + 0.02 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(d)).astype(np.float32),
        }

    def embed(vocab):
        return {"embed": {"embedding": (0.02 * rng.standard_normal((vocab, d))).astype(np.float32)}}

    def ffn():
        return {"up": dense(d, f), "down": dense(f, d)}

    encoder = {"embed": embed(cfg.src_vocab_size)}
    decoder = {"embed": embed(cfg.trg_vocab_size)}
    for i in range(cfg.num_layers):
        encoder[f"layer_{i}"] = {
            "self_attn": {"qkv": dense(d, 3 * d), "out": dense(d, d)},
            "ln1": ln(), "ffn": ffn(), "ln2": ln(),
        }
        decoder[f"layer_{i}"] = {
            "self_attn": {"qkv": dense(d, 3 * d), "out": dense(d, d)},
            "ln1": ln(),
            "cross_attn": {"q": dense(d, d), "kv": dense(d, 2 * d), "out": dense(d, d)},
            "ln2": ln(), "ffn": ffn(), "ln3": ln(),
        }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "lm_head": dense(d, cfg.trg_vocab_size + cfg.logit_pad),
    }
