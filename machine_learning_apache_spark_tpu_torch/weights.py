"""Weight bridge: the JAX package's Flax parameter tree → the torch model.

``load_flax_params(model, params)`` takes the tree as nested dicts of numpy
arrays under Flax's own key names (``encoder/layer_0/self_attn/qkv/kernel``,
``…/ln1/scale``, ``encoder/embed/embed/embedding``, ``lm_head/bias``;
the zoo's ``dense_{i}``, ``block{b}_conv{c}``, ``classifier``,
``embedding``, ``lstm_{l}/{w_x,w_h,bias}``, ``head``) and fills the
matching torch modules of any of the port's models, name for name:

- a Flax ``Dense.kernel`` ``[in, out]`` becomes ``Linear.weight``
  ``[out, in]``; the fused ``qkv``/``kv`` column order is kept, so the
  split into thirds/halves and then into heads is the JAX model's;
- ``LayerNorm.scale``/``bias`` → ``weight``/``bias`` (the port's
  LayerNorms use Flax's epsilon, 1e-6);
- ``Embed.embedding`` → ``Embedding.weight``;
- a Flax ``Conv.kernel`` ``[kh, kw, in, out]`` (HWIO) becomes
  ``Conv2d.weight`` ``[out, in, kh, kw]`` (OIHW);
- a module's own parameters (the LSTM layer's ``w_x``, ``w_h``, ``bias``)
  are carried as they are, under their names;
- ``lm_head`` keeps its ``logit_pad`` columns; ``Transformer.logits``
  slices them off as the JAX model does;
- an MoE FFN's ``ffn/router`` ``[d, E]``, ``ffn/w_up`` ``[E, d, f]`` and
  ``ffn/w_down`` ``[E, f, d]`` are the module's own parameters, in the
  Flax layout, carried as they are.

Every leaf of the tree must land on a parameter and every parameter must
be filled: a mismatch raises, naming the keys. With ``mesh=`` (a mesh with
a ``"model"`` axis) the full load is then sharded over that axis
(``parallel.tensor_parallel.shard_params``): the rank keeps its slice,
and ``tensor_parallel.gather_params`` gives the full load's tensors back,
bit for bit.

``export_flax_params(model)`` is the inverse: the model's parameters as
such a tree, so trained weights can be compared with (or handed to) the
JAX model.

``random_flax_params(cfg, seed)`` makes such a tree for a Transformer
config with numpy from a seed — random weights in Flax's layout, for runs
that have no trained checkpoint; ``random_flax_like(model, seed)`` does
the same for any model of the port, shaped as ``export_flax_params(model)``.
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


def _hwio_to_oihw(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def _flax_path(module_name: str) -> str:
    """``decoder.layers.0.cross_attn.kv`` → ``decoder/layer_0/cross_attn/kv``."""
    return re.sub(r"layers\.(\d+)", r"layer_\1", module_name).replace(".", "/")


def _leaf(base: str, name: str) -> str:
    """A parameter's path under its module's (the root module's is ``""``)."""
    return f"{base}/{name}" if base else name


@torch.no_grad()
def load_flax_params(model: nn.Module, params, *, mesh=None) -> nn.Module:
    """Fill ``model`` (the port's ``Transformer``) from a Flax parameter
    tree of numpy arrays; returns the model, sharded over ``mesh``'s
    model axis when given."""
    flat = _flatten(params)
    used: set[str] = set()
    missing: list[str] = []

    def take(path: str, dest: torch.Tensor, to_torch=None) -> None:
        if path not in flat:
            missing.append(path)
            return
        arr = to_torch(flat[path]) if to_torch is not None else flat[path]
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
            take(f"{base}/kernel", mod.weight, np.transpose)
            take(f"{base}/bias", mod.bias)
        elif isinstance(mod, nn.Conv2d):
            take(f"{base}/kernel", mod.weight, _hwio_to_oihw)
            take(f"{base}/bias", mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            take(f"{base}/scale", mod.weight)
            take(f"{base}/bias", mod.bias)
        elif isinstance(mod, nn.Embedding):
            take(f"{base}/embedding", mod.weight)
        else:
            for pname, param in mod.named_parameters(recurse=False):
                take(_leaf(base, pname), param)
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise ValueError(
            f"Flax tree does not match the model: missing {missing}, "
            f"unused {unused}"
        )
    if mesh is not None:
        from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import shard_params

        shard_params(model, mesh)
    return model


def flax_named_parameters(model: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """Every parameter of ``model`` under its Flax tree path, as a view in
    the Flax layout (a ``Linear.weight`` transposed, a ``Conv2d.weight``
    as HWIO) — no copy."""
    out = []
    for name, mod in model.named_modules():
        base = _flax_path(name)
        if isinstance(mod, nn.Linear):
            out += [(f"{base}/kernel", mod.weight.T), (f"{base}/bias", mod.bias)]
        elif isinstance(mod, nn.Conv2d):
            out += [(f"{base}/kernel", mod.weight.permute(2, 3, 1, 0)), (f"{base}/bias", mod.bias)]
        elif isinstance(mod, nn.LayerNorm):
            out += [(f"{base}/scale", mod.weight), (f"{base}/bias", mod.bias)]
        elif isinstance(mod, nn.Embedding):
            out.append((f"{base}/embedding", mod.weight))
        else:
            out += [
                (_leaf(base, pname), param)
                for pname, param in mod.named_parameters(recurse=False)
            ]
    return out


@torch.no_grad()
def export_flax_params(model: nn.Module) -> dict:
    """The model's parameters as a Flax tree of numpy float arrays (nested
    dicts under Flax's key names) — the inverse of ``load_flax_params``."""
    tree: dict = {}
    for path, value in flax_named_parameters(model):
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return tree


def random_flax_like(model: nn.Module, seed: int) -> dict:
    """A Flax-layout tree shaped as ``export_flax_params(model)``, drawn
    from ``numpy.random.default_rng(seed)``: every matrix or kernel
    LeCun-normal over its fan-in (all axes but the last), every vector
    N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if node.ndim >= 2:
            fan_in = int(np.prod(node.shape[:-1]))
            out = rng.standard_normal(node.shape) / np.sqrt(fan_in)
        else:
            out = 0.02 * rng.standard_normal(node.shape)
        return out.astype(np.float32)

    return draw(export_flax_params(model))


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

    experts = getattr(cfg, "moe_experts", 0)

    def ffn():
        if experts:
            # models.moe's Flax names and layout: router [d, E], w_up
            # [E, d, f], w_down [E, f, d].
            def kernel(*shape):
                fan_in = int(np.prod(shape[:-1]))
                return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

            return {
                "router": kernel(d, experts),
                "w_up": kernel(experts, d, f),
                "w_down": kernel(experts, f, d),
            }
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
