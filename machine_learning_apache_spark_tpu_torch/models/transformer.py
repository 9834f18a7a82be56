"""Encoder-decoder Transformer.

Reference: the 11-class ``transformer.py`` module library (C14-C23,
SURVEY.md §2.1) used by the en→de MT driver
(``pytorch_machine_translator.py:120``: d_model=512, ffn=1024, heads=8,
drop=0.1, layers=1, max_seq=200).

The port of ``machine_learning_apache_spark_tpu/models/transformer.py``:
the same post-LN residual structure, the same fused projections and
module names (``qkv``/``q``/``kv``/``out``, ``up``/``down``,
``ln1``..``ln3``, ``lm_head``) so that ``weights.load_flax_params`` maps a
Flax tree onto it name for name, the same structured masks (boolean,
True = attendable, ``where`` before the softmax), and the same paged
serving entry points. Attention runs through ``ops.attention``: the
Hopper kernels for CUDA tensors, their plain versions on the CPU.

Where Flax *sows* intermediate values into a mutable collection, these
methods return them: ``prefill_paged`` returns each layer's memory K/V,
``decode_step_paged`` each layer's new self-attention K/V.

Parameters are made with an explicit ``torch.Generator`` (Flax's
initialiser families: LeCun-normal kernels, zero biases, N(0, 0.02)
embeddings, unit LayerNorm scales); modules are built on the meta device
first, so construction never draws from the global RNG.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch.ops.attention import (
    dot_product_attention,
    ragged_paged_attention,
)
from machine_learning_apache_spark_tpu_torch.ops.positional import (
    sinusoidal_encoding,
)

#: Flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Hyperparameters — the reference ctor signature (``transformer.py:256-267``)
    plus compute dtype. Defaults are the MT driver's
    (``pytorch_machine_translator.py:108-117``)."""

    src_vocab_size: int
    trg_vocab_size: int
    d_model: int = 512
    ffn_hidden: int = 1024
    num_heads: int = 8
    num_layers: int = 1
    dropout: float = 0.1
    max_len: int = 200
    pad_id: int = 0
    dtype: torch.dtype = torch.float32
    # Extra LM-head columns (tensor-parallel vocab padding in the JAX
    # package); logits are sliced back to trg_vocab_size.
    logit_pad: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _linear(n_in: int, n_out: int, cfg: TransformerConfig) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=cfg.dtype)


def _layer_norm(cfg: TransformerConfig) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.d_model, eps=LN_EPS, dtype=cfg.dtype)


class SentenceEmbedding(nn.Module):
    """Token embedding + sinusoidal positional encoding + dropout (C16,
    ``transformer.py:44-62``), with the PE table kept on the module's
    device."""

    def __init__(self, vocab_size: int, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, cfg.d_model, dtype=cfg.dtype)
        self.dropout = nn.Dropout(cfg.dropout)
        self.register_buffer(
            "pe", torch.empty(cfg.max_len, cfg.d_model, dtype=cfg.dtype),
            persistent=False,
        )

    def reset_table(self) -> None:
        self.pe.copy_(sinusoidal_encoding(self.cfg.max_len, self.cfg.d_model))

    def forward(
        self, tokens: torch.Tensor, *, positions: torch.Tensor | None = None
    ) -> torch.Tensor:
        x = self.embed(tokens)
        length = tokens.shape[-1]
        # The table covers max(max_len, L), as in the JAX package, so a
        # static sequence longer than max_len still has encodings.
        table = self.pe
        if length > table.shape[0]:
            table = sinusoidal_encoding(
                length, self.cfg.d_model, self.cfg.dtype, tokens.device
            )
        if positions is not None:
            # Per-row position ids (paged decode). A JAX gather clamps an
            # out-of-range index; torch indexing would fault, so clamp
            # the same way (only frozen, finished rows can reach the end).
            pe = table[positions.clamp(0, table.shape[0] - 1)]
        else:
            pe = table[:length]
        return self.dropout(x + pe)


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused ``qkv`` projection (C17), or
    cross-attention with ``q`` and a fused ``kv`` (C21) that reshapes each
    stream with its own length (Q8 fixed)."""

    def __init__(self, cfg: TransformerConfig, *, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        d = cfg.d_model
        if cross:
            self.q = _linear(d, d, cfg)
            self.kv = _linear(d, 2 * d, cfg)
        else:
            self.qkv = _linear(d, 3 * d, cfg)
        self.out = _linear(d, d, cfg)

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, length, _ = t.shape
        cfg = self.cfg
        return t.view(b, length, cfg.num_heads, cfg.head_dim).transpose(1, 2)

    def project_memory(self, memory: torch.Tensor):
        """Cross-attention K/V over the encoder memory, ``[B, S, d]``
        each — what paged prefill stores in its pages."""
        return self.kv(memory).chunk(2, dim=-1)

    def forward(
        self,
        x_q: torch.Tensor,
        x_kv: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        *,
        causal: bool = False,
        kv_valid: torch.Tensor | None = None,
    ) -> torch.Tensor:
        b, s_q, d = x_q.shape
        if self.cross:
            k, v = self.project_memory(x_kv)
            q = self.q(x_q)
        else:
            q, k, v = self.qkv(x_q).chunk(3, dim=-1)
        # Structured masks go to the flash kernel; a dense mask to the
        # plain path.
        out = dot_product_attention(
            self._split_heads(q), self._split_heads(k), self._split_heads(v),
            mask, causal=causal, kv_valid=kv_valid,
        )
        return self.out(out.transpose(1, 2).reshape(b, s_q, d))

    def forward_paged(self, x: torch.Tensor, paged: dict):
        """Paged ragged decode: ``x`` is one position per request row
        (``[R, 1, d]``); cached K/V are read from the page store through
        ``paged``'s block table and lengths. Self-attention also attends
        this step's own K/V (the causal diagonal) and returns them for the
        caller to scatter: ``(out, k_new, v_new)``; cross-attention
        returns ``(out, None, None)``."""
        cfg = self.cfg
        r = x.shape[0]
        k_new = v_new = None
        if self.cross:
            q = self.q(x)
        else:
            q, k_new, v_new = self.qkv(x).chunk(3, dim=-1)
            k_new, v_new = k_new[:, 0], v_new[:, 0]
        ctx = ragged_paged_attention(
            q[:, 0].reshape(r, cfg.num_heads, cfg.head_dim),
            paged["k_pages"], paged["v_pages"],
            paged["table"], paged["length"],
            k_scale=paged.get("k_scale"), v_scale=paged.get("v_scale"),
            cur_k=k_new, cur_v=v_new,
        )
        return self.out(ctx.reshape(r, 1, cfg.d_model)), k_new, v_new


class FeedForward(nn.Module):
    """Position-wise FFN (C19, ``transformer.py:104-117``):
    Linear(ffn) → ReLU → Dropout → Linear(d)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.up = _linear(cfg.d_model, cfg.ffn_hidden, cfg)
        self.down = _linear(cfg.ffn_hidden, cfg.d_model, cfg)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.dropout(torch.relu(self.up(x))))


class EncoderLayer(nn.Module):
    """Post-LN residual block (C20, ``transformer.py:120-139``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.ln1 = _layer_norm(cfg)
        self.ffn = FeedForward(cfg)
        self.ln2 = _layer_norm(cfg)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, mask=None, kv_valid=None):
        attn = self.self_attn(x, mask=mask, kv_valid=kv_valid)
        x = self.ln1(x + self.dropout(attn))
        return self.ln2(x + self.dropout(self.ffn(x)))


class Encoder(nn.Module):
    """Embedding + layer stack (C20's ``Encoder``, ``transformer.py:149-166``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.embed = SentenceEmbedding(cfg.src_vocab_size, cfg)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_layers)
        )

    def forward(self, src_tokens, src_mask=None, src_valid=None, *, positions=None):
        x = self.embed(src_tokens, positions=positions)
        for layer in self.layers:
            x = layer(x, src_mask, src_valid)
        return x


class DecoderLayer(nn.Module):
    """Self-attn + cross-attn + FFN, each post-LN residual (C22,
    ``transformer.py:194-224``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.ln1 = _layer_norm(cfg)
        self.cross_attn = MultiHeadAttention(cfg, cross=True)
        self.ln2 = _layer_norm(cfg)
        self.ffn = FeedForward(cfg)
        self.ln3 = _layer_norm(cfg)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(
        self, y, memory, self_mask=None, cross_mask=None, trg_valid=None,
        memory_valid=None, self_causal: bool = False,
    ):
        attn = self.self_attn(
            y, mask=self_mask, causal=self_causal, kv_valid=trg_valid
        )
        y = self.ln1(y + self.dropout(attn))
        cross = self.cross_attn(
            y, memory, mask=cross_mask, kv_valid=memory_valid
        )
        y = self.ln2(y + self.dropout(cross))
        return self.ln3(y + self.dropout(self.ffn(y)))

    def forward_paged(self, y, paged_self: dict, paged_mem: dict):
        attn, k_new, v_new = self.self_attn.forward_paged(y, paged_self)
        y = self.ln1(y + self.dropout(attn))
        cross, _, _ = self.cross_attn.forward_paged(y, paged_mem)
        y = self.ln2(y + self.dropout(cross))
        return self.ln3(y + self.dropout(self.ffn(y))), k_new, v_new


class Decoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.embed = SentenceEmbedding(cfg.trg_vocab_size, cfg)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_layers)
        )

    def forward(
        self, trg_tokens, memory, self_mask=None, cross_mask=None,
        trg_valid=None, memory_valid=None, *, self_causal: bool = False,
        positions=None,
    ):
        y = self.embed(trg_tokens, positions=positions)
        for layer in self.layers:
            y = layer(
                y, memory, self_mask, cross_mask, trg_valid, memory_valid,
                self_causal,
            )
        return y


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    # Flax's lecun_normal: truncated normal at two standard deviations,
    # variance 1/fan_in after truncation. A Linear weight is [out, in].
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class Transformer(nn.Module):
    """Encoder + Decoder + LM head (C23, ``transformer.py:255-284``).

    ``forward(src_tokens, trg_tokens)`` builds the three masks from the pad
    id — src self-attn padding, trg causal∧padding, cross (trg queries over
    src keys) — as structured masks; explicit dense masks may be passed to
    override. The model is built on the CPU; move it with ``.to(device)``.
    """

    def __init__(
        self, cfg: TransformerConfig, *, generator: torch.Generator | None = None
    ):
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.lm_head = _linear(
                cfg.d_model, cfg.trg_vocab_size + cfg.logit_pad, cfg
            )
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's initialiser families, drawn from ``generator`` (a fresh
        ``torch.Generator()`` seeded 0 when None) — never the global RNG."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, SentenceEmbedding):
                m.reset_table()

    def logits(self, y: torch.Tensor) -> torch.Tensor:
        """LM head with the vocab padding sliced off."""
        out = self.lm_head(y)
        if self.cfg.logit_pad:
            out = out[..., : self.cfg.trg_vocab_size]
        return out

    def forward(
        self,
        src_tokens: torch.Tensor,
        trg_tokens: torch.Tensor,
        src_mask: torch.Tensor | None = None,
        trg_mask: torch.Tensor | None = None,
        cross_mask: torch.Tensor | None = None,
        *,
        src_positions: torch.Tensor | None = None,
        trg_positions: torch.Tensor | None = None,
    ) -> torch.Tensor:
        pad = self.cfg.pad_id
        src_valid = (src_tokens != pad) if src_mask is None else None
        trg_valid = (trg_tokens != pad) if trg_mask is None else None
        memory_valid = (src_tokens != pad) if cross_mask is None else None
        memory = self.encoder(
            src_tokens, src_mask, src_valid, positions=src_positions
        )
        y = self.decoder(
            trg_tokens, memory, trg_mask, cross_mask, trg_valid, memory_valid,
            self_causal=trg_mask is None, positions=trg_positions,
        )
        return self.logits(y)

    def encode(self, src_tokens: torch.Tensor) -> torch.Tensor:
        return self.encoder(src_tokens, None, src_tokens != self.cfg.pad_id)

    def decode(self, trg_tokens, memory, src_valid) -> torch.Tensor:
        """One decoder pass → hidden states (causal + padding masks)."""
        return self.decoder(
            trg_tokens, memory, None, None, trg_tokens != self.cfg.pad_id,
            src_valid, self_causal=True,
        )

    def decode_logits(self, trg_tokens, memory, src_valid) -> torch.Tensor:
        """One decoder pass → vocab logits, for the generation loop."""
        return self.logits(self.decode(trg_tokens, memory, src_valid))

    def prefill_paged(self, src_tokens: torch.Tensor):
        """Paged-serving prefill: encode the prompt and project every
        decoder layer's cross-attention K/V over the memory. Returns
        ``(memory, k_mem, v_mem)`` with ``k_mem``/``v_mem`` ``[layers, B,
        S_src, d]``.

        The JAX package gets these by running a one-token decoder pass and
        keeping what its cross-attention sows; nothing else of that pass
        is live, so its compiled program drops the rest. The port computes
        only the live part: the memory projections."""
        memory = self.encode(src_tokens)
        kv = [layer.cross_attn.project_memory(memory) for layer in self.decoder.layers]
        k_mem = torch.stack([k for k, _ in kv])
        v_mem = torch.stack([v for _, v in kv])
        return memory, k_mem, v_mem

    def decode_step_paged(
        self, token, self_pages, mem_pages, self_table, self_len,
        mem_table, mem_len, positions, self_scales=None, mem_scales=None,
    ):
        """One ragged decode step over the paged KV stores: ``token`` is
        ``[R, 1]``; ``self_pages``/``mem_pages`` are ``[layers, 2,
        num_pages, page, d]`` stores (int8 ones with ``[layers, 2,
        num_pages, page]`` fp32 scales); tables/lengths address each row's
        pages; ``positions`` ``[R, 1]`` is each row's PE index. Returns
        ``(logits [R, 1, V], k_new [layers, R, d], v_new [layers, R, d])``
        — the step's self-attention K/V for the caller to scatter."""
        y = self.decoder.embed(token, positions=positions)
        k_new, v_new = [], []
        for i, layer in enumerate(self.decoder.layers):
            paged_self = dict(
                k_pages=self_pages[i, 0], v_pages=self_pages[i, 1],
                table=self_table, length=self_len,
            )
            paged_mem = dict(
                k_pages=mem_pages[i, 0], v_pages=mem_pages[i, 1],
                table=mem_table, length=mem_len,
            )
            if self_scales is not None:
                paged_self["k_scale"] = self_scales[i, 0]
                paged_self["v_scale"] = self_scales[i, 1]
            if mem_scales is not None:
                paged_mem["k_scale"] = mem_scales[i, 0]
                paged_mem["v_scale"] = mem_scales[i, 1]
            y, k, v = layer.forward_paged(y, paged_self, paged_mem)
            k_new.append(k)
            v_new.append(v)
        return self.logits(y), torch.stack(k_new), torch.stack(v_new)


@torch.no_grad()
def greedy_translate(
    model: Transformer,
    src_tokens: torch.Tensor,
    *,
    max_new_tokens: int | None = None,
    sos_id: int = 1,
    eos_id: int = 2,
) -> torch.Tensor:
    """Greedy decoding, re-running the full decoder per emitted token over
    a fixed-width buffer — the simple one-shot oracle. Generates exactly
    ``max_new_tokens`` tokens (default ``cfg.max_len - 1``) after the
    leading ``sos``; returns ``[B, max_new_tokens + 1]`` int64 ids, rows
    padded after their ``eos``. Runs on ``src_tokens``' device."""
    cfg = model.cfg
    pad = cfg.pad_id
    if max_new_tokens is None:
        max_new_tokens = cfg.max_len - 1
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    length = max_new_tokens + 1  # + the sos slot
    src_valid = src_tokens != pad
    memory = model.encode(src_tokens)
    ys = torch.full(
        (src_tokens.shape[0], length), pad, dtype=torch.long,
        device=src_tokens.device,
    )
    ys[:, 0] = sos_id
    finished = torch.zeros(src_tokens.shape[0], dtype=torch.bool, device=ys.device)
    for t in range(length - 1):
        y = model.decode(ys, memory, src_valid)
        # Only position t's logits are read: project that row alone.
        nxt = torch.argmax(model.logits(y[:, t, :]), dim=-1)
        nxt = torch.where(finished, pad, nxt)
        finished = finished | (nxt == eos_id)
        ys[:, t + 1] = nxt
    return ys
