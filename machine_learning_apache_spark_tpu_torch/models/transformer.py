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

Dropout draws its random bits from an explicit ``torch.Generator``
passed down as ``dropout_rng`` (Flax's ``rngs={"dropout": rng}``); with
none it is the identity (Flax's ``deterministic=True``), so eval, serving
and parity runs need no mode switch. The training step owns the
generator (``train.loop``). The bits differ from JAX's by design.

``cfg.moe_experts > 0`` swaps every FFN for the switch-routed
``models.moe.MoEFeedForward``. Its routing validity comes from the tokens
themselves, whatever mask overrides the caller passes; the one-token
decode paths (``decode_step``, ``decode_step_paged``) route their token
with no validity, as the JAX model does. ``forward(aux_losses=[])``
collects each MoE layer's load-balancing loss as a device tensor (Flax's
``mutable=["losses"]``).

``cfg.remat`` recomputes each encoder and decoder layer in the backward
(``torch.utils.checkpoint``, non-reentrant) when gradients are being
recorded: the training path only, never the decode, paged or prefill
paths. The checkpoint rewinds only the global generators, and dropout
draws from the fit's own; so a checkpointed layer keeps the keep-masks
its forward drew (one byte per element, ``_ReplayedDraws``) and its
recompute takes them back in the same order. Its gradients equal the
unrematerialised layer's bit for bit, on the CPU and inside a CUDA graph
alike.

Where Flax *sows* intermediate values into a mutable collection, these
methods return them: ``prefill_paged`` returns each layer's memory K/V,
``decode_step_paged`` each layer's new self-attention K/V. Flax's mutable
``cache`` collection (the KV-cache decoder's state) is an explicit
``DecodeCache`` that ``decode_step`` takes and returns.

The token embeddings' gradient is summed in an order fixed by the ids
(``EmbeddingLookup``): torch's ``embedding`` backward on the card gives
run-to-run different last bits when a token id repeats thousands of
times in a batch (the pads), and a training run must repeat bit for bit.

Parameters are made with an explicit ``torch.Generator`` (Flax's
initialiser families: LeCun-normal kernels, zero biases, N(0, 0.02)
embeddings, unit LayerNorm scales); modules are built on the meta device
first, so construction never draws from the global RNG.

``cfg.dtype`` is the compute dtype, Flax's ``dtype=`` with its default
``param_dtype=float32``: parameters stay float32 whatever it is (the
optimizer updates them in float32), and at ``bfloat16`` each layer casts
its input and parameters to bf16 and computes there — the linears
(``Dense``), the attention kernels, the embedding (looked up in float32,
then cast: Flax casts the table, then takes; the same values), the PE
table (built in bf16, as ``sinusoidal_encoding(..., dtype)``) — with two
exceptions as in Flax: ``LayerNorm`` takes its statistics and affine in
float32 and casts its output, and the MoE router runs in float32. The
logits, the decode caches and the paged stores come out in bf16.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from machine_learning_apache_spark_tpu_torch.ops import hopper_attention
from machine_learning_apache_spark_tpu_torch.ops.attention import (
    NEG_INF,
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
    # Recompute each encoder/decoder layer in the backward instead of
    # keeping its activations (training path only).
    remat: bool = False
    # Mixture-of-experts FFN (models.moe): 0 = the dense FFN; N > 0 puts N
    # switch-routed experts at every FFN site. Training adds
    # moe_aux_weight x the mean of the layers' load-balancing losses.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def add_bias(y: torch.Tensor, bias: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``y + bias`` (broadcast along ``dim``) in ``y``'s dtype: Flax's
    ``Dense`` and ``Conv`` add the bias to the product already rounded to
    the compute dtype, so at bf16 there are two roundings, as here."""
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).view(shape)


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``
    (Flax's ``Dense(dtype=)``): input, weight and bias cast to ``dtype``,
    then ``x·Wᵀ`` rounded to ``dtype`` and the bias added (``add_bias``).
    At float32 it is ``nn.Linear`` (one fused call: the same function).

    ``axes`` are the Flax kernel's logical axis names (``[in, out]``) and
    ``parts`` the fused projections its output holds, which
    ``parallel.tensor_parallel.shard_params`` reads; once sharded, ``tp``
    runs the layer's column- or row-parallel forward."""

    tp = None  # a tensor_parallel.LinearShard once sharded

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype = torch.float32,
                 *, axes: tuple | None = None, parts: int = 1):
        super().__init__(n_in, n_out)
        self.compute_dtype = dtype
        if axes is not None:
            self.logical_axes, self.fused_parts = tuple(axes), parts

    def compute(self, x: torch.Tensor, *, with_bias: bool = True) -> torch.Tensor:
        """``x·Wᵀ (+ b)`` in the compute dtype, on whatever slice of the
        weight this rank holds."""
        dt = self.compute_dtype
        bias = self.bias if with_bias else None
        if dt == torch.float32:
            return nn.functional.linear(x, self.weight, bias)
        y = nn.functional.linear(x.to(dt), self.weight.to(dt))
        return y if bias is None else add_bias(y, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp(self, x)
        return self.compute(x)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with float32 parameters whose output is cast to
    ``dtype`` (Flax's ``LayerNorm(dtype=)``: mean, variance, scale and
    bias in float32 whatever the input's dtype)."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(self.compute_dtype)


def _linear(n_in: int, n_out: int, cfg: TransformerConfig, axes: tuple | None = None,
            parts: int = 1) -> nn.Linear:
    return Dense(n_in, n_out, cfg.dtype, axes=axes, parts=parts)


def _layer_norm(cfg: TransformerConfig) -> nn.LayerNorm:
    return LayerNorm(cfg.d_model, LN_EPS, cfg.dtype)


class EmbeddingLookup(torch.autograd.Function):
    """``weight[tokens]`` whose weight gradient is summed in an order fixed
    by the ids alone, with no atomics and no host sync, so it repeats bit
    for bit and a CUDA graph can hold it.

    The backward sorts the ids (stably) and cuts the sorted rows into
    chunks of ``CHUNK``. In each chunk one batched matmul with a 0/1
    lower-triangular same-id mask gives every row the running sum of its
    id's rows so far; a second, over the chunks' last rows, carries each
    id's sum across the chunks it spans. An id's gradient is the running
    sum at its last sorted row."""

    CHUNK = 64

    @staticmethod
    def forward(ctx, weight, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = weight.shape[0]
        return torch.nn.functional.embedding(tokens, weight)

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        rows, chunk = ctx.rows, EmbeddingLookup.CHUNK
        ids = tokens.reshape(-1)
        n, dev = ids.shape[0], ids.device
        grad = grad.reshape(n, -1)
        width = grad.shape[1]
        order = torch.argsort(ids.int(), stable=True)
        # Sorted ids padded to whole chunks with an id past the vocabulary.
        size = -(-n // chunk) * chunk
        sorted_ids = torch.full((size,), rows, dtype=ids.dtype, device=dev)
        sorted_ids[:n] = ids[order]
        rows_in = grad.new_zeros(size, width)
        rows_in[:n] = grad[order]
        chunk_ids = sorted_ids.view(-1, chunk)
        tri = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
        running = torch.bmm(
            ((chunk_ids[:, :, None] == chunk_ids[:, None, :]) & tri).to(grad.dtype),
            rows_in.view(-1, chunk, width),
        )
        # Each chunk's last row, summed over the chunks that end with its id.
        end_ids = chunk_ids[:, -1]
        spans = torch.ones(len(end_ids), len(end_ids), dtype=torch.bool, device=dev).tril()
        carried = ((end_ids[:, None] == end_ids[None, :]) & spans).to(grad.dtype) @ running[:, -1]
        # A row whose id runs on from the previous chunk adds its carry.
        prev_ids = torch.cat([end_ids.new_full((1,), -1), end_ids[:-1]])
        prev_sums = torch.cat([carried.new_zeros(1, width), carried[:-1]])
        running = running + torch.where(
            (chunk_ids == prev_ids[:, None])[:, :, None], prev_sums[:, None, :], 0.0
        )
        counts = torch.zeros(rows, dtype=torch.long, device=dev)
        counts.scatter_add_(0, ids, torch.ones_like(ids))
        last = (torch.cumsum(counts, 0) - 1).clamp(min=0)
        weight_grad = torch.where(
            (counts > 0)[:, None], running.view(size, width)[last], 0.0
        )
        return weight_grad, None


class _ReplayedDraws:
    """A rematerialised layer's dropout draws: the layer's first run
    draws each keep-mask from ``rng`` and keeps it; after ``rewind()``
    (the recompute in the backward) the same masks come back in order.
    ``torch.utils.checkpoint`` cannot rewind an explicit generator, and
    inside a CUDA graph no generator state can be read or set; holding
    the masks needs neither."""

    def __init__(self, rng: torch.Generator):
        self.rng = rng
        self.masks: list[torch.Tensor] = []
        self.next = 0

    def rewind(self) -> None:
        self.next = 0

    def keep_mask(self, x: torch.Tensor, keep: float, shards: tuple = ()) -> torch.Tensor:
        if self.next == len(self.masks):
            self.masks.append(_draw_keep_mask(x, keep, self.rng, shards))
        mask = self.masks[self.next]
        self.next += 1
        return mask


def _draw_keep_mask(x: torch.Tensor, keep: float, rng: torch.Generator,
                    shards: tuple = ()) -> torch.Tensor:
    """The keep-mask of ``x``. For a shard of ``x`` (``shards``: ``(dim,
    index, size)`` for each dim of which this rank holds the ``index``-th
    of ``size`` equal slices) the mask of the whole tensor is drawn and
    this rank's slice kept, so the shards of one layer draw as the
    unsharded layer does and every rank's generator advances alike."""
    shape = list(x.shape)
    for dim, _, size in shards:
        shape[dim] *= size
    draw = torch.rand(shape, generator=rng, device=x.device, dtype=x.dtype)
    for dim, index, _ in shards:
        width = x.shape[dim]
        draw = draw.narrow(dim, index * width, width)
    return draw < keep


class Dropout(nn.Module):
    """Flax's ``nn.Dropout`` with its bits from an explicit generator.

    ``forward(x, rng)``: with ``rng`` None or ``rate`` 0 it returns ``x``
    (Flax's ``deterministic=True``); with ``rate`` 1, zeros; otherwise it
    keeps each element where ``torch.rand(..., generator=rng) < 1 - rate``
    and scales the kept ones by ``1 / (1 - rate)``. ``rng`` must live on
    ``x``'s device (or be a rematerialised layer's ``_ReplayedDraws``).
    Never touches the global RNG. On a shard (``shards``, set by tensor
    and expert parallelism: ``(dim, index, size)`` per sharded dim) the
    mask is this rank's slice of the whole tensor's."""

    shards: tuple = ()

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(
        self, x: torch.Tensor, rng: torch.Generator | None = None
    ) -> torch.Tensor:
        if rng is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if keep == 0.0:
            return torch.zeros_like(x)
        if isinstance(rng, _ReplayedDraws):
            mask = rng.keep_mask(x, keep, self.shards)
        else:
            mask = _draw_keep_mask(x, keep, rng, self.shards)
        return torch.where(mask, x / keep, 0.0)


@dataclasses.dataclass
class DecodeCache:
    """The KV-cache decoder's state: what the JAX package keeps in Flax's
    mutable ``cache`` collection, as one object that ``decode_step``
    takes and returns.

    ``key``/``value`` ``[layers, B, gen_len, d]``: each decoder layer's
    self-attention K/V, written one position per step at ``index`` (the
    shared write index); ``mem_key``/``mem_value`` ``[layers, B, S_src,
    d]``: each layer's cross-attention K/V over the encoder memory,
    projected once, on the priming call. ``decode_step`` writes the
    buffers in place and returns the cache with ``index`` advanced.
    """

    key: torch.Tensor
    value: torch.Tensor
    mem_key: torch.Tensor
    mem_value: torch.Tensor
    index: int = 0

    @property
    def gen_len(self) -> int:
        return self.key.shape[2]

    def reorder(self, rows: torch.Tensor) -> "DecodeCache":
        """The cache with its self-attention rows gathered by ``rows``
        (beam search's reorder). The memory K/V stay as they are: a
        sentence's beams share them, and a reorder only moves rows
        between beams of one sentence."""
        return dataclasses.replace(
            self,
            key=self.key.index_select(1, rows),
            value=self.value.index_select(1, rows),
        )


class SentenceEmbedding(nn.Module):
    """Token embedding + sinusoidal positional encoding + dropout (C16,
    ``transformer.py:44-62``), with the PE table kept on the module's
    device."""

    def __init__(self, vocab_size: int, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, cfg.d_model)  # float32, as Flax's param
        self.dropout = Dropout(cfg.dropout)
        self.register_buffer(
            "pe", torch.empty(cfg.max_len, cfg.d_model, dtype=cfg.dtype),
            persistent=False,
        )

    def reset_table(self) -> None:
        self.pe.copy_(sinusoidal_encoding(self.cfg.max_len, self.cfg.d_model))

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        positions: torch.Tensor | None = None,
        position_offset: int = 0,
        dropout_rng: torch.Generator | None = None,
    ) -> torch.Tensor:
        x = EmbeddingLookup.apply(self.embed.weight, tokens).to(self.cfg.dtype)
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
            # ``position_offset`` shifts the window for incremental
            # decoding (token t gets row t), clamped into the table as
            # JAX's dynamic_slice clamps its start.
            start = min(max(position_offset, 0), table.shape[0] - length)
            pe = table[start : start + length]
        return self.dropout(x + pe, dropout_rng)


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused ``qkv`` projection (C17), or
    cross-attention with ``q`` and a fused ``kv`` (C21) that reshapes each
    stream with its own length (Q8 fixed).

    Under tensor parallelism the projections are column-parallel and
    ``out`` row-parallel; ``heads`` becomes this rank's ``H/M``, whose q,
    k and v columns its slices of the fused kernels hold."""

    def __init__(self, cfg: TransformerConfig, *, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        self.heads = cfg.num_heads
        d = cfg.d_model
        if cross:
            self.q = _linear(d, d, cfg, ("embed", "heads"))
            self.kv = _linear(d, 2 * d, cfg, ("embed", "heads"), parts=2)
        else:
            self.qkv = _linear(d, 3 * d, cfg, ("embed", "heads"), parts=3)
        self.out = _linear(d, d, cfg, ("heads", "embed"))

    def tp_check(self, ways: int) -> None:
        if self.cfg.num_heads % ways:
            raise ValueError(
                f"num_heads={self.cfg.num_heads} does not divide over a "
                f"{ways}-way model axis: each rank runs whole heads"
            )

    def tp_sharded(self, axis) -> None:
        if (self.q if self.cross else self.qkv).tp is not None:
            self.heads = self.cfg.num_heads // axis.size

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, length, _ = t.shape
        return t.view(b, length, self.heads, self.cfg.head_dim).transpose(1, 2)

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
        return self.out(out.transpose(1, 2).reshape(b, s_q, self.heads * self.cfg.head_dim))

    def forward_decode(
        self,
        x: torch.Tensor,
        cache: DecodeCache,
        layer: int,
        kv_valid: torch.Tensor | None,
        *,
        prime: bool,
    ) -> torch.Tensor:
        """One position per row (``x`` ``[B, 1, d]``) against the decode
        cache: the ``decode=True`` branches of the JAX package's
        ``MultiHeadAttention``. Cross-attention attends the cached memory
        K/V under ``kv_valid`` (the source validity). Self-attention on
        the priming call (``prime``, ``kv_valid`` None) attends only its
        own K/V and writes nothing; on later calls it writes its K/V at
        ``cache.index`` and attends the whole buffer under ``kv_valid``
        (the written prefix and the target validity), never causal."""
        b = x.shape[0]
        if self.cross:
            q = self.q(x)
            k, v = cache.mem_key[layer], cache.mem_value[layer]
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
            if not prime:
                cache.key[layer, :, cache.index] = k[:, 0]
                cache.value[layer, :, cache.index] = v[:, 0]
                k, v = cache.key[layer], cache.value[layer]
        out = dot_product_attention(
            self._split_heads(q), self._split_heads(k), self._split_heads(v),
            kv_valid=kv_valid,
        )
        return self.out(out.transpose(1, 2).reshape(b, 1, self.cfg.d_model))

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
    Linear(ffn) → ReLU → Dropout → Linear(d). Takes ``MoEFeedForward``'s
    ``valid`` and ``aux`` and ignores them."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.up = _linear(cfg.d_model, cfg.ffn_hidden, cfg, ("embed", "mlp"))
        self.down = _linear(cfg.ffn_hidden, cfg.d_model, cfg, ("mlp", "embed"))
        self.dropout = Dropout(cfg.dropout)

    def tp_sharded(self, axis) -> None:
        # The dropout between up and down sees this rank's hidden slice.
        if self.up.tp is not None:
            self.dropout.shards = ((-1, axis.index, axis.size),)

    def forward(
        self, x: torch.Tensor, dropout_rng: torch.Generator | None = None, *,
        valid=None, aux=None,
    ) -> torch.Tensor:
        return self.down(self.dropout(torch.relu(self.up(x)), dropout_rng))


def _make_ffn(cfg: TransformerConfig) -> nn.Module:
    """The dense FFN, or the switch-routed MoE one when ``cfg.moe_experts``."""
    if cfg.moe_experts > 0:
        from machine_learning_apache_spark_tpu_torch.models.moe import MoEFeedForward

        return MoEFeedForward(
            cfg.d_model, cfg.ffn_hidden, cfg.moe_experts,
            capacity_factor=cfg.moe_capacity_factor, dropout=cfg.dropout,
            dtype=cfg.dtype,
        )
    return FeedForward(cfg)


def _token_valid(tokens: torch.Tensor, cfg: TransformerConfig):
    """MoE routing validity, from the tokens whatever the mask overrides."""
    return tokens != cfg.pad_id if cfg.moe_experts > 0 else None


def _run_layer(layer: nn.Module, remat: bool, *args, dropout_rng, aux):
    """``layer(*args, dropout_rng=, aux=)``; with ``remat`` while grad is
    recorded, through a non-reentrant ``checkpoint``. Its recompute (on
    autograd's device thread) replays the first run's dropout masks
    (``_ReplayedDraws``), counts its kernel launches as the first run's
    thread does (so a graph capture records them), and hands the MoE
    layers a list of its own for the aux losses, which the loss has read
    by then."""
    if not (remat and torch.is_grad_enabled()):
        return layer(*args, dropout_rng=dropout_rng, aux=aux)
    draws = None if dropout_rng is None else _ReplayedDraws(dropout_rng)
    recording = hopper_attention.launch_recording()
    first = True

    def run(*tensors):
        nonlocal first
        if first:
            first = False
            return layer(*tensors, dropout_rng=draws, aux=aux)
        if draws is not None:
            draws.rewind()
        with hopper_attention.recording_as(recording):
            return layer(*tensors, dropout_rng=draws, aux=None if aux is None else [])

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class EncoderLayer(nn.Module):
    """Post-LN residual block (C20, ``transformer.py:120-139``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.ln1 = _layer_norm(cfg)
        self.ffn = _make_ffn(cfg)
        self.ln2 = _layer_norm(cfg)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask=None, kv_valid=None, token_valid=None, *,
                dropout_rng=None, aux=None):
        attn = self.self_attn(x, mask=mask, kv_valid=kv_valid)
        x = self.ln1(x + self.dropout(attn, dropout_rng))
        ffn = self.ffn(x, dropout_rng, valid=token_valid, aux=aux)
        return self.ln2(x + self.dropout(ffn, dropout_rng))


class Encoder(nn.Module):
    """Embedding + layer stack (C20's ``Encoder``, ``transformer.py:149-166``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = SentenceEmbedding(cfg.src_vocab_size, cfg)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_layers)
        )

    def forward(
        self, src_tokens, src_mask=None, src_valid=None, *, positions=None,
        dropout_rng=None, aux=None,
    ):
        x = self.embed(src_tokens, positions=positions, dropout_rng=dropout_rng)
        return self.run_layers(
            x, 0, len(self.layers), src_mask, src_valid, _token_valid(src_tokens, self.cfg),
            dropout_rng=dropout_rng, aux=aux,
        )

    def run_layers(
        self, x, start: int, stop: int, src_mask=None, src_valid=None, token_valid=None, *,
        dropout_rng=None, aux=None,
    ):
        """Layers ``[start, stop)`` of the stack on ``x`` (one pipeline
        stage's share), each through ``cfg.remat``'s recompute when set."""
        for layer in self.layers[start:stop]:
            x = _run_layer(
                layer, self.cfg.remat, x, src_mask, src_valid, token_valid,
                dropout_rng=dropout_rng, aux=aux,
            )
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
        self.ffn = _make_ffn(cfg)
        self.ln3 = _layer_norm(cfg)
        self.dropout = Dropout(cfg.dropout)

    def forward(
        self, y, memory, self_mask=None, cross_mask=None, trg_valid=None,
        memory_valid=None, self_causal: bool = False, token_valid=None, *,
        dropout_rng=None, aux=None,
    ):
        attn = self.self_attn(
            y, mask=self_mask, causal=self_causal, kv_valid=trg_valid
        )
        y = self.ln1(y + self.dropout(attn, dropout_rng))
        cross = self.cross_attn(
            y, memory, mask=cross_mask, kv_valid=memory_valid
        )
        y = self.ln2(y + self.dropout(cross, dropout_rng))
        ffn = self.ffn(y, dropout_rng, valid=token_valid, aux=aux)
        return self.ln3(y + self.dropout(ffn, dropout_rng))

    def forward_decode(self, y, cache, layer, self_valid, memory_valid, *, prime):
        attn = self.self_attn.forward_decode(y, cache, layer, self_valid, prime=prime)
        y = self.ln1(y + self.dropout(attn))
        cross = self.cross_attn.forward_decode(
            y, cache, layer, memory_valid, prime=prime
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
        self.cfg = cfg
        self.embed = SentenceEmbedding(cfg.trg_vocab_size, cfg)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_layers)
        )

    def forward(
        self, trg_tokens, memory, self_mask=None, cross_mask=None,
        trg_valid=None, memory_valid=None, *, self_causal: bool = False,
        positions=None, dropout_rng=None, aux=None,
    ):
        y = self.embed(trg_tokens, positions=positions, dropout_rng=dropout_rng)
        return self.run_layers(
            y, 0, len(self.layers), memory, self_mask, cross_mask, trg_valid, memory_valid,
            self_causal=self_causal, token_valid=_token_valid(trg_tokens, self.cfg),
            dropout_rng=dropout_rng, aux=aux,
        )

    def run_layers(
        self, y, start: int, stop: int, memory, self_mask=None, cross_mask=None,
        trg_valid=None, memory_valid=None, *, self_causal: bool = False, token_valid=None,
        dropout_rng=None, aux=None,
    ):
        """Layers ``[start, stop)`` of the stack on ``y`` (one pipeline
        stage's share), each through ``cfg.remat``'s recompute when set."""
        for layer in self.layers[start:stop]:
            y = _run_layer(
                layer, self.cfg.remat, y, memory, self_mask, cross_mask,
                trg_valid, memory_valid, self_causal, token_valid,
                dropout_rng=dropout_rng, aux=aux,
            )
        return y

    def forward_decode(
        self, token, cache, self_valid, memory_valid, position: int, *, prime: bool
    ):
        """One incremental step of the stack over the decode cache:
        ``token`` ``[B, 1]`` embedded at PE row ``position``."""
        y = self.embed(token, position_offset=position)
        for i, layer in enumerate(self.layers):
            y = layer.forward_decode(
                y, cache, i, self_valid, memory_valid, prime=prime
            )
        return y


def lecun_normal_(
    w: torch.Tensor, generator: torch.Generator | None, fan_in: int | None = None
) -> None:
    """Flax's ``lecun_normal``: a truncated normal at two standard
    deviations with variance ``1/fan_in`` after truncation. ``fan_in``
    defaults to a ``Linear`` weight's (``[out, in]``) input width."""
    fan_in = w.shape[1] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class Transformer(nn.Module):
    """Encoder + Decoder + LM head (C23, ``transformer.py:255-284``).

    ``forward(src_tokens, trg_tokens)`` builds the three masks from the pad
    id — src self-attn padding, trg causal∧padding, cross (trg queries over
    src keys) — as structured masks; explicit dense masks may be passed to
    override. ``dropout_rng`` (a ``torch.Generator`` on the model's
    device) turns dropout on, as Flax's ``rngs={"dropout": ...}`` with
    ``deterministic=False`` does. ``aux_losses`` (a list) receives each
    MoE layer's load-balancing loss, encoder layers first. The model is
    built on the CPU; move it with ``.to(device)``.
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
                cfg.d_model, cfg.trg_vocab_size + cfg.logit_pad, cfg, ("embed", "vocab")
            )
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's initialiser families, drawn from ``generator`` (a fresh
        ``torch.Generator()`` seeded 0 when None) — never the global RNG."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        from machine_learning_apache_spark_tpu_torch.models.moe import MoEFeedForward

        for m in self.modules():
            if isinstance(m, MoEFeedForward):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, SentenceEmbedding):
                m.reset_table()

    #: Set by tensor and expert parallelism: the model and expert axes
    #: this model's shards lie on.
    tp_axis = None
    ep_axis = None

    @property
    def vocab_shard(self):
        """``(model axis, first vocab column)`` when the LM head is
        vocab-parallel: ``logits`` then returns this rank's columns,
        ``logit_pad`` included, for the vocab-parallel loss; else None."""
        if self.lm_head.tp is None:
            return None
        axis = self.lm_head.tp.axis
        return axis, axis.index * self.lm_head.weight.shape[0]

    def _single_device(self, what: str) -> None:
        if self.tp_axis is not None or self.ep_axis is not None:
            raise ValueError(
                f"{what} runs on whole weights; this model holds a model- or "
                "expert-axis shard — load tensor_parallel.gather_params(model) "
                "into an unsharded Transformer"
            )

    def logits(self, y: torch.Tensor) -> torch.Tensor:
        """LM head with the vocab padding sliced off (a vocab-parallel
        head's local columns stay as they are)."""
        out = self.lm_head(y)
        if self.cfg.logit_pad and self.lm_head.tp is None:
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
        dropout_rng: torch.Generator | None = None,
        aux_losses: list | None = None,
    ) -> torch.Tensor:
        pad = self.cfg.pad_id
        src_valid = (src_tokens != pad) if src_mask is None else None
        trg_valid = (trg_tokens != pad) if trg_mask is None else None
        memory_valid = (src_tokens != pad) if cross_mask is None else None
        memory = self.encoder(
            src_tokens, src_mask, src_valid, positions=src_positions,
            dropout_rng=dropout_rng, aux=aux_losses,
        )
        y = self.decoder(
            trg_tokens, memory, trg_mask, cross_mask, trg_valid, memory_valid,
            self_causal=trg_mask is None, positions=trg_positions,
            dropout_rng=dropout_rng, aux=aux_losses,
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
        self._single_device("decoding")
        return self.logits(self.decode(trg_tokens, memory, src_valid))

    def decode_step(
        self,
        token: torch.Tensor,
        memory: torch.Tensor,
        src_valid: torch.Tensor,
        position: int,
        trg_valid: torch.Tensor | None = None,
        cache: DecodeCache | None = None,
    ) -> tuple[torch.Tensor, DecodeCache]:
        """One incremental step of the KV-cache decoder (the JAX
        package's ``Transformer.decode_step``): ``token`` ``[B, 1]`` at
        generation position ``position``; returns ``(logits [B, 1, V],
        cache)``. O(1) projection work per token: the self-attention K/V
        of earlier tokens and the memory's cross-attention K/V come from
        the cache.

        With ``cache`` None this is the priming call: it projects every
        layer's cross-attention K/V over ``memory`` once, makes zeroed
        self-attention buffers of ``trg_valid.shape[1]`` positions
        (``cfg.max_len`` without ``trg_valid``) and writes nothing into
        them; its self-attention sees only its own K/V. Later calls write
        this step's K/V at ``cache.index``, attend the written prefix with
        ``trg_valid`` ``[B, gen_len]`` (False where the token is pad)
        masking it further, and return the cache with ``index`` + 1."""
        self._single_device("decode_step")
        prime = cache is None
        if prime:
            gen_len = self.cfg.max_len if trg_valid is None else trg_valid.shape[1]
            mem_key, mem_value = self._memory_kv(memory)
            buf = memory.new_zeros((mem_key.shape[0], memory.shape[0], gen_len, self.cfg.d_model))
            cache = DecodeCache(buf, buf.clone(), mem_key, mem_value)
            self_valid = None  # the priming call attends its own K/V alone
        else:
            prefix = torch.arange(cache.gen_len, device=token.device) < cache.index + 1
            self_valid = (
                prefix.expand(token.shape[0], -1) if trg_valid is None
                else prefix & trg_valid
            )
        y = self.decoder.forward_decode(
            token, cache, self_valid, src_valid, position, prime=prime
        )
        if not prime:
            cache = dataclasses.replace(cache, index=cache.index + 1)
        return self.logits(y), cache

    def prefill_paged(self, src_tokens: torch.Tensor):
        """Paged-serving prefill: encode the prompt and project every
        decoder layer's cross-attention K/V over the memory. Returns
        ``(memory, k_mem, v_mem)`` with ``k_mem``/``v_mem`` ``[layers, B,
        S_src, d]``.

        The JAX package gets these by running a one-token decoder pass and
        keeping what its cross-attention sows; nothing else of that pass
        is live, so its compiled program drops the rest. The port computes
        only the live part: the memory projections."""
        self._single_device("prefill_paged")
        memory = self.encode(src_tokens)
        return (memory, *self._memory_kv(memory))

    def _memory_kv(self, memory: torch.Tensor):
        """Every decoder layer's cross-attention K/V over ``memory``,
        stacked: ``[layers, B, S_src, d]`` each."""
        kv = [layer.cross_attn.project_memory(memory) for layer in self.decoder.layers]
        return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

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


def _validate_max_new_tokens(max_new_tokens: int | None, cfg: TransformerConfig) -> int:
    if max_new_tokens is None:
        return cfg.max_len - 1
    if not 1 <= max_new_tokens <= cfg.max_len - 1:
        raise ValueError(
            f"max_new_tokens must be in [1, {cfg.max_len - 1}], got "
            f"{max_new_tokens}"
        )
    return max_new_tokens


def _prime_decode_cache(model, memory, src_valid, gen_len, sos_id) -> DecodeCache:
    """The cached decoders' priming call: zeroed self-attention buffers of
    ``gen_len`` positions and the memory's cross-attention K/V, projected
    once. Its logits are discarded; it writes nothing into the self cache,
    so the first real step recomputes ``sos`` with the same semantics."""
    rows = memory.shape[0]
    token = torch.full((rows, 1), sos_id, dtype=torch.long, device=memory.device)
    valid = torch.ones((rows, gen_len), dtype=torch.bool, device=memory.device)
    return model.decode_step(token, memory, src_valid, 0, valid)[1]


@torch.no_grad()
def _cached_decode(
    model: Transformer,
    src_tokens: torch.Tensor,
    select_next,
    *,
    max_new_tokens: int | None,
    sos_id: int,
    eos_id: int,
) -> torch.Tensor:
    """The KV-cache decode loop shared by the greedy and sampling
    decoders: encode once, prime the cache, then one-token decoder steps;
    ``select_next(logits [B, V], t) -> [B]`` is the only policy
    difference. The cache holds ``max_new_tokens + 1`` positions (the
    JAX package sizes its decode model's ``max_len`` so), and every step
    attends that many keys, the unwritten ones masked."""
    cfg = model.cfg
    pad = cfg.pad_id
    max_new_tokens = _validate_max_new_tokens(max_new_tokens, cfg)
    b = src_tokens.shape[0]
    src_valid = src_tokens != pad
    memory = model.encode(src_tokens)
    gen_len = max_new_tokens + 1
    cache = _prime_decode_cache(model, memory, src_valid, gen_len, sos_id)
    ys = torch.full((b, gen_len), pad, dtype=torch.long, device=src_tokens.device)
    ys[:, 0] = sos_id
    finished = torch.zeros(b, dtype=torch.bool, device=ys.device)
    for t in range(max_new_tokens):
        # Pad tokens in the prefix stay unattendable, as in greedy_translate.
        logits, cache = model.decode_step(
            ys[:, t : t + 1], memory, src_valid, t, ys != pad, cache
        )
        nxt = select_next(logits[:, 0, :], t)
        nxt = torch.where(finished, pad, nxt)
        finished = finished | (nxt == eos_id)
        ys[:, t + 1] = nxt
    return ys


def greedy_translate_cached(
    model: Transformer,
    src_tokens: torch.Tensor,
    *,
    max_new_tokens: int | None = None,
    sos_id: int = 1,
    eos_id: int = 2,
) -> torch.Tensor:
    """KV-cache greedy decoding: ``_cached_decode`` with an argmax policy.
    Same output contract as ``greedy_translate`` (``[B, max_new_tokens +
    1]`` int64, ``sos``-led, padded after ``eos``); ``max_new_tokens``
    must lie in ``[1, cfg.max_len - 1]``."""
    return _cached_decode(
        model, src_tokens, lambda logits, t: torch.argmax(logits, dim=-1),
        max_new_tokens=max_new_tokens, sos_id=sos_id, eos_id=eos_id,
    )


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the ``k`` largest values,
    descending, the lower index first among equal values. ``torch.topk``
    does not promise that order on ties; a stable descending sort does."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def beam_translate(
    model: Transformer,
    src_tokens: torch.Tensor,
    *,
    beam_size: int = 4,
    max_new_tokens: int | None = None,
    length_penalty: float = 0.6,
    sos_id: int = 1,
    eos_id: int = 2,
) -> torch.Tensor:
    """KV-cache beam search (the JAX package's ``beam_translate``).

    Beams are flat-batched: row ``b * K + j`` is beam ``j`` of sentence
    ``b``, and all rows share one decode cache, reordered each step by
    ``index_select`` on its rows (the memory K/V are not gathered). Step
    0 searches beam 0 only; finished beams extend with ``pad`` at zero
    cost; a hypothesis is scored with the GNMT length penalty
    ``((5 + L) / 6) ** length_penalty`` and banked the step it finishes,
    so top-k can never evict the best finished one. ``beam_size=1`` is
    greedy decoding. Returns ``[B, max_new_tokens + 1]`` int64 ids, the
    ``greedy_translate`` contract."""
    cfg = model.cfg
    pad = cfg.pad_id
    max_new_tokens = _validate_max_new_tokens(max_new_tokens, cfg)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    b, k = src_tokens.shape[0], beam_size
    gen_len = max_new_tokens + 1
    vocab = cfg.trg_vocab_size
    dev = src_tokens.device

    src_valid = src_tokens != pad
    memory = model.encode(src_tokens).repeat_interleave(k, dim=0)
    src_valid_t = src_valid.repeat_interleave(k, dim=0)
    cache = _prime_decode_cache(model, memory, src_valid_t, gen_len, sos_id)

    ys = torch.full((b, k, gen_len), pad, dtype=torch.long, device=dev)
    ys[:, :, 0] = sos_id
    scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.long, device=dev)  # incl. eos
    best_score = torch.full((b,), NEG_INF, dtype=torch.float32, device=dev)
    best_ys = torch.full((b, gen_len), pad, dtype=torch.long, device=dev)
    # Built without a host-to-device copy, so the serving engine can
    # capture the whole search as one CUDA graph.
    pad_only = torch.where(torch.arange(vocab, device=dev) == pad, 0.0, NEG_INF)
    later_beams = torch.arange(k, device=dev)[None, :, None] > 0
    sentence = torch.arange(b, device=dev)

    def penalize(score, length):
        return score / ((5.0 + length.float()) / 6.0) ** length_penalty

    for t in range(max_new_tokens):
        logits, cache = model.decode_step(
            ys[:, :, t].reshape(b * k, 1), memory, src_valid_t, t,
            (ys != pad).reshape(b * k, gen_len), cache,
        )
        logp = torch.log_softmax(logits[:, 0, :].float(), dim=-1).reshape(b, k, vocab)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        total = scores[:, :, None] + logp
        if t == 0:  # every beam is a copy of sos: search beam 0 only
            total = torch.where(later_beams, NEG_INF, total)
        scores, flat_idx = _top_k(total.reshape(b, k * vocab), k)
        beam_idx = flat_idx // vocab  # [b, k]: each new beam's parent
        token = flat_idx % vocab
        was_finished = finished.gather(1, beam_idx)
        ys = ys.gather(1, beam_idx[:, :, None].expand(-1, -1, gen_len))
        ys[:, :, t + 1] = token
        lengths = lengths.gather(1, beam_idx) + (~was_finished).long()
        newly_finished = ~was_finished & (token == eos_id)
        finished = was_finished | (token == eos_id)
        # Bank the best newly finished hypothesis before top-k can evict it.
        cand = torch.where(newly_finished, penalize(scores, lengths), NEG_INF)
        cand_beam = torch.argmax(cand, dim=1)
        cand_score = cand[sentence, cand_beam]
        better = cand_score > best_score
        best_score = torch.where(better, cand_score, best_score)
        best_ys = torch.where(better[:, None], ys[sentence, cand_beam], best_ys)
        cache = cache.reorder((sentence[:, None] * k + beam_idx).reshape(-1))

    # The banked best finished hypothesis wins where one exists; otherwise
    # the best live beam by penalized score.
    live_ys = ys[sentence, torch.argmax(penalize(scores, lengths), dim=1)]
    use_banked = best_score > NEG_INF * 0.5
    return torch.where(use_banked[:, None], best_ys, live_ys)


def _filter_logits(
    logits: torch.Tensor, temperature: float, top_k: int | None, top_p: float | None
) -> torch.Tensor:
    """Sampling filters over ``[B, V]`` logits: temperature, then top-k,
    then nucleus (top-p); what they drop becomes ``NEG_INF``."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        # top_k >= vocab keeps everything, like the temperature-only case.
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # The smallest prefix whose mass reaches top_p (the first token
        # always stays: its exclusive cumulative mass is 0 < top_p).
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.where(exclusive_cum < top_p, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def sample_translate(
    model: Transformer,
    src_tokens: torch.Tensor,
    rng: torch.Generator,
    *,
    max_new_tokens: int | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    sos_id: int = 1,
    eos_id: int = 2,
) -> torch.Tensor:
    """Stochastic decoding with temperature / top-k / nucleus filtering:
    ``_cached_decode`` with a filtered-categorical policy;
    ``temperature <= 0`` is argmax. ``rng`` is a ``torch.Generator`` on
    ``src_tokens``' device (the global RNG is never drawn from); one seed
    gives one output. The categorical draw is Gumbel-max, ``argmax(logits
    - log(-log(u)))`` with ``u`` uniform from ``rng``: the JAX package's
    ``jax.random.categorical`` draws the same distribution from other
    bits. Same output contract as the greedy decoders."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not isinstance(rng, torch.Generator):
        raise TypeError(f"rng must be a torch.Generator, got {type(rng).__name__}")
    if rng.device.type != src_tokens.device.type:
        raise ValueError(
            f"rng is a generator on {rng.device}, the tokens are on "
            f"{src_tokens.device}: pass torch.Generator(device) on the "
            "tokens' device"
        )
    if temperature <= 0.0:
        def select(logits, t):
            return torch.argmax(logits, dim=-1)
    else:
        tiny = torch.finfo(torch.float32).tiny

        def select(logits, t):
            filtered = _filter_logits(logits, temperature, top_k, top_p)
            u = torch.rand(filtered.shape, generator=rng, device=filtered.device)
            return torch.argmax(filtered - torch.log(-torch.log(u.clamp_(min=tiny))), dim=-1)

    return _cached_decode(
        model, src_tokens, select,
        max_new_tokens=max_new_tokens, sos_id=sos_id, eos_id=eos_id,
    )
