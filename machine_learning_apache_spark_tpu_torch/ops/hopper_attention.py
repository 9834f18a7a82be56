"""The serving slice's attention kernels for Hopper, beside their plain
PyTorch versions.

Two CUDA C++ kernels (``csrc/``), each replacing a Pallas TPU kernel of
``machine_learning_apache_spark_tpu/ops/pallas_attention.py``:

- ``flash_attention`` → ``csrc/flash_attention_fwd.cu``, replacing
  ``_flash_kernel`` (the forward, without the ``lse`` output that only
  the backward needs);
- ``ragged_paged_attention`` → ``csrc/ragged_paged_attention.cu``,
  replacing ``_ragged_paged_kernel``.

Each source's header says what bounds it on the card and how its design
answers that. Each wrapper takes the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises — there is no
fallback. ``LAUNCHES`` counts kernel launches (plain calls are not
counted), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY

NEG_INF = -1e30
MAX_HEAD_DIM = 128

#: Kernel launches per kernel name since the last ``reset_launches()``.
LAUNCHES = {"flash_attention_fwd": 0, "ragged_paged_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_head_dim(head_dim: int) -> None:
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim must be a multiple of 8 in [8, {MAX_HEAD_DIM}], "
            f"got {head_dim}"
        )


def _check_cuda(name: str, *tensors: torch.Tensor | None) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(
            f"{name}: tensors must be on the CPU (plain version) or on a "
            f"CUDA device (kernel), got {dev}"
        )
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = LIBRARY.get(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


# -- flash attention forward ---------------------------------------------------


def flash_attention_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch form of the flash forward: the same masks, the same
    explicit-zero probabilities, zeros for rows that see no key."""
    q_len, kv_len = query.shape[2], key.shape[2]
    scale = 1.0 / math.sqrt(query.shape[-1])
    s = torch.matmul(query, key.transpose(-1, -2)) * scale
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=query.device)
    if causal:
        mask = torch.tril(mask, diagonal=kv_len - q_len)
    mask = mask[None, None]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, value) / torch.where(l == 0.0, 1.0, l)


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over ``[B, H, S, d]`` fp32 streams with structured masks:
    ``causal`` (bottom-right aligned when ``Sq != Sk``) and ``kv_valid``
    (``[B, Sk]`` bool, per-key validity). Query and key lengths may
    differ. Rows that see no key give zeros. Returns a contiguous
    ``[B, H, Sq, d]`` tensor.

    The head dim must have stride 1; the other strides are free, so the
    head-split views of a fused projection go in without a copy."""
    b, h, q_len, d = query.shape
    kv_len = key.shape[2]
    if key.shape != (b, h, kv_len, d) or value.shape != key.shape:
        raise ValueError(
            f"shape mismatch: query {tuple(query.shape)}, key "
            f"{tuple(key.shape)}, value {tuple(value.shape)}"
        )
    if kv_valid is not None and kv_valid.shape != (b, kv_len):
        raise ValueError(
            f"kv_valid must be [batch={b}, kv_len={kv_len}], got "
            f"{tuple(kv_valid.shape)}"
        )
    if query.device.type == "cpu":
        return flash_attention_plain(
            query, key, value, causal=causal, kv_valid=kv_valid
        )
    dev = _check_cuda("flash_attention", query, key, value, kv_valid)
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
    _check_head_dim(d)
    valid = None
    if kv_valid is not None:
        if kv_valid.dtype != torch.bool:
            raise TypeError(f"kv_valid must be bool, got {kv_valid.dtype}")
        valid = kv_valid.contiguous()
    out = torch.empty((b, h, q_len, d), dtype=torch.float32, device=dev)
    _launch(
        "flash_attention_fwd", dev,
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        b, h, q_len, kv_len, d, int(causal), 1.0 / math.sqrt(d),
        *query.stride()[:3], *key.stride()[:3], *value.stride()[:3],
    )
    return out


# -- ragged paged attention --------------------------------------------------


def ragged_paged_attention_plain(
    query: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    cur_k: torch.Tensor | None = None,
    cur_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch form: gather every table page into a dense
    ``[R, W]`` view (int8 pages dequantised first), mask positions past
    each row's length, append ``cur`` as an always-valid key, and take a
    masked softmax with explicit zeros — rows that see nothing give
    zeros."""
    rows, heads, head_dim = query.shape
    pages_per_row, page_size = block_table.shape[1], k_pages.shape[1]
    width = pages_per_row * page_size
    table = block_table.long()
    k = k_pages[table]  # [R, P, page, H*dh]
    v = v_pages[table]
    if k_scale is not None:
        k = k.float() * k_scale[table][..., None]
        v = v.float() * v_scale[table][..., None]
    k = k.reshape(rows, width, heads, head_dim).transpose(1, 2)
    v = v.reshape(rows, width, heads, head_dim).transpose(1, 2)
    positions = torch.arange(width, device=query.device)
    valid = positions[None, :] < lengths[:, None].long()  # [R, W]
    if cur_k is not None:
        k = torch.cat([k, cur_k.reshape(rows, heads, 1, head_dim)], dim=2)
        v = torch.cat([v, cur_v.reshape(rows, heads, 1, head_dim)], dim=2)
        always = torch.ones((rows, 1), dtype=torch.bool, device=query.device)
        valid = torch.cat([valid, always], dim=1)
    s = torch.einsum("rhd,rhwd->rhw", query, k) * (1.0 / math.sqrt(head_dim))
    mask = valid[:, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("rhw,rhwd->rhd", p, v)
    return out / torch.where(l == 0.0, 1.0, l)


def ragged_paged_attention(
    query: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    cur_k: torch.Tensor | None = None,
    cur_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """One decode step of attention over a paged KV store, ragged across
    rows (the contract of ``ops.attention.ragged_paged_attention``).

    ``query`` ``[R, H, dh]`` fp32; ``k_pages``/``v_pages`` ``[N, page,
    H*dh]`` fp32, or int8 with ``k_scale``/``v_scale`` ``[N, page]`` fp32;
    ``block_table`` ``[R, P]`` and ``lengths`` ``[R]`` int32; optional
    ``cur_k``/``cur_v`` ``[R, H*dh]`` fp32. Returns a contiguous ``[R, H,
    dh]`` fp32 tensor. Query rows and cur rows may be strided views (a
    slice of a fused projection); within a row the data must be
    contiguous.

    The kernel trusts the tables as the Pallas kernel does: every
    ``lengths[r] <= P * page`` and every table entry it walks
    ``< num_pages`` (checking them here would cost a device sync per
    call; the paged runtime builds them so)."""
    rows, heads, head_dim = query.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if (cur_k is None) != (cur_v is None):
        raise ValueError("cur_k and cur_v must be given together")
    if k_pages.shape[2] != heads * head_dim or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pages must be [num_pages, page, {heads * head_dim}], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    if query.device.type == "cpu":
        return ragged_paged_attention_plain(
            query, k_pages, v_pages, block_table, lengths,
            k_scale=k_scale, v_scale=v_scale, cur_k=cur_k, cur_v=cur_v,
        )
    dev = _check_cuda(
        "ragged_paged_attention", query, k_pages, v_pages, block_table,
        lengths, k_scale, v_scale, cur_k, cur_v,
    )
    _check_head_dim(head_dim)
    if query.dtype != torch.float32:
        raise TypeError(f"query must be float32, got {query.dtype}")
    if query.stride(2) != 1 or (heads > 1 and query.stride(1) != head_dim):
        raise ValueError("each query row [H, dh] must be contiguous")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None):
        raise ValueError("int8 pages need k_scale/v_scale, float32 pages take none")
    if k_pages.dtype not in (torch.float32, torch.int8) or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be float32 or int8, got {k_pages.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scale", k_scale), ("v_scale", v_scale),
                    ("block_table", block_table), ("lengths", lengths)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("k_scale and v_scale must be float32")
    cur_stride = 0
    if cur_k is not None:
        if cur_k.dtype != torch.float32 or cur_v.dtype != torch.float32:
            raise TypeError("cur_k and cur_v must be float32")
        if cur_k.stride(1) != 1 or cur_v.stride() != cur_k.stride():
            raise ValueError("cur_k and cur_v rows must be contiguous, same strides")
        cur_stride = cur_k.stride(0)
    out = torch.empty((rows, heads, head_dim), dtype=torch.float32, device=dev)
    _launch(
        "ragged_paged_attention", dev,
        query.data_ptr(), query.stride(0),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        int(quant), block_table.data_ptr(), block_table.shape[1],
        lengths.data_ptr(),
        None if cur_k is None else cur_k.data_ptr(),
        None if cur_v is None else cur_v.data_ptr(),
        cur_stride, out.data_ptr(), rows, heads, head_dim,
        k_pages.shape[1], 1.0 / math.sqrt(head_dim),
    )
    return out
