"""A ragged decode step at the serving slice's shapes, shared by the CPU
model of the ragged kernel's split-and-merge (``test_torch_kernel_layout.py``)
and the card's kernel tests (``test_torch_gpu.py``). numpy only: the card's
tests run where there is no JAX."""

import numpy as np


def serving_decode(rng, quant, *, rows=32, heads=8, dh=64, page=16, pages_per_row=4):
    """One decode step: lengths with the edge values 0, 1, 15, 16, 17 and
    full among random ones, and the last row sharing the previous row's
    pages, length and query (a prefix-cache hit). Returns ``(qkv, k_pages,
    v_pages, table, lengths, scales)`` as numpy arrays: ``qkv`` ``[rows,
    3 * heads * dh]`` holds q, cur_k and cur_v side by side, as the model's
    fused projection does; ``scales`` holds ``k_scale``/``v_scale`` for
    int8 pages and is empty for fp32 ones."""
    cap = page * pages_per_row
    lengths = rng.integers(1, cap + 1, rows).astype(np.int32)
    lengths[:6] = [0, 1, 15, 16, 17, cap]
    table = np.zeros((rows, pages_per_row), np.int32)
    nxt = 1
    for r in range(rows - 1):
        used = -(-int(lengths[r]) // page)
        table[r, :used] = np.arange(nxt, nxt + used)
        nxt += used
    table[-1], lengths[-1] = table[-2], lengths[-2]
    width = heads * dh
    qkv = rng.standard_normal((rows, 3 * width)).astype(np.float32)
    qkv[-1, :width] = qkv[-2, :width]
    shape = (1 + rows * pages_per_row, page, width)
    scales = {}
    if quant:
        k_pages, v_pages = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        scales["k_scale"], scales["v_scale"] = (
            (rng.random(shape[:2]) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
    else:
        k_pages, v_pages = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return qkv, k_pages, v_pages, table, lengths, scales


def split_qkv(qkv, heads):
    """``qkv`` ``[rows, 3 * heads * dh]`` -> q ``[rows, heads, dh]``,
    cur_k and cur_v ``[rows, heads * dh]``, as views where the array type
    allows (a torch tensor gives strided views, as the model passes them)."""
    width = qkv.shape[1] // 3
    rows = qkv.shape[0]
    return (qkv[:, :width].reshape(rows, heads, width // heads),
            qkv[:, width:2 * width], qkv[:, 2 * width:])
