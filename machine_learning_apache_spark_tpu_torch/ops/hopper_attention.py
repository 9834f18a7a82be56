"""The port's attention kernels for Hopper, beside their plain PyTorch
versions.

Four CUDA C++ kernels (``csrc/``), each replacing a Pallas TPU kernel of
``machine_learning_apache_spark_tpu/ops/pallas_attention.py``:

- the flash forward → ``csrc/flash_attention_fwd.cu``, replacing
  ``_flash_kernel``, with its optional ``lse`` output (what the backward
  recomputes probabilities from);
- the flash-2 backward → ``csrc/flash_attention_bwd.cu``: a dQ kernel
  replacing ``_flash_bwd_dq_kernel`` and a dK/dV kernel replacing
  ``_flash_bwd_dkv_kernel``;
- ``ragged_paged_attention`` → ``csrc/ragged_paged_attention.cu``,
  replacing ``_ragged_paged_kernel`` (forward only, as in the JAX
  package).

Every kernel has a float32 and a bfloat16 instantiation (``*_bf16``
entry points and ``LAUNCHES`` keys): a bf16 CUDA tensor launches the
bf16 kernel, never the fp32 one. At bf16 the flash kernels take their
products on bf16 tensor cores (``mma.sync`` m16n8k16, float32
accumulators) and round P and dS to bf16 before the products that use
them, as the Pallas kernels do; ``lse`` and ``delta`` stay float32; the
ragged kernel widens bf16 (or int8) pages to float32 and rounds only its
output. The plain versions round at the same points.

``flash_attention`` is differentiable: ``FlashAttention`` is the
``torch.autograd.Function`` that mirrors the JAX package's
``_flash_vjp_nomask``/``_flash_vjp_masked``. Each source's header says
what bounds it on the card and how its design answers that. The three
flash kernels (forward, dQ, dK/dV) run on the tensor cores (``mma.sync``
in 3xTF32, ``cp.async`` tiles): their wrappers pass the launch parameters
that ``flash_fwd_launch_params``, ``dq_launch_params`` and
``dkv_launch_params`` pick (warps per block, splits, padded head dim) and
check the 16-byte row layout their copies need (``check_kernel_layout``).
The ragged decode kernel stays on the CUDA cores (one query per row and
head), its positions split between warps and staged by ``cp.async``; its
wrapper passes what ``ragged_launch_params`` picks (splits, stages). Each
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises — there is no fallback. ``LAUNCHES`` counts kernel launches (plain calls are not
counted), so a run can show that its main path went through the kernels.
A launch made while a CUDA graph is being captured runs only when the
graph is replayed: ``recorded_launches(counted=False)`` keeps it out of
``LAUNCHES`` and hands it to the capturer, which adds it back on every
replay (``utils/graph_cache.py``).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.autograd.function import once_differentiable

from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY

NEG_INF = -1e30
MAX_HEAD_DIM = 128

#: Warps per block the tensor-core kernels (flash forward, dQ, dK/dV) are
#: built for; each warp owns 16 rows (forward and dQ: query rows, dK/dV:
#: keys).
KERNEL_WARPS = (1, 2, 4)
#: Splits: warps that share out one 16-row group's walk (the forward's
#: and dQ's key tiles, dK/dV's query tiles).
KERNEL_SPLITS = (1, 2)
#: Padded head dims they are instantiated for; columns past ``d`` are
#: never read.
KERNEL_D_PADS = (64, 128)
#: The ragged kernel: warps that share out one (row, head)'s positions,
#: 32 at a time; a block covers one (row, head).
RAGGED_SPLITS = (1, 2, 4)
RAGGED_CHUNK = 32
#: Dynamic shared memory a block may ask for on an H100 (227 KB).
SMEM_LIMIT = 227 * 1024
#: The element types the kernels are instantiated for.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: The four kernels, by the name of their float32 entry point.
KERNELS = (
    "flash_attention_fwd",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "ragged_paged_attention",
)


def kernel_name(kernel: str, dtype: torch.dtype) -> str:
    """The entry point (and ``LAUNCHES`` key) of ``kernel``'s instantiation
    for ``dtype``: the float32 one keeps the kernel's name, the bf16 one
    adds ``_bf16``."""
    return kernel if dtype == torch.float32 else f"{kernel}_bf16"


#: Kernel launches per instantiation since the last ``reset_launches()``.
#: ``flash_attention_fwd`` (and its ``_bf16``) counts both forward
#: variants (with and without ``lse``).
LAUNCHES = {kernel_name(k, dt): 0 for dt in KERNEL_DTYPES for k in KERNELS}


_RECORDING = threading.local()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict) -> None:
    """Adds ``counts`` (kernel name -> launches) to ``LAUNCHES``: what a
    replayed CUDA graph launched."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@contextlib.contextmanager
def recorded_launches(*, counted: bool):
    """Records the kernel launches this thread makes inside the block in
    the dict it yields (kernel name -> launches). With ``counted=False``
    they are left out of ``LAUNCHES``: a graph capture, whose kernels run
    only when the graph is replayed."""
    record = dict.fromkeys(LAUNCHES, 0)
    outer = getattr(_RECORDING, "state", None)
    _RECORDING.state = (record, counted)
    try:
        yield record
    finally:
        _RECORDING.state = outer


def launch_recording():
    """This thread's launch recording (None outside ``recorded_launches``),
    for ``recording_as`` in work another thread runs on this one's behalf."""
    return getattr(_RECORDING, "state", None)


@contextlib.contextmanager
def recording_as(state):
    """Launches this thread makes inside the block are recorded and
    counted as ``state`` (another thread's ``launch_recording()``) says:
    autograd runs a backward, and a checkpointed layer's recompute, on its
    device thread, which does not see the forward thread's recording."""
    outer = getattr(_RECORDING, "state", None)
    _RECORDING.state = state
    try:
        yield
    finally:
        _RECORDING.state = outer


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
    state = getattr(_RECORDING, "state", None)
    if state is not None:
        state[0][name] += 1
    if state is None or state[1]:
        LAUNCHES[name] += 1


# -- flash attention: shapes and plain versions ----------------------------------


def _check_flash_shapes(query, key, value, kv_valid) -> None:
    b, h, _, d = query.shape
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


def _structural_mask(q_len, kv_len, causal, kv_valid, device) -> torch.Tensor:
    """``[1 or B, 1, Sq, Sk]`` bool: bottom-right causal and ``kv_valid``."""
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask = torch.tril(mask, diagonal=kv_len - q_len)
    mask = mask[None, None]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    return mask


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float32 for bf16 inputs
    (the kernels' accumulators), the inputs' own otherwise (float64 for
    ``gradcheck``)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back (nearest even): where the
    reference casts P or dS to the inputs' dtype before a product. The
    identity when ``x`` is already in ``dtype``'s precision."""
    return x.to(dtype).to(x.dtype)


def _scores(query, key) -> torch.Tensor:
    return torch.matmul(query, key.transpose(-1, -2)) * (1.0 / math.sqrt(query.shape[-1]))


def flash_attention_lse_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of the flash forward: the same masks, the same
    explicit-zero probabilities, zeros for rows that see no key. Returns
    ``(out, lse)``: ``lse`` ``[B, H, Sq]`` is ``m + log(l)`` of each row's
    softmax, ``NEG_INF`` on rows that see no key (``_flash_kernel``'s
    ``lse`` output). Any float dtype (float64 for ``gradcheck``). At
    bf16 the scores, the softmax and ``lse`` are float32 (products of bf16
    values are exact in float32), P is rounded to bf16 before P·V
    (``_flash_kernel``'s ``p.astype(v.dtype)``), ``l`` sums the unrounded
    P, and ``out`` is cast back to bf16."""
    dtype = query.dtype
    acc = _acc_dtype(dtype)
    query, key, value = query.to(acc), key.to(acc), value.to(acc)
    mask = _structural_mask(
        query.shape[2], key.shape[2], causal, kv_valid, query.device
    )
    s = torch.where(mask, _scores(query, key), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(_rounded(p, dtype), value) / safe_l
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))[..., 0]
    return out.to(dtype), lse


def flash_attention_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain flash forward's output alone."""
    return flash_attention_lse_plain(
        query, key, value, causal=causal, kv_valid=kv_valid
    )[0]


def _backward_terms(query, key, value, d_out, lse, delta, causal, kv_valid):
    """``(p, ds)`` of the flash-2 backward (``pallas_attention.py``
    ``:304-329``, ``:369-396``): P recomputed from ``lse``, masked where
    the forward masked and where ``lse`` is not finite (rows that see no
    key), and an explicit zero in ``ds`` wherever P is masked. In the
    plain versions' compute dtype (float32 at bf16)."""
    acc = _acc_dtype(query.dtype)
    query, key, value, d_out = (t.to(acc) for t in (query, key, value, d_out))
    mask = _structural_mask(
        query.shape[2], key.shape[2], causal, kv_valid, query.device
    ) & (lse > NEG_INF * 0.5)[..., None]
    p = torch.where(mask, torch.exp(_scores(query, key) - lse[..., None]), 0.0)
    dp = torch.matmul(d_out, value.transpose(-1, -2))
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    return p, ds


def _dq(query, key, ds):
    """dS·K·scale with dS rounded to the inputs' dtype first
    (``ds.astype(k.dtype)``), in the inputs' dtype."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    return (torch.matmul(_rounded(ds, key.dtype), key.to(ds.dtype)) * scale).to(query.dtype)


def _dkv(query, d_out, p, ds):
    """``(dSᵀ·Q·scale, Pᵀ·dO)`` with dS and P rounded to the inputs'
    dtype first (``ds_t.astype(q.dtype)``, ``p_t.astype(do.dtype)``)."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    dk = torch.matmul(_rounded(ds, query.dtype).transpose(-1, -2), query.to(ds.dtype)) * scale
    dv = torch.matmul(_rounded(p, d_out.dtype).transpose(-1, -2), d_out.to(p.dtype))
    return dk.to(query.dtype), dv.to(query.dtype)


def flash_attention_bwd_dq_plain(
    query, key, value, d_out, lse, delta, *, causal=False, kv_valid=None
) -> torch.Tensor:
    """dQ = dS·K·scale — the plain form of the dQ kernel."""
    _, ds = _backward_terms(query, key, value, d_out, lse, delta, causal, kv_valid)
    return _dq(query, key, ds)


def flash_attention_bwd_dkv_plain(
    query, key, value, d_out, lse, delta, *, causal=False, kv_valid=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """dK = dSᵀ·Q·scale, dV = Pᵀ·dO — the plain form of the dK/dV kernel."""
    p, ds = _backward_terms(query, key, value, d_out, lse, delta, causal, kv_valid)
    return _dkv(query, d_out, p, ds)


def flash_attention_backward_plain(
    query, key, value, out, lse, d_out, *, causal=False, kv_valid=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain flash-2 backward: ``(dq, dk, dv)`` from the forward's ``out``
    and ``lse``, with ``delta = rowsum(dO∘O)``."""
    delta = _delta(out, d_out)
    p, ds = _backward_terms(query, key, value, d_out, lse, delta, causal, kv_valid)
    return (_dq(query, key, ds), *_dkv(query, d_out, p, ds))


def _delta(out: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO∘O)`` ``[B, H, Sq]``, in fp32 for fp32 and bf16 inputs
    (``g.astype(f32) * out.astype(f32)``). The JAX package computes it
    outside any kernel (``pallas_attention.py:431``); so does the port —
    a torch reduction."""
    acc = _acc_dtype(out.dtype)
    return (d_out.to(acc) * out.to(acc)).sum(dim=-1)


# -- flash attention: kernels ------------------------------------------------------


def _check_flash_cuda(
    name, tensors, kv_valid, stats=()
) -> tuple[torch.device, torch.Tensor | None]:
    """Device, dtype and layout checks shared by the three flash kernels:
    ``tensors`` (q, k, v and dO) share one dtype of ``KERNEL_DTYPES``,
    ``stats`` (``lse``, ``delta``) are float32. Returns the device and
    ``kv_valid`` as contiguous bytes (or None)."""
    dev = _check_cuda(name, *tensors, *stats, kv_valid)
    dtype = tensors[0].dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: inputs must be float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: inputs must share one dtype, got {dtype} and {t.dtype}")
    for t in stats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: lse and delta must be float32, got {t.dtype}")
    valid = None
    if kv_valid is not None:
        if kv_valid.dtype != torch.bool:
            raise TypeError(f"kv_valid must be bool, got {kv_valid.dtype}")
        valid = kv_valid.contiguous()
    return dev, valid


def device_sm_count(dev: torch.device) -> int:
    """The number of SMs on a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _d_pad(head_dim: int) -> int:
    _check_head_dim(head_dim)
    return next(p for p in KERNEL_D_PADS if head_dim <= p)


def _pad_elems(elem_bytes: int) -> int:
    """Elements a shared row is padded by: 16 bytes (4 floats, 8 bf16)."""
    return 16 // elem_bytes


def fwd_smem_bytes(warps: int, splits: int, d_pad: int, kv_len: int, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one flash forward block
    (``fwd_smem_bytes``/``fwd_bf16_smem_bytes`` in
    ``csrc/flash_attention_fwd.cu``): the Q rows, two buffers of K/V tiles
    per split (rows of ``d_pad`` + 16 bytes of ``elem_bytes`` elements),
    the key-validity words and the live-tile list."""
    stride = d_pad + _pad_elems(elem_bytes)
    rows = 16 * (warps // splits)
    return elem_bytes * (rows * stride + 2 * splits * 2 * 32 * stride) + 8 * -(-kv_len // 32)


def _check_smem(name: str, need: int) -> None:
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: the launch needs {need} bytes of shared memory, more than {SMEM_LIMIT}")


def flash_fwd_launch_params(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int, sm_count: int,
    warps: int | None = None, splits: int | None = None, elem_bytes: int = 4,
) -> tuple[int, int, int]:
    """``(warps per block, key splits, padded head dim)`` of the flash
    forward kernel on a card with ``sm_count`` SMs. A block has
    ``warps // splits`` row groups of 16 query rows; the ``splits`` warps
    of a group share out its key tiles. Unless given: the most row groups
    (so the most rows sharing each staged K/V tile) that the rows fill and
    that still leave a block for every SM, with one split; where even one row group per block leaves the
    card part empty (the serving prefill: 8 heads of 64 rows), two splits
    when there are two 32-key tiles or more, so a block walks them side by
    side, and as many row groups as the rows fill up to four warps (the
    prefill: 16 blocks of two row groups by two splits). At 16 query rows
    or fewer (a decode step's one row) a block has one row group whatever
    the grid, and one warp's walk leaves each SM a warp or two: two
    splits whenever there are two key tiles (the eval decode's
    self-attention at step 198 on an H100: 33.9 µs against 56.8 µs with
    one warp). The same choices at both element sizes (``elem_bytes`` 4
    for fp32, 2 for bf16); each must fit a block's shared memory."""
    d_pad = _d_pad(head_dim)
    if warps is None and splits is None:
        for rows in (4, 2, 1):
            if (q_len > 16 and 16 * (rows - 1) < q_len
                    and batch * heads * -(-q_len // (16 * rows)) >= sm_count):
                warps, splits = rows, 1
                break
        else:
            splits = 2 if kv_len > 32 else 1
            rows = next(r for r in (4, 2, 1) if r * splits in KERNEL_WARPS and 16 * (r - 1) < q_len)
            warps = rows * splits
    else:
        warps, splits = _check_launch(warps, splits)
    _check_smem("flash_attention", fwd_smem_bytes(warps, splits, d_pad, kv_len, elem_bytes))
    return warps, splits, d_pad


def dq_launch_params(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int, sm_count: int,
    warps: int | None = None, splits: int | None = None, elem_bytes: int = 4,
) -> tuple[int, int, int]:
    """``(warps per block, key splits, padded head dim)`` of the dQ kernel.
    It walks the forward's tiles (16-row groups against 32-key tiles), so
    it takes the forward's rule: at the training sites four row groups per
    block and one split (1,024 blocks); where the rows leave the card part
    empty (one sequence of 200), two warps share out a group's key tiles."""
    warps, splits, d_pad = flash_fwd_launch_params(
        batch, heads, q_len, kv_len, head_dim, sm_count, warps, splits, elem_bytes
    )
    _check_smem("flash_attention_bwd_dq", dq_smem_bytes(warps, splits, d_pad, kv_len, elem_bytes))
    return warps, splits, d_pad


def dq_smem_bytes(warps: int, splits: int, d_pad: int, kv_len: int, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one dQ block (``dq_smem_bytes``/
    ``dq_bf16_smem_bytes`` in ``csrc/flash_attention_bwd.cu``): Q and dO
    rows, their float32 lse and delta, two buffers of K/V tiles per split
    (rows of ``d_pad`` + 16 bytes), the key-validity words and the
    live-tile list."""
    stride = d_pad + _pad_elems(elem_bytes)
    rows = 16 * (warps // splits)
    tiles = -(-kv_len // 32)
    return (elem_bytes * (2 * rows * stride + 2 * splits * 2 * 32 * stride)
            + 4 * 2 * rows + 8 * tiles)


def dkv_smem_bytes(warps: int, splits: int, d_pad: int, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one dK/dV block (``dkv_smem_bytes``/
    ``dkv_bf16_smem_bytes``): the block's K and V rows, then two buffers
    per split of a 32-row query tile (Q and dO rows, float32 lse and
    delta)."""
    stride = d_pad + _pad_elems(elem_bytes)
    keys = 16 * (warps // splits)
    return elem_bytes * 2 * keys * stride + 2 * splits * (elem_bytes * 2 * 32 * stride + 4 * 2 * 32)


def ragged_smem_bytes(
    head_dim: int, quant: bool, splits: int, stages: int, page_bytes: int = 4,
) -> int:
    """Dynamic shared memory of one ragged block (``warp_bytes`` in
    ``csrc/ragged_paged_attention.cu``, times the splits): per warp,
    ``stages`` chunks of 32 K and V head slices (fp32 and bf16 rows —
    ``page_bytes`` 4 or 2 — padded by 16 bytes, int8 rows to 16 and 16
    more) with their scales and slots, then its float32 q row, the chunk's
    p and its merge state."""
    def r16(x):
        return (x + 15) & ~15

    row = r16(head_dim) + 16 if quant else page_bytes * head_dim + 16
    stage = 2 * RAGGED_CHUNK * row + 3 * RAGGED_CHUNK * 4
    per_warp = stages * stage + r16(4 * head_dim) + 4 * RAGGED_CHUNK + r16(4 * (head_dim + 2))
    return splits * per_warp


def ragged_launch_params(
    head_dim: int, capacity: int, quant: bool, splits: int | None = None,
    page_bytes: int = 4,
) -> tuple[int, int]:
    """``(splits, stages)`` of the ragged decode kernel for block tables
    that cover ``capacity`` = pages per row × page size positions. A block
    covers one (row, head); its positions go 32 at a time (one per lane)
    to its ``splits`` warps; a warp that may walk more than one chunk
    keeps two in flight (``stages`` 2). Unless given: as many splits as
    the longest row has chunks, up to four (the serving decode: 64
    positions, two splits, one chunk each), and fewer where the shared
    memory would not fit (fp32 pages at a head dim of 128). ``page_bytes``
    is a float page's element size (4 fp32, 2 bf16)."""
    _check_head_dim(head_dim)
    chunks = max(1, -(-capacity // RAGGED_CHUNK))
    if splits is None:
        splits = next((s for s in RAGGED_SPLITS if s >= chunks), RAGGED_SPLITS[-1])
        while ragged_smem_bytes(
            head_dim, quant, splits, 2 if chunks > splits else 1, page_bytes
        ) > SMEM_LIMIT:
            splits //= 2
    elif splits not in RAGGED_SPLITS:
        raise ValueError(f"splits must be one of {RAGGED_SPLITS}, got {splits}")
    stages = 2 if chunks > splits else 1
    need = ragged_smem_bytes(head_dim, quant, splits, stages, page_bytes)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"splits={splits} needs {need} bytes of shared memory at head_dim={head_dim}, "
            f"more than {SMEM_LIMIT}"
        )
    return splits, stages


def dkv_launch_params(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
    warps: int | None = None, splits: int | None = None, elem_bytes: int = 4,
) -> tuple[int, int, int]:
    """``(warps per block, query splits, padded head dim)`` of the dK/dV
    kernel. A block has ``warps // splits`` key groups of 16 keys; the
    ``splits`` warps of a group share out the 32-row query tiles. Unless
    given: two splits when the walk has two query tiles or more (it is one
    block's serial chain), and as many key groups as the keys fill up to
    four warps (the training sites: blocks of 2 x 16 keys by 2 splits).
    The same choices at both element sizes; each must fit a block."""
    d_pad = _d_pad(head_dim)
    if warps is None and splits is None:
        splits = 2 if q_len > 32 else 1
        groups = next(r for r in (4, 2, 1) if r * splits in KERNEL_WARPS and 16 * (r - 1) < kv_len)
        warps = groups * splits
    else:
        warps, splits = _check_launch(warps, splits)
    _check_smem("flash_attention_bwd_dkv", dkv_smem_bytes(warps, splits, d_pad, elem_bytes))
    return warps, splits, d_pad


def _check_launch(warps: int | None, splits: int | None) -> tuple[int, int]:
    splits = 1 if splits is None else splits
    warps = splits if warps is None else warps
    if splits not in KERNEL_SPLITS or warps not in KERNEL_WARPS or warps % splits:
        raise ValueError(
            f"warps must be one of {KERNEL_WARPS} and a multiple of splits "
            f"(one of {KERNEL_SPLITS}), got warps={warps}, splits={splits}"
        )
    return warps, splits


def kernel_layout_ok(t: torch.Tensor) -> bool:
    """Whether a ``[B, H, S, d]`` tensor meets ``check_kernel_layout``."""
    per_16 = 16 // t.element_size()  # elements in 16 bytes
    return (
        t.stride(3) == 1
        and t.data_ptr() % 16 == 0
        and all(t.stride(i) % per_16 == 0 for i in range(3) if t.shape[i] > 1)
    )


def check_kernel_layout(name: str, *tensors: torch.Tensor) -> None:
    """The tensor-core kernels copy rows into shared memory 16 bytes at a
    time (``cp.async``): every ``[B, H, S, d]`` input must have a
    contiguous head dim, a 16-byte aligned start, and batch, head and
    position strides of whole 16-byte pieces — multiples of 4 float32 or
    8 bf16 elements (strides of size-1 dims are never used). Raises
    ``ValueError`` otherwise. The model's head-split views of fused
    projections pass, since ``d`` is a multiple of 8."""
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{name}: every input's head dim must be contiguous")
        if not kernel_layout_ok(t):
            raise ValueError(
                f"{name}: every row must start on 16 bytes (data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())}); the "
                f"kernel copies rows with 16-byte cp.async"
            )


def _strides(*tensors) -> list[int]:
    """The batch, head and position strides of ``[B, H, S, d]`` tensors
    whose head dim has stride 1 (raises otherwise)."""
    out = []
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError("flash attention: every input's head dim must be contiguous")
        out.extend(t.stride()[:3])
    return out


def flash_attention_fwd(
    query, key, value, *, causal=False, kv_valid=None, return_lse=False,
    warps=None, splits=None,
):
    """The flash forward kernel's wrapper: ``out`` ``[B, H, Sq, d]`` in the
    inputs' dtype (float32 or bf16), or ``(out, lse)`` with ``lse`` ``[B,
    H, Sq]`` fp32, both contiguous. No
    autograd: ``flash_attention`` is the differentiable entry point.
    ``warps``/``splits`` override ``flash_fwd_launch_params``' choice."""
    _check_flash_shapes(query, key, value, kv_valid)
    if query.device.type == "cpu":
        out, lse = flash_attention_lse_plain(
            query, key, value, causal=causal, kv_valid=kv_valid
        )
        return (out, lse) if return_lse else out
    b, h, q_len, d = query.shape
    kv_len = key.shape[2]
    dev, valid = _check_flash_cuda("flash_attention", (query, key, value), kv_valid)
    n_warps, n_splits, d_pad = flash_fwd_launch_params(
        b, h, q_len, kv_len, d, device_sm_count(dev), warps, splits, query.element_size()
    )
    check_kernel_layout("flash_attention", query, key, value)
    strides = _strides(query, key, value)
    out = torch.empty((b, h, q_len, d), dtype=query.dtype, device=dev)
    lse = (
        torch.empty((b, h, q_len), dtype=torch.float32, device=dev)
        if return_lse else None
    )
    _launch(
        kernel_name("flash_attention_fwd", query.dtype), dev,
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, q_len, kv_len, d, int(causal), 1.0 / math.sqrt(d),
        n_warps, n_splits, d_pad, *strides,
    )
    return (out, lse) if return_lse else out


def _bwd_cuda(name, query, key, value, d_out, lse, delta, kv_valid):
    b, h, q_len, d = query.shape
    if d_out.shape != query.shape:
        raise ValueError(f"{name}: d_out {tuple(d_out.shape)} must match query {tuple(query.shape)}")
    if lse.shape != (b, h, q_len) or delta.shape != lse.shape:
        raise ValueError(f"{name}: lse and delta must be [{b}, {h}, {q_len}]")
    dev, valid = _check_flash_cuda(name, (query, key, value, d_out), kv_valid, (lse, delta))
    _check_head_dim(d)
    return dev, valid, _strides(query, key, value, d_out), lse.contiguous(), delta.contiguous()


def flash_attention_bwd_dq(
    query, key, value, d_out, lse, delta, *, causal=False, kv_valid=None,
    warps=None, splits=None,
) -> torch.Tensor:
    """dQ of flash attention ``[B, H, Sq, d]``, contiguous, in the inputs'
    dtype (float32 or bf16), from the forward's ``lse`` and ``delta =
    rowsum(dO∘O)`` (both ``[B, H, Sq]`` fp32). q/k/v/d_out (one dtype)
    may be strided views with a contiguous head dim and
    rows 16-byte aligned (``check_kernel_layout``). ``warps``/``splits``
    override ``dq_launch_params``' choice."""
    _check_flash_shapes(query, key, value, kv_valid)
    if query.device.type == "cpu":
        return flash_attention_bwd_dq_plain(
            query, key, value, d_out, lse, delta, causal=causal, kv_valid=kv_valid
        )
    dev, valid, strides, lse, delta = _bwd_cuda(
        "flash_attention_bwd_dq", query, key, value, d_out, lse, delta, kv_valid
    )
    b, h, q_len, d = query.shape
    kv_len = key.shape[2]
    n_warps, n_splits, d_pad = dq_launch_params(
        b, h, q_len, kv_len, d, device_sm_count(dev), warps, splits, query.element_size()
    )
    check_kernel_layout("flash_attention_bwd_dq", query, key, value, d_out)
    dq = torch.empty((b, h, q_len, d), dtype=query.dtype, device=dev)
    _launch(
        kernel_name("flash_attention_bwd_dq", query.dtype), dev,
        query.data_ptr(), key.data_ptr(), value.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if valid is None else valid.data_ptr(), dq.data_ptr(),
        b, h, q_len, kv_len, d, int(causal), 1.0 / math.sqrt(d),
        n_warps, n_splits, d_pad, *strides,
    )
    return dq


def flash_attention_bwd_dkv(
    query, key, value, d_out, lse, delta, *, causal=False, kv_valid=None,
    warps=None, splits=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of flash attention, each ``[B, H, Sk, d]`` contiguous
    in the inputs' dtype;
    same inputs as ``flash_attention_bwd_dq``, with rows 16-byte aligned
    (``check_kernel_layout``). A key that no row sees gets exactly zero.
    ``warps``/``splits`` override ``dkv_launch_params``' choice."""
    _check_flash_shapes(query, key, value, kv_valid)
    if query.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(
            query, key, value, d_out, lse, delta, causal=causal, kv_valid=kv_valid
        )
    dev, valid, strides, lse, delta = _bwd_cuda(
        "flash_attention_bwd_dkv", query, key, value, d_out, lse, delta, kv_valid
    )
    b, h, q_len, d = query.shape
    kv_len = key.shape[2]
    n_warps, n_splits, d_pad = dkv_launch_params(
        b, h, q_len, kv_len, d, warps, splits, query.element_size()
    )
    check_kernel_layout("flash_attention_bwd_dkv", query, key, value, d_out)
    dk = torch.empty((b, h, kv_len, d), dtype=query.dtype, device=dev)
    dv = torch.empty_like(dk)
    _launch(
        kernel_name("flash_attention_bwd_dkv", query.dtype), dev,
        query.data_ptr(), key.data_ptr(), value.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if valid is None else valid.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, q_len, kv_len, d, int(causal), 1.0 / math.sqrt(d),
        n_warps, n_splits, d_pad, *strides,
    )
    return dk, dv


def flash_attention_backward(
    query, key, value, out, lse, d_out, *, causal=False, kv_valid=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the plain backward for CPU tensors; on the card,
    ``delta`` by a torch reduction, then the dQ and dK/dV kernels.

    There is no dense fallback on the card. The JAX package recomputes the
    backward densely below ``PALLAS_BWD_MIN_SCORES`` (256·1024 scores),
    a TPU launch-cost heuristic: the MT model's training sites (200×200 =
    40,000 scores) never reach its Pallas backward. Here the dense
    recompute would be the plain version, which no CUDA tensor takes, so
    every length on the card runs the two kernels."""
    if query.device.type == "cpu":
        return flash_attention_backward_plain(
            query, key, value, out, lse, d_out, causal=causal, kv_valid=kv_valid
        )
    delta = _delta(out, d_out)
    dq = flash_attention_bwd_dq(
        query, key, value, d_out, lse, delta, causal=causal, kv_valid=kv_valid
    )
    dk, dv = flash_attention_bwd_dkv(
        query, key, value, d_out, lse, delta, causal=causal, kv_valid=kv_valid
    )
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash-2 backward, mirroring
    ``_flash_vjp_nomask``/``_flash_vjp_masked`` (``pallas_attention.py``
    ``:205-267``). When a gradient is wanted the forward also writes
    ``lse`` and saves ``q, k, v, out, lse`` (the strided q/k/v views as
    they came: autograd maps the contiguous dq/dk/dv back through the
    model's ``chunk``/``view``/``transpose``); otherwise it runs the
    forward without ``lse`` and saves nothing. ``kv_valid`` takes no
    gradient."""

    @staticmethod
    def forward(ctx, query, key, value, kv_valid, causal, with_lse):
        if not with_lse:
            return flash_attention_fwd(
                query, key, value, causal=causal, kv_valid=kv_valid
            )
        out, lse = flash_attention_fwd(
            query, key, value, causal=causal, kv_valid=kv_valid, return_lse=True
        )
        ctx.save_for_backward(query, key, value, out, lse, kv_valid)
        ctx.causal = causal
        # The backward runs on autograd's device thread, which does not see
        # this thread's launch recording: it takes the forward's, so a
        # backward inside a graph capture is recorded with it.
        ctx.recording = launch_recording()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        query, key, value, out, lse, kv_valid = ctx.saved_tensors
        if d_out.device.type == "cuda" and not kernel_layout_ok(d_out):
            # Autograd picks dO's layout (an expanded ``sum()`` gradient
            # has stride 0): give the kernels rows they can copy.
            d_out = d_out.clone(memory_format=torch.contiguous_format)
        with recording_as(ctx.recording):
            dq, dk, dv = flash_attention_backward(
                query, key, value, out, lse, d_out,
                causal=ctx.causal, kv_valid=kv_valid,
            )
        return dq, dk, dv, None, None, None


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over ``[B, H, S, d]`` float32 or bf16 streams with
    structured masks:
    ``causal`` (bottom-right aligned when ``Sq != Sk``) and ``kv_valid``
    (``[B, Sk]`` bool, per-key validity). Query and key lengths may
    differ. Rows that see no key give zeros. Returns a contiguous
    ``[B, H, Sq, d]`` tensor, differentiable in q, k and v through
    ``FlashAttention``.

    The head dim must have stride 1; the other strides are free, so the
    head-split views of a fused projection go in without a copy."""
    _check_flash_shapes(query, key, value, kv_valid)
    with_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (query, key, value)
    )
    return FlashAttention.apply(query, key, value, kv_valid, causal, with_lse)


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
    zeros. A bf16 query (with bf16 or int8 pages) is taken in float32,
    with no rounding of P, and the output cast back to bf16."""
    rows, heads, head_dim = query.shape
    pages_per_row, page_size = block_table.shape[1], k_pages.shape[1]
    width = pages_per_row * page_size
    dtype = query.dtype
    acc = _acc_dtype(dtype)
    table = block_table.long()
    k = k_pages[table]  # [R, P, page, H*dh]
    v = v_pages[table]
    if k_scale is not None:
        k = k.float() * k_scale[table][..., None]
        v = v.float() * v_scale[table][..., None]
    query, k, v = query.to(acc), k.to(acc), v.to(acc)
    if cur_k is not None:
        cur_k, cur_v = cur_k.to(acc), cur_v.to(acc)
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
    return (out / torch.where(l == 0.0, 1.0, l)).to(dtype)


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
    splits: int | None = None,
) -> torch.Tensor:
    """One decode step of attention over a paged KV store, ragged across
    rows (the contract of ``ops.attention.ragged_paged_attention``).

    ``query`` ``[R, H, dh]`` float32 or bf16; ``k_pages``/``v_pages``
    ``[N, page, H*dh]`` in the query's dtype, or int8 with
    ``k_scale``/``v_scale`` ``[N, page]`` fp32; ``block_table`` ``[R, P]``
    and ``lengths`` ``[R]`` int32; optional ``cur_k``/``cur_v`` ``[R,
    H*dh]`` in the query's dtype. Returns a contiguous ``[R, H, dh]``
    tensor in the query's dtype (the bf16 kernel for a bf16 query). Query rows and cur rows may be strided views (a
    slice of a fused projection); within a row the data must be
    contiguous, and on the card query rows and the page stores must start
    on 16 bytes (the kernel stages them with 16-byte ``cp.async``).
    ``splits`` overrides ``ragged_launch_params``' choice.

    The kernel trusts the tables as the Pallas kernel does: every
    ``lengths[r] <= P * page`` and every table entry it walks
    ``< num_pages`` (checking them here would cost a device sync per
    call; the paged runtime builds them so)."""
    rows, heads, head_dim = query.shape
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (query, k_pages, v_pages, k_scale, v_scale, cur_k, cur_v)
    ):
        # The kernel has no backward (nor has the Pallas one); a result
        # without a grad_fn would silently cut the graph.
        raise RuntimeError(
            "ragged_paged_attention has no backward: call it under "
            "torch.no_grad() (serving does) or on tensors that need no grad"
        )
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
    dtype = query.dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"query must be float32 or bfloat16, got {dtype}")
    if query.stride(2) != 1 or (heads > 1 and query.stride(1) != head_dim):
        raise ValueError("each query row [H, dh] must be contiguous")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None):
        raise ValueError("int8 pages need k_scale/v_scale, float pages take none")
    if k_pages.dtype not in (dtype, torch.int8) or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be {dtype} (the query's dtype) or int8, got {k_pages.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scale", k_scale), ("v_scale", v_scale),
                    ("block_table", block_table), ("lengths", lengths)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("k_scale and v_scale must be float32")
    if query.data_ptr() % 16 or (rows > 1 and query.stride(0) % (16 // query.element_size())):
        raise ValueError(
            f"ragged_paged_attention: query rows must start on 16 bytes (data_ptr % 16 = "
            f"{query.data_ptr() % 16}, row stride {query.stride(0)}); the kernel "
            f"copies them with 16-byte cp.async"
        )
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: the page stores must start on 16 bytes")
    cur_stride = 0
    if cur_k is not None:
        if cur_k.dtype != dtype or cur_v.dtype != dtype:
            raise TypeError(f"cur_k and cur_v must be {dtype} (the query's dtype)")
        if cur_k.stride(1) != 1 or cur_v.stride() != cur_k.stride():
            raise ValueError("cur_k and cur_v rows must be contiguous, same strides")
        cur_stride = cur_k.stride(0)
    pages_per_row, page_size = block_table.shape[1], k_pages.shape[1]
    n_splits, stages = ragged_launch_params(
        head_dim, pages_per_row * page_size, quant, splits, k_pages.element_size()
    )
    out = torch.empty((rows, heads, head_dim), dtype=dtype, device=dev)
    _launch(
        kernel_name("ragged_paged_attention", dtype), dev,
        query.data_ptr(), query.stride(0),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        1 if quant else 0, block_table.data_ptr(), pages_per_row,
        lengths.data_ptr(),
        None if cur_k is None else cur_k.data_ptr(),
        None if cur_v is None else cur_v.data_ptr(),
        cur_stride, out.data_ptr(), rows, heads, head_dim,
        page_size, 1.0 / math.sqrt(head_dim), n_splits, stages,
    )
    return out
