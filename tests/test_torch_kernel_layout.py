"""What the attention kernels take, checked on the CPU.

The flash forward, dQ and dK/dV kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) and the ragged decode kernel
(``csrc/ragged_paged_attention.cu``) run only on the card. What surrounds
them is Python and is pinned here: the launch parameters the wrappers
pass (warps per block, splits, padded head dim; the ragged kernel's
splits and stages), that every choice's shared memory
fits a block, the 16-byte row layout their ``cp.async`` copies need, the
build's hash over the shared header, the arithmetic of the 3xTF32
products, and the ragged kernel's split-and-merge. A numpy model of the
tensor core (``mma.sync`` m16n8k8 on TF32 operands: exact products,
truncated to fp32 once per mma) runs the plain forward at the MT training
sites' shapes, and shows why the kernels take three passes (three stay
within 1e-6 of fp32, one falls outside the port's 1e-4 gates) and why
each k-step's passes start from a fresh fragment (a running sum carried
through the truncating accumulator drifts several times further from
the exact sum than fp32's own).
"""

import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu_torch.ops import cuda_build
from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
from torch_ragged_cases import serving_decode, split_qkv
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process


# -- launch parameters -----------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize(
    "batch,heads,q_len,kv_len,head_dim,want",
    [
        (1, 8, 64, 64, 64, (4, 2, 64)),     # serving prefill: 16 blocks, 2 rows x 2 splits
        (1, 8, 32, 64, 64, (4, 2, 64)),     # the shorter prefill chunk
        (1, 8, 1, 64, 64, (2, 2, 64)),      # one row against a 64-key chunk
        (1, 8, 64, 30, 64, (4, 1, 64)),     # one key tile: nothing to split
        (32, 8, 200, 200, 64, (4, 1, 64)),  # training sites: 1,024 four-warp blocks
        (32, 8, 199, 199, 64, (4, 1, 64)),  # decoder self-attention
        (64, 8, 1, 65, 64, (2, 2, 64)),     # one-row decode step: 2 splits walk its key tiles
        (32, 8, 1, 200, 64, (2, 2, 64)),    # the eval decode's self cache: 7 tiles, 2 splits
        (32, 8, 1, 1, 64, (1, 1, 64)),      # the priming call: one key, nothing to split
        (64, 8, 24, 70, 64, (2, 1, 64)),    # 24 rows fill two row groups, not four
        (2, 4, 40, 30, 8, (2, 1, 64)),      # small head dims take the 64 build; 40 rows fill 2 groups
        (3, 2, 17, 45, 72, (4, 2, 128)),
        (3, 2, 16, 45, 72, (2, 2, 128)),    # one row group of 16
    ],
)
def test_flash_fwd_launch_params(batch, heads, q_len, kv_len, head_dim, want):
    assert hop.flash_fwd_launch_params(batch, heads, q_len, kv_len, head_dim, H100_SMS) == want


@pytest.mark.parametrize(
    "batch,heads,q_len,kv_len,head_dim,want",
    [
        (32, 8, 200, 200, 64, (4, 2, 64)),  # training sites: 2 key groups x 2 query splits
        (32, 8, 199, 199, 64, (4, 2, 64)),
        (2, 8, 32, 200, 64, (4, 1, 64)),    # one query tile: nothing to split
        (3, 2, 17, 45, 128, (2, 1, 128)),   # 45 keys fill two groups, not four
        (3, 2, 40, 16, 128, (2, 2, 128)),   # 16 keys fill one group
    ],
)
def test_dkv_launch_params(batch, heads, q_len, kv_len, head_dim, want):
    assert hop.dkv_launch_params(batch, heads, q_len, kv_len, head_dim) == want


@pytest.mark.parametrize(
    "batch,heads,q_len,kv_len,head_dim,want",
    [
        (32, 8, 200, 200, 64, (4, 1, 64)),  # encoder self-attention: 1,024 blocks of 4 row groups
        (32, 8, 199, 199, 64, (4, 1, 64)),  # decoder self-attention
        (32, 8, 199, 200, 64, (4, 1, 64)),  # cross-attention
        (2, 8, 77, 200, 64, (4, 2, 64)),    # a small batch leaves the card part empty: 2 splits
        (1, 8, 200, 200, 64, (4, 2, 64)),   # one training sequence: 2 splits
        (2, 4, 40, 30, 16, (2, 1, 64)),     # one key tile: nothing to split; 40 rows fill 2 groups
        (3, 2, 17, 45, 128, (4, 2, 128)),
        (2, 3, 33, 65, 40, (4, 2, 64)),
        (1, 8, 1, 64, 64, (2, 2, 64)),      # one query row
    ],
)
def test_dq_launch_params(batch, heads, q_len, kv_len, head_dim, want):
    assert hop.dq_launch_params(batch, heads, q_len, kv_len, head_dim, H100_SMS) == want


def _fwd_params(*args, **kw):
    return hop.flash_fwd_launch_params(*args, H100_SMS, **kw)


def _dq_params(*args, **kw):
    return hop.dq_launch_params(*args, H100_SMS, **kw)


def test_launch_params_take_explicit_choices():
    for w in hop.KERNEL_WARPS:
        assert hop.dkv_launch_params(1, 8, 64, 64, 40, warps=w) == (w, 1, 64)
        assert _fwd_params(1, 8, 64, 64, 40, warps=w) == (w, 1, 64)
        assert _dq_params(1, 8, 64, 64, 40, warps=w) == (w, 1, 64)
    for params in (_fwd_params, _dq_params, hop.dkv_launch_params):
        assert params(1, 8, 64, 64, 64, splits=2) == (2, 2, 64)
        assert params(1, 8, 64, 64, 64, warps=4, splits=2) == (4, 2, 64)
        for bad in (dict(warps=3), dict(splits=4), dict(warps=1, splits=2), dict(warps=3, splits=1)):
            with pytest.raises(ValueError, match="warps must be one of"):
                params(1, 8, 64, 64, 64, **bad)


@pytest.mark.parametrize("head_dim", [0, 4, 12, 136])
def test_launch_params_reject_head_dims_without_a_build(head_dim):
    for params in (_fwd_params, _dq_params, hop.dkv_launch_params):
        with pytest.raises(ValueError, match="multiple of 8"):
            params(1, 8, 64, 64, head_dim)
    with pytest.raises(ValueError, match="multiple of 8"):
        hop.ragged_launch_params(head_dim, 64, False)


# The ragged kernel's launch: (head_dim, capacity = pages per row x page
# size, int8 pages) -> (splits, stages); a block covers one (row, head).
@pytest.mark.parametrize(
    "head_dim,capacity,quant,want",
    [
        (64, 64, False, (2, 1)),    # serving decode, fp32 pages: two chunks, one per warp
        (64, 64, True, (2, 1)),     # the same over int8 pages
        (64, 40, False, (2, 1)),    # 40 positions: two chunks
        (64, 32, False, (1, 1)),    # one chunk: nothing to split
        (64, 16, True, (1, 1)),
        (64, 65, False, (4, 1)),    # three chunks: four warps, one chunk each
        (64, 96, True, (4, 1)),
        (64, 208, False, (4, 2)),   # 7 chunks over 4 warps: two in flight
        (128, 208, False, (2, 2)),  # d=128 fp32, two stages: 4 warps would not fit
        (128, 208, True, (4, 2)),   # int8 rows are a quarter of the size
        (8, 24, True, (1, 1)),
        (72, 2048, True, (4, 2)),
    ],
)
def test_ragged_launch_params(head_dim, capacity, quant, want):
    assert hop.ragged_launch_params(head_dim, capacity, quant) == want


def test_ragged_launch_params_take_explicit_choices():
    for s in hop.RAGGED_SPLITS:
        assert hop.ragged_launch_params(64, 64, False, splits=s) == (s, 2 if s < 2 else 1)
        assert hop.ragged_launch_params(64, 208, True, splits=s) == (s, 2)
    for bad in (3, 8):
        with pytest.raises(ValueError, match="splits must be one of"):
            hop.ragged_launch_params(64, 64, False, splits=bad)
    with pytest.raises(ValueError, match="shared memory"):
        hop.ragged_launch_params(128, 208, False, splits=4)


# -- shared memory -----------------------------------------------------------------

H100_SMEM = 227 * 1024  # a block's dynamic shared memory on an H100 (hopper-kernels guide)

# The shapes the port runs (serving prefill and decode, the MT training
# sites, the eval decode) and the edge shapes the smoke and the gpu tests use.
FLASH_SHAPES = [
    (1, 8, 64, 64, 64), (1, 8, 1, 64, 64), (32, 8, 200, 200, 64), (32, 8, 199, 199, 64),
    (32, 8, 199, 200, 64), (2, 8, 77, 200, 64), (2, 4, 40, 30, 16), (3, 2, 17, 45, 128),
    (2, 3, 33, 65, 40), (2, 4, 100, 140, 128), (2, 4, 50, 50, 8), (1, 8, 2000, 2000, 128),
]
# (head_dim, capacity)
RAGGED_SHAPES = [
    (64, 64), (64, 96), (64, 40), (64, 208), (128, 208), (8, 24), (128, 64), (72, 2048),
]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_dq_choice_fits_a_block(shape):
    b, h, sq, sk, d = shape
    d_pad = next(p for p in hop.KERNEL_D_PADS if d <= p)
    picked = hop.dq_launch_params(b, h, sq, sk, d, H100_SMS)
    for w, c in [picked[:2], *((w, c) for w in hop.KERNEL_WARPS for c in hop.KERNEL_SPLITS if w % c == 0)]:
        assert hop.dq_smem_bytes(w, c, d_pad, sk) <= H100_SMEM, (w, c)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_ragged_choice_fits_a_block(shape, quant):
    """What ``ragged_launch_params`` picks fits; an explicit choice that
    would not is refused in Python, before the kernel could refuse it."""
    d, cap = shape
    s, st = hop.ragged_launch_params(d, cap, quant)
    assert hop.ragged_smem_bytes(d, quant, s, st) <= H100_SMEM
    for s in hop.RAGGED_SPLITS:
        stages = 2 if -(-cap // 32) > s else 1
        if hop.ragged_smem_bytes(d, quant, s, stages) <= H100_SMEM:
            assert hop.ragged_launch_params(d, cap, quant, s) == (s, stages)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                hop.ragged_launch_params(d, cap, quant, s)


def test_ragged_smem_at_the_serving_decode():
    # per warp: one stage of 32 K and 32 V rows of 68 floats, 3 x 32 words
    # of scales and slots, q (64 floats), p (32), state (66 -> 68 floats)
    assert hop.ragged_smem_bytes(64, False, 1, 1) == 2 * 32 * 272 + 384 + 256 + 128 + 272
    assert hop.ragged_smem_bytes(64, True, 1, 1) == 2 * 32 * 80 + 384 + 256 + 128 + 272
    assert hop.dq_smem_bytes(4, 1, 64, 200) == 4 * (2 * 64 * 68 + 128 + 2 * 2 * 32 * 68) + 8 * 7


# -- 16-byte row layout --------------------------------------------------------


def _fused_views(b=2, s=10, h=4, d=64):
    """q, k, v as the model passes them: head-split views of one fused
    ``[B, S, 3*H*d]`` projection."""
    qkv = torch.zeros(b, s, 3 * h * d)
    return [t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("d", [8, 40, 64, 128])
def test_kernel_layout_admits_the_models_views(d):
    views = _fused_views(d=d)
    contiguous = torch.zeros(2, 4, 10, d)
    hop.check_kernel_layout("flash_attention", contiguous, *views)
    # dO as the backward of out.transpose(1, 2).reshape(b, s, h*d) gives it
    g = torch.zeros(2, 10, 4 * d).view(2, 10, 4, d).transpose(1, 2)
    hop.check_kernel_layout("flash_attention_bwd_dkv", g)
    assert all(hop.kernel_layout_ok(t) for t in (contiguous, g, *views))


def _offset_view():
    flat = torch.zeros(2 * 4 * 10 * 64 + 1)
    return flat[1:].view(2, 4, 10, 64)  # starts 4 bytes past an aligned one


def _odd_stride_view():
    # position stride 66: every other row starts 8 bytes off 16
    return torch.zeros(2, 4, 10, 66)[..., :64]


def _odd_head_stride_view():
    return torch.zeros(2, 4 * 64 + 2, 10).as_strided((2, 4, 10, 64), (2580, 642, 64, 1))


@pytest.mark.parametrize(
    "make", [_offset_view, _odd_stride_view, _odd_head_stride_view],
    ids=["offset", "odd-position-stride", "odd-head-stride"],
)
def test_kernel_layout_rejects_rows_off_16_bytes(make):
    t = make()
    assert not hop.kernel_layout_ok(t)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.check_kernel_layout("flash_attention", torch.zeros(1, 1, 4, 64), t)


def test_kernel_layout_rejects_a_strided_head_dim():
    t = torch.zeros(2, 4, 10, 128)[..., ::2]
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        hop.check_kernel_layout("flash_attention_bwd_dkv", t)


def test_kernel_layout_ignores_strides_of_size_one_dims():
    # a one-prompt batch and a one-row step: those strides are never used
    t = torch.zeros(1, 8, 1, 64).as_strided((1, 8, 1, 64), (3, 64, 5, 1))
    assert hop.kernel_layout_ok(t)


def test_expanded_sum_gradient_fails_the_layout():
    """``out.sum().backward()`` hands the backward a stride-0 dO;
    ``FlashAttention.backward`` copies such a dO before the kernels."""
    g = torch.ones(()).expand(2, 4, 10, 64)
    assert not hop.kernel_layout_ok(g)
    assert hop.kernel_layout_ok(g.clone(memory_format=torch.contiguous_format))


# -- the build ------------------------------------------------------------------


def test_every_local_include_ships_in_csrc():
    for src in sorted(cuda_build.CSRC_DIR.glob("*.cu")):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                name = line.split('"')[1]
                assert (cuda_build.CSRC_DIR / name).is_file(), (src.name, name)


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build._digest(tmp_path / "a.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_build._digest(tmp_path / "a.cu") != before


def test_entry_points_take_the_launch_parameters():
    """After ``scale`` the forward, dQ and dK/dV take (warps, splits,
    d_pad) as ints, then the strides; the ragged kernel takes (splits,
    stages), then the stream."""
    f32 = cuda_build._F32
    for name, extra in (("flash_attention_fwd", 3), ("flash_attention_bwd_dkv", 3),
                        ("flash_attention_bwd_dq", 3)):
        argtypes = cuda_build.ENTRY_POINTS[name][2]
        i = argtypes.index(f32)
        assert argtypes[i + 1:i + 1 + extra] == [cuda_build._INT] * extra
        assert argtypes[i + 1 + extra] is cuda_build._I64
    argtypes = cuda_build.ENTRY_POINTS["ragged_paged_attention"][2]
    i = argtypes.index(f32)
    assert argtypes[i + 1:] == [cuda_build._INT] * 2 + [cuda_build._VOID]


# -- 3xTF32 ----------------------------------------------------------------------


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero, as an fp32 bit pattern."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> float32, truncating: the tensor core's fp32 accumulation
    does not round to nearest."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_matmul(a: np.ndarray, b: np.ndarray, passes: int, fresh: bool = True) -> np.ndarray:
    """``a @ b`` as the kernels form it: per 8-wide k-step, mma.sync
    m16n8k8 products in 3xTF32 (lo*hi, hi*lo, hi*hi, hopper_mma.cuh's
    order) or in one TF32 pass. The tensor core is modelled as exact
    products summed and truncated to fp32 once per mma. With ``fresh``
    (the kernels' way) each k-step's passes start from a zero fragment
    that an fp32 add (round to nearest) puts into the running sum;
    otherwise every mma accumulates into the running sum itself."""
    k = a.shape[-1]
    pad = -k % 8
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
    b = np.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, k + pad, 8):
        x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if passes == 3:
            xh, yh = tf32(x), tf32(y)
            xl, yl = tf32(x - xh), tf32(y - yh)
            terms = [(xl, yh), (xh, yl), (xh, yh)]
        else:
            terms = [(tf32(x), tf32(y))]
        frag = np.zeros_like(acc) if fresh else acc
        for u, w in terms:
            frag = round_toward_zero(frag.astype(np.float64) + u.astype(np.float64) @ w.astype(np.float64))
        acc = (acc + frag).astype(np.float32) if fresh else frag
    return acc


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2)], np.float32)
    np.testing.assert_array_equal(tf32(x), [one, one + ulp, one + ulp, -(one + ulp)])
    # hi + lo holds 22 of fp32's 24 bits: within 2^-21 relative
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(v)
    lo = tf32(v - hi)
    assert np.abs((hi.astype(np.float64) + lo) - v).max() <= 2.0 ** -21 * np.abs(v).max()


def _site(rng, sq, sk, causal, b=4, h=8, d=64):
    """One MT training site's per-(batch, head) shape at batch 4, with
    fixture-like key validity (5-29 valid keys at the front of each row)."""
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    valid = np.arange(sk)[None, :] < rng.integers(5, 30, (b, 1))
    mask = np.broadcast_to(valid[:, None, None, :], (b, h, sq, sk))
    if causal:
        mask = mask & np.tril(np.ones((sq, sk), bool), sk - sq)
    return q, k, v, valid, mask


def _forward(q, k, v, mask, matmul):
    """The plain forward's arithmetic (``flash_attention_lse_plain``)
    with the two products done by ``matmul``: scores, out, lse."""
    s = matmul(q, np.swapaxes(k, -1, -2)) * np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = np.where(mask, s, np.float32(-1e30)).astype(np.float32)
    m = s.max(-1, keepdims=True)
    p = np.where(mask, np.exp(s - m), np.float32(0)).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    out = matmul(p, v) / l
    return s, out, (m + np.log(l))[..., 0]


SITES = {
    "encoder self": (200, 200, False),
    "decoder self": (199, 199, True),
    "cross": (199, 200, False),
}


@pytest.mark.parametrize("site", list(SITES))
def test_three_tf32_passes_keep_fp32_accuracy_and_one_does_not(site):
    rng = np.random.default_rng(7)
    q, k, v, valid, mask = _site(rng, *SITES[site])
    exact = _forward(*(x.astype(np.float64) for x in (q, k, v)), mask, np.matmul)
    three = _forward(q, k, v, mask, lambda a, b: tc_matmul(a, b, 3))
    one = _forward(q, k, v, mask, lambda a, b: tc_matmul(a, b, 1))

    def rel(got, want, where=None):
        err, ref = np.abs(got - want), np.abs(want)
        if where is not None:
            err, ref = err[where], ref[where]
        return err.max() / ref.max()

    # fp32 itself, through the port's plain forward (torch, float32)
    out32, lse32 = hop.flash_attention_lse_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        causal=SITES[site][2], kv_valid=torch.from_numpy(valid),
    )
    s32 = np.matmul(q, np.swapaxes(k, -1, -2)) * np.float32(1.0 / np.sqrt(64))
    assert rel(three[0], s32, mask) < 1e-6  # 3xTF32 scores vs fp32 scores
    assert rel(three[1], out32.numpy()) < 1e-6
    assert rel(three[2], lse32.numpy()) < 1e-6
    for got, want, where in zip(three, exact, (mask, None, None)):
        assert rel(got, want, where) < 1e-6  # and vs float64
    # One pass breaks the kernels' gates: 1e-4 absolute on the output
    # (chip_smoke.py's forward cases) and 1e-4 relative on scores and out.
    assert np.abs(one[1] - exact[1]).max() > 1e-4
    assert rel(one[0], exact[0], mask) > 1e-4
    assert rel(one[1], exact[1]) > 1e-4


@pytest.mark.parametrize("k", [64, 200], ids=["head-dim-sum", "query-row-sum"])
def test_fresh_fragments_keep_the_truncating_accumulator_at_fp32_error(k):
    """Sums the kernels take: over the head dim (S, dP) and over 200
    query rows (dK, dV). Carried through the tensor core's truncating
    accumulator the error grows several-fold over an fp32 FMA loop's;
    started from a fresh fragment per k-step and added in fp32, it stays
    at the FMA loop's level."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((4000, k)).astype(np.float32)
    b = rng.standard_normal((k, 1)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    norm = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    fma = np.zeros((a.shape[0], 1), np.float32)
    for i in range(k):
        fma = (fma + a[:, i:i + 1] * b[i]).astype(np.float32)

    def err(x):
        return float(np.mean(np.abs(x - exact) / norm))

    fresh = err(tc_matmul(a, b, 3, fresh=True))
    chained = err(tc_matmul(a, b, 3, fresh=False))
    assert fresh <= 1.5 * err(fma)
    assert chained > 3 * fresh


# -- the ragged kernel's split-and-merge -------------------------------------------


def ragged_split_model(q, k_pages, v_pages, table, lengths, splits, *,
                       k_scale=None, v_scale=None, cur_k=None, cur_v=None):
    """The ragged kernel's order of arithmetic in numpy float32: a row's
    positions in chunks of 32, chunk c to split c % splits; each split an
    online softmax (m, l, acc) over its chunks; the splits merged in split
    order (rescaled to the common max and added); cur folded in last. int8
    slots are dequantised before the products. (Within a chunk the dot
    products and the P·V sums are numpy's, not the kernel's partial sums.)"""
    f32 = np.float32
    rows, heads, dh = q.shape
    page = k_pages.shape[1]
    cap = table.shape[1] * page
    scale = f32(1.0 / np.sqrt(dh))
    pos = np.arange(cap)
    slots = table[:, pos // page] * page + pos % page  # [R, cap]
    k = k_pages.reshape(-1, heads, dh)[slots].astype(f32)  # [R, cap, H, dh]
    v = v_pages.reshape(-1, heads, dh)[slots].astype(f32)
    if k_scale is not None:
        k = k * k_scale.reshape(-1)[slots][..., None, None]
        v = v * v_scale.reshape(-1)[slots][..., None, None]
    m = np.full((splits, rows, heads), -1e30, f32)
    l = np.zeros((splits, rows, heads), f32)
    acc = np.zeros((splits, rows, heads, dh), f32)
    for c in range(-(-cap // 32)):
        w = c % splits
        sl = slice(32 * c, 32 * c + 32)
        valid = (pos[sl][None, :] < lengths[:, None])[:, None, :]  # [R, 1, 32]
        s = np.einsum("rhd,rjhd->rhj", q, k[:, sl]) * scale
        s = np.where(valid, s, f32(-1e30))
        m_new = np.maximum(m[w], s.max(-1))
        p = np.where(valid, np.exp(s - m_new[..., None]), f32(0))
        alpha = np.exp(m[w] - m_new)
        l[w] = l[w] * alpha + p.sum(-1)
        acc[w] = acc[w] * alpha[..., None] + np.einsum("rhj,rjhd->rhd", p, v[:, sl])
        m[w] = m_new
    mm, ll, aa = m[0], l[0], acc[0]
    for w in range(1, splits):
        mn = np.maximum(mm, m[w])
        a, b = np.exp(mm - mn), np.exp(m[w] - mn)
        ll = ll * a + l[w] * b
        aa = aa * a[..., None] + acc[w] * b[..., None]
        mm = mn
    if cur_k is not None:
        ck, cv = cur_k.reshape(rows, heads, dh), cur_v.reshape(rows, heads, dh)
        s = (q * ck).sum(-1) * scale
        mn = np.maximum(mm, s)
        p, alpha = np.exp(s - mn), np.exp(mm - mn)
        ll = ll * alpha + p
        aa = aa * alpha[..., None] + p[..., None] * cv
    return aa / np.where(ll == 0, f32(1), ll)[..., None]


def _decode_case(rng, quant, **shape):
    """The shared serving decode step, q split off its fused projection."""
    qkv, k_pages, v_pages, table, lengths, kw = serving_decode(rng, quant, **shape)
    q, cur_k, cur_v = split_qkv(qkv, shape.get("heads", 8))
    return np.ascontiguousarray(q), k_pages, v_pages, table, lengths, kw, cur_k, cur_v


# The kernel's merge reorders fp32 sums (per-split maxima and sums, then a
# rescale), so it is held to the fp32 rounding of a softmax over at most
# 65 positions with outputs of order one: 2e-6 absolute, 50x below the
# kernel-vs-plain gate (1e-4) that chip_smoke.py applies on the card.
MERGE_TOL = 2e-6


@pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_ragged_split_merge_matches_one_pass(quant, with_cur):
    rng = np.random.default_rng(31)
    q, k_pages, v_pages, table, lengths, kw, cur_k, cur_v = _decode_case(rng, quant)
    if with_cur:
        kw["cur_k"], kw["cur_v"] = np.ascontiguousarray(cur_k), np.ascontiguousarray(cur_v)
    want = hop.ragged_paged_attention_plain(
        *(torch.from_numpy(x) for x in (q, k_pages, v_pages, table, lengths)),
        **{n: torch.from_numpy(x) for n, x in kw.items()},
    ).numpy()
    one = ragged_split_model(q, k_pages, v_pages, table, lengths, 1, **kw)
    for splits in (1, 2, 4):
        got = ragged_split_model(q, k_pages, v_pages, table, lengths, splits, **kw)
        assert np.abs(got - one).max() <= MERGE_TOL, splits
        assert np.abs(got - want).max() <= MERGE_TOL, splits
        if not with_cur:  # (with cur the two rows' own K/V differ)
            assert np.abs(got[0]).max() == 0.0  # length 0, no cur: zeros
            np.testing.assert_array_equal(got[-1], got[-2])  # shared prefix pages


def test_ragged_split_merge_over_long_rows():
    """Rows of up to 208 positions (seven chunks): four splits walk two
    chunks each (the kernel's two-stage case) and merge to one pass."""
    rng = np.random.default_rng(32)
    q, k_pages, v_pages, table, lengths, _, _, _ = _decode_case(rng, False, rows=8, pages_per_row=13)
    one = ragged_split_model(q, k_pages, v_pages, table, lengths, 1)
    want = hop.ragged_paged_attention_plain(
        *(torch.from_numpy(x) for x in (q, k_pages, v_pages, table, lengths))).numpy()
    for splits in (2, 4):
        got = ragged_split_model(q, k_pages, v_pages, table, lengths, splits)
        assert np.abs(got - one).max() <= MERGE_TOL
        assert np.abs(got - want).max() <= MERGE_TOL


# -- the bf16 instantiations --------------------------------------------------------


def test_bf16_entry_points_sit_beside_the_fp32_ones():
    """Each kernel's bf16 instantiation is its own C entry point in the
    same source (so the build hash covers it with the fp32 one) with the
    same arguments, and its own ``LAUNCHES`` count."""
    for name in hop.KERNELS:
        stem, fn, argtypes = cuda_build.ENTRY_POINTS[name]
        stem16, fn16, argtypes16 = cuda_build.ENTRY_POINTS[f"{name}_bf16"]
        assert (stem16, fn16, argtypes16) == (stem, f"{fn}_bf16", argtypes)
        source = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
        assert f'extern "C" int {fn16}(' in source
        assert hop.kernel_name(name, torch.bfloat16) == f"{name}_bf16"
        assert hop.kernel_name(name, torch.float32) == name
    assert set(hop.LAUNCHES) == set(cuda_build.ENTRY_POINTS)


def test_build_hash_covers_a_bf16_instantiation(tmp_path, monkeypatch):
    """Editing a bf16 kernel rebuilds its source's library: the hash is
    over the whole source, both instantiations."""
    src = tmp_path / "k.cu"
    src.write_text('extern "C" int k() { return 0; }\nextern "C" int k_bf16() { return 0; }\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build._digest(src)
    src.write_text('extern "C" int k() { return 0; }\nextern "C" int k_bf16() { return 1; }\n')
    assert cuda_build._digest(src) != before


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_launch_params_and_every_choice_fit_a_block(shape):
    """The bf16 kernels take the fp32 kernels' launch choices (the rules
    follow the rows and keys, not the bytes), and every choice's shared
    memory at bf16 — rows of d_pad + 8 bf16 — fits a block."""
    b, h, sq, sk, d = shape
    d_pad = next(p for p in hop.KERNEL_D_PADS if d <= p)
    for params in (_fwd_params, _dq_params):
        assert params(b, h, sq, sk, d, elem_bytes=2) == params(b, h, sq, sk, d)
    assert hop.dkv_launch_params(b, h, sq, sk, d, elem_bytes=2) == hop.dkv_launch_params(b, h, sq, sk, d)
    for w in hop.KERNEL_WARPS:
        for c in hop.KERNEL_SPLITS:
            if w % c:
                continue
            for elem in (4, 2):
                assert hop.fwd_smem_bytes(w, c, d_pad, sk, elem) <= H100_SMEM, (w, c, elem)
                assert hop.dq_smem_bytes(w, c, d_pad, sk, elem) <= H100_SMEM, (w, c, elem)
                assert hop.dkv_smem_bytes(w, c, d_pad, elem) <= H100_SMEM, (w, c, elem)
            # halving the element halves the rows' bytes
            assert hop.dq_smem_bytes(w, c, d_pad, sk, 2) < hop.dq_smem_bytes(w, c, d_pad, sk, 4)


def test_bf16_smem_mirrors_the_kernels():
    """``fwd_bf16_smem_bytes``, ``dq_bf16_smem_bytes``,
    ``dkv_bf16_smem_bytes`` and ``warp_bytes`` at 2-byte pages, as the
    sources compute them, at the training and serving sites."""
    # forward, 4 row groups, 200 keys: Q 64 x 72 bf16, 2 x 1 x 2 x 32 x 72 bf16, 2 x 7 words
    assert hop.fwd_smem_bytes(4, 1, 64, 200, 2) == 2 * (64 * 72 + 2 * 2 * 32 * 72) + 8 * 7
    assert hop.fwd_smem_bytes(4, 1, 64, 200) == 4 * (64 * 68 + 2 * 2 * 32 * 68) + 8 * 7
    assert hop.dq_smem_bytes(4, 1, 64, 200, 2) == 2 * (2 * 64 * 72 + 2 * 2 * 32 * 72) + 4 * 2 * 64 + 8 * 7
    # dK/dV, 2 key groups x 2 splits: K, V 32 x 72 bf16; 2 x 2 tiles of Q, dO 32 x 72 bf16 + 64 floats
    assert hop.dkv_smem_bytes(4, 2, 64, 2) == 2 * 2 * 32 * 72 + 2 * 2 * (2 * 2 * 32 * 72 + 4 * 64)
    assert hop.dkv_smem_bytes(4, 2, 64) == 4 * (2 * 32 * 68 + 2 * 2 * (2 * 32 * 68 + 64))
    # ragged, bf16 pages: rows of 2 x 64 + 16 bytes
    assert hop.ragged_smem_bytes(64, False, 1, 1, page_bytes=2) == 2 * 32 * 144 + 384 + 256 + 128 + 272


@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_bf16_ragged_choice_fits_a_block(shape):
    d, cap = shape
    s, st = hop.ragged_launch_params(d, cap, False, page_bytes=2)
    assert hop.ragged_smem_bytes(d, False, s, st, page_bytes=2) <= H100_SMEM
    # bf16 pages never need fewer splits than fp32 ones
    assert s >= hop.ragged_launch_params(d, cap, False)[0]
    for s in hop.RAGGED_SPLITS:
        stages = 2 if -(-cap // 32) > s else 1
        if hop.ragged_smem_bytes(d, False, s, stages, page_bytes=2) <= H100_SMEM:
            assert hop.ragged_launch_params(d, cap, False, s, page_bytes=2) == (s, stages)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                hop.ragged_launch_params(d, cap, False, s, page_bytes=2)


@pytest.mark.parametrize("d", [8, 40, 64, 128])
def test_bf16_layout_admits_the_models_views(d):
    qkv = torch.zeros(2, 10, 3 * 4 * d, dtype=torch.bfloat16)
    views = [t.view(2, 10, 4, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    hop.check_kernel_layout("flash_attention", *views)
    assert all(hop.kernel_layout_ok(t) for t in views)


def test_layout_counts_16_bytes_not_4_elements_at_bf16():
    """A row stride of 68 elements is 272 bytes in fp32 (whole 16-byte
    pieces) but 136 in bf16 (not): the same strides pass at fp32 and
    fail at bf16. 72 bf16 elements (144 bytes) pass."""
    fp32 = torch.zeros(2, 4, 10, 68)[..., :64]
    bf16 = torch.zeros(2, 4, 10, 68, dtype=torch.bfloat16)[..., :64]
    assert hop.kernel_layout_ok(fp32)
    assert not hop.kernel_layout_ok(bf16)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.check_kernel_layout("flash_attention", bf16)
    assert hop.kernel_layout_ok(torch.zeros(2, 4, 10, 72, dtype=torch.bfloat16)[..., :64])


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def tc_matmul_bf16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` as the bf16 kernels form it: operands rounded to bf16,
    mma.sync m16n8k16 per 16-wide k-step with exact products, the running
    float32 accumulator carried through every mma and truncated once per
    mma (no fresh fragment)."""
    a, b = _bf16(a), _bf16(b)
    k = a.shape[-1]
    pad = -k % 16
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
    b = np.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, k + pad, 16):
        x, y = a[..., k0:k0 + 16].astype(np.float64), b[..., k0:k0 + 16, :].astype(np.float64)
        acc = round_toward_zero(acc.astype(np.float64) + x @ y)
    return acc


@pytest.mark.parametrize("k", [64, 200], ids=["head-dim-sum", "query-row-sum"])
def test_chained_bf16_accumulator_stays_far_below_a_bf16_ulp(k):
    """Why the bf16 kernels carry their accumulator through every mma
    (no fresh fragment, unlike the fp32 kernels): over the head dim (4
    k-steps) and over 200 query rows (13), the truncating accumulator
    leaves the sum of the bf16 operands' products within 2^-18 of its
    exact value, while the bf16 output it becomes rounds at 2^-9."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal((4000, k)).astype(np.float32)
    b = rng.standard_normal((k, 1)).astype(np.float32)
    exact = _bf16(a).astype(np.float64) @ _bf16(b).astype(np.float64)
    norm = np.abs(_bf16(a)).astype(np.float64) @ np.abs(_bf16(b)).astype(np.float64)
    err = (np.abs(tc_matmul_bf16(a, b) - exact) / norm).max()
    assert err < 2.0 ** -18
