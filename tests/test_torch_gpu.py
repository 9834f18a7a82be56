"""The port's CUDA kernels and its card path, run only where there is a card.

Each kernel is held against its plain PyTorch version on the card
(``atol 1e-4``: the two sum in different orders), and the paged engine on
the card must give the tokens the same engine gives on the CPU. Without a
card every test skips. A machine with a card need not have JAX, so this
file imports none, and runs without the suite's JAX-loading conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
from torch_ragged_cases import serving_decode, split_qkv

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize(
    "b,h,sq,sk,d,causal,valid_frac",
    [
        (1, 8, 64, 64, 64, False, 0.6),
        (2, 8, 24, 70, 64, True, 0.8),
        (2, 4, 40, 30, 16, True, None),
        (3, 2, 17, 45, 128, False, 0.5),
        (2, 3, 1, 65, 40, False, None),
    ],
)
def test_flash_kernel_matches_plain(cuda, b, h, sq, sk, d, causal, valid_frac):
    rng = np.random.default_rng(20)
    q, k, v = (_randn(rng, b, h, n, d).to(cuda) for n in (sq, sk, sk))
    valid = None
    if valid_frac is not None:
        valid = torch.from_numpy(rng.random((b, sk)) < valid_frac).to(cuda)
    got = hop.flash_attention(q, k, v, causal=causal, kv_valid=valid)
    want = hop.flash_attention_plain(q, k, v, causal=causal, kv_valid=valid)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("sq", [64, 1], ids=["prefill", "one-row"])
@pytest.mark.parametrize("d", [8, 40, 64, 128])
def test_flash_kernel_at_the_serving_prefill(cuda, d, sq):
    """The serving prefill as the model hands it over: head-split views of
    a fused qkv projection, a 64-key chunk with 45 valid keys; and a
    one-row query against the same keys."""
    rng = np.random.default_rng(25)
    h = 8
    q = _randn(rng, 1, sq, 3 * h * d).to(cuda)[..., : h * d].view(1, sq, h, d).transpose(1, 2)
    kv = _randn(rng, 1, 64, 2 * h * d).to(cuda)
    k = kv[..., : h * d].view(1, 64, h, d).transpose(1, 2)
    v = kv[..., h * d:].view(1, 64, h, d).transpose(1, 2)
    valid = (torch.arange(64) < 45)[None].to(cuda)
    hop.reset_launches()
    got = hop.flash_attention(q, k, v, kv_valid=valid)
    assert hop.LAUNCHES["flash_attention_fwd"] == 1
    want = hop.flash_attention_plain(q, k, v, kv_valid=valid)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize(
    "warps,splits", [(1, 1), (2, 2), (4, 2)], ids=["w1", "w2-split2", "w4-split2"]
)
@pytest.mark.parametrize("d", [64, 128], ids=["d_pad64", "d_pad128"])
def test_tensor_core_kernels_at_every_launch_param(cuda, d, warps, splits):
    """Forward (with lse) and dK/dV at each warps per block and splits, and
    each padded head dim, on strided views with masked keys under causality
    (keys past the first two tiles, query rows past the first two tiles)."""
    rng = np.random.default_rng(26)
    q, k, v, g, valid = _bwd_inputs(rng, cuda, 2, 4, 100, 140, d, 0.7, strided=True)
    kw = dict(causal=True, kv_valid=valid)
    out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, warps=warps, splits=splits, **kw)
    want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
    finite = want_lse > hop.NEG_INF / 2
    assert torch.equal(lse > hop.NEG_INF / 2, finite)
    assert _max_rel(lse[finite], want_lse[finite]) < TOL
    delta = (g * out).sum(-1)
    dk, dv = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, warps=warps, splits=splits, **kw)
    want_dk, want_dv = hop.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
    assert _max_rel(dk, want_dk) < TOL
    assert _max_rel(dv, want_dv) < TOL


@pytest.mark.parametrize("warps,splits", [(1, 1), (4, 1), (4, 2)], ids=["w1", "w4", "w4-split2"])
def test_dkv_kernel_zeroes_whole_masked_key_blocks(cuda, warps, splits):
    """Only the first 10 of 200 keys are valid, so every block of 16 or 64
    keys past them is dead: exactly zero dK/dV there, the live keys within
    1e-4 relative, and a second run gives the same bits."""
    rng = np.random.default_rng(27)
    q, k, v, g, _ = _bwd_inputs(rng, cuda, 2, 8, 77, 200, 64, None, strided=True)
    valid = (torch.arange(200) < 10)[None].expand(2, 200).to(cuda)
    out, lse = hop.flash_attention_fwd(q, k, v, kv_valid=valid, return_lse=True)
    delta = (g * out).sum(-1)
    runs = [hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, kv_valid=valid, warps=warps, splits=splits)
            for _ in range(2)]
    dk, dv = runs[0]
    assert torch.equal(runs[1][0], dk) and torch.equal(runs[1][1], dv)
    assert dk[:, :, 10:].abs().max().item() == 0.0
    assert dv[:, :, 10:].abs().max().item() == 0.0
    want_dk, want_dv = hop.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, kv_valid=valid)
    assert _max_rel(dk, want_dk) < TOL
    assert _max_rel(dv, want_dv) < TOL


def test_tensor_core_kernels_refuse_rows_off_16_bytes(cuda):
    flat = torch.zeros(2 * 4 * 10 * 64 + 1, device=cuda)
    q = flat[1:].view(2, 4, 10, 64)
    k = v = torch.zeros(2, 4, 10, 64, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.flash_attention_fwd(q, k, v)
    lse = torch.zeros(2, 4, 10, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.flash_attention_bwd_dkv(k, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.flash_attention_bwd_dq(k, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.flash_attention_bwd_dq(q, k, v, k, lse, lse)


def test_ragged_kernel_refuses_query_rows_off_16_bytes(cuda):
    rows, heads, dh = 4, 2, 64
    flat = torch.zeros(rows * heads * dh + 1, device=cuda)
    pages = torch.zeros(5, 8, heads * dh, device=cuda)
    table = torch.zeros(rows, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(rows, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.ragged_paged_attention(flat[1:].view(rows, heads, dh), pages, pages, table, lengths)
    # rows 130 floats apart: every other row starts 8 bytes off 16
    odd = torch.zeros(rows, 130, device=cuda)[:, :heads * dh].view(rows, heads, dh)
    with pytest.raises(ValueError, match="16 bytes"):
        hop.ragged_paged_attention(odd, pages, pages, table, lengths)


def test_backward_takes_an_expanded_sum_gradient(cuda):
    """``out.sum().backward()`` gives the backward a stride-0 dO; the
    Function copies it into rows the kernels can read."""
    rng = np.random.default_rng(28)
    x = [_randn(rng, 2, 4, 33, 64) for _ in range(3)]
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev, copy=True).requires_grad_() for t in x]
        hop.flash_attention(*leaves, causal=True).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, ref in zip(*grads[::-1]):
        assert _max_rel(got, ref) < TOL


# The backward's cases: the MT training sites at a reduced batch, and the
# edges (Sq != Sk both ways under causality, fully masked rows, masked
# keys, lengths that are not tile multiples, other head dims).
BWD_CASES = [
    (2, 8, 200, 200, 64, False, 0.7),
    (2, 8, 199, 199, 64, True, 0.8),
    (2, 8, 199, 200, 64, False, 0.7),
    (2, 4, 24, 70, 64, True, 0.8),
    (2, 4, 40, 30, 16, True, None),
    (3, 2, 17, 45, 128, False, 0.5),
    (2, 3, 33, 65, 40, False, None),
]


def _bwd_inputs(rng, cuda, b, h, sq, sk, d, valid_frac, *, strided):
    if strided:
        # Head-split views of fused projections, as the model passes them.
        q = _randn(rng, b, sq, 3 * h * d).to(cuda)[..., : h * d]
        q = q.view(b, sq, h, d).transpose(1, 2)
        kv = _randn(rng, b, sk, 2 * h * d).to(cuda)
        k = kv[..., : h * d].view(b, sk, h, d).transpose(1, 2)
        v = kv[..., h * d:].view(b, sk, h, d).transpose(1, 2)
        # dO as the backward of out.transpose(1, 2).reshape(b, sq, h*d).
        g = _randn(rng, b, sq, h * d).to(cuda).view(b, sq, h, d).transpose(1, 2)
    else:
        q, k, v, g = (_randn(rng, b, h, n, d).to(cuda) for n in (sq, sk, sk, sq))
    valid = None
    if valid_frac is not None:
        mask = rng.random((b, sk)) < valid_frac
        mask[0] = False  # batch row 0 sees no key: every row fully masked
        valid = torch.from_numpy(mask).to(cuda)
    return q, k, v, g, valid


def _max_rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize(
    "warps,splits", [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)], ids=lambda x: str(x)
)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,valid_frac", BWD_CASES)
def test_dq_kernel_at_every_launch_param(cuda, b, h, sq, sk, d, causal, valid_frac, warps, splits):
    """dQ at each warps per block and splits, on strided views: within 1e-4
    relative of the plain version, rows that see no key exactly zero, and
    a second run the same bits."""
    rng = np.random.default_rng(33)
    q, k, v, g, valid = _bwd_inputs(rng, cuda, b, h, sq, sk, d, valid_frac, strided=True)
    kw = dict(causal=causal, kv_valid=valid)
    out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    delta = (g * out).sum(-1)
    runs = [hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, warps=warps, splits=splits, **kw)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    want = hop.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    assert _max_rel(runs[0], want) < TOL
    empty = ~(lse > hop.NEG_INF / 2)
    if bool(empty.any().item()):
        assert runs[0][empty].abs().max().item() == 0.0


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,valid_frac", BWD_CASES)
def test_flash_lse_and_backward_kernels_match_plain(
    cuda, b, h, sq, sk, d, causal, valid_frac, strided
):
    rng = np.random.default_rng(23)
    q, k, v, g, valid = _bwd_inputs(
        rng, cuda, b, h, sq, sk, d, valid_frac, strided=strided
    )
    kw = dict(causal=causal, kv_valid=valid)
    out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
    finite = want_lse > hop.NEG_INF / 2
    assert torch.equal(lse > hop.NEG_INF / 2, finite)
    assert _max_rel(lse[finite], want_lse[finite]) < TOL
    delta = (g * out).sum(-1)
    dq = hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    want = hop.flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
    for got, ref in zip((dq, dk, dv), want):
        assert got.is_contiguous()
        assert _max_rel(got, ref) < TOL
    if valid is not None:  # keys no row sees: exactly zero dK and dV
        masked = ~valid[:, None, :, None].expand_as(dk)
        assert dk[masked].abs().max().item() == 0.0
        assert dv[masked].abs().max().item() == 0.0
        assert dq[0].abs().max().item() == 0.0  # batch row 0 saw no key


def test_flash_function_on_the_card_launches_the_kernels(cuda):
    """Under grad the forward writes lse and the backward runs both
    kernels; the dQ/dK/dV agree with the CPU's plain backward, and a second
    backward on the same inputs gives the same bits."""
    rng = np.random.default_rng(24)
    x = [_randn(rng, 2, 4, 37, 64) for _ in range(3)]
    g = _randn(rng, 2, 4, 37, 64)
    valid = torch.from_numpy(rng.random((2, 37)) < 0.8)
    grads = {}
    for dev in ("cpu", cuda, cuda):
        leaves = [t.to(dev, copy=True).requires_grad_() for t in x]
        hop.reset_launches()
        out = hop.flash_attention(*leaves, causal=True, kv_valid=valid.to(dev))
        (out * g.to(dev)).sum().backward()
        if dev != "cpu":
            assert hop.LAUNCHES["flash_attention_fwd"] == 1
            assert hop.LAUNCHES["flash_attention_bwd_dq"] == 1
            assert hop.LAUNCHES["flash_attention_bwd_dkv"] == 1
        grads.setdefault(str(dev), []).append([t.grad.cpu() for t in leaves])
    ref = grads["cpu"][0]
    first, second = grads[str(cuda)]
    for a, b, r in zip(first, second, ref):
        assert torch.equal(a, b)  # no atomics: the same bits every run
        assert _max_rel(a, r) < TOL


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
def test_ragged_kernel_matches_plain(cuda, int8, with_cur):
    rng = np.random.default_rng(21)
    rows, heads, dh, page, pages_per_row = 6, 4, 64, 8, 5
    num_pages = 1 + rows * pages_per_row
    lengths = np.array([0, 1, 8, 9, 40, 23], np.int32)
    table = np.zeros((rows, pages_per_row), np.int32)
    for r in range(rows):
        used = -(-int(lengths[r]) // page)
        table[r, :used] = 1 + r * pages_per_row + np.arange(used)
    kw = {}
    if int8:
        k_pages = torch.from_numpy(
            rng.integers(-127, 128, (num_pages, page, heads * dh)).astype(np.int8)
        )
        v_pages = torch.from_numpy(
            rng.integers(-127, 128, (num_pages, page, heads * dh)).astype(np.int8)
        )
        kw["k_scale"] = torch.from_numpy((rng.random((num_pages, page)) * 0.02).astype(np.float32))
        kw["v_scale"] = torch.from_numpy((rng.random((num_pages, page)) * 0.02).astype(np.float32))
    else:
        k_pages = _randn(rng, num_pages, page, heads * dh)
        v_pages = _randn(rng, num_pages, page, heads * dh)
    if with_cur:
        kw["cur_k"] = _randn(rng, rows, heads * dh)
        kw["cur_v"] = _randn(rng, rows, heads * dh)
    args = [
        _randn(rng, rows, heads, dh), k_pages, v_pages,
        torch.from_numpy(table), torch.from_numpy(lengths),
    ]
    args = [a.to(cuda) for a in args]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    got = hop.ragged_paged_attention(*args, **kw)
    want = hop.ragged_paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    if not with_cur:
        assert got[0].abs().max().item() == 0.0  # length 0, no cur: zeros


def _serving_decode(rng, cuda, int8, **shape):
    """The shared serving decode step on the card: q, cur_k and cur_v are
    strided slices of one fused projection, as the model passes them."""
    qkv, k_pages, v_pages, table, lengths, scales = serving_decode(rng, int8, **shape)
    q, cur_k, cur_v = split_qkv(torch.from_numpy(qkv).to(cuda), shape.get("heads", 8))
    args = [q, *(torch.from_numpy(x).to(cuda) for x in (k_pages, v_pages, table, lengths))]
    return args, {n: torch.from_numpy(x).to(cuda) for n, x in scales.items()}, cur_k, cur_v


@pytest.mark.parametrize("splits", hop.RAGGED_SPLITS)
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
def test_ragged_kernel_at_every_launch_choice(cuda, with_cur, int8, splits):
    """Every split choice at the serving decode's shapes, the
    edge lengths among the rows: within 1e-4 of the plain version, a
    length-0 row without cur exactly zero, rows sharing prefix pages
    identical, and a second run the same bits."""
    rng = np.random.default_rng(29)
    args, kw, cur_k, cur_v = _serving_decode(rng, cuda, int8)
    if with_cur:
        kw.update(cur_k=cur_k, cur_v=cur_v)
    choice = dict(splits=splits)
    hop.reset_launches()
    got = hop.ragged_paged_attention(*args, **kw, **choice)
    again = hop.ragged_paged_attention(*args, **kw, **choice)
    assert hop.LAUNCHES["ragged_paged_attention"] == 2
    want = hop.ragged_paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.equal(got, again)
    if not with_cur:
        assert got[0].abs().max().item() == 0.0
        assert torch.equal(got[-1], got[-2])


@pytest.mark.parametrize("splits", hop.RAGGED_SPLITS)
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_ragged_kernel_over_long_rows(cuda, int8, splits):
    """Rows of up to 208 positions (13 pages of 16): a warp walks several
    chunks with two in flight; one row alone; d = 40 and 128."""
    rng = np.random.default_rng(30)
    for rows, dh in ((8, 64), (1, 64), (3, 40), (3, 128)):
        args, kw, cur_k, cur_v = _serving_decode(rng, cuda, int8, rows=max(rows, 7), dh=dh,
                                                 pages_per_row=13)
        args = [a[:rows] if i in (0, 3, 4) else a for i, a in enumerate(args)]
        kw.update(cur_k=cur_k[:rows], cur_v=cur_v[:rows])
        if hop.ragged_smem_bytes(dh, int8, splits, 2) > hop.SMEM_LIMIT:
            with pytest.raises(ValueError, match="shared memory"):
                hop.ragged_paged_attention(*args, **kw, splits=splits)
            continue
        got = hop.ragged_paged_attention(*args, **kw, splits=splits)
        want = hop.ragged_paged_attention_plain(*args, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_paged_engine_on_the_card_matches_the_cpu(cuda):
    """A tiny model served on the card (kernels) and on the CPU (plain
    versions), same weights: identical tokens, and both kernels ran."""
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import (
        load_flax_params,
        random_flax_params,
    )

    rng = np.random.default_rng(22)
    words = [f"w{i}" for i in range(40)]
    texts = [" ".join(rng.choice(words, int(n))) for n in rng.integers(2, 12, 16)]
    src_pipe = TextPipeline.fit(texts, max_seq_len=15)
    trg_pipe = TextPipeline.fit(texts, max_seq_len=15)
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos),
        trg_vocab_size=len(trg_pipe.vocab.itos),
        d_model=64, ffn_hidden=128, num_heads=4, num_layers=2, max_len=24,
        dropout=0.0,
    )
    params = random_flax_params(cfg, seed=3)
    params["lm_head"]["bias"][0] = -30.0  # no emitted pad (see chip_smoke.py)
    outs = {}
    hop.reset_launches()
    for device in ("cpu", cuda):
        model = load_flax_params(Transformer(cfg), params)
        t = Translator(model, src_pipe, trg_pipe, device=device)
        with t.serve(boundaries=(8, 16), max_active=4, page_size=4,
                     max_new_tokens=10) as eng:
            outs[str(device)] = [
                f.result(timeout=120) for f in [eng.submit(s) for s in texts]
            ]
            assert eng.runtime.stats()["self_pages_in_use"] == 0
    assert outs["cpu"] == outs[str(cuda)]
    assert hop.LAUNCHES["flash_attention_fwd"] > 0
    assert hop.LAUNCHES["ragged_paged_attention"] > 0


def _decode_site(rng, cuda, rows, sk, valid, *, h=8, dh=64):
    """One decode-step attention call as the model makes it: q a head
    view of the step's fused qkv, K/V head views of cache buffers
    ``[rows, sk, h dh]`` (strided, rows 256 bytes apart)."""
    d = h * dh
    q = _randn(rng, rows, 1, 3 * d).to(cuda)[..., :d].view(rows, 1, h, dh).transpose(1, 2)
    k, v = (_randn(rng, rows, sk, d).to(cuda).view(rows, sk, h, dh).transpose(1, 2) for _ in range(2))
    return q, k, v, None if valid is None else torch.from_numpy(valid).to(cuda)


DECODE_STEPS = [0, 31, 32, 33, 99, 198]


@pytest.mark.parametrize("pads", [False, True], ids=["prefix", "pads-in-prefix"])
@pytest.mark.parametrize("t", DECODE_STEPS)
def test_flash_kernel_at_the_cached_decode_self_site(cuda, t, pads):
    """One query row per (row, head) against a 200-position self cache
    whose first t + 1 positions are written (t = 31, 32, 33 straddle a
    32-key tile; 198 is the last step of a 199-token decode); with pads,
    half the rows finished earlier and their positions after eos are
    masked. Every launch choice, and two runs the same bits."""
    rng = np.random.default_rng(40 + t)
    valid = np.broadcast_to(np.arange(200) < t + 1, (32, 200)).copy()
    if pads and t >= 2:
        valid[::2, int(rng.integers(1, t)) + 1:] = False
    q, k, v, kv_valid = _decode_site(rng, cuda, 32, 200, valid)
    want = hop.flash_attention_plain(q, k, v, kv_valid=kv_valid)
    hop.reset_launches()
    got = hop.flash_attention(q, k, v, kv_valid=kv_valid)
    assert hop.LAUNCHES["flash_attention_fwd"] == 1
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.equal(got, hop.flash_attention(q, k, v, kv_valid=kv_valid))
    for warps, splits in [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)]:
        torch.testing.assert_close(
            hop.flash_attention_fwd(q, k, v, kv_valid=kv_valid, warps=warps, splits=splits),
            want, atol=TOL, rtol=0,
        )


@pytest.mark.parametrize(
    "rows,sk,with_valid",
    [(32, 200, True), (32, 1, False), (16, 64, True), (16, 65, True)],
    ids=["bleu-cross", "priming", "beam-cross", "beam-self"],
)
def test_flash_kernel_at_the_other_decode_sites(cuda, rows, sk, with_valid):
    """The cross-attention over the sources, the priming call (one key, no
    mask) and the beam grid (16 rows: two key splits on 132 SMs)."""
    rng = np.random.default_rng(50 + rows + sk)
    valid = None
    if with_valid:
        valid = np.arange(sk)[None, :] < rng.integers(1, sk + 1, (rows, 1))
    q, k, v, kv_valid = _decode_site(rng, cuda, rows, sk, valid)
    want = hop.flash_attention_plain(q, k, v, kv_valid=kv_valid)
    got = hop.flash_attention(q, k, v, kv_valid=kv_valid)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.equal(got, hop.flash_attention(q, k, v, kv_valid=kv_valid))
    for warps, splits in [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)]:
        torch.testing.assert_close(
            hop.flash_attention_fwd(q, k, v, kv_valid=kv_valid, warps=warps, splits=splits),
            want, atol=TOL, rtol=0,
        )


def test_cached_decoders_on_the_card_launch_the_kernel(cuda):
    """``greedy_translate_cached`` on the card launches the flash forward
    for the encoder, the priming call and every step (self and cross per
    layer), gives the plain path's tokens, and repeats bit for bit; beam
    search on the card gives the CPU's tokens."""
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
        beam_translate,
        greedy_translate_cached,
    )

    cfg = TransformerConfig(
        src_vocab_size=50, trg_vocab_size=47, d_model=128, ffn_hidden=256,
        num_heads=2, num_layers=2, max_len=24, dropout=0.0,
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(23)
    src = torch.from_numpy(rng.integers(4, 50, (6, 12)))
    src[3, 7:] = 0
    want = greedy_translate_cached(model, src, max_new_tokens=20)
    want_beam = beam_translate(model, src, beam_size=3, max_new_tokens=20)
    model = model.to(cuda)
    hop.reset_launches()
    got = greedy_translate_cached(model, src.to(cuda), max_new_tokens=20)
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert hop.LAUNCHES["flash_attention_fwd"] == layers + 2 * layers * (1 + 20)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, greedy_translate_cached(model, src.to(cuda), max_new_tokens=20))
    got_beam = beam_translate(model, src.to(cuda), beam_size=3, max_new_tokens=20)
    assert torch.equal(got_beam.cpu(), want_beam)


def test_sampling_on_the_card_needs_a_card_generator(cuda):
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
        sample_translate,
    )

    cfg = TransformerConfig(
        src_vocab_size=30, trg_vocab_size=30, d_model=64, ffn_hidden=64,
        num_heads=1, num_layers=1, max_len=12, dropout=0.0,
    )
    model = Transformer(cfg).to(cuda)
    src = torch.randint(4, 30, (3, 8), generator=torch.Generator().manual_seed(0)).to(cuda)
    with pytest.raises(ValueError, match="generator on cpu"):
        sample_translate(model, src, torch.Generator().manual_seed(0), max_new_tokens=5)
    runs = [
        sample_translate(model, src, torch.Generator(device=cuda).manual_seed(9), top_k=5, max_new_tokens=5)
        for _ in range(2)
    ]
    assert torch.equal(runs[0], runs[1])


def test_full_width_train_steps_on_the_card_match_the_cpu(cuda):
    """Three Adam steps of the reference MT model at full width (d_model
    512, ffn 1024, 8 heads of 64, max_len 200) on fixture batches, from the
    same weights on the card and on the CPU: per-step losses within 1e-3
    relative (the two sum in different orders and Adam amplifies it), and
    the card's steps went through the three flash kernels: 3 sites per step
    per layer."""
    from pathlib import Path

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import (
        make_train_step,
        to_device,
    )
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
    from machine_learning_apache_spark_tpu_torch.weights import (
        load_flax_params,
        random_flax_params,
    )

    resolve_device(cuda)  # full fp32 matmuls on the card, as the CPU does
    root = Path(__file__).resolve().parent.parent / "assets" / "fixtures"
    pairs = load_multi30k(str(root), "train")
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=200)
    ds = ArrayDataset(src_pipe([s for s, _ in pairs]), trg_pipe([t for _, t in pairs]))
    batches = list(DataLoader(ds, 32, shuffle=True, seed=0))[:3]
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
        dropout=0.0,
    )
    params = random_flax_params(cfg, seed=4)
    step = make_train_step(make_translation_loss(cfg.pad_id))
    losses = {}
    for dev in ("cpu", cuda):
        model = load_flax_params(Transformer(cfg), params).to(dev)
        state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
        hop.reset_launches()
        losses[str(dev)] = [
            step(state, to_device(b, torch.device(dev)), None)[1].item() for b in batches
        ]
    got, want = np.array(losses[str(cuda)]), np.array(losses["cpu"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert hop.LAUNCHES["flash_attention_bwd_dq"] == 3 * len(batches)
    assert hop.LAUNCHES["flash_attention_bwd_dkv"] == 3 * len(batches)
    assert hop.LAUNCHES["flash_attention_fwd"] == 3 * len(batches)


# -- the engines' programs: CUDA graphs captured at warmup ----------------------


def _card_translator(cuda, dtype=torch.float32):
    """A tiny model on the card (compute ``dtype``), its pipelines, and 16
    prompts of 2-11 words (random weights, the pad logit pushed down as in
    ``chip_smoke.py``)."""
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import (
        load_flax_params,
        random_flax_params,
    )

    rng = np.random.default_rng(26)
    words = [f"w{i}" for i in range(40)]
    texts = [" ".join(rng.choice(words, int(n))) for n in rng.integers(2, 12, 16)]
    pipe = TextPipeline.fit(texts, max_seq_len=15)
    cfg = TransformerConfig(
        src_vocab_size=len(pipe.vocab.itos), trg_vocab_size=len(pipe.vocab.itos),
        d_model=64, ffn_hidden=128, num_heads=4, num_layers=2, max_len=24,
        dropout=0.0, dtype=dtype,
    )
    params = random_flax_params(cfg, seed=7)
    params["lm_head"]["bias"][0] = -30.0
    model = load_flax_params(Transformer(cfg), params)
    return Translator(model, pipe, pipe, device=cuda), texts


CARD_ENGINE = dict(boundaries=(8, 16), max_active=4, max_batch=4, page_size=4, max_new_tokens=10)


def _replay_and_eager(replay, eager):
    """The outputs of one eager call and one replay, with each one's
    launches."""
    hop.reset_launches()
    want = eager()
    torch.cuda.synchronize()
    eager_n = dict(hop.LAUNCHES)
    hop.reset_launches()
    got = replay()
    torch.cuda.synchronize()
    return got, want, dict(hop.LAUNCHES), eager_n


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_replayed_paged_launch_equals_an_eager_call(cuda, kv_dtype):
    """The launch's graph, replayed over rows of real prompts, against an
    eager call of the same function on cloned stores and inputs: the
    emits and the stores bit for bit, the launches equal; N replays add N
    times one eager call's launches."""
    from machine_learning_apache_spark_tpu_torch.serving import ServeRequest

    t, texts = _card_translator(cuda)
    eng = t.serve(start=False, kv_dtype=kv_dtype, quantize_self=kv_dtype == "int8", **CARD_ENGINE)
    assert eng.warmup() == eng.compile_count() == eng.runtime.max_chunks + 1
    rt = eng.runtime
    for row, s in enumerate(texts[: rt.max_active]):
        assert rt.admit(ServeRequest(s, t.src_pipe.ragged([s])[0], 0.0), row) is not None
    rt.grow()
    rt.launch()
    rt.grow()
    inputs = [x.to(cuda) for x in rt._stage()]
    stores = [None if x is None else x.clone() for x in rt.stores()]
    got, want, got_n, eager_n = _replay_and_eager(
        lambda: [rt._replay(rt._stage()).clone(), *(x for x in rt.stores() if x is not None)],
        lambda: [rt._decode(stores, *inputs), *(x for x in stores if x is not None)],
    )
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got_n == eager_n and eager_n["ragged_paged_attention"] == 2 * 2 * rt.steps_per_launch
    hop.reset_launches()
    for _ in range(3):
        rt._replay(rt._stage())
    torch.cuda.synchronize()
    assert hop.LAUNCHES == {k: 3 * n for k, n in eager_n.items()}
    assert eng.recompiles_after_warmup == 0


@pytest.mark.parametrize("mode", [dict(kv_mode="padded"), dict(method="beam", beam_size=2)],
                         ids=["padded", "beam"])
def test_replayed_bucket_decode_equals_an_eager_call(cuda, mode):
    """A bucket's whole decode (encoder, priming call, every step and
    beam reorder) as one graph, replayed on a rectangle of real prompts,
    against an eager call of the decoder: the same bits and launches."""
    t, texts = _card_translator(cuda)
    eng = t.serve(start=False, **CARD_ENGINE, **mode)
    assert eng.warmup() == eng.compile_count() == 2
    src = np.zeros((eng.max_batch, 16), np.int64)
    for i, s in enumerate(texts[: eng.max_batch]):
        ids = t.src_pipe.ragged([s])[0]
        src[i, : len(ids)] = ids
    host = torch.from_numpy(src)
    got, want, got_n, eager_n = _replay_and_eager(
        lambda: eng._decode(host).clone(), lambda: eng._decode_body(host.to(cuda)),
    )
    assert torch.equal(got, want)
    layers = t.model.cfg.num_layers
    assert got_n == eager_n and eager_n["flash_attention_fwd"] == layers + 2 * layers * (1 + 10)
    assert eng.recompiles_after_warmup == 0


def test_serving_after_a_reset_replays_the_same_programs(cuda):
    """The quarantine path (``runtime.reset()``) keeps the stores'
    addresses and the programs: the same prompts give the same tokens
    afterwards, with nothing captured again; and both equal the CPU's."""
    t, texts = _card_translator(cuda)
    eng = t.serve(**CARD_ENGINE)
    rt = eng.runtime
    ptrs = [x.data_ptr() for x in rt.stores() if x is not None]
    with eng:
        first = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
    assert rt.reset() == []
    assert [x.data_ptr() for x in rt.stores() if x is not None] == ptrs
    with eng.start(warmup=False):
        again = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        assert eng.recompiles_after_warmup == 0
        assert eng.compile_count() == rt.max_chunks + 1
    assert again == first
    t.model.to("cpu")
    from machine_learning_apache_spark_tpu_torch.inference import Translator

    cpu = Translator(t.model, t.src_pipe, t.trg_pipe, device="cpu")
    assert first == cpu(texts, max_new_tokens=CARD_ENGINE["max_new_tokens"])


def test_a_second_engine_on_the_card_captures_its_own_programs(cuda):
    """Two engines over one model on one card, serving in turns: each
    holds its own programs (its own graphs and memory pool) and neither
    adds any; both give the same tokens."""
    t, texts = _card_translator(cuda)
    a, b = t.serve(**CARD_ENGINE), t.serve(**CARD_ENGINE)
    try:
        assert a.programs() is not b.programs()
        outs = []
        for eng in (a, b, a):
            outs.append([f.result(timeout=120) for f in [eng.submit(s) for s in texts]])
        for eng in (a, b):
            assert eng.compile_count() == eng.runtime.max_chunks + 1
            assert eng.recompiles_after_warmup == 0
    finally:
        a.stop()
        b.stop()
    assert outs[0] == outs[1] == outs[2]


# -- training and one-shot decoding as programs ----------------------------------


def _tiny_fit(cuda, k, *, epochs=2, ckpt=None, resume=False, seed=31):
    """A tiny MT model on the card (2 layers, dropout 0.2) trained by
    ``fit`` from fixed weights: Adam under a warmup-cosine schedule,
    clipping, accumulation 2, 6 batches an epoch, ``k`` steps per call."""
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset, DataLoader
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    cfg = TransformerConfig(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
                            num_heads=4, num_layers=2, max_len=24, dropout=0.2)
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 41, (48, 16))
    trg = rng.integers(4, 37, (48, 12))
    for toks, lengths in ((src, rng.integers(3, 17, 48)), (trg, rng.integers(3, 13, 48))):
        for i, n in enumerate(lengths):
            toks[i, n:] = 0
    model = Transformer(cfg, generator=torch.Generator().manual_seed(seed)).to(cuda)
    state = TrainState.create(model=model, tx=make_optimizer(
        "adam", 2e-3, schedule="warmup_cosine", warmup_steps=2, total_steps=12,
        grad_clip=1.0, accumulate_steps=2))
    loader = DataLoader(ArrayDataset(src, trg), 8, shuffle=True, seed=3)
    return fit(state, make_translation_loss(0), loader, epochs=epochs, log_every=0,
               rng=torch.Generator().manual_seed(5), steps_per_call=k,
               checkpointer=ckpt, resume=resume)


@pytest.mark.parametrize("k", [3, 4], ids=["exact-groups", "ragged-tail"])
def test_k_step_replays_train_bit_for_bit_like_single_steps(cuda, k):
    """Groups of K steps as CUDA graphs (one per accumulation phase,
    captured at its first group, replayed after) against one eager step
    at a time: every parameter and every step's loss bit for bit, dropout
    drawn from the registered generator; each replay launches the three
    flash kernels 3 sites x 2 layers x K times, as its eager first call
    did."""
    hop.reset_launches()
    one = _tiny_fit(cuda, 1)
    torch.cuda.synchronize()
    eager_launches = dict(hop.LAUNCHES)
    hop.reset_launches()
    many = _tiny_fit(cuda, k)
    torch.cuda.synchronize()
    assert dict(hop.LAUNCHES) == eager_launches
    assert eager_launches["flash_attention_bwd_dq"] == 6 * 12
    for a, b in zip(one.state.params, many.state.params):
        assert torch.equal(a, b)
    assert one.step_losses == many.step_losses and len(one.step_losses) == 12
    phases = {3: 2, 4: 1}[k]
    assert len(many.programs) == phases
    for p in many.programs:
        assert p["replays"] == p["calls"] - 1 > 0
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            assert p["launches"][name] == p["eager_launches"][name] == 6 * k


def test_resumed_fit_on_the_card_equals_the_uninterrupted_run(cuda, tmp_path):
    """2 epochs with a checkpointer, then ``resume=True`` to 4, at K=3,
    against 4 epochs in one run: the same parameters and step losses."""
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager

    whole = _tiny_fit(cuda, 3, epochs=4)
    with CheckpointManager(str(tmp_path / "c")) as ck:
        first = _tiny_fit(cuda, 3, ckpt=ck)
    with CheckpointManager(str(tmp_path / "c")) as ck:
        second = _tiny_fit(cuda, 3, epochs=4, ckpt=ck, resume=True, seed=31)
    assert second.resumed_step == 12
    assert first.step_losses + second.step_losses == whole.step_losses
    for a, b in zip(second.state.params, whole.state.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_translator_replays_equal_an_eager_decode(cuda, method):
    """``Translator`` keeps one CUDA graph per call shape: its first call
    runs eagerly and captures, a second call of that shape replays and
    captures nothing; the replay's ids equal an eager call of the decoder
    on the card bit for bit, with the same forward launches."""
    from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
    from machine_learning_apache_spark_tpu_torch.models import (
        beam_translate,
        greedy_translate_cached,
    )

    t, texts = _card_translator(cuda)
    kw = dict(method=method, max_new_tokens=10, beam_size=2)
    first = t.translate_ids(texts[:6], **kw)
    assert t.programs().size() == 1
    hop.reset_launches()
    replay = t.translate_ids(texts[:6], **kw)
    replay_n = dict(hop.LAUNCHES)
    assert t.programs().size() == 1 and t.programs().stats()[0]["replays"] == 1
    src = torch.as_tensor(t.src_pipe(texts[:6]), dtype=torch.long, device=cuda)
    hop.reset_launches()
    dec = dict(max_new_tokens=10, sos_id=SOS_ID, eos_id=EOS_ID)
    if method == "greedy":
        eager = greedy_translate_cached(t.model, src, **dec)
    else:
        eager = beam_translate(t.model, src, beam_size=2, length_penalty=0.6, **dec)
    torch.cuda.synchronize()
    assert torch.equal(replay, eager.cpu()) and torch.equal(first, replay)
    layers = t.model.cfg.num_layers
    assert replay_n == dict(hop.LAUNCHES)
    assert replay_n["flash_attention_fwd"] == layers + 2 * layers * (1 + 10)


# -- the model zoo: MLP, TinyVGG, the LSTM classifier --------------------------


def _zoo_models():
    from machine_learning_apache_spark_tpu_torch.models import (
        MLP,
        LSTMClassifier,
        TinyVGG,
    )

    rng = np.random.default_rng(40)
    tokens = np.zeros((32, 129), np.int64)
    for i, n in enumerate(rng.integers(1, 129, 32)):
        tokens[i, :n] = rng.integers(4, 500, n)
    return {
        "mlp": (MLP((4, 5, 4, 3)), torch.from_numpy(rng.standard_normal((30, 4)).astype(np.float32))),
        "cnn": (TinyVGG(10, 10, input_shape=(32, 32, 3)),
                torch.from_numpy(rng.random((32, 32, 32, 3)).astype(np.float32))),
        "lstm": (LSTMClassifier(500, 32, 32, 4, 2, 0.5), torch.from_numpy(tokens)),
    }


@pytest.mark.parametrize("name", ["mlp", "cnn", "lstm"])
def test_zoo_models_on_the_card_match_the_cpu(cuda, name):
    """Logits within 1e-4 and gradients within 1e-4 of the largest, at the
    recipes' widths (dropout off: no generator)."""
    import copy

    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    resolve_device(None)
    model, x = _zoo_models()[name]
    card = copy.deepcopy(model).to(cuda)
    outs = []
    for m, inp in ((model, x), (card, x.to(cuda))):
        logits = m(inp)
        (logits.float() ** 2).mean().backward()
        outs.append((logits.detach().cpu(), [p.grad.cpu() for p in m.parameters()]))
    (want, want_g), (got, got_g) = outs
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    scale = max(g.abs().max().item() for g in want_g)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("name", ["cnn", "lstm"])
def test_zoo_recipes_train_bit_for_bit_at_four_steps_per_call(cuda, name):
    """K = 4 steps per CUDA graph against K = 1 on the card: every step's
    loss and every parameter the same bits (one program)."""
    from machine_learning_apache_spark_tpu_torch.recipes.cnn import train_cnn
    from machine_learning_apache_spark_tpu_torch.recipes.lstm import train_lstm

    fn, kw = {
        "cnn": (train_cnn, dict(dataset="cifar10")),
        "lstm": (train_lstm, dict(max_seq_len=32, dropout=0.5)),
    }[name]
    runs = [fn(data_root="assets/fixtures", epochs=1, steps_per_call=k, _return_state=True, **kw)
            for k in (1, 4)]
    one, four = runs
    assert one["fit_result"].step_losses == four["fit_result"].step_losses
    for p, q in zip(one["state"].params, four["state"].params):
        assert torch.equal(p, q)
    assert len(four["fit_result"].programs) == 1


def test_read_libsvm_through_the_built_native_parser(cuda):
    from machine_learning_apache_spark_tpu_torch import native
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm

    got = read_libsvm("assets/sample_multiclass_classification_data.txt", use_native=True)
    want = read_libsvm("assets/sample_multiclass_classification_data.txt", use_native=False)
    assert native.available() and native.library_path().exists()
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.shape == (150, 4)


# -- the recipe's options: MoE, remat, packing, length buckets -------------------------


def _option_run(k, **kw):
    """The recipe on the fixture corpus at a reduced width (d_model 64, 4
    heads, max_len 48), dropout 0.1, ``k`` steps per call, launches read
    over the run."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    torch.cuda.synchronize()
    hop.reset_launches()
    out = train_translator(data_root="assets/fixtures", d_model=64, ffn_hidden=128, num_heads=4,
                           max_len=48, epochs=1, log_every=0, dropout=0.1, steps_per_call=k,
                           _return_state=True, **kw)
    torch.cuda.synchronize()
    out["launches"] = dict(hop.LAUNCHES)
    return out


def _same_bits(a, b):
    assert a["fit_result"].step_losses == b["fit_result"].step_losses
    for p, q in zip(a["state"].params, b["state"].params):
        assert torch.equal(p, q)


def test_moe_recipe_at_four_steps_per_call_trains_bit_for_bit(cuda):
    """argmax routing, the 0/1 cumsum and the dispatch einsums repeat
    inside the graph; the aux losses are tensors of the captured step."""
    one, four = (_option_run(k, moe_experts=4) for k in (1, 4))
    _same_bits(one, four)
    assert np.isfinite(one["history"][0]["moe_aux"])
    assert one["launches"]["flash_attention_bwd_dq"] == 3 * 12


@pytest.mark.parametrize("k", [1, 4])
def test_remat_trains_bit_for_bit_like_no_remat(cuda, k):
    """The recompute replays the layer's dropout masks, in a graph too; the
    forward runs twice a step at each of the 3 sites."""
    base, remat = _option_run(k), _option_run(k, remat=True)
    _same_bits(base, remat)
    train_fwd = remat["launches"]["flash_attention_fwd"] - base["launches"]["flash_attention_fwd"]
    assert train_fwd == 3 * 12  # one more forward per site and step
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert remat["launches"][name] == base["launches"][name] == 3 * 12


def test_packed_recipe_launches_no_flash_kernel_and_repeats_at_four_steps(cuda):
    one, four = (_option_run(k, pack_sequences=True) for k in (1, 4))
    _same_bits(one, four)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert one["launches"][name] == 0  # dense segment masks: the plain path
    assert one["packed_rows"] < one["packed_pairs"] == 400


@pytest.mark.parametrize("width", [50, 100, 200])
def test_training_kernels_at_the_bucket_widths(cuda, width):
    """The default buckets' training sites ([32, 8, w | w - 1, 64]):
    encoder self, causal decoder self and cross, forward with ``lse``, dQ
    and dK/dV within 1e-4 relative of the plain versions."""
    rng = np.random.default_rng(width)
    for sq, sk, causal in ((width, width, False), (width - 1, width - 1, True), (width - 1, width, False)):
        q, k, v, g, valid = _bwd_inputs(rng, cuda, 32, 8, sq, sk, 64, 0.3, strided=True)
        valid[0] = True  # no empty row at the fixture's shapes
        kw = dict(causal=causal, kv_valid=valid)
        out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **kw)
        assert _max_rel(out, want_out) < TOL and _max_rel(lse, want_lse) < TOL
        delta = (g * out).sum(-1)
        got = (hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
               *hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw))
        want = hop.flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
        for a, b in zip(got, want):
            assert _max_rel(a, b) < TOL


def test_bucketed_recipe_on_the_card_matches_the_cpu(cuda):
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    kw = dict(data_root="assets/fixtures", d_model=64, ffn_hidden=128, num_heads=4, max_len=48,
              epochs=1, log_every=0, dropout=0.0, bucket_by_length=True, _return_state=True)
    card, cpu = train_translator(**kw), train_translator(device="cpu", **kw)
    np.testing.assert_allclose(card["fit_result"].step_losses, cpu["fit_result"].step_losses,
                               rtol=1e-3)
    assert card["padding_efficiency"] == cpu["padding_efficiency"] < 1.0


# -- the distributed path on the card ------------------------------------------------


GANG_CFG = dict(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
                num_heads=2, num_layers=1, max_len=24, dropout=0.0)


@pytest.fixture(scope="module")
def card_gang():
    """One 2-rank gang on the card (gloo: the ranks share it), training a
    small Transformer through ``fit(mesh=)`` on 3 global batches of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs

    rng = np.random.default_rng(31)
    batches = []
    for _ in range(3):
        src = rng.integers(4, 41, (8, 20)).astype(np.int64)
        trg = rng.integers(4, 37, (8, 19)).astype(np.int64)
        for i, m in enumerate(rng.integers(3, 19, 8)):
            trg[i, m:] = 0
        batches.append((src, trg))
    ranks = Distributor(num_processes=2, timeout=300).run(
        "torch_launcher_workers:card_gang", GANG_CFG, batches
    )
    assert kill_stray_gangs() == 0
    return ranks


def test_gang_on_the_card_runs_each_rank_on_cuda_over_gloo(card_gang):
    assert [r["rank"] for r in card_gang] == [0, 1]
    for r in card_gang:
        assert r["backend"] == "gloo"
        assert r["device"] == "cuda:0" and r["param_device"] == "cuda:0"
        assert r["divergence"] == 0.0
    assert card_gang[0]["losses"] == card_gang[1]["losses"]  # the global batch's loss


def test_gang_ranks_launch_the_training_kernels_three_per_step(card_gang):
    for r in card_gang:
        n, steps = r["train_launches"], r["steps"]
        assert steps == 3
        assert n["flash_attention_fwd"] == n["flash_attention_bwd_dq"] == 3 * steps
        assert n["flash_attention_bwd_dkv"] == 3 * steps
        # evaluate adds one forward per site of its one batch
        assert r["launches"]["flash_attention_fwd"] == 3 * steps + 3


@pytest.fixture(scope="module")
def card_zero1_gang():
    """One 2-rank gang on the card running every data-parallel variant of
    ``torch_launcher_workers:zero1_variants`` on a small Transformer over
    8 global batches of 8: the replicated step at 1 and 4 steps per call,
    ZeRO-1 serial and overlapped with one bucket and several, the bf16
    and int8 wires, Adam replicated, ZeRO-1 and ``zero1=True``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    rng = np.random.default_rng(37)
    batches = []
    for _ in range(8):
        src = rng.integers(4, 41, (8, 20)).astype(np.int64)
        trg = rng.integers(4, 37, (8, 19)).astype(np.int64)
        for i, m in enumerate(rng.integers(3, 19, 8)):
            trg[i, m:] = 0
        batches.append((src, trg))
    tree = export_flax_params(Transformer(TransformerConfig(**GANG_CFG),
                                          generator=torch.Generator().manual_seed(5)))
    segments = (rng.standard_normal((2, 64)) * 3).astype(np.float32)
    out = Distributor(num_processes=2, timeout=600).run(
        "torch_launcher_workers:zero1_variants", GANG_CFG, tree, batches, segments
    )
    assert kill_stray_gangs() == 0
    return out


def _same_run(a: dict, b: dict) -> bool:
    def flat(t):
        return [np.asarray(v) for k in sorted(t) for v in (flat(t[k]) if isinstance(t[k], dict) else [t[k]])]

    return a["step_losses"] == b["step_losses"] and all(
        np.array_equal(x, y) for x, y in zip(flat(a["params"]), flat(b["params"])))


@pytest.mark.parametrize("name,base", [
    ("zero1_overlap", "replicated"), ("zero1_serial", "replicated"),
    ("zero1_overlap_4096", "replicated"), ("zero1_serial_4096", "replicated"),
    ("adam_zero1_overlap_4096", "adam_replicated"), ("adam_zero1_serial", "adam_replicated"),
    ("adam_implicit", "adam_replicated"),
])
def test_zero1_gang_on_the_card_trains_the_replicated_bits(card_zero1_gang, name, base):
    runs = card_zero1_gang["runs"]
    assert runs[name]["type"] in ("Zero1State", "LeadingShardState")
    assert _same_run(runs[name], runs[base])


def test_zero1_gang_on_the_card_launches_the_replicated_kernels(card_zero1_gang):
    runs = card_zero1_gang["runs"]
    for name in ("zero1_overlap", "zero1_serial_4096", "adam_zero1_overlap_4096"):
        base = "adam_replicated" if name.startswith("adam") else "replicated"
        for got, want in zip(runs[name]["launches"], runs[base]["launches"]):
            assert got == want
            assert got["flash_attention_bwd_dq"] == got["flash_attention_bwd_dkv"] == 3 * 8


def test_zero1_wires_on_the_card_train(card_zero1_gang):
    runs = card_zero1_gang["runs"]
    base = runs["zero1_serial_4096"]["step_losses"]
    bf16 = runs["zero1_bf16"]["step_losses"]
    assert max(abs(a - b) / b for a, b in zip(bf16, base)) <= 2 * 2.0**-8
    int8 = runs["zero1_int8"]["history"]
    assert int8[0] > int8[1] > int8[2]
    # The wires as the gang sums them on the card: bf16 within its two
    # roundings, int8 within its scale of the float32 reduce-scatter.
    wires = card_zero1_gang["wires"]
    exact = wires["float32"]
    assert np.abs(wires["bfloat16"] - exact).max() <= 2 * 2.0**-8 * np.abs(exact).max()
    assert np.abs(wires["int8"] - exact).max() <= 2 * np.abs(exact).max() / 127


def test_zero1_gang_on_the_card_holds_half_the_moments(card_zero1_gang):
    runs = card_zero1_gang["runs"]
    for name in ("adam_zero1_overlap_4096", "adam_zero1_serial"):
        layout = runs[name]["layout"]
        assert runs[name]["opt_bytes"] == [2 * 4 * layout["shard_len"] + 4] * 2
    assert card_zero1_gang["sync"]["opt_state_refused"]


def test_k_steps_per_call_in_a_card_gang_train_like_single_steps(card_zero1_gang):
    runs = card_zero1_gang["runs"]
    assert _same_run(runs["replicated_k4"], runs["replicated"])
    assert runs["replicated_k4"]["comms"]["allreduce_steps"] == 8


def test_fault_drill_on_the_card_resumes_the_agreed_step(cuda, tmp_path, monkeypatch):
    """The drill's mesh twin on the card: a 2-rank data-parallel gang with
    per-rank checkpoints, rank 1 crashed at step 9 and the gang retried,
    against the same gang unfaulted. Every rank resumes the same step
    (4 or 8, by whether the step-8 writes were durable at the crash), and
    the retried gang's final parameters and step losses after the resume
    equal the unfaulted gang's bit for bit."""
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.utils import faults

    def gang(workdir, **kw):
        return Distributor(num_processes=2, timeout=300, **kw).run(
            "torch_launcher_workers:fault_drill_train_mesh", str(workdir), epochs=3,
        )

    ref = gang(tmp_path / "ref")
    monkeypatch.setenv(faults.ENV_PLAN, "crash@train_step:rank=1,step=9")
    monkeypatch.setenv(faults.ENV_MARKER_DIR, str(tmp_path / "markers"))
    out = gang(tmp_path / "gang", max_restarts=1, backoff_base=0.05, term_grace=2.0)
    assert kill_stray_gangs() == 0
    assert list((tmp_path / "markers").iterdir()), "crash fault never fired"
    assert ref["resumed_step"] is None and out["resumed_step"] in (4, 8)
    assert out["step_losses"] == ref["step_losses"][out["resumed_step"]:]
    for name, leaf in ref["params"].items():
        for key in leaf:
            np.testing.assert_array_equal(out["params"][name][key], leaf[key])


def test_healthz_flips_on_a_card_engine(cuda, monkeypatch):
    import json
    import time
    import urllib.error
    import urllib.request

    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.serving import InternalError
    from machine_learning_apache_spark_tpu_torch.utils import faults

    def healthz(srv):
        try:
            with urllib.request.urlopen(srv.url("/healthz"), timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    monkeypatch.delenv("MLSPARK_TELEMETRY", raising=False)
    monkeypatch.setenv("MLSPARK_TELEMETRY_HTTP", "0")
    telemetry.reset()
    t, texts = _card_translator(cuda)
    faults.install(faults.FaultPlan.from_spec("raise@decode_batch:batch=0"))
    try:
        with t.serve(**CARD_ENGINE) as eng:
            srv = telemetry.get_http_server()
            assert healthz(srv)[0] == 200
            victim = eng.submit(texts[0])
            with pytest.raises(InternalError):
                victim.result(timeout=120)
            code, payload = healthz(srv)
            assert code == 503 and payload["checks"]["serving"]["quarantined"] >= 1
            assert isinstance(eng.submit(texts[1]).result(timeout=120), str)
            # The verdict flips after the launch's results are handed out.
            deadline = time.monotonic() + 10
            while healthz(srv)[0] != 200 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert healthz(srv)[0] == 200
    finally:
        faults.clear()
        telemetry.reset()
        t.model.to("cpu")


def test_mllib_mesh_fit_on_the_card_matches_the_cpu(cuda):
    """``fit(mesh=)`` of a 2-rank gang on the card against one process on
    the CPU, within the JAX ``TestMeshFit`` bound (atol 1e-5, rtol 1e-4) at
    maxIter=5."""
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.mllib import MultilayerPerceptronClassifier

    data = "assets/sample_multiclass_classification_data.txt"
    train, _ = read_libsvm(data).random_split([0.6, 0.4], seed=1234)
    cpu = MultilayerPerceptronClassifier(layers=[4, 5, 4, 3], maxIter=5).fit(train, device="cpu")
    out = Distributor(num_processes=2, timeout=300).run(
        "torch_launcher_workers:mllib_mesh_fit", data, [4, 5, 4, 3], 5, None,
    )
    assert kill_stray_gangs() == 0
    assert out["ranks_agree"] and out["allreduces"] == out["evaluations"]
    for name, leaf in cpu.params.items():
        for key in leaf:
            np.testing.assert_allclose(out["params"][name][key], leaf[key], atol=1e-5, rtol=1e-4)


# -- bf16 ------------------------------------------------------------------------

BF16_TOL = 2.0 ** -6  # two bf16 ulps of the largest value (chip_smoke.BF16_TOL)


def _bf16_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("warps,splits", [(None, None), (1, 1), (4, 1), (4, 2)],
                         ids=["picked", "w1", "w4", "w4-split2"])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,valid_frac", [
    (4, 8, 200, 200, 64, False, 0.1), (4, 8, 199, 199, 64, True, 0.1), (2, 4, 40, 30, 16, True, None),
    (3, 2, 37, 45, 128, False, 0.5), (2, 3, 33, 65, 40, False, None), (2, 8, 1, 65, 64, False, 0.8),
])
def test_bf16_flash_kernels_match_plain(cuda, b, h, sq, sk, d, causal, valid_frac, warps, splits):
    """The bf16 forward (``lse`` float32), dQ and dK/dV against their plain
    versions on the same bf16 inputs: outputs bf16 within two ulps of the
    largest value, ``lse`` within 1e-5; masked keys' dK/dV exactly zero;
    only the bf16 instantiations launch; a second run the same bits."""
    rng = np.random.default_rng(41)
    q, k, v, g = (_randn(rng, b, h, n, d).to(cuda).to(torch.bfloat16) for n in (sq, sk, sk, sq))
    valid = None if valid_frac is None else torch.from_numpy(rng.random((b, sk)) < valid_frac).to(cuda)
    kw = dict(causal=causal, kv_valid=valid, warps=warps, splits=splits)
    hop.reset_launches()
    out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    delta = (g.float() * out.float()).sum(-1)
    dq = hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert {n: c for n, c in hop.LAUNCHES.items() if c} == {
        "flash_attention_fwd_bf16": 1, "flash_attention_bwd_dq_bf16": 1, "flash_attention_bwd_dkv_bf16": 1}
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16 and lse.dtype == torch.float32
    plain = dict(causal=causal, kv_valid=valid)
    want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **plain)
    want = hop.flash_attention_backward_plain(q, k, v, out, lse, g, **plain)
    assert _bf16_rel(out, want_out) <= BF16_TOL
    finite = want_lse > hop.NEG_INF / 2
    assert torch.equal(lse > hop.NEG_INF / 2, finite)
    if finite.any():
        assert _bf16_rel(lse[finite], want_lse[finite]) <= 1e-5
    for got, ref in zip((dq, dk, dv), want):
        assert _bf16_rel(got, ref) <= BF16_TOL
    if valid is not None:
        masked = ~valid[:, None, :, None].expand_as(dk)
        assert not dk[masked].any() and not dv[masked].any()
    assert torch.equal(hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw), dq)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
def test_bf16_ragged_kernel_matches_plain(cuda, int8, with_cur):
    """A bf16 query over bf16 pages or int8 pages (float32 scales), at
    every splits choice: bf16 out within two ulps of the plain version's
    largest value, a length-0 row zeros, rows sharing prefix pages equal."""
    rng = np.random.default_rng(42)
    qkv, kp, vp, table, lengths, scales = serving_decode(rng, int8)

    def dev(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

    q, ck, cv = split_qkv(dev(qkv), 8)
    kw = {n: torch.from_numpy(x).to(cuda) for n, x in scales.items()}
    if with_cur:
        kw.update(cur_k=ck, cur_v=cv)
    args = (q, dev(kp), dev(vp), dev(table), dev(lengths))
    want = hop.ragged_paged_attention_plain(*args, **kw)
    hop.reset_launches()
    for sp in (None, *hop.RAGGED_SPLITS):
        got = hop.ragged_paged_attention(*args, splits=sp, **kw)
        assert got.dtype == torch.bfloat16
        assert _bf16_rel(got, want) <= BF16_TOL
        if not with_cur:
            assert not got[0].any()
            assert torch.equal(got[-1], got[-2])
    torch.cuda.synchronize()
    assert hop.LAUNCHES["ragged_paged_attention_bf16"] == 1 + len(hop.RAGGED_SPLITS)
    assert hop.LAUNCHES["ragged_paged_attention"] == 0


def test_bf16_recipe_at_four_steps_per_call_trains_bit_for_bit(cuda):
    """The recipe at ``dtype="bfloat16"``: float32 parameters; 4 steps per
    CUDA graph against 1, every step's loss and parameter the same bits;
    the bf16 kernels launched 3 x 12 and the fp32 ones never."""
    one, four = (_option_run(k, dtype="bfloat16") for k in (1, 4))
    _same_bits(one, four)
    assert {p.dtype for p in one["state"].params} == {torch.float32}
    assert one["launches"]["flash_attention_bwd_dq_bf16"] == 3 * 12
    assert one["launches"]["flash_attention_bwd_dkv_bf16"] == 3 * 12
    assert all(one["launches"][n] == 0 for n in hop.KERNELS)


def test_bf16_cnn_recipe_at_four_steps_per_call_trains_bit_for_bit(cuda):
    from machine_learning_apache_spark_tpu_torch.recipes.cnn import train_cnn

    one, four = (train_cnn(data_root="assets/fixtures", dataset="cifar10", epochs=1, dtype="bfloat16",
                           steps_per_call=k, _return_state=True) for k in (1, 4))
    _same_bits(one, four)
    assert {p.dtype for p in one["state"].params} == {torch.float32}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"], ids=["bf16_pages", "int8_pages"])
def test_bf16_paged_engine_builds_every_program_at_warmup(cuda, kv_dtype):
    """A bf16 model served by the paged engine: the store follows the
    model (bf16 pages) or is int8; the JAX program count, zero recompiles
    after traffic, the bf16 kernels launched and the fp32 ones never, and
    the one-shot decoder's tokens on at least 99 % of positions."""
    t, texts = _card_translator(cuda, torch.bfloat16)
    hop.reset_launches()
    with t.serve(kv_dtype=kv_dtype, **CARD_ENGINE) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        assert eng.compile_count() == eng.runtime.max_chunks + 1
        assert eng.recompiles_after_warmup == 0
        assert eng.runtime.kv_mem.dtype == (torch.int8 if kv_dtype == "int8" else torch.bfloat16)
    torch.cuda.synchronize()
    assert hop.LAUNCHES["ragged_paged_attention_bf16"] > 0 and hop.LAUNCHES["flash_attention_fwd_bf16"] > 0
    assert all(hop.LAUNCHES[n] == 0 for n in hop.KERNELS)
    want = t(texts, max_new_tokens=CARD_ENGINE["max_new_tokens"])
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g.split(), w.split())]
    assert sum(a == b for a, b in pairs) >= 0.99 * len(pairs)


# -- tensor parallelism on the card (gloo: the ranks share it) -----------------

TP_CFG = dict(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
              num_heads=4, num_layers=1, max_len=24, dropout=0.0, logit_pad=3)


@pytest.fixture(scope="module")
def card_tp_gang():
    """One 4-rank gang on the card per check: the sharded Transformer
    (``{data: 1, model: 4}``, one head a rank) against the unsharded one
    and the vocab-parallel loss against the full-logit loss, then the
    hybrid ``{data: 2, model: 2}`` MLP steps (replicated, ZeRO-1 float32
    overlapped and serial, bf16 and int8 wires)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.models import MLP
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    rng = np.random.default_rng(41)
    src = rng.integers(4, 41, (8, 20)).astype(np.int64)
    trg = rng.integers(4, 37, (8, 19)).astype(np.int64)
    for i, m in enumerate(rng.integers(3, 19, 8)):
        trg[i, m:] = 0
    tree = export_flax_params(Transformer(TransformerConfig(**TP_CFG),
                                          generator=torch.Generator().manual_seed(7)))
    layers = (4, 8, 8, 4)
    mlp_tree = export_flax_params(MLP(layers, tp_rules=True, generator=torch.Generator().manual_seed(1)))
    feats = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 16)
    out = {"layers": Distributor(num_processes=4, timeout=300).run(
        "torch_launcher_workers:tp_card_layers", TP_CFG, tree, (src, trg))}
    out["hybrid"] = Distributor(num_processes=4, timeout=300).run(
        "torch_launcher_workers:tp_hybrid_four_rank", layers, mlp_tree, (feats, labels), 5, 1e-2, 64)
    assert kill_stray_gangs() == 0
    return out


def test_tp_layers_on_the_card_match_the_unsharded_model(card_tp_gang):
    r = card_tp_gang["layers"]
    assert r["device"] == "cuda:0" and r["heads"] == 1
    got, want = r["loss"]
    assert abs(got - want) <= TOL * abs(want)
    assert r["grad_rel"] <= TOL
    # Each rank runs the flash kernels on its own heads: 3 sites, once.
    assert r["launches"]["flash_attention_fwd"] == 3
    assert r["launches"]["flash_attention_bwd_dq"] == r["launches"]["flash_attention_bwd_dkv"] == 3


def test_vocab_parallel_loss_on_the_card_matches_the_full_logit_loss(card_tp_gang):
    got, want = card_tp_gang["layers"]["vocab_parallel"]
    assert abs(got - want) <= 1e-6 * abs(want)


def test_hybrid_zero1_on_the_card_trains_the_replicated_hybrid_bits(card_tp_gang):
    h = card_tp_gang["hybrid"]
    for name in ("fp32_overlap", "fp32_serial"):
        for k, v in h["replicated"]["params"].items():
            for leaf, x in v.items():
                np.testing.assert_array_equal(h[name]["params"][k][leaf], x)
        assert h[name]["moments_equal"] == [True] * 4
        for b, n in zip(h[name]["opt_bytes"], h[name]["shard_len"]):
            assert b == 2 * 4 * n + 4 and b <= h["replicated_bytes"] / 4 + 64
    for name in ("bf16", "int8"):
        for v in h[name]["params"].values():
            assert all(np.isfinite(x).all() for x in v.values())


# -- pipeline parallelism on the card (gloo: the ranks share it) ---------------

PP_CFG = dict(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
              num_heads=4, num_layers=4, max_len=24, dropout=0.0)


@pytest.mark.parametrize("rows", [8, 4], ids=["M4_of_32", "M8_of_32"])
@pytest.mark.parametrize("causal,sk", [(False, 200), (True, 199)], ids=["enc_cross", "dec_self"])
def test_pipeline_microbatch_sites_match_plain(cuda, rows, causal, sk):
    """The forward with lse, dQ and dK/dV at a pipeline microbatch's shape
    (``[B/M, 8, 200|199, 64]``, head-split views, masked keys) within 1e-4
    of their plain versions, dQ and dK/dV bit-repeating."""
    rng = np.random.default_rng(28 + rows)
    sq = sk
    q, k, v, g, valid = _bwd_inputs(rng, cuda, rows, 8, sq, sk, 64, 0.6, strided=True)
    kw = dict(causal=causal, kv_valid=valid)
    out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
    finite = want_lse > hop.NEG_INF / 2
    assert _max_rel(lse[finite], want_lse[finite]) < TOL
    delta = (g * out).sum(-1)
    dq = hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    want = hop.flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
    for got, ref in zip((dq, dk, dv), want):
        assert _max_rel(got, ref) < TOL
    assert torch.equal(hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw), dq)
    again = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


@pytest.fixture(scope="module")
def card_pp_gang():
    """One 4-rank ``{pipeline: 4}`` gang on the card (4 layers, one a
    stage, 4 microbatches): 3 SGD steps of the pipelined ``fit``, and the
    same steps in this process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    rng = np.random.default_rng(43)
    batches = []
    for _ in range(3):
        src = rng.integers(4, 41, (16, 20)).astype(np.int64)
        trg = rng.integers(4, 37, (16, 19)).astype(np.int64)
        for i, m in enumerate(rng.integers(3, 19, 16)):
            trg[i, m:] = 0
        batches.append((src, trg))
    tree = export_flax_params(Transformer(TransformerConfig(**PP_CFG),
                                          generator=torch.Generator().manual_seed(9)))
    gang = Distributor(num_processes=4, timeout=300).run(
        "torch_launcher_workers:pp_card_gang", PP_CFG, tree, batches, 0.5, 4)
    assert kill_stray_gangs() == 0
    model = load_flax_params(Transformer(TransformerConfig(**PP_CFG)), tree).cuda()
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", 0.5)),
              make_translation_loss(0), batches, epochs=1, log_every=0)
    one = {"step_losses": res.step_losses,
           "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}}
    return gang, one


def test_pipeline_gang_on_the_card_trains_as_one_process(card_pp_gang):
    gang, one = card_pp_gang
    assert gang["device"] == "cuda:0" and gang["mesh"] == {"pipeline": 4}
    np.testing.assert_allclose(gang["step_losses"], one["step_losses"], rtol=1e-4)
    assert gang["ranks_equal"]
    for k, want in one["params"].items():
        np.testing.assert_allclose(gang["params"][k], want, rtol=0, atol=1e-5, err_msg=k)


def test_pipeline_gang_on_the_card_launches_its_stage_share(card_pp_gang):
    gang, _ = card_pp_gang
    # Each rank: 3 sites x 1 layer x 4 microbatches a step, 3 steps.
    for launches in gang["launches"]:
        assert launches["flash_attention_fwd"] == 36
        assert launches["flash_attention_bwd_dq"] == launches["flash_attention_bwd_dkv"] == 36


# -- sequence parallelism on the card (gloo: the ranks share it) -----------------

SP_HOP_SHAPES = [(32, 8, 50, 64), (32, 8, 100, 64), (2, 8, 512, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SP_HOP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ring_hops_match_plain_with_the_merged_lse(cuda, shape, dtype):
    """A ring's two kinds of computed hop at its chunk shape — the diagonal
    (causal) and one behind (unmasked; batch row 0 sees no key there) —
    through the flash forward with ``lse`` against the plain version; the
    hops merged by ``lse`` against the forward over both chunks at once;
    each hop's dQ and dK/dV with the MERGED ``lse`` and ``delta`` against
    their plain versions (1e-4 relative; bf16: 2^-6 of the largest)."""
    from machine_learning_apache_spark_tpu_torch.parallel.ring_attention import (
        finish_merge,
        hop_backward,
        hop_forward,
        merge_hop,
    )

    tol = TOL if dtype == torch.float32 else 2.0 ** -6
    b, h, c, d = shape
    rng = np.random.default_rng(60 + c)
    q, k0, v0, k1, v1, g = (_randn(rng, b, h, c, d).to(cuda).to(dtype) for _ in range(6))
    valid0 = torch.from_numpy(rng.random((b, c)) < 0.8).to(cuda)
    behind = rng.random((b, c)) < 0.8
    behind[0] = False
    valid1 = torch.from_numpy(behind).to(cuda)
    hops = ((k0, v0, valid0, "diagonal"), (k1, v1, valid1, "behind"))
    hop.reset_launches()
    acc = None
    for k, v, valid, kind in hops:
        o, lse = hop_forward(q, k, v, valid, kind)
        want_o, _ = hop.flash_attention_lse_plain(q, k, v, causal=kind == "diagonal", kv_valid=valid)
        assert _max_rel(o.float(), want_o.float()) < tol
        acc = merge_hop(acc, o, lse)
    out, lse = finish_merge(acc, dtype)
    k_all, v_all = torch.cat([k1, k0], dim=2), torch.cat([v1, v0], dim=2)
    valid_all = torch.cat([valid1, valid0], dim=1)
    whole, whole_lse = hop.flash_attention_lse_plain(q, k_all, v_all, causal=True, kv_valid=valid_all)
    assert _max_rel(out.float(), whole.float()) < tol
    live = whole_lse > hop.NEG_INF / 2
    assert torch.equal(lse > hop.NEG_INF / 2, live)
    assert _max_rel(lse[live], whole_lse[live]) < 1e-4
    delta = (g.float() * out.float()).sum(-1)
    for k, v, valid, kind in hops:
        got = hop_backward(q, k, v, g, lse, delta, valid, kind)
        kw = dict(causal=kind == "diagonal", kv_valid=valid)
        want = (hop.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
                *hop.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
        for x, ref in zip(got, want):
            assert _max_rel(x.float(), ref.float()) < tol
    name = lambda n: hop.kernel_name(n, dtype)  # noqa: E731
    assert hop.LAUNCHES[name("flash_attention_fwd")] == 2
    assert hop.LAUNCHES[name("flash_attention_bwd_dq")] == hop.LAUNCHES[name("flash_attention_bwd_dkv")] == 2


SP_CFG = dict(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
              num_heads=4, num_layers=1, max_len=24, dropout=0.0)


@pytest.fixture(scope="module")
def card_sp_gang():
    """One 4-rank gang on the card: 3 SGD steps of ``fit`` under
    ``sequence_parallel`` on ``{seq: 4}`` with ring and with Ulysses, and
    the same steps in this process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    rng = np.random.default_rng(47)
    batches = []
    for _ in range(3):
        src = rng.integers(4, 41, (16, 20)).astype(np.int64)
        trg = rng.integers(4, 37, (16, 21)).astype(np.int64)
        for i, m in enumerate(rng.integers(3, 21, 16)):
            trg[i, m:] = 0
        src[0, 12:] = 0
        batches.append((src, trg))
    tree = export_flax_params(Transformer(TransformerConfig(**SP_CFG),
                                          generator=torch.Generator().manual_seed(9)))
    gang = Distributor(num_processes=4, timeout=300).run(
        "torch_launcher_workers:sp_card_gang", SP_CFG, tree, batches, 0.5)
    assert kill_stray_gangs() == 0
    model = load_flax_params(Transformer(TransformerConfig(**SP_CFG)), tree).cuda()
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", 0.5)),
              make_translation_loss(0), batches, epochs=1, log_every=0)
    one = {"step_losses": res.step_losses,
           "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}}
    return gang, one


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_sp_gang_on_the_card_trains_as_one_process(card_sp_gang, method):
    gang, one = card_sp_gang
    run = gang[method]
    assert run["device"] == "cuda:0" and run["mesh"] == {"seq": 4}
    np.testing.assert_allclose(run["step_losses"], one["step_losses"], rtol=1e-4)
    assert run["ranks_equal"]
    for k, want in one["params"].items():
        np.testing.assert_allclose(run["params"][k], want, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_sp_gang_on_the_card_launches_the_hop_schedule(card_sp_gang, method):
    gang, _ = card_sp_gang
    for r, launches in enumerate(gang[method]["launches"]):
        # 3 steps; the ring: 4 hops at the encoder and the cross-attention,
        # r + 1 at the causal decoder; Ulysses: one inner attention a site.
        per = (4 + (r + 1) + 4) if method == "ring" else 3
        assert launches["flash_attention_fwd"] == launches["flash_attention_bwd_dq"] \
            == launches["flash_attention_bwd_dkv"] == 3 * per, (method, r, launches)


EP_CFG = dict(src_vocab_size=41, trg_vocab_size=37, d_model=64, ffn_hidden=128,
              num_heads=4, num_layers=1, max_len=24, dropout=0.0, moe_experts=4)
EP_MESHES = ("expert4", "data2 expert2", "expert2 model2")


@pytest.fixture(scope="module")
def card_ep_gang():
    """One 4-rank gang on the card: 3 SGD steps of the MoE Transformer's
    ``fit`` on ``{expert: 4}``, ``{data: 2, expert: 2}`` and ``{expert: 2,
    model: 2}``, and the same steps in this process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang's ranks run on it")
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    rng = np.random.default_rng(53)
    batches = []
    for _ in range(3):
        src = rng.integers(4, 41, (16, 20)).astype(np.int64)
        trg = rng.integers(4, 37, (16, 21)).astype(np.int64)
        for i, m in enumerate(rng.integers(3, 21, 16)):
            trg[i, m:] = 0
        src[0, 12:] = 0
        batches.append((src, trg))
    tree = export_flax_params(Transformer(TransformerConfig(**EP_CFG),
                                          generator=torch.Generator().manual_seed(9)))
    gang = Distributor(num_processes=4, timeout=300).run(
        "torch_launcher_workers:ep_card_gang", EP_CFG, tree, batches, 0.5)
    assert kill_stray_gangs() == 0
    model = load_flax_params(Transformer(TransformerConfig(**EP_CFG)), tree).cuda()
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", 0.5)),
              make_translation_loss(0), batches, epochs=1, log_every=0)
    one = {"step_losses": res.step_losses,
           "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}}
    return gang, one


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_gang_on_the_card_trains_as_one_process(card_ep_gang, mesh):
    gang, one = card_ep_gang
    run = gang[mesh]
    assert run["device"] == "cuda:0"
    np.testing.assert_allclose(run["step_losses"], one["step_losses"], rtol=1e-5)
    for k, want in one["params"].items():
        np.testing.assert_allclose(run["params"][k], want, rtol=0, atol=1e-5, err_msg=k)
    for r, launches in enumerate(run["launches"]):
        # 3 steps, 3 attention sites each, on every rank.
        assert launches["flash_attention_fwd"] == launches["flash_attention_bwd_dq"] \
            == launches["flash_attention_bwd_dkv"] == 9, (mesh, r, launches)


# -- the streaming pipeline's device stage --------------------------------------------


@pytest.mark.parametrize("buffer", [0, 2])
def test_pipeline_device_stage_copies_once_onto_the_card(cuda, buffer):
    """The device stage on the card: every batch arrives on the card, ids
    as int64, equal to the host batches; two copies a batch (one a
    field), none after; no ingest thread outlives the iterator."""
    import threading

    from machine_learning_apache_spark_tpu_torch.ingest import ArraySource, StreamingPipeline, WORKER_PREFIX
    from machine_learning_apache_spark_tpu_torch.train.loop import stack_batches, to_device

    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = rng.integers(0, 9, 40).astype(np.int32)
    host = list(StreamingPipeline(ArraySource(x, y), 8, device=False, buffer=buffer))
    pipe = StreamingPipeline(ArraySource(x, y), 8, device=cuda, buffer=buffer, device_prefetch=2)
    got = list(pipe)
    assert len(got) == len(host) == 5 and pipe.h2d_copies == 2 * len(got)
    for b, h in zip(got, host):
        assert all(t.is_cuda for t in b) and b[1].dtype == torch.int64
        assert all(m is t for m, t in zip(to_device(b, b[0].device), b))
        np.testing.assert_array_equal(b[0].cpu().numpy(), h[0])
        np.testing.assert_array_equal(b[1].cpu().numpy(), h[1].astype(np.int64))
    assert stack_batches(got[:4], got[0][0].device)[0].is_cuda
    pipe.shutdown()
    assert not [t for t in threading.enumerate() if t.name.startswith(WORKER_PREFIX) and t.is_alive()]
