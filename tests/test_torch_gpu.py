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
