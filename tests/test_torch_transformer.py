"""The port's Transformer against the JAX package's, with bridged weights.

A Flax model is initialised with its own initialisers; its parameter tree
crosses to the port as numpy arrays through ``weights.load_flax_params``.
Both then see the same numpy inputs: ``__call__`` logits, ``encode``,
``prefill_paged``'s memory K/V, ``decode_step_paged``'s logits and new
K/V over a hand-built page store (fp32 and int8), and ``greedy_translate``
tokens, which must be identical. Tolerance ``atol 1e-4, rtol 1e-4``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
    greedy_translate as j_greedy,
)
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    greedy_translate,
)
from machine_learning_apache_spark_tpu_torch.weights import (
    load_flax_params,
    random_flax_params,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = RTOL = 1e-4

TINY = dict(
    src_vocab_size=41, trg_vocab_size=37, d_model=32, ffn_hidden=64,
    num_heads=2, num_layers=1, max_len=24, dropout=0.0,
)


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL
    )


def _japply(jm, params, *args, method=None, mutable=False, **kwargs):
    """``jm.apply`` under ``jax.jit`` (one compile beats eager dispatch
    of every op); keyword arguments stay static."""
    fn = jax.jit(
        lambda p, *a: jm.apply(
            {"params": p}, *a, method=method, mutable=mutable, **kwargs
        )
    )
    return fn(params, *[jnp.asarray(a) for a in args])


def _bridge(params_fn, **overrides):
    kw = {**TINY, **overrides}
    jm = JTransformer(JConfig(**kw))
    params = params_fn(jm)
    tm = Transformer(TransformerConfig(**kw)).eval()
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _flax_init(jm):
    dummy = np.ones((2, 6), np.int32)
    return nn.unbox(jax.jit(jm.init)(jax.random.key(0), dummy, dummy)["params"])


@pytest.fixture(scope="module")
def bridged():
    """The Flax model's own initialisers, bridged to the port."""
    return _bridge(_flax_init)


def _tokens(rng, b, s, vocab, lengths):
    toks = rng.integers(4, vocab, (b, s)).astype(np.int32)
    for i, n in enumerate(lengths):
        toks[i, n:] = 0
    return toks


def test_call_logits_and_encode(bridged):
    jm, params, tm = bridged
    rng = np.random.default_rng(0)
    src = _tokens(rng, 3, 9, TINY["src_vocab_size"], [9, 5, 2])
    trg = _tokens(rng, 3, 7, TINY["trg_vocab_size"], [7, 4, 3])
    want = _japply(jm, params, src, trg)
    mem_want = _japply(jm, params, src, method=JTransformer.encode)
    with torch.no_grad():
        got = tm(torch.from_numpy(src).long(), torch.from_numpy(trg).long())
        mem_got = tm.encode(torch.from_numpy(src).long())
    _close(got, want)
    _close(mem_got, mem_want)


@pytest.mark.parametrize(
    "overrides", [dict(num_layers=2, logit_pad=3), dict(d_model=128, num_heads=2)],
    ids=["two_layers_logit_pad", "head_dim_64"],
)
def test_call_logits_other_shapes(overrides):
    jm, params, tm = _bridge(lambda jm: random_flax_params(jm.cfg, 1), **overrides)
    rng = np.random.default_rng(1)
    src = _tokens(rng, 2, 8, TINY["src_vocab_size"], [8, 3])
    trg = _tokens(rng, 2, 5, TINY["trg_vocab_size"], [5, 2])
    want = _japply(jm, params, src, trg)
    with torch.no_grad():
        got = tm(torch.from_numpy(src).long(), torch.from_numpy(trg).long())
    assert got.shape == (2, 5, TINY["trg_vocab_size"])
    _close(got, want)


def test_prefill_paged_memory_kv(bridged):
    jm, params, tm = bridged
    rng = np.random.default_rng(2)
    src = _tokens(rng, 2, 8, TINY["src_vocab_size"], [8, 5])
    mem, var = _japply(
        jm, params, src, method=JTransformer.prefill_paged, mutable=["paged"]
    )
    sown = var["paged"]["decoder"]["layer_0"]["cross_attn"]
    with torch.no_grad():
        t_mem, k_mem, v_mem = tm.prefill_paged(torch.from_numpy(src).long())
    _close(t_mem, mem)
    _close(k_mem[0], sown["k_mem"][0])
    _close(v_mem[0], sown["v_mem"][0])


def _page_store(rng, layers, num_pages, page, d, *, int8):
    store = rng.standard_normal((layers, 2, num_pages, page, d)).astype(np.float32)
    if not int8:
        return store, None
    scale = (np.abs(store).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
    q = np.clip(np.round(store / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_paged_logits_and_new_kv(bridged, int8):
    jm, params, tm = bridged
    rng = np.random.default_rng(3)
    rows, page, d = 4, 4, TINY["d_model"]
    self_pages, mem_pages = 3, 3
    num = 1 + rows * max(self_pages, mem_pages)
    kv_self, s_self = _page_store(rng, 1, num, page, d, int8=int8)
    kv_mem, s_mem = _page_store(rng, 1, num, page, d, int8=int8)
    self_len = np.array([0, 3, 5, 9], np.int32)  # cursors
    mem_len = np.array([2, 7, 12, 4], np.int32)
    self_tbl = np.zeros((rows, self_pages), np.int32)
    mem_tbl = np.zeros((rows, mem_pages), np.int32)
    for r in range(rows):
        n_s = max(1, -(-int(self_len[r]) // page))
        self_tbl[r, :n_s] = 1 + r * self_pages + np.arange(n_s)
        n_m = -(-int(mem_len[r]) // page)
        mem_tbl[r, :n_m] = 1 + r * mem_pages + np.arange(n_m)
    token = rng.integers(4, TINY["trg_vocab_size"], (rows, 1)).astype(np.int32)
    positions = self_len[:, None]
    args = (token, kv_self, kv_mem, self_tbl, self_len, mem_tbl, mem_len, positions)
    scales = () if s_self is None else (s_self, s_mem)
    logits, var = _japply(
        jm, params, *args, *scales,
        method=JTransformer.decode_step_paged, mutable=["paged"],
    )
    sown = var["paged"]["decoder"]["layer_0"]["self_attn"]
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].long()
    targs[-1] = targs[-1].long()
    with torch.no_grad():
        t_logits, k_new, v_new = tm.decode_step_paged(
            *targs,
            None if s_self is None else torch.from_numpy(s_self),
            None if s_mem is None else torch.from_numpy(s_mem),
        )
    _close(t_logits, logits)
    _close(k_new[0], sown["k_new"][0])
    _close(v_new[0], sown["v_new"][0])


def test_greedy_translate_tokens_identical(bridged):
    jm, params, tm = bridged
    rng = np.random.default_rng(4)
    src = _tokens(rng, 5, 10, TINY["src_vocab_size"], [10, 7, 4, 2, 9])
    want = j_greedy(jm, params, jnp.asarray(src), max_new_tokens=12)
    got = greedy_translate(tm, torch.from_numpy(src).long(), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_flax_params_fit_both_models():
    """The numpy tree ``chip_smoke.py`` serves from is a valid Flax tree:
    the JAX model applies it and the port agrees."""
    cfg = JConfig(**TINY)
    params = random_flax_params(cfg, seed=5)
    jm = JTransformer(cfg)
    tm = load_flax_params(Transformer(TransformerConfig(**TINY)).eval(), params)
    rng = np.random.default_rng(5)
    src = _tokens(rng, 2, 6, TINY["src_vocab_size"], [6, 4])
    trg = _tokens(rng, 2, 5, TINY["trg_vocab_size"], [5, 5])
    want = _japply(jm, params, src, trg)
    with torch.no_grad():
        got = tm(torch.from_numpy(src).long(), torch.from_numpy(trg).long())
    _close(got, want)


def test_bridge_rejects_a_mismatched_tree(bridged):
    _, params, _ = bridged
    tree = jax.tree.map(np.asarray, params)
    tree["decoder"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(Transformer(TransformerConfig(**TINY)), tree)
    wide = Transformer(TransformerConfig(**{**TINY, "d_model": 16, "ffn_hidden": 32}))
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(wide, jax.tree.map(np.asarray, params))


def test_construction_leaves_the_global_rng_alone():
    state = torch.random.get_rng_state()
    a = Transformer(TransformerConfig(**TINY), generator=torch.Generator().manual_seed(3))
    b = Transformer(TransformerConfig(**TINY), generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
