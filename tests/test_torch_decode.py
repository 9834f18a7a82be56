"""The port's KV-cache decoders against the JAX package's, on the CPU.

A tiny Flax model (d_model 32, 2 heads, max_len 16, vocabularies of ~30)
is initialised with its own initialisers and its parameter tree bridged
to the port (``weights.load_flax_params``); numpy-seeded prompts go
through both. ``decode_step``'s logits must match the JAX
``Transformer.decode_step`` at every step of a generation, the priming
call included (``atol 1e-4, rtol 1e-4``, as in
``tests/test_torch_transformer.py``); ``greedy_translate_cached`` and
``beam_translate`` (beams 1, 2, 4) must give the JAX decoders' tokens;
``_filter_logits`` must give JAX's values exactly. Sampling draws from
other bits than ``jax.random.categorical``, so it is held to its own
contract: one generator seed gives one output, ``temperature=0`` and
``top_k=1`` are greedy, and every sampled id lies in the filtered
support. Each JAX decoder is jitted once per configuration and kept in a
module fixture.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
    beam_translate as j_beam,
    greedy_translate_cached as j_greedy_cached,
)
from machine_learning_apache_spark_tpu.models.transformer import (
    _filter_logits as j_filter_logits,
)
from machine_learning_apache_spark_tpu_torch.models import (
    DecodeCache,
    Transformer,
    TransformerConfig,
    beam_translate,
    greedy_translate,
    greedy_translate_cached,
    sample_translate,
)
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    _filter_logits,
)
from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import (
    NEG_INF,
    kernel_layout_ok,
)
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = RTOL = 1e-4
SOS, EOS, PAD = 1, 2, 0
MAX_NEW = 12

CONFIGS = {
    # One layer, the Flax initialisers as they are.
    "1-layer": dict(num_layers=1, eos_bias=None),
    # Two layers, with the eos logit raised so that rows finish at
    # different steps (greedy: 2, 2 and 9): finished rows feed pads into
    # the prefix, and beam search banks finished hypotheses.
    "2-layer, eos raised": dict(num_layers=2, eos_bias=2.3),
}


@dataclasses.dataclass
class Bridged:
    jm: JTransformer
    params: dict
    tm: Transformer
    src: np.ndarray  # int32 [3, 10], the last row padded after 6 ids
    eos_raised: bool


def _bridge(num_layers, eos_bias):
    kw = dict(
        src_vocab_size=31, trg_vocab_size=29, d_model=32, ffn_hidden=64,
        num_heads=2, num_layers=num_layers, max_len=16, dropout=0.0,
    )
    jm = JTransformer(JConfig(**kw))
    dummy = np.ones((2, 6), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(1), dummy, dummy)["params"])
    params = jax.tree.map(np.array, params)
    if eos_bias is not None:
        params["lm_head"]["bias"][EOS] = eos_bias
    tm = load_flax_params(Transformer(TransformerConfig(**kw)), params).eval()
    src = np.random.default_rng(3).integers(4, 31, (3, 10)).astype(np.int32)
    src[2, 6:] = PAD
    return Bridged(jm, params, tm, src, eos_bias is not None)


@pytest.fixture(scope="module", params=list(CONFIGS))
def bridged(request):
    return _bridge(**CONFIGS[request.param])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


# -- decode_step, step by step -------------------------------------------------


def _jax_step_logits(jm, params, src, ys):
    """The JAX decode cache's logits over a whole generation: the priming
    call's, then each step's, fed ``ys[:, t]`` (one jitted program)."""
    gen_len = ys.shape[1]
    decode_model = JTransformer(dataclasses.replace(jm.cfg, max_len=gen_len))

    @jax.jit
    def run(params, src, ys):
        src_valid = src != PAD
        memory = jm.apply({"params": params}, src, method=JTransformer.encode)
        rows = src.shape[0]
        prime, primed = decode_model.apply(
            {"params": params}, jnp.full((rows, 1), SOS, jnp.int32), memory,
            src_valid, jnp.zeros((), jnp.int32), jnp.ones((rows, gen_len), bool),
            method=JTransformer.decode_step, mutable=["cache"],
        )

        def step(cache, t):
            token = jax.lax.dynamic_slice_in_dim(ys, t, 1, axis=1)
            logits, updated = decode_model.apply(
                {"params": params, "cache": cache}, token, memory, src_valid, t,
                ys != PAD, method=JTransformer.decode_step, mutable=["cache"],
            )
            return updated["cache"], logits[:, 0]

        _, steps = jax.lax.scan(step, primed["cache"], jnp.arange(gen_len - 1))
        return prime[:, 0], steps

    prime, steps = run(params, jnp.asarray(src), jnp.asarray(ys))
    return np.asarray(prime), np.asarray(steps)


def test_decode_step_logits_match_jax_at_every_step(bridged):
    b = bridged
    ys = np.asarray(j_greedy_cached(b.jm, b.params, jnp.asarray(b.src), max_new_tokens=MAX_NEW))
    want_prime, want_steps = _jax_step_logits(b.jm, b.params, b.src, ys)
    src, ys_t = _t(b.src), _t(ys)
    src_valid = src != PAD
    with torch.no_grad():
        memory = b.tm.encode(src)
        rows, gen_len = ys.shape
        prime, cache = b.tm.decode_step(
            torch.full((rows, 1), SOS), memory, src_valid, 0,
            torch.ones((rows, gen_len), dtype=torch.bool),
        )
        np.testing.assert_allclose(prime[:, 0].numpy(), want_prime, atol=ATOL, rtol=RTOL)
        # The priming call projects the memory K/V and writes nothing else.
        assert cache.index == 0 and not cache.key.any() and not cache.value.any()
        assert cache.mem_key.shape == (len(b.tm.decoder.layers), rows, 10, 32)
        for t in range(gen_len - 1):
            logits, cache = b.tm.decode_step(
                ys_t[:, t : t + 1], memory, src_valid, t, ys_t != PAD, cache
            )
            assert cache.index == t + 1
            np.testing.assert_allclose(
                logits[:, 0].numpy(), want_steps[t], atol=ATOL, rtol=RTOL,
                err_msg=f"step {t}",
            )
    if b.eos_raised:
        assert (ys[:, 1:-1] == PAD).any()  # finished rows fed pads


# -- the decoders' tokens --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    """Each JAX decoder once per configuration (jitted), keyed by name."""
    b = bridged
    src = jnp.asarray(b.src)
    out = {"greedy": j_greedy_cached(b.jm, b.params, src, max_new_tokens=MAX_NEW)}
    for k in (1, 2, 4):
        out[f"beam{k}"] = jax.jit(
            lambda p, s, k=k: j_beam(b.jm, p, s, beam_size=k, max_new_tokens=MAX_NEW)
        )(b.params, src)
    return {name: np.asarray(v) for name, v in out.items()}


def test_greedy_cached_matches_jax_and_the_uncached_decoder(bridged, jax_tokens):
    b = bridged
    got = greedy_translate_cached(b.tm, _t(b.src), max_new_tokens=MAX_NEW)
    assert got.shape == (3, MAX_NEW + 1) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), jax_tokens["greedy"])
    uncached = greedy_translate(b.tm, _t(b.src), max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), uncached.numpy())


@pytest.mark.parametrize("beam_size", [1, 2, 4])
def test_beam_matches_jax(bridged, jax_tokens, beam_size):
    b = bridged
    got = beam_translate(b.tm, _t(b.src), beam_size=beam_size, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), jax_tokens[f"beam{beam_size}"])
    out = got.numpy()
    assert (out[:, 0] == SOS).all()
    for row in out:
        eos = np.flatnonzero(row == EOS)
        if eos.size:
            assert (row[eos[0] + 1 :] == PAD).all()
    if beam_size == 1:
        # length_penalty only rescales one beam's score: beam 1 is greedy.
        np.testing.assert_array_equal(out, jax_tokens["greedy"])
    if b.eos_raised:
        # Every row finished: the banked hypotheses are what came back.
        assert (out == EOS).any(axis=1).all()


# -- the cache's layout ------------------------------------------------------------


def test_cache_head_views_meet_the_kernel_layout(bridged):
    """The cache's head-split views are what the flash kernel reads on the
    card: strided ``[B, H, gen_len, dh]`` views whose rows start on 16
    bytes, before and after a beam reorder, with no copy."""
    b = bridged
    src = _t(b.src).repeat_interleave(2, dim=0)
    with torch.no_grad():
        memory = b.tm.encode(src)
        _, cache = b.tm.decode_step(
            torch.full((6, 1), SOS), memory, src != PAD, 0,
            torch.ones((6, 9), dtype=torch.bool),
        )
    reordered = cache.reorder(torch.tensor([1, 1, 2, 3, 5, 4]))
    assert reordered.mem_key is cache.mem_key and reordered.index == cache.index
    for c in (cache, reordered):
        assert isinstance(c, DecodeCache) and c.gen_len == 9
        for buf in (c.key, c.value, c.mem_key, c.mem_value):
            view = buf[0].view(6, buf.shape[2], 2, 16).transpose(1, 2)
            assert kernel_layout_ok(view) and view.stride(3) == 1
    torch.testing.assert_close(reordered.key[:, 0], cache.key[:, 1], rtol=0, atol=0)


# -- sampling ----------------------------------------------------------------------


def test_filter_logits_matches_jax_exactly():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((6, 29)) * 3).astype(np.float32)
    logits[0, :4] = logits[0, 4]  # ties at the top-k and top-p cutoffs
    for temperature, top_k, top_p in [
        (1.0, None, None), (0.7, 5, None), (1.0, None, 0.9), (1.3, 7, 0.6),
        (1.0, 100, None), (1.0, None, 1e-6), (0.0, 3, 1.0), (1.0, 1, 0.5),
    ]:
        got = _filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
        want = j_filter_logits(jnp.asarray(logits), temperature, top_k, top_p)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want), err_msg=f"{temperature}, {top_k}, {top_p}"
        )


def _sample(tm, src, seed, **kw):
    return sample_translate(
        tm, src, torch.Generator().manual_seed(seed), max_new_tokens=MAX_NEW, **kw
    )


def test_sampling_follows_its_generator_and_degrades_to_greedy(bridged, jax_tokens):
    b = bridged
    src = _t(b.src)
    a = _sample(b.tm, src, 7, top_p=0.9)
    np.testing.assert_array_equal(a.numpy(), _sample(b.tm, src, 7, top_p=0.9).numpy())
    assert a.shape == (3, MAX_NEW + 1) and (a[:, 0] == SOS).all()
    assert not torch.equal(a, _sample(b.tm, src, 8, top_p=0.9))
    for kw in (dict(temperature=0.0), dict(temperature=1.0, top_k=1)):
        np.testing.assert_array_equal(_sample(b.tm, src, 0, **kw).numpy(), jax_tokens["greedy"])


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(top_p=0.5), dict(temperature=0.5, top_k=4, top_p=0.8)])
def test_sampled_ids_lie_in_the_filtered_support(bridged, kw):
    b = bridged
    src = _t(b.src)
    ys = _sample(b.tm, src, 3, **kw)
    src_valid = src != PAD
    finished = torch.zeros(3, dtype=torch.bool)
    with torch.no_grad():
        memory = b.tm.encode(src)
        _, cache = b.tm.decode_step(
            torch.full((3, 1), SOS), memory, src_valid, 0,
            torch.ones((3, MAX_NEW + 1), dtype=torch.bool),
        )
        for t in range(MAX_NEW):
            logits, cache = b.tm.decode_step(ys[:, t : t + 1], memory, src_valid, t, ys != PAD, cache)
            filtered = _filter_logits(logits[:, 0], kw.get("temperature", 1.0), kw.get("top_k"), kw.get("top_p"))
            picked = filtered.gather(1, ys[:, t + 1 : t + 2])[:, 0]
            assert (picked[~finished] > NEG_INF / 2).all(), f"step {t}"
            assert (ys[finished, t + 1] == PAD).all()
            finished |= ys[:, t + 1] == EOS


# -- validation (tests/test_generate.py's) ---------------------------------------


def test_decoders_validate_their_arguments(bridged):
    b = bridged
    src = _t(b.src[:1])
    with pytest.raises(ValueError, match="max_new_tokens"):
        greedy_translate_cached(b.tm, src, max_new_tokens=16)  # max_len 16
    with pytest.raises(ValueError, match="max_new_tokens"):
        greedy_translate_cached(b.tm, src, max_new_tokens=0)
    with pytest.raises(ValueError, match="beam_size"):
        beam_translate(b.tm, src, beam_size=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        beam_translate(b.tm, src, max_new_tokens=16)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="top_k"):
        sample_translate(b.tm, src, gen, top_k=0, max_new_tokens=4)
    with pytest.raises(ValueError, match="top_p"):
        sample_translate(b.tm, src, gen, top_p=1.5, max_new_tokens=4)
    with pytest.raises(ValueError, match="top_k"):  # greedy mode too
        sample_translate(b.tm, src, gen, temperature=0.0, top_k=0, max_new_tokens=4)
    with pytest.raises(TypeError, match="torch.Generator"):
        sample_translate(b.tm, src, 0, max_new_tokens=4)
    # top_k past the vocabulary keeps everything: not an error
    out = sample_translate(b.tm, src, gen, top_k=10 * 29, max_new_tokens=4)
    assert out.shape == (1, 5)
