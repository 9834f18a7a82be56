"""The port's program cache and the serving engine's compile-at-warmup
contract, on the CPU.

On the card every program of ``utils/graph_cache.ProgramCache`` is a CUDA
graph (``tests/test_torch_gpu.py`` replays them); on the CPU it runs
eagerly and is counted the same way. So here: the cache's counting
contract (the twin of the JAX ``test_jit_cache_size_counts_programs``),
the port's engines holding as many programs after warmup as the JAX
engines with the same configuration, none added by a mixed-length run,
and a quarantine ``reset()`` that keeps the stores' addresses and the
programs.
"""

import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu_torch.utils.graph_cache import (
    ProgramCache,
    signature,
)
from test_torch_serving import ENGINE, translators  # noqa: F401 — the fixture

pytestmark = pytest.mark.serving


def test_program_cache_counts_programs():
    """One program per (name, signature): the same shapes twice give one,
    a new shape, dtype, static value or name one more; every call returns
    what the function returns."""
    cache = ProgramCache("cpu")
    calls = []

    def add(x, n):
        calls.append(n)
        return x + n

    assert cache.size() == 0
    a = torch.zeros(2)
    assert torch.equal(cache("add", add, a, 1), a + 1)
    assert torch.equal(cache("add", add, torch.ones(2), 1), torch.full((2,), 2.0))
    assert cache.size() == 1  # same signature: no new program
    cache("add", add, torch.zeros(3), 1)
    assert cache.size() == 2
    cache("add", add, torch.zeros(3, dtype=torch.float64), 1)
    cache("add", add, torch.zeros(3), 2)
    cache("other", add, torch.zeros(3), 2)
    assert cache.size() == 5 and calls == [1, 1, 1, 1, 2, 2]
    assert signature((a, 4, None)) == (((2,), torch.float32), 4, None)
    stats = cache.stats()
    assert [s["replays"] for s in stats] == [2, 1, 1, 1, 1]
    assert stats[0]["signature"] == [[[2], "torch.float32"], 1]
    assert all(s["launches"] == s["eager_launches"] == {} for s in stats)


ENGINE_MODES = {
    "paged-fp32": dict(kv_mode="paged"),
    "paged-int8": dict(kv_mode="paged", kv_dtype="int8"),
    "padded": dict(kv_mode="padded"),
    "beam2": dict(method="beam", beam_size=2),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_compile_count_equals_jax_engine(translators, mode):  # noqa: F811
    """After warmup each engine holds as many programs as the JAX engine
    of the same configuration: paged ``max_chunks + 1`` (one prefill per
    chunk width and the launch), padded and beam one per bucket."""
    jt, tt, _ = translators
    kw = {**ENGINE, **ENGINE_MODES[mode]}
    want = jt.serve(start=False, **kw)
    got = tt.serve(start=False, **kw)
    assert got.recompiles_after_warmup is None  # not warmed up yet
    assert got.warmup() == want.warmup()
    assert got.compile_count() == want.compile_count()
    if got.runtime is not None:
        assert got.compile_count() == got.runtime.max_chunks + 1 == 3
    else:
        assert got.compile_count() == len(ENGINE["boundaries"])
    assert got.recompiles_after_warmup == want.recompiles_after_warmup == 0


@pytest.mark.parametrize("kv_mode", ["paged", "padded"])
def test_zero_recompiles_across_ragged_occupancies(translators, kv_mode):  # noqa: F811
    """The twin of the JAX engine's test: after warmup, every wave shape —
    occupancy 1..max_active, short and long prompts interleaved, repeat
    prompts hitting the prefix cache — runs the programs built at warmup,
    and gives the one-shot ``Translator``'s tokens."""
    _, tt, texts = translators
    short = [s for s in texts if len(s.split()) <= 5]
    long_ = [s for s in texts if len(s.split()) >= 7]
    waves = [short[:1], long_[:3], short[:2] + long_[3:5], short[:1]]
    with tt.serve(**{**ENGINE, "kv_mode": kv_mode, "max_wait_s": 0.01}) as eng:
        programs = eng.compile_count()
        outs = [[f.result(timeout=120) for f in [eng.submit(s) for s in w]] for w in waves]
        assert eng.recompiles_after_warmup == 0
        assert eng.compile_count() == programs
        if kv_mode == "paged":
            assert eng.runtime.stats()["prefix_cache"]["hits"] >= 1
        eng.metrics.check_conservation(in_flight=0)
    for wave, out in zip(waves, outs):
        assert out == tt(wave, max_new_tokens=8)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_reset_keeps_stores_and_programs(translators, kv_dtype):  # noqa: F811
    """The quarantine path zeroes the page stores in place (their
    addresses are what the programs captured) and keeps every program;
    the engine then serves the same tokens with no program added."""
    _, tt, texts = translators
    wave = texts[:6]
    eng = tt.serve(kv_dtype=kv_dtype, **ENGINE)
    rt = eng.runtime
    ptrs = [t.data_ptr() for t in rt.stores() if t is not None]
    assert len(ptrs) == (3 if kv_dtype == "int8" else 2)  # int8: the mem store's scales
    with eng:
        first = [f.result(timeout=120) for f in [eng.submit(s) for s in wave]]
        assert any(t.abs().sum() > 0 for t in rt.stores() if t is not None)
        programs = eng.compile_count()
    # The runtime is the decode thread's alone: reset it between runs
    # (stopping the engine resets it too).
    assert rt.reset() == []  # drained: no request was active
    assert [t.data_ptr() for t in rt.stores() if t is not None] == ptrs
    assert all(not t.any() for t in rt.stores() if t is not None)
    assert rt.programs().size() == eng.compile_count() == programs
    with eng.start(warmup=False):
        again = [f.result(timeout=120) for f in [eng.submit(s) for s in wave]]
        assert eng.recompiles_after_warmup == 0
    assert again == first


def test_launch_is_one_program_over_staged_host_state(translators):  # noqa: F811
    """The launch reads the host state through the staging buffers, in
    ``_decode``'s order, and returns one ``[T + 3, R]`` int32 tensor: the
    emits, then the new token, cursor and finished rows."""
    _, tt, _ = translators
    eng = tt.serve(start=False, **ENGINE)
    rt = eng.runtime
    eng.warmup()
    staged = rt._stage()
    for buf, a in zip(staged, rt._host_inputs()):
        assert np.array_equal(buf.numpy(), a) and buf.numpy().dtype == a.dtype
    out = rt._replay(staged)
    assert out.dtype == torch.int32
    assert out.shape == (rt.steps_per_launch + 3, rt.max_active)
    assert rt.programs().stats()[-1]["name"] == "launch"
    assert eng.recompiles_after_warmup == 0


def test_serve_bench_smoke_gates():
    """``tools/torch_serve_bench.py --smoke`` in this process: the four
    engines on the CPU pass the bench's gates (parity with the one-shot
    decoder, int8 token match, zero recompiles, conservation)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "torch_serve_bench.py"
    spec = importlib.util.spec_from_file_location("torch_serve_bench_under_test", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    result = bench.measure(smoke=True, requests=16)
    assert result["gates"] == dict(parity=True, token_match=True, zero_recompiles=True, conservation=True)
    for label, row in result["engines"].items():
        assert row["programs"] == (3 if label.startswith("paged") else 2)
        assert row["completed"] >= row["requests"] and row["idle_share"] is None
