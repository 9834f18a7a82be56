"""The port's serving layer, on the CPU.

Host-side pieces (queue, batchers, slot pool, page pool, prefix cache,
metrics) mirror the JAX package's ``tests/test_serving.py`` against the
port's copies. The paged engine (``device="cpu"``: plain versions of the
kernels) must give tokens identical to the JAX package's paged engine
with the same bridged weights, for fp32 and int8 pages, and to the port's
one-shot ``Translator``; its pools and prefix-cache refcounts must return
to baseline after a drain and after a mid-decode deadline expiry. The
padded engine and the beam engine must give the tokens of the JAX
engines in the same mode, and the padded engine those of the paged one.
"""

import threading
import time

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch  # noqa: F401 — JAX and torch both load before any test

from machine_learning_apache_spark_tpu.data.datasets import (
    synthetic_translation_pairs,
)
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline, Vocab
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.serving import (
    NULL_PAGE,
    Backpressure,
    Batcher,
    DeadlineExceeded,
    Histogram,
    KVPagePool,
    KVSlotPool,
    PrefixCache,
    RequestQueue,
    ServingMetrics,
    TokenBudgetBatcher,
)
from machine_learning_apache_spark_tpu_torch.serving.metrics import (
    ConservationError,
    percentile,
)
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

pytestmark = pytest.mark.serving


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestRequestQueue:
    def test_backpressure_at_capacity_with_retry_after(self):
        q = RequestQueue(max_depth=2)
        q.submit("a", [1, 2])
        q.submit("b", [3])
        with pytest.raises(Backpressure) as ei:
            q.submit("c", [4])
        assert ei.value.retry_after > 0 and ei.value.depth == 2
        before = ei.value.retry_after
        q.note_serviced(1, 10.0)
        with pytest.raises(Backpressure) as ei2:
            q.submit("c", [4])
        assert ei2.value.retry_after > before

    def test_expiry_sweeps_and_fail_all(self):
        clock = FakeClock()
        q = RequestQueue(max_depth=4, clock=clock)
        r1 = q.submit("a", [1], deadline_s=1.0)
        r2 = q.submit("b", [2], deadline_s=10.0)
        assert q.expire_now() == 0
        clock.advance(2.0)
        assert q.expire_now() == 1
        with pytest.raises(DeadlineExceeded):
            r1.result(timeout=0)
        assert q.fail_all(RuntimeError("down")) == 1
        with pytest.raises(RuntimeError, match="down"):
            r2.result(timeout=0)
        assert q.depth == 0 and q.expired == 1


class TestBatchers:
    def test_bucketed_batcher_full_bucket_ships(self):
        q = RequestQueue(max_depth=64, clock=FakeClock())
        b = Batcher(q, boundaries=(4, 8), max_batch=2, max_wait_s=1.0)
        q.submit("a", [1, 2])
        q.submit("b", [1, 2, 3, 4, 5])
        q.submit("c", [3])
        batch = b.next_batch(timeout=0)
        assert batch.boundary == 4 and [r.text for r in batch.requests] == ["a", "c"]

    def test_token_budget_fifo_prefix_and_head_grant(self):
        q = RequestQueue(max_depth=64)
        b = TokenBudgetBatcher(q, chunk=4)
        assert b.cost([]) == 4 and b.cost([1] * 5) == 8
        q.submit("long", list(range(10)))
        q.submit("s1", [1, 2, 3])
        q.submit("s2", [4, 5, 6])
        assert [r.text for r in b.take(max_requests=8, token_budget=16)] == ["long", "s1"]
        assert [r.text for r in b.take(max_requests=8, token_budget=1)] == ["s2"]

    def test_token_budget_cost_fn_and_expiry(self):
        clock = FakeClock()
        q = RequestQueue(max_depth=64, clock=clock)
        b = TokenBudgetBatcher(q, chunk=4)
        dead = q.submit("dead", [1], deadline_s=1.0)
        clock.advance(2.0)
        for i in range(3):
            q.submit(f"hit{i}", [i])
        q.submit("miss", list(range(6)))
        taken = b.take(
            max_requests=8, token_budget=8,
            cost_fn=lambda r: 0 if r.text.startswith("hit") else 8,
        )
        assert [r.text for r in taken] == ["hit0", "hit1", "hit2", "miss"]
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=0)


class TestKVSlotPool:
    def test_acquire_release_occupancy(self):
        pool = KVSlotPool(4)
        s0, s1 = pool.try_acquire(10), pool.try_acquire(11)
        assert {s0, s1} == {0, 1} and pool.occupancy == 0.5
        pool.release(s0)
        assert pool.holder(s1) == 11 and pool.release_owner(11) == 1
        assert pool.free == 4 and pool.total_released == 2
        with pytest.raises(ValueError, match="not held"):
            pool.release(0)

    def test_blocked_batch_not_starved_by_try_acquire(self):
        pool = KVSlotPool(2)
        pool.try_acquire(100)
        pool.try_acquire(101)
        got = []
        waiter = threading.Thread(
            target=lambda: got.append(pool.acquire_many([200, 201], timeout=10))
        )
        waiter.start()
        deadline = time.monotonic() + 5
        while not pool._tickets and time.monotonic() < deadline:
            time.sleep(0.001)
        pool.release_owner(100)
        assert pool.try_acquire(300) is None
        pool.release_owner(101)
        waiter.join(timeout=10)
        assert got and got[0] is not None and pool.in_use == 2


class TestKVPagePoolAndPrefixCache:
    def test_round_trip_refcounts_and_bytes(self):
        pool = KVPagePool(8, page_bytes=576)
        pages = pool.try_acquire(3, "a")
        assert NULL_PAGE not in pages and pool.bytes_in_use == 3 * 576
        pool.add_ref(pages[:2], "b")
        assert pool.release_owner("a") == 1  # shared pages survive
        assert pool.in_use == 2 and pool.release_owner("b") == 2
        assert pool.in_use == 0 and pool.bytes_high_water == 3 * 576
        assert pool.try_acquire(8, "c") is None
        with pytest.raises(ValueError, match="not allocated"):
            pool.add_ref([NULL_PAGE], "x")

    def test_prefix_cache_hit_eviction_and_flush(self):
        pool = KVPagePool(16)
        cache = PrefixCache(pool, 1)
        a = pool.try_acquire(1, "r1")
        assert cache.put(("a",), a, width=8)
        entry = cache.get(("a",), owner="r1-decode")
        assert entry["pages"] == a and entry["width"] == 8
        assert cache.contains(("a",)) and not cache.contains(("b",))
        b = pool.try_acquire(1, "r2")
        cache.put(("b",), b)  # capacity 1: evicts ("a",)
        assert cache.stats()["evictions"] == 1 and pool.refcount(a[0]) == 2
        pool.release_owner("r1")
        pool.release_owner("r1-decode")
        pool.release_owner("r2")
        assert pool.refcount(a[0]) == 0
        assert cache.flush() == 1 and pool.in_use == 0


class TestMetrics:
    def test_percentile_and_histogram(self):
        assert percentile([], 50) is None
        xs = [float(i) for i in range(1, 101)]
        assert percentile(xs, 50) == 50.0 and percentile(xs, 99) == 99.0
        h = Histogram("x")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.record(v)
        assert h.summary()["mean"] == 2.5

    def test_ledger_and_conservation(self):
        clock = FakeClock()
        m = ServingMetrics(clock=clock)
        for _ in range(4):
            m.on_submit()
        m.on_reject()
        m.on_expire()
        clock.advance(2.0)
        m.on_batch(n_requests=2, max_batch=4, decode_s=0.5, new_tokens=20,
                   queue_depth=1, slot_occupancy=0.25)
        m.on_complete(queue_wait=0.1, ttft=0.6, total=0.7)
        s = m.summary()
        assert s["tokens_out"] == 20 and s["tokens_per_sec"] == 10.0
        assert m.check_conservation(in_flight=1)["in_flight"] == 1
        with pytest.raises(ConservationError, match="conservation violated"):
            m.check_conservation(in_flight=0)


# -- the paged engine against the JAX package's ------------------------------


@pytest.fixture(scope="module")
def translators():
    """One tiny untrained MT bundle in both packages, same weights (the
    Flax tree bridged), same vocabularies."""
    pairs = synthetic_translation_pairs(64, min_len=3, max_len=8, seed=0)
    src_j = JPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_j = JPipeline.fit([t for _, t in pairs], max_seq_len=14)
    kw = dict(
        src_vocab_size=len(src_j.vocab.itos),
        trg_vocab_size=len(trg_j.vocab.itos),
        d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16,
        dropout=0.0,
    )
    jm = JTransformer(JConfig(**kw))
    dummy = np.ones((2, 8), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(0), dummy, dummy)["params"])
    model = load_flax_params(
        Transformer(TransformerConfig(**kw)), jax.tree.map(np.asarray, params)
    )

    def pipe(p):
        return TextPipeline(Vocab(p.vocab.itos, specials=()), max_seq_len=14)

    port = Translator(model, pipe(src_j), pipe(trg_j), device="cpu")
    return JTranslator(jm, params, src_j, trg_j), port, [s for s, _ in pairs]


ENGINE = dict(boundaries=(8, 16), max_batch=4, max_new_tokens=8, kv_mode="paged")


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_engine_tokens_identical_to_jax_engine(translators, kv_dtype):
    jt, tt, texts = translators
    texts = texts[:16]
    with jt.serve(kv_dtype=kv_dtype, **ENGINE) as eng:
        want = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
    with tt.serve(kv_dtype=kv_dtype, **ENGINE) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        stats = eng.runtime.stats()
        assert eng.metrics.completed == len(texts)
        assert stats["active_rows"] == 0 and stats["self_pages_in_use"] == 0
        assert eng.pool.in_use == 0
        assert eng.recompiles_after_warmup == 0  # every program built at warmup
        eng.metrics.check_conservation(in_flight=0)
    assert got == want
    if kv_dtype == "float32":
        assert got == tt(texts, max_new_tokens=8)  # the one-shot oracle


def test_engine_rejects_what_the_jax_engine_rejects(translators, monkeypatch):
    """The JAX engine's construction-time rejections: int8 pages need the
    paged store (a padded or beam engine says how its mode resolved), an
    unknown KV dtype or method; and a sampling call needs its rng."""
    _, tt, _ = translators
    base = {k: v for k, v in ENGINE.items() if k != "kv_mode"}
    with pytest.raises(ValueError, match="requires the paged KV store"):
        tt.serve(kv_mode="padded", kv_dtype="int8", start=False, **base)
    with pytest.raises(ValueError, match="via method='beam'"):
        tt.serve(method="beam", kv_dtype="int8", start=False, **base)
    with pytest.raises(ValueError, match="kv_dtype"):
        tt.serve(kv_dtype="int4", start=False, **base)
    with pytest.raises(ValueError, match="method"):
        tt.serve(method="sample", start=False, **base)
    with pytest.raises(ValueError, match="explicit rng"):
        tt(["a b"], method="sample")
    monkeypatch.setenv("MLSPARK_SERVE_KV_DTYPE", "int8")
    eng = tt.serve(start=False, **base)
    assert eng.kv_mode == "paged" and eng.kv_dtype == "int8"
    assert eng.runtime.kv_mem.dtype.itemsize == 1


def test_kv_mode_env_flips_the_default(translators, monkeypatch):
    _, tt, _ = translators
    base = {k: v for k, v in ENGINE.items() if k != "kv_mode"}
    monkeypatch.setenv("MLSPARK_SERVE_KV_MODE", "padded")
    eng = tt.serve(start=False, **base)
    assert eng.kv_mode == "padded" and eng.runtime is None
    assert eng.pool.free == 2 * base["max_batch"]  # one batch decoding, one forming
    eng = tt.serve(kv_mode="paged", start=False, **base)  # the argument wins
    assert eng.kv_mode == "paged" and eng.runtime is not None
    eng = tt.serve(method="beam", kv_mode="paged", start=False, **base)
    assert eng.kv_mode == "padded"  # beam always runs padded


PADDED_MODES = {
    "padded": dict(kv_mode="padded"),
    "beam2": dict(method="beam", beam_size=2),
}


@pytest.mark.parametrize("mode", list(PADDED_MODES))
def test_padded_engines_tokens_identical_to_jax_engine(translators, mode):
    """The padded greedy engine and the beam engine against the JAX
    engines in the same mode; the padded engine also against the paged
    engine and the one-shot ``Translator``. Slots drain and the ledger
    conserves."""
    jt, tt, texts = translators
    texts = texts[:12]
    kw = {**ENGINE, **PADDED_MODES[mode], "max_wait_s": 0.01}
    with jt.serve(**kw) as eng:
        want = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        want_real = eng.metrics.real_tokens
    with tt.serve(**kw) as eng:
        assert eng.kv_mode == "padded" and eng.runtime is None
        got = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        assert eng.metrics.completed == len(texts) and eng.pool.in_use == 0
        assert eng.recompiles_after_warmup == 0  # every program built at warmup
        eng.metrics.check_conservation(in_flight=0)
        real, padded = eng.metrics.real_tokens, eng.metrics.padded_tokens
    assert got == want
    # The real-token ledger counts each request once, however the batches
    # formed; the padded one counts the rectangles that ran.
    assert real == want_real and 0 < real < padded
    if mode == "padded":
        with tt.serve(**ENGINE) as eng:
            paged = [f.result(timeout=120) for f in [eng.submit(s) for s in texts]]
        assert got == paged == tt(texts, max_new_tokens=8)
    else:
        assert got == tt(texts, method="beam", beam_size=2, max_new_tokens=8)


def _prefix_refcounts(runtime):
    cache = runtime.prefix_cache
    with cache._lock:
        pages = {k: list(e["pages"]) for k, e in cache._entries.items()}
    return {k: [runtime.mem_pool.refcount(p) for p in ps] for k, ps in pages.items()}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_mid_decode_expiry_restores_pools_and_cache(translators, kv_dtype):
    """Rows reaped mid-decode by the deadline sweep leave no residue:
    pages, rows and prefix-cache refcounts return to their pre-wave
    state, the ledger closes, and the engine still serves."""
    _, tt, texts = translators
    wave = texts[:4]
    with tt.serve(kv_dtype=kv_dtype, steps_per_launch=1, **ENGINE) as eng:
        for f in [eng.submit(s, deadline_s=120.0) for s in wave]:
            f.result(timeout=120)
        base_in_use = eng.runtime.mem_pool.in_use
        base_refs = _prefix_refcounts(eng.runtime)
        assert eng.pool.in_use == 0
        futs = [eng.submit(s, deadline_s=120.0) for s in wave]
        cancelled = set()
        t_end = time.time() + 30.0
        while len(cancelled) < len(wave) and time.time() < t_end:
            for _row, req in eng.runtime.active_rows():
                if req.id not in cancelled:
                    req.deadline = 0.0
                    cancelled.add(req.id)
            time.sleep(0.0005)
        n_expired = 0
        for f in futs:
            try:
                f.result(timeout=60)
            except DeadlineExceeded:
                n_expired += 1
        assert n_expired >= 1 and eng.metrics.expired_in_flight == n_expired
        assert eng.runtime.mem_pool.in_use == base_in_use
        assert _prefix_refcounts(eng.runtime) == base_refs
        assert eng.pool.in_use == 0
        assert eng.runtime.stats()["self_pages_in_use"] == 0
        eng.metrics.check_conservation(in_flight=0)
        again = [f.result(timeout=120) for f in [eng.submit(s) for s in wave]]
        assert all(isinstance(o, str) for o in again)
        eng.metrics.check_conservation(in_flight=0)
