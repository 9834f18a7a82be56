"""The port's streaming ingest pipeline (``machine_learning_apache_spark_tpu_torch.ingest``)
against the JAX package's, on the CPU.

- batches: the port's ``StreamingPipeline`` over each source yields the
  JAX pipeline's batches (``device=False``) bit for bit — every
  ``(rank, world)``, both shard modes, both tail policies, online packing,
  the mixture and its state replay, ``shard_files`` and the text sources;
  ``OnlinePacker`` rows equal both one-shot packers' (the port's
  ``data.packing`` and the JAX one);
- the equalization contract, the bounded producer thread and its clean
  shutdown (no ``WORKER_PREFIX`` thread outlives an iterator, a raise or
  ``fit``), the ``MLSPARK_INGEST_*`` env contract through
  ``Distributor(ingest=)``, the ``data.*`` telemetry;
- ``fit(data=pipe)``: the MLP under SGD against the JAX ``fit(data=pipe)``
  (atol 1e-5), at 1 and 3 steps per call; the device stage's batches go
  into the step without a copy (``to_device`` hands them back as they
  are); a 2 + 2 epoch resume replays the stream bit for bit; a mesh binds
  the pipeline to its data index.

The card's own device stage (pinned memory, a side stream, events and
``record_stream``) runs in ``chip_smoke.py``'s phase 7j.
"""

import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu import ingest as J
from machine_learning_apache_spark_tpu.data import packing as jpacking
from machine_learning_apache_spark_tpu.data.libsvm import write_libsvm
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JTextPipeline
from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch import ingest as P
from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.data import packing as tpacking
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models import MLP
from machine_learning_apache_spark_tpu_torch.train import checkpoint as tckpt
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_like,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = 1e-5
LAYERS = (4, 8, 3)


def host(mod, source, batch, **kw):
    """A pipeline of either package that yields host batches."""
    kw.setdefault("device", False)
    kw.setdefault("buffer", 0)
    return mod.StreamingPipeline(source, batch, **kw)


def same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    return len(a)


def no_ingest_threads():
    time.sleep(0.05)  # a joined thread can take a beat to deregister
    return not [t for t in threading.enumerate()
                if t.name.startswith(P.WORKER_PREFIX) and t.is_alive()]


def random_pairs(rng, n, lo=4, hi=18):
    return [(list(rng.integers(4, 100, rng.integers(lo, hi))),
             list(rng.integers(4, 100, rng.integers(lo + 1, hi + 2)))) for _ in range(n)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# -- batches against the JAX pipeline ------------------------------------------------

COORDS = [(0, 1), (0, 2), (1, 2), (2, 3), (0, 4), (3, 4)]


@pytest.mark.parametrize("tail", ["pad", "drop"])
@pytest.mark.parametrize("rank,world", COORDS)
def test_records_mode_batches_equal_jax(rank, world, tail, rng):
    # N=19, B=5: ragged shards at every world but 1.
    feats = rng.normal(size=(19, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 19)
    kw = dict(rank=rank, world=world, tail=tail, buffer=2)
    n = same_batches(host(P, P.ArraySource(feats, labels), 5, **kw),
                     host(J, J.ArraySource(feats, labels), 5, **kw))
    assert n == (-(-(-(-19 // world)) // 5) if tail == "pad" else (19 // world) // 5)


def _libsvm_files(tmp_path, rng, sizes=(7, 3, 5)):
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"f{i}.libsvm")
        write_libsvm(p, rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 3, n))
        paths.append(p)
    return paths


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_files_mode_batches_equal_jax(rank, world, use_native, tmp_path, rng):
    paths = _libsvm_files(tmp_path, rng)
    kw = dict(rank=rank, world=world, shard="files", steps_per_epoch=4)
    got = host(P, P.LibsvmStreamSource(paths, num_features=3, chunk_lines=2, use_native=use_native), 2, **kw)
    want = host(J, J.LibsvmStreamSource(paths, num_features=3, chunk_lines=2, use_native=False), 2, **kw)
    assert same_batches(got, want) == 4


def test_shard_files_equal_jax(tmp_path, rng):
    paths = _libsvm_files(tmp_path, rng)
    for world in (1, 2, 3):
        for rank in range(world):
            p = P.LibsvmStreamSource(paths, num_features=3).shard_files(rank, world)
            j = J.LibsvmStreamSource(paths, num_features=3).shard_files(rank, world)
            assert p.paths == j.paths
            same_batches([tuple(r) for r in p], [tuple(r) for r in j])
            assert P.TextLineSource(paths).shard_files(rank, world).paths == \
                J.TextLineSource(paths).shard_files(rank, world).paths
    with pytest.raises(ValueError, match="cannot file-shard 3 file"):
        P.LibsvmStreamSource(paths, num_features=3).shard_files(0, 4)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        host(P, P.LibsvmStreamSource(paths, num_features=3), 2, rank=0, world=2, shard="files")


@pytest.mark.parametrize("tail", ["pad", "drop"])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (3, 4)])
def test_packed_batches_equal_jax(rank, world, tail, rng):
    pairs = random_pairs(rng, 60)
    kw = dict(rank=rank, world=world, tail=tail, pack=dict(src_len=32, trg_len=36, max_segments=3))
    n = same_batches(host(P, P.PairSource(pairs), 2, **kw), host(J, J.PairSource(pairs), 2, **kw))
    assert n >= 1 or tail == "drop"


def test_online_packer_equals_both_one_shot_packers(rng):
    pairs = random_pairs(rng, 80, lo=2, hi=22)
    kw = dict(src_len=32, trg_len=40, max_segments=3)
    packer = P.OnlinePacker(**kw)
    rows = [r for p in pairs if (r := packer.add(*p)) is not None]
    if (last := packer.flush()) is not None:
        rows.append(last)
    got = tuple(np.stack([r[i] for r in rows]) for i in range(6))
    for one_shot in (tpacking.pack_translation_pairs, jpacking.pack_translation_pairs):
        want = one_shot([p[0] for p in pairs], [p[1] for p in pairs], **kw)
        for g, w in zip(got, want.arrays()):
            np.testing.assert_array_equal(g, w)
        assert packer.dropped_pairs == want.dropped_pairs
        assert abs(packer.token_efficiency - want.token_efficiency) < 1e-9
    with pytest.raises(ValueError, match="budgets"):
        P.OnlinePacker(src_len=8, trg_len=1)
    with pytest.raises(ValueError, match="pack option"):
        host(P, P.PairSource(pairs), 1, pack=dict(src_len=8, trg_len=8, typo=3))


def _mixtures(mod, seed=9, n=30):
    a = mod.ArraySource(np.arange(6, dtype=np.float32)[:, None], name="a")
    b = mod.ArraySource(100 + np.arange(10, dtype=np.float32)[:, None], name="b")
    return mod.MixtureSampler({"a": a, "b": b}, [0.4, 0.6], records_per_epoch=n, seed=seed)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (2, 3)])
def test_mixture_stream_and_its_replay_equal_jax(rank, world):
    got = host(P, _mixtures(P), 4, rank=rank, world=world)
    want = host(J, _mixtures(J), 4, rank=rank, world=world)
    for _ in range(2):  # the sources' iterators persist across epochs
        same_batches(got, want)
    # A capture mid-stream, through JSON as the sidecar holds it, replays
    # the rest in both packages.
    mp, mj = _mixtures(P), _mixtures(J)
    ip, ij = iter(mp), iter(mj)
    for _ in range(13):
        assert float(next(ip)[0][0]) == float(next(ij)[0][0])
    snap = json.loads(json.dumps(mp.state_dict()))
    assert snap == json.loads(json.dumps(mj.state_dict()))
    rest = [float(r[0][0]) for r in ip] + [float(r[0][0]) for r in mp]
    fp, fj = _mixtures(P), _mixtures(J)
    fp.load_state_dict(snap)
    fj.load_state_dict(snap)
    for fresh in (fp, fj):
        it = iter(fresh)
        assert [float(next(it)[0][0]) for _ in range(17)] + [float(r[0][0]) for r in fresh] == rest
    state = mp.state_dict()
    state["cycles"] = {k: v + 1 for k, v in state["cycles"].items()}
    with pytest.raises(ValueError, match="cycle"):
        _mixtures(P).load_state_dict(state)


def test_text_sources_equal_jax(tmp_path):
    lines = ["a dog runs", "", "two cats sleep here", "the end"] * 3
    path = tmp_path / "t.txt"
    path.write_text("\n".join(lines) + "\n")
    assert list(P.TextLineSource(str(path))) == list(J.TextLineSource(str(path)))
    texts = [t for t in lines if t]
    labels = np.arange(len(texts)) % 3
    pipe = TextPipeline.fit(texts, max_seq_len=5, fixed_len=7)
    jpipe = JTextPipeline.fit(texts, max_seq_len=5, fixed_len=7)
    kw = dict(buffer=2)
    same_batches(host(P, P.EncodedTextSource(texts, labels, pipe, chunk=4), 3, **kw),
                 host(J, J.EncodedTextSource(texts, labels, jpipe, chunk=4), 3, **kw))


# -- equalization, the producer thread ----------------------------------------------


@pytest.mark.parametrize("tail,want", [("drop", [0, 0, 0, 0]), ("pad", [1, 1, 1, 1])])
def test_ragged_shards_equalize(tail, want):
    feats = np.arange(19, dtype=np.float32).reshape(19, 1)
    counts, seen = [], set()
    for rank in range(4):
        batches = list(host(P, P.ArraySource(feats), 5, rank=rank, world=4, tail=tail))
        counts.append(len(batches))
        seen |= {int(v) for b in batches for v in np.asarray(b[0]).ravel()}
    assert counts == want
    if tail == "pad":  # pad wraps each rank's own records; every record appears
        assert set(range(19)) <= seen
    with pytest.raises(ValueError, match="smaller than the world"):
        list(host(P, P.ArraySource(np.ones((2, 1), np.float32)), 1, rank=3, world=4))


def test_producer_buffer_is_bounded_and_errors_propagate(rng):
    telemetry.reset()
    try:
        pipe = host(P, P.ArraySource(rng.normal(size=(64, 2)).astype(np.float32)), 4,
                    tail="drop", buffer=3)
        for _ in pipe:
            time.sleep(0.002)  # a slow consumer: the producer fills the queue
        occ = [ev.value for ev in telemetry.get_log().snapshot()
               if ev.kind == "gauge" and ev.name == "data.buffer_occupancy"]
        assert occ and max(occ) <= 3
    finally:
        telemetry.reset()

    def bad_stream():
        yield (np.zeros(1, np.float32),)
        raise RuntimeError("reader exploded")

    with pytest.raises(RuntimeError, match="reader exploded"):
        list(host(P, P.CallableSource(bad_stream), 1, tail="drop", buffer=2))
    assert no_ingest_threads()


def test_abandoned_iterator_and_context_manager_leave_no_threads(rng):
    feats = rng.normal(size=(400, 2)).astype(np.float32)
    pipe = host(P, P.ArraySource(feats), 4, tail="drop", buffer=2, device="cpu")
    it = iter(pipe)
    next(it)  # the producer is alive, likely blocked on a full queue
    pipe.shutdown()
    assert no_ingest_threads()
    pipe.shutdown()  # idempotent
    with host(P, P.ArraySource(feats), 4, tail="drop", buffer=2) as pipe:
        next(iter(pipe))
    assert no_ingest_threads()


# -- the device stage and fit --------------------------------------------------------


def test_device_stage_hands_batches_to_the_step_without_a_copy(rng):
    """A CPU device stage: tensors wrapping the host arrays, ids widened
    to int64; ``to_device`` hands each back as it is and
    ``stack_batches`` stacks them where they lie. (On the card the
    stage's copies are its only ones: ``h2d_copies`` counts them, phase
    7j.)"""
    feats = rng.normal(size=(24, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 24).astype(np.int32)
    pipe = P.StreamingPipeline(P.ArraySource(feats, labels), 8, device="cpu", buffer=2)
    assert pipe.yields_device_batches and pipe.target_device() == torch.device("cpu")
    batches = list(pipe)
    cpu = torch.device("cpu")
    for b in batches:
        assert all(isinstance(t, torch.Tensor) for t in b)
        assert b[1].dtype == torch.int64
        moved = tloop.to_device(b, cpu)
        assert all(m is t for m, t in zip(moved, b))
    stacked = tloop.stack_batches(batches, cpu)
    assert stacked[0].shape == (3, 8, 4) and stacked[1].dtype == torch.int64
    np.testing.assert_array_equal(stacked[0].numpy(), feats.reshape(3, 8, 4))
    assert pipe.h2d_copies == 0  # no card, nothing copied
    assert not P.StreamingPipeline(P.ArraySource(feats), 8, device=False).yields_device_batches
    assert not P.StreamingPipeline(P.ArraySource(feats), 8, device_prefetch=0).yields_device_batches


def _mlp_states(opt="sgd", lr=0.1):
    tm = MLP(LAYERS)
    tree = random_flax_like(tm, 3)
    load_flax_params(tm, tree)
    jm = JMLP(layers=LAYERS)
    js = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
                                  tx=jstate.make_optimizer(opt, lr))
    return tstate.TrainState.create(model=tm, tx=tstate.make_optimizer(opt, lr)), js, jm


def _close(got_model, want_params):
    got = jax.tree_util.tree_leaves(export_flax_params(got_model))
    want = jax.tree_util.tree_leaves(want_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("steps_per_call", [1, 3])
@pytest.mark.parametrize("tail", ["pad", "drop"])
def test_fit_over_a_pipeline_matches_the_jax_fit(tail, steps_per_call, rng):
    x = rng.normal(size=(50, 4)).astype(np.float32)
    y = rng.integers(0, 3, 50)
    ts, js, jm = _mlp_states()
    jres = jloop.fit(js, jloop.classification_loss(jm.apply), epochs=2, log_every=0,
                     data=J.StreamingPipeline(J.ArraySource(x, y), 8, tail=tail, device_prefetch=2))
    pipe = P.StreamingPipeline(P.ArraySource(x, y), 8, tail=tail, device="cpu")
    tres = tloop.fit(ts, tloop.classification_loss(), data=pipe, epochs=2, log_every=0,
                     steps_per_call=steps_per_call)
    assert tres.state.step == int(jres.state.step) == 2 * pipe.last_epoch_batches
    np.testing.assert_allclose([h["loss"] for h in tres.history],
                               [h["loss"] for h in jres.history], rtol=1e-5)
    _close(tres.state.model, jres.state.params)
    assert no_ingest_threads()  # fit's finally ran shutdown()


def test_fit_raise_path_leaves_no_threads(rng):
    def poisoned():
        for i, rec in enumerate(P.ArraySource(rng.normal(size=(64, 4)).astype(np.float32),
                                              rng.integers(0, 3, 64))):
            if i == 20:
                raise RuntimeError("mid-epoch reader failure")
            yield rec

    ts, _, _ = _mlp_states()
    pipe = P.StreamingPipeline(P.CallableSource(poisoned), 8, tail="drop", buffer=2, device="cpu")
    with pytest.raises(RuntimeError, match="mid-epoch reader failure"):
        tloop.fit(ts, tloop.classification_loss(), data=pipe, epochs=1, log_every=0)
    assert no_ingest_threads()
    with pytest.raises(ValueError, match="not both"):
        tloop.fit(ts, tloop.classification_loss(), [], data=[], epochs=1)


def _mixture_pipe(x, y, per_epoch, batch):
    mix = P.MixtureSampler({"rows": P.ArraySource(x, y)}, records_per_epoch=per_epoch, seed=4)
    return P.StreamingPipeline(mix, batch, device="cpu")


def test_checkpointed_resume_replays_the_stream(tmp_path, rng):
    """2 fit epochs with checkpoints (the sidecar holds the stream's
    position: the mixture's generator and cursor), then a resumed run of
    2 more over fresh objects: the same steps, losses and parameters as 4
    epochs in one run, bit for bit — mid-way through the records, since a
    mixture epoch (24 records) is a part of the 40 rows."""
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    whole, _, _ = _mlp_states("adam", 0.01)
    one = tloop.fit(whole, tloop.classification_loss(), data=_mixture_pipe(x, y, 24, 8), epochs=4,
                    log_every=0)
    with tckpt.CheckpointManager(str(tmp_path)) as ck:
        first, _, _ = _mlp_states("adam", 0.01)
        a = tloop.fit(first, tloop.classification_loss(), data=_mixture_pipe(x, y, 24, 8), epochs=2,
                      checkpointer=ck, log_every=0)
    meta = tckpt.read_meta_at(str(tmp_path), 6)
    assert meta["ingest"]["source"]["draws"] == {"rows": 48}
    with tckpt.CheckpointManager(str(tmp_path)) as ck:
        second, _, _ = _mlp_states("adam", 0.01)
        b = tloop.fit(second, tloop.classification_loss(), data=_mixture_pipe(x, y, 24, 8), epochs=4,
                      checkpointer=ck, resume=True, log_every=0)
    assert b.resumed_step == 6 and b.state.step == one.state.step == 12
    assert a.step_losses + b.step_losses == one.step_losses
    assert all(torch.equal(p, q) for p, q in zip(b.state.params, one.state.params))
    assert no_ingest_threads()


def test_a_mesh_binds_the_pipeline_to_its_data_index(rng):
    feats = rng.normal(size=(24, 2)).astype(np.float32)

    def mesh(data, model):
        coords = {"data": data[0], "model": model}
        return types.SimpleNamespace(shape={"data": data[1], "model": 2},
                                     index=lambda a: coords.get(a, 0),
                                     axis_size=lambda a: {"data": data[1], "model": 2}.get(a, 1))

    # The two ranks of a model line read the same rows: their data index's.
    rows = []
    for model in (0, 1):
        pipe = host(P, P.ArraySource(feats), 4)
        pipe.bind(mesh=mesh((1, 3), model))
        assert (pipe.rank, pipe.world) == (1, 3)
        rows.append(np.concatenate([b[0] for b in pipe]))
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[0], feats[1::3])
    with pytest.raises(ValueError, match="another rank's rows"):
        host(P, P.ArraySource(feats), 4, rank=0, world=3).bind(mesh=mesh((1, 3), 0))
    with pytest.raises(ValueError, match="another rank's rows"):
        host(P, P.ArraySource(feats), 4, world=2).bind(mesh=mesh((0, 3), 0))


def test_rescatter_stream_state_is_the_jax_contract():
    sd = {"version": 1, "epoch": 3, "source": {"draws": {"a": 5}}}
    got = P.rescatter_stream_state(sd, old_world=3, new_world=2)
    assert got == J.rescatter_stream_state(sd, old_world=3, new_world=2)
    assert got["rescattered"] == {"old_world": 3, "new_world": 2}
    with pytest.raises(ValueError, match="shard='files'"):
        P.rescatter_stream_state(sd, old_world=3, new_world=2, shard="files")
    with pytest.raises(ValueError, match="world sizes"):
        P.rescatter_stream_state(sd, old_world=0, new_world=2)


# -- the env contract, telemetry -----------------------------------------------------


def test_from_env_precedence_and_bad_values(monkeypatch):
    monkeypatch.setenv("MLSPARK_INGEST_BUFFER", "7")
    monkeypatch.setenv("MLSPARK_INGEST_TAIL", "drop")
    cfg = P.IngestConfig.from_env(tail="pad")
    assert (cfg.buffer, cfg.tail, cfg.device_prefetch, cfg.chunk_lines) == (7, "pad", 2, 1024)
    assert cfg == P.IngestConfig(**vars(J.IngestConfig.from_env(tail="pad")))
    monkeypatch.setenv("MLSPARK_INGEST_BUFFER", "many")
    with pytest.raises(ValueError, match="MLSPARK_INGEST_BUFFER"):
        P.IngestConfig.from_env()
    monkeypatch.setenv("MLSPARK_INGEST_BUFFER", "2")
    monkeypatch.setenv("MLSPARK_INGEST_TAIL", "wrap")
    with pytest.raises(ValueError, match="unknown ingest tail policy"):
        P.IngestConfig.from_env()


@pytest.mark.parametrize("knobs", [{"buffer": 4, "tail": "drop"}, {"device_prefetch": 0, "chunk_lines": "16"},
                                   {"bufer": 4}, {"tail": "wrap"}, {"buffer": -1}])
def test_validate_knobs_equals_jax(knobs):
    try:
        want = J.validate_ingest_knobs(knobs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0].strip()):
            P.validate_ingest_knobs(knobs)
    else:
        assert P.validate_ingest_knobs(knobs) == want


def test_pipeline_reads_rank_world_from_env(monkeypatch, rng):
    monkeypatch.setenv("MLSPARK_PROCESS_ID", "1")
    monkeypatch.setenv("MLSPARK_NUM_PROCESSES", "2")
    pipe = host(P, P.ArraySource(rng.normal(size=(8, 1)).astype(np.float32)), 2)
    assert (pipe.rank, pipe.world) == (1, 2)


def test_gang_ingest_env_plumbing():
    with pytest.raises(ValueError, match="ingest knob"):
        Distributor(num_processes=2, ingest={"bufer": 4})
    out = Distributor(num_processes=2, platform="cpu", timeout=120,
                      ingest={"buffer": 5, "tail": "drop"}).run("torch_launcher_workers:echo_ingest_env")
    assert out == {"buffer": 5, "tail": "drop", "rank": 0}
    assert kill_stray_gangs() == 0


def test_fit_emits_the_data_family_and_the_report_folds_it(rng, tmp_path):
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    telemetry.reset()
    try:
        ts, _, _ = _mlp_states()
        pipe = P.StreamingPipeline(P.ArraySource(rng.normal(size=(48, 4)).astype(np.float32),
                                                 rng.integers(0, 3, 48)), 8, tail="drop", device="cpu")
        tloop.fit(ts, tloop.classification_loss(), data=pipe, epochs=2, log_every=0)
        reg = telemetry.get_registry().snapshot()["data"]
        assert reg["records"] == 96 and reg["batches"] == 12 and reg["bytes_h2d"] > 0
        telemetry.write_rank_file(str(tmp_path), rank=0)
        report = aggregate.merge_gang_dir(str(tmp_path))
        ing = report["ingest"]
        assert {"data.read", "data.wait", "data.h2d"} <= set(ing["phases"])
        assert ing["counters"]["data.bytes_h2d"] and ing["buffer_occupancy"]
        assert ing["verdict"] in ("input-bound", "compute-bound")
        assert "## Ingest (data.*)" in aggregate.render_markdown(report)
    finally:
        telemetry.reset()
