"""Elastic resume in the port (``machine_learning_apache_spark_tpu_torch.train.reshard``)
against the JAX package, on the CPU.

- the layout algebra: ``BucketLayout``, ``gather_spec`` and
  ``reshard_flat`` against the JAX ``BucketLayout``, ``gather_spec`` and
  ``reshard_flat_oracle``, bit for bit, over the grid of the JAX
  ``tests/test_reshard.py::TestGatherSpec``;
- ``elastic_restore`` on checkpoint groups written by real gangs: a
  3-rank group (replicated SGD and ZeRO-1 Adam, several buckets) restored
  onto 2 ranks and back onto 3 is bit-identical in the logical state —
  the parameters, and the flat moments read through ``zero.py``'s own
  bucket map (``Zero1State.bucket_span``) — and a ``{data: 2, model: 2}``
  hybrid ZeRO-1 group onto ``{data: 1, model: 2}`` and back, each rank
  held against the old ranks of its own model coordinate; a crossed
  resume without ``elastic`` names both topologies; what the JAX module
  refuses is refused; after two shrinks the agreed step's own stamp is
  the one resharded from (``_agreed_step_and_stamp``, against the JAX
  function on the same directories);
- the shrink drill: ``Distributor(num_processes=3, elastic=True,
  rank_restart_budget=0, elastic_min_world=2)`` with rank 2 crashed
  mid-run reshards its ZeRO-1 checkpoints onto 2 ranks and finishes on
  the JAX replicated ``fit``'s parameters over the same global batches
  (SGD, atol 1e-5).

The JAX package's own elastic restore (``TestElasticRestoreOnVirtualMeshes``)
does not run on this jax (its ZeRO-1 step, ``zero.py:736``), so the
oracles here are its flat functions, its ``_agreed_step_and_stamp`` and
its replicated ``fit``, as ``tests/test_torch_zero.py`` does for ZeRO-1.
The gangs run once for the module, in a thread, while the JAX oracles
run in the main one.
"""

import json
import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu import ingest as J
from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import reshard as jreshard
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch import ingest as P
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models import MLP
from machine_learning_apache_spark_tpu_torch.parallel import mesh as mesh_mod
from machine_learning_apache_spark_tpu_torch.parallel import zero
from machine_learning_apache_spark_tpu_torch.train import checkpoint as tckpt
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import reshard
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.utils import faults
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_like,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL = 1e-5
LAYERS = (4, 8, 3)
HYBRID_LAYERS = (4, 8, 6)  # the model axis of 2 divides both widths
GLOBAL = 12  # lcm(3, 2) x 2: every world on the shrink path slices the same rows
EPOCHS = 6  # one global batch a fit epoch: a checkpoint every step
LR = 0.1
BUCKET_BYTES = 64  # several buckets: the copies cross bucket seams
GROUP_STEP = 2  # the groups' 2 epochs


# -- the layout algebra ---------------------------------------------------------------


def _stored_shards(layout, logical):
    shards = [np.zeros(layout.shard_len, dtype=logical.dtype) for _ in range(layout.world)]
    for lo, hi, i, base in layout.segments():
        hi = min(hi, layout.total)
        if lo < hi:
            shards[i][base:base + (hi - lo)] = logical[lo:hi]
    return shards


def test_bucket_layout_mirrors_the_plan_and_the_jax_layout():
    params = list(MLP(LAYERS).parameters())
    total = sum(p.numel() for p in params)
    for world, bb in [(8, 128), (4, 128), (2, 64), (3, 64), (8, 1 << 20)]:
        layout = reshard.BucketLayout.create(total, world, bb)
        assert layout.to_json() == zero.plan_layout(zero.make_flat_plan(params, world, bb))
        assert layout.to_json() == jreshard.BucketLayout.create(total, world, bb).to_json()
        assert reshard.BucketLayout.from_json(layout.to_json()) == layout
    layout = reshard.BucketLayout.create(1000, 8, 256)
    covered = np.zeros(layout.padded, dtype=int)
    for lo, hi, shard, base in layout.segments():
        assert 0 <= shard < layout.world and base + (hi - lo) <= layout.shard_len
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)
    assert list(layout.segments()) == list(jreshard.BucketLayout.create(1000, 8, 256).segments())
    with pytest.raises(ValueError, match="inconsistent layout"):
        reshard.BucketLayout(total=10, world=2, padded=12, shard_len=5, buckets=((0, 12),))
    with pytest.raises(ValueError, match="partition"):
        reshard.BucketLayout(total=10, world=2, padded=12, shard_len=6, buckets=((0, 10),))


GRID = [(1000, 8, 4, 64), (1000, 4, 8, 64), (1000, 8, 6, 64), (1000, 6, 8, 64), (1000, 8, 8, 64),
        (37, 8, 3, 64), (37, 3, 8, 64), (1000, 8, 4, 1 << 20)]


@pytest.mark.parametrize("total,sw,dw,bb", GRID)
def test_reshard_flat_equals_the_jax_oracle_bit_for_bit(total, sw, dw, bb):
    src, dst = reshard.BucketLayout.create(total, sw, bb), reshard.BucketLayout.create(total, dw, bb)
    jsrc, jdst = jreshard.BucketLayout.create(total, sw, bb), jreshard.BucketLayout.create(total, dw, bb)
    logical = np.random.default_rng(total + sw + dw).standard_normal(total).astype(np.float32)
    shards = _stored_shards(src, logical)
    spec = reshard.gather_spec(src, dst)
    assert spec == jreshard.gather_spec(jsrc, jdst)
    assert reshard.spec_byte_ranges(spec) == jreshard.spec_byte_ranges(spec)
    got = reshard.reshard_flat(shards, src, dst)
    for g, o, w in zip(got, reshard.reshard_flat_oracle(shards, src, dst),
                       jreshard.reshard_flat_oracle(shards, jsrc, jdst)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(o, w)
    for g, w in zip(got, _stored_shards(dst, logical)):
        np.testing.assert_array_equal(g, w)


def test_gather_spec_edges():
    a = reshard.BucketLayout.create(100, 4, 64)
    spec = reshard.gather_spec(a, a)
    assert all(i == j and so == do for j, copies in enumerate(spec) for i, so, do, _ in copies)
    with pytest.raises(ValueError, match="different vectors"):
        reshard.gather_spec(a, reshard.BucketLayout.create(101, 4, 64))
    with pytest.raises(ValueError, match="expected 4 shards"):
        reshard.reshard_flat([np.zeros(a.shard_len)] * 3, a, reshard.BucketLayout.create(100, 2, 64))


def test_resolve_elastic(monkeypatch):
    monkeypatch.setenv("MLSPARK_ELASTIC", "1")
    assert reshard.resolve_elastic(False) is False and reshard.resolve_elastic(True) is True
    assert reshard.resolve_elastic(None) is True
    for raw, want in [("1", True), ("true", True), ("0", False), ("off", False), ("YES", True)]:
        monkeypatch.setenv("MLSPARK_ELASTIC", raw)
        assert reshard.resolve_elastic(None) is want
    monkeypatch.delenv("MLSPARK_ELASTIC")
    assert reshard.resolve_elastic(None) is False
    assert reshard.TopologyMismatch is tckpt.TopologyMismatch


# -- the gangs --------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = rng.integers(0, 3, 60).astype(np.int64)
    tree = random_flax_like(MLP(LAYERS), 11)
    tree_h = random_flax_like(MLP(HYBRID_LAYERS), 12)
    return x, y, jax.tree.map(np.array, tree), jax.tree.map(np.array, tree_h)


def _jax_fit(tree, x, y, epochs, opt="sgd"):
    """The JAX replicated fit on the global batches: one process, the
    whole global batch a step, from a JAX streaming pipeline."""
    jm = JMLP(layers=LAYERS)
    state = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
                                     tx=jstate.make_optimizer(opt, LR))
    mix = J.MixtureSampler({"rows": J.ArraySource(x, y)}, records_per_epoch=GLOBAL)
    res = jloop.fit(state, jloop.classification_loss(jm.apply), epochs=epochs, log_every=0,
                    data=J.StreamingPipeline(mix, GLOBAL, device=False), emit=lambda s: None)
    return jax.tree.map(np.asarray, res.state.params)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    x, y, tree, tree_h = _inputs()
    root = tmp_path_factory.mktemp("elastic")
    got: dict = {}

    def run():
        try:
            env = {"OMP_NUM_THREADS": "1",
                   faults.ENV_PLAN: "crash@train_step:world=3,rank=2,step=3",
                   faults.ENV_MARKER_DIR: str(root / "markers")}
            got["drill"] = Distributor(
                num_processes=3, platform="cpu", timeout=300, env=env, elastic=True,
                rank_restart_budget=0, elastic_min_world=2, backoff_base=0.05, term_grace=1.0,
            ).run("torch_launcher_workers:elastic_drill", str(root / "drill"), LAYERS, tree, x, y,
                  GLOBAL, EPOCHS, LR, BUCKET_BYTES, str(root / "groups"))
            got["hybrid"] = Distributor(
                num_processes=4, platform="cpu", timeout=300, env={"OMP_NUM_THREADS": "1"},
            ).run("torch_launcher_workers:hybrid_ckpt_group", str(root / "hybrid"), HYBRID_LAYERS,
                  tree_h, x, y, GLOBAL, LR, BUCKET_BYTES)
        except BaseException as e:  # noqa: BLE001 - re-raised in the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        oracle = {n: _jax_fit(tree, x, y, n) for n in (GROUP_STEP, 4, EPOCHS)}
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    assert kill_stray_gangs() == 0
    return dict(got, oracle=oracle, root=root, x=x, y=y, tree=tree, tree_h=tree_h)


def _close(params, want):
    got = jax.tree_util.tree_leaves(params)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL, rtol=0)


def test_shrink_drill_matches_the_jax_fit(gangs):
    out = gangs["drill"]
    assert out["world"] == 2 and out["step"] == EPOCHS
    assert out["resumed"] in (2, 3)  # the newest step durable on all 3 old ranks
    assert len(out["step_losses"]) == EPOCHS - out["resumed"]
    names = [e["name"] for e in out["events"]]
    assert names == ["train.elastic_restore", "train.elastic_resume"]
    resume = out["events"][1]
    assert (resume["old_world"], resume["new_world"], resume["dp_mode"]) == (3, 2, "zero1")
    assert out["events"][0]["bytes_read"] > 0
    assert out["threads"] == []
    flat = {tuple(k.split("/")): v for k, v in out["params"].items()}
    want = {k: v for k, v in zip(*_paths_and_leaves(gangs["oracle"][EPOCHS]))}
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(flat[k], want[k], atol=ATOL, rtol=0)


def _paths_and_leaves(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return [tuple(p.key for p in path) for path, _ in leaves], [np.asarray(v) for _, v in leaves]


# -- elastic_restore on the groups --------------------------------------------------------


def _logical(stored: dict, plan, model_ways: int = 1) -> dict:
    """Each model index's logical flat vector (the parameters' order,
    pads taken out) from the ranks' stored vectors ``{(d, m): vec}``,
    read through ``zero.py``'s own map of a rank's pieces."""
    out = {}
    for m in range(model_ways):
        full = np.zeros(plan.padded, np.float32)
        for (d, mm), vec in stored.items():
            ns = types.SimpleNamespace(plan=plan, rank=d, model_rank=mm)
            for k in range(len(plan.buckets)):
                if plan.subs[k] == 1 and mm != m:
                    continue
                in_flat, in_shard = zero.Zero1State.bucket_span(ns, k)
                full[in_flat] = np.asarray(vec)[in_shard]
        out[m] = np.concatenate([full[o:o + n] for o, n in zip(plan.offsets, plan.sizes)])
    return out


def _as_rank(monkeypatch, rank: int, world: int):
    monkeypatch.setattr(tckpt, "_world_size", lambda: world)
    monkeypatch.setattr(mesh_mod, "process_index", lambda: rank)


def _template(name, world, tree):
    model = load_flax_params(MLP(LAYERS), tree)
    state = tstate.TrainState.create(model=model, tx=tstate.make_optimizer(
        "adam" if name == "zero1" else "sgd", LR))
    mesh = mesh_mod.make_mesh({"data": world}, world=world, device="cpu")
    if name == "zero1":
        state = zero.shard_optimizer_state(state, mesh, zero.Zero1Config(bucket_bytes=BUCKET_BYTES))
    state.mesh = mesh
    return state


def _restore_onto(monkeypatch, group_root, name, world, tree):
    """``elastic_restore`` of the group under ``group_root`` onto each rank
    of a ``world``-rank gang, each through its own manager."""
    out = []
    for rank in range(world):
        _as_rank(monkeypatch, rank, world)
        with tckpt.CheckpointManager(os.path.join(group_root, f"ckpt_r{rank}")) as ck:
            stamp = ck.newest_topology_stamp()
            out.append(reshard.elastic_restore(ck, _template(name, world, tree), old_stamp=stamp))
    return out


def _old_payloads(group_root, world, step=GROUP_STEP):
    return [tckpt.read_raw_payload(os.path.join(group_root, f"ckpt_r{r}"), step) for r in range(world)]


def _flat_keys(payload, plan):
    return [k for k, v in payload["optimizer"].items()
            if isinstance(v, torch.Tensor) and v.ndim == 1 and v.numel() == plan.shard_len]


@pytest.mark.parametrize("name", ["replicated", "zero1"])
def test_elastic_restore_3_to_2_and_back_is_bit_identical(gangs, name, monkeypatch, tmp_path):
    group = str(gangs["root"] / "groups" / name)
    old = _old_payloads(group, 3)
    params = list(MLP(LAYERS).parameters())
    restored = _restore_onto(monkeypatch, group, name, 2, gangs["tree"])
    assert [r[1] for r in restored] == [GROUP_STEP, GROUP_STEP]
    assert all(r[2]["topology"]["world_size"] == 3 and "ingest" in r[2] for r in restored)
    for state, _, _ in restored:  # the parameters adopt from old rank 0
        got = state.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in old[0]["model"].items())
        assert state.step == old[0]["step"] == GROUP_STEP
    if name == "replicated":
        # The 3-rank group trained as the JAX replicated fit does.
        _close(export_flax_params(restored[0][0].model), gangs["oracle"][GROUP_STEP])
    plans = {3: zero.make_flat_plan(params, 3, BUCKET_BYTES), 2: zero.make_flat_plan(params, 2, BUCKET_BYTES)}
    if name == "zero1":
        keys = _flat_keys(old[0], plans[3])
        assert sorted(keys) == ["exp_avg", "exp_avg_sq"] and len(plans[3].buckets) > 1
        for key in keys:
            want = _logical({(r, 0): old[r]["optimizer"][key] for r in range(3)}, plans[3])
            got = _logical({(r, 0): s.opt_state[key] for r, (s, _, _) in enumerate(restored)}, plans[2])
            np.testing.assert_array_equal(got[0], want[0])
    # ... and back onto 3 ranks from a group the 2 ranks write.
    back_root = tmp_path / "two"
    for rank, (state, step, meta) in enumerate(restored):
        _as_rank(monkeypatch, rank, 2)
        with tckpt.CheckpointManager(str(back_root / f"ckpt_r{rank}")) as ck:
            ck.save(state, meta={k: v for k, v in meta.items() if k != "topology"})
    again = _restore_onto(monkeypatch, str(back_root), name, 3, gangs["tree"])
    for rank, (state, step, _) in enumerate(again):
        assert step == GROUP_STEP
        payload = state.state_dict()
        assert all(torch.equal(payload["model"][k], v) for k, v in old[rank]["model"].items())
        for key in (_flat_keys(old[rank], plans[3]) if name == "zero1" else []):
            assert torch.equal(payload["optimizer"][key], old[rank]["optimizer"][key])


def test_hybrid_group_reshards_against_its_own_model_coordinates(gangs, tmp_path):
    out = gangs["hybrid"]
    # The ranks of a model line read the same rows: their data index's.
    assert [c[1] for c in out["coords"]] == [(c[0]["data"], 2) for c in out["coords"]]
    old_stamp = out["stamp"]
    assert old_stamp["mesh"] == {"data": 2, "model": 2} and old_stamp["layout"]["subs"]
    group = str(gangs["root"] / "hybrid")
    old_dirs = {r: os.path.join(group, f"ckpt_r{r}") for r in range(4)}
    old = {(r // 2, r % 2): tckpt.read_raw_payload(old_dirs[r], out["step"]) for r in range(4)}
    shapes, n = out["shapes"], out["n_sharded"]

    def plan(d):
        return zero.make_hybrid_plan([np.zeros(s) for s in shapes[:n]], [np.zeros(s) for s in shapes[n:]],
                                     d, 2, BUCKET_BYTES)

    assert zero.plan_layout(plan(2)) == old_stamp["layout"]
    new_stamp = {"world_size": 2, "dp_mode": "zero1", "mesh": {"data": 1, "model": 2},
                 "layout": zero.plan_layout(plan(1))}
    keys = [k for k, v in old[(0, 0)]["optimizer"].items() if getattr(v, "ndim", 0) == 1]
    assert sorted(keys) == ["exp_avg", "exp_avg_sq"]
    new = {}
    for m in range(2):
        payload, read = reshard.restore_payload(old_dirs, out["step"], old_stamp, new_stamp,
                                                {"data": 0, "model": m})
        assert read > 0
        # Each model index's parameters (its shards) from the old ranks of
        # its own model coordinate.
        assert all(torch.equal(payload["model"][k], v) for k, v in old[(0, m)]["model"].items())
        new[(0, m)] = payload
    for key in keys:
        want = _logical({c: p["optimizer"][key] for c, p in old.items()}, plan(2), 2)
        got = _logical({c: p["optimizer"][key] for c, p in new.items()}, plan(1), 2)
        for m in range(2):
            np.testing.assert_array_equal(got[m], want[m])
    # ... and back onto {data: 2, model: 2}: the old ranks' vectors, bit for bit.
    new_dirs = {}
    for (d, m), payload in new.items():
        new_dirs[m] = str(tmp_path / f"ckpt_r{m}")
        os.makedirs(os.path.join(new_dirs[m], str(out["step"])))
        torch.save(payload, os.path.join(new_dirs[m], str(out["step"]), tckpt.PAYLOAD))
    for (d, m), want in old.items():
        payload, _ = reshard.restore_payload(new_dirs, out["step"], new_stamp, old_stamp, {"data": d, "model": m})
        assert all(torch.equal(payload["model"][k], v) for k, v in want["model"].items())
        for key in keys:
            assert torch.equal(payload["optimizer"][key], want["optimizer"][key])
    # Another model-axis size is not a data-axis change: refused.
    with pytest.raises(reshard.TopologyMismatch, match="only the data axis reshards"):
        reshard.restore_payload(old_dirs, out["step"], old_stamp,
                                {**new_stamp, "mesh": {"data": 2, "model": 1}}, {"data": 0})


def test_crossed_resume_without_elastic_names_both_topologies(gangs, monkeypatch):
    monkeypatch.delenv("MLSPARK_ELASTIC", raising=False)
    group = str(gangs["root"] / "groups" / "replicated")
    with tckpt.CheckpointManager(os.path.join(group, "ckpt_r0")) as ck:
        with pytest.raises(tckpt.TopologyMismatch) as e:
            tloop.fit(_template("replicated", 1, gangs["tree"]), tloop.classification_loss(), [],
                      epochs=3, checkpointer=ck, resume=True, log_every=0)
    msg = str(e.value)
    assert "'world_size': 3" in msg and "'world_size': 1" in msg and "'data': 3" in msg
    assert "elastic" in msg


def test_elastic_fit_resumes_a_3_rank_group_in_one_process(gangs, tmp_path):
    """The 3-rank replicated group resumed by one process under
    ``elastic=True`` (world 3 -> 1): it trains on from step 2 over the
    stream's state and ends on the JAX replicated fit's 4 epochs."""
    root = tmp_path / "group"
    shutil.copytree(gangs["root"] / "groups" / "replicated", root)
    state = tstate.TrainState.create(model=load_flax_params(MLP(LAYERS), gangs["tree"]),
                                     tx=tstate.make_optimizer("sgd", LR))
    mix = P.MixtureSampler({"rows": P.ArraySource(gangs["x"], gangs["y"])}, records_per_epoch=GLOBAL)
    with tckpt.CheckpointManager(str(root / "ckpt_r0")) as ck:
        res = tloop.fit(state, tloop.classification_loss(), data=P.StreamingPipeline(mix, GLOBAL, device="cpu"),
                        epochs=4, checkpointer=ck, resume=True, elastic=True, log_every=0)
    assert res.resumed_step == GROUP_STEP and res.state.step == 4
    _close(export_flax_params(res.state.model), gangs["oracle"][4])


def test_two_shrinks_reshard_from_the_agreed_steps_own_stamp(gangs, monkeypatch, tmp_path):
    """After a 3 -> 2 shrink whose own step never became durable on
    every rank, the newest sidecar names the 2-rank gang; the restore
    takes the newest step durable on the gang its own stamp names (the
    3-rank step 2) and reshards from that stamp — as the JAX function
    picks on the same directories."""
    root = tmp_path / "group"
    shutil.copytree(gangs["root"] / "groups" / "zero1", root)
    dirs = {r: str(root / f"ckpt_r{r}") for r in range(3)}
    three = tckpt.read_meta_at(dirs[0], GROUP_STEP)["topology"]
    two = {**three, "world_size": 2, "mesh": {"data": 2},
           "layout": zero.plan_layout(zero.make_flat_plan(list(MLP(LAYERS).parameters()), 2, BUCKET_BYTES))}
    for r in (0, 1):  # the 2-rank gang's step 3: sidecars, a payload on rank 0 only
        with open(os.path.join(dirs[r], "meta_3.json"), "w") as f:
            json.dump({"epoch": 2, "topology": two}, f)
    shutil.copytree(os.path.join(dirs[0], str(GROUP_STEP)), os.path.join(dirs[0], "3"))
    with open(os.path.join(dirs[0], tckpt.LATEST_POINTER), "w") as f:
        json.dump({"step": 3}, f)
    got = reshard._agreed_step_and_stamp(dirs, two)
    assert got == (GROUP_STEP, three) == jreshard._agreed_step_and_stamp(dirs, two)
    with tckpt.CheckpointManager(dirs[0]) as ck:
        assert ck.newest_topology_stamp() == two
    direct = _restore_onto(monkeypatch, gangs["root"] / "groups" / "zero1", "zero1", 2, gangs["tree"])
    shrunk = _restore_onto(monkeypatch, root, "zero1", 2, gangs["tree"])
    for (a, sa, _), (b, sb, _) in zip(direct, shrunk):
        assert sa == sb == GROUP_STEP
        pa, pb = a.state_dict(), b.state_dict()
        assert all(torch.equal(pa["optimizer"][k], pb["optimizer"][k]) for k in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("change,match", [
    (dict(dp_mode="replicated", layout=None), "dp_mode"),
    (dict(mesh={"data": 1, "model": 2}), "only the data axis reshards"),
    (dict(layout_total=7), "a different model/optimizer"),
])
def test_what_the_jax_module_refuses_is_refused(gangs, change, match):
    old = tckpt.read_meta_at(str(gangs["root"] / "groups" / "zero1" / "ckpt_r0"), GROUP_STEP)["topology"]
    new = {**old, "world_size": 2, "mesh": {"data": 2}}
    new["layout"] = dict(old["layout"], total=change.pop("layout_total", old["layout"]["total"]))
    new.update(change)
    with pytest.raises(reshard.TopologyMismatch, match=match) as e:
        reshard.check_reshardable(old, new)
    assert str(old) in str(e.value) and str(new) in str(e.value)
