"""Gang checkpoints in the port, held against the JAX package on the CPU.

- The checkpoint group's functions (``group_agreed_step``,
  ``group_durable_step``, ``sidecar_steps_of``, ``durable_steps_of``,
  ``pointed_step_of``, ``group_rank_dirs``, the agreement scope and
  ``newest_topology_stamp``) against the JAX ones on the same directory
  trees: a healthy group, a rank with no pointer, a torn newest payload
  on one rank, a missing sidecar, a stale ``ckpt_r2`` left by a bigger
  run, a stamp of another world size. They read only pointers, sidecars
  and the integer step directories, so the results must be equal.
- ``restore_latest_valid`` capped at the group-agreed step; a group with
  no agreed step is a fresh start.
- A crossed topology raises ``TopologyMismatch`` with the JAX message;
  ``elastic=True`` raises ``NotImplementedError`` naming
  ``train/reshard.py``.
- The recipe's resume count: a retried attempt finishes its own run, a
  new run trains its epochs on.
- In a 2-rank CPU gang: the MLP recipe trained 2 + 2 epochs with
  ``checkpoint_dir`` equals 4 epochs bit for bit, each rank in its own
  ``ckpt_r<rank>``.
- The fault drill's twin: ``Distributor(max_restarts=1)`` with rank 1
  crashed at step 9. The JAX drill itself fails on hosts whose orbax
  lacks the per-rank handler API, so the oracle is the port's unfaulted
  run (the JAX drill's own reference) together with the JAX group
  functions above; the final loss and parameters must be equal bit for
  bit (the JAX drill holds the loss to rtol 1e-6).
"""

import json
import logging
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.train import checkpoint as jckpt
from machine_learning_apache_spark_tpu_torch.launcher import Distributor
from machine_learning_apache_spark_tpu_torch.launcher.distributor import kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
from machine_learning_apache_spark_tpu_torch.recipes._common import resume_epochs
from machine_learning_apache_spark_tpu_torch.train import checkpoint as ckpt
from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss, fit
from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
from machine_learning_apache_spark_tpu_torch.utils import faults
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

SAMPLE = "assets/sample_multiclass_classification_data.txt"
STAMP_1 = {"world_size": 1, "dp_mode": "replicated", "mesh": None, "layout": None}
STAMP_2 = {"world_size": 2, "dp_mode": "replicated", "mesh": {"data": 2}, "layout": None}
STAMP_4 = {"world_size": 4, "dp_mode": "replicated", "mesh": {"data": 4}, "layout": None}


def _write_rank(d, steps, *, pointer=None, sidecars=None, stamp=STAMP_2, torn=()):
    """One rank directory: a step directory with a payload per step
    (``torn`` ones truncated), a sidecar per step in ``sidecars``
    (default: all), the ``latest`` pointer when given."""
    os.makedirs(d, exist_ok=True)
    for s in steps:
        os.makedirs(os.path.join(d, str(s)), exist_ok=True)
        with open(os.path.join(d, str(s), ckpt.PAYLOAD), "wb") as f:
            f.write(b"\x80" if s in torn else b"payload")
    for s in steps if sidecars is None else sidecars:
        with open(os.path.join(d, f"meta_{s}.json"), "w") as f:
            json.dump({"epoch": s // 4 - 1, "topology": stamp}, f)
    if pointer is not None:
        with open(os.path.join(d, ckpt.LATEST_POINTER), "w") as f:
            json.dump({"step": pointer}, f)


def _tree(root, case):
    r0, r1, r2 = (os.path.join(root, f"ckpt_r{k}") for k in range(3))
    if case == "healthy":
        _write_rank(r0, [4, 8], pointer=8)
        _write_rank(r1, [4, 8], pointer=8)
    elif case == "no_pointer":
        _write_rank(r0, [4, 8], pointer=8)
        _write_rank(r1, [4, 8])
    elif case == "torn_newest":
        # Rank 1 died writing step 8: its step directory is torn and its
        # pointer never moved past 4.
        _write_rank(r0, [4, 8], pointer=8)
        _write_rank(r1, [4, 8], pointer=4, sidecars=[4], torn=(8,))
    elif case == "missing_sidecar":
        _write_rank(r0, [4, 8, 12], pointer=12, sidecars=[4, 12])
        _write_rank(r1, [4, 8, 12], pointer=12)
    elif case == "stale_r2":
        # A bigger run left ckpt_r2 behind at an older step.
        _write_rank(r0, [8, 12], pointer=12)
        _write_rank(r1, [8, 12], pointer=12)
        _write_rank(r2, [4], pointer=4)
    elif case == "other_world":
        _write_rank(r0, [4, 8], pointer=8, stamp=STAMP_4)
        _write_rank(r1, [4, 8], pointer=8, stamp=STAMP_4)
    return {0: r0, 1: r1, 2: r2}


CASES = ["healthy", "no_pointer", "torn_newest", "missing_sidecar", "stale_r2", "other_world"]


def _manager_view(cls, directory):
    """``cls``'s group methods over ``directory`` without constructing a
    manager (the JAX one would open orbax on it): they read only paths."""
    view = types.SimpleNamespace(directory=os.path.abspath(directory))
    view.group_rank_dirs = lambda: cls.group_rank_dirs(view)
    view._group_scope = lambda: cls._group_scope(view)
    return view


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_group_functions_equal_jax(tmp_path, case, world, monkeypatch):
    dirs = _tree(str(tmp_path), case)
    present = {k: d for k, d in dirs.items() if os.path.isdir(d)}
    for d in present.values():
        assert ckpt.pointed_step_of(d) == jckpt.pointed_step_of(d)
        assert ckpt.sidecar_steps_of(d) == jckpt.sidecar_steps_of(d)
        assert ckpt.durable_steps_of(d) == jckpt.durable_steps_of(d)
        for s in ckpt.durable_steps_of(d):
            assert ckpt.read_meta_at(d, s) == jckpt.read_meta_at(d, s)
    scopes = [present, {k: present.get(k) for k in range(2)}, {0: present[0], 1: None}]
    for scope in scopes:
        assert ckpt.group_agreed_step(scope) == jckpt.group_agreed_step(scope)
        assert ckpt.group_durable_step(scope) == jckpt.group_durable_step(scope)
        assert ckpt.group_durable_step(scope, meta_dir=present[0]) == \
            jckpt.group_durable_step(scope, meta_dir=present[0])
    # The agreement scope: in a gang exactly the current world's ranks,
    # offline every sibling present.
    monkeypatch.setattr(ckpt, "_world_size", lambda: world)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for d in present.values():
        mine = _manager_view(ckpt.CheckpointManager, d)
        theirs = _manager_view(jckpt.CheckpointManager, d)
        assert mine.group_rank_dirs() == theirs.group_rank_dirs()
        assert mine._group_scope() == theirs._group_scope()
        assert ckpt.CheckpointManager.newest_topology_stamp(mine) == \
            jckpt.CheckpointManager.newest_topology_stamp(theirs)
    loose = os.path.join(str(tmp_path), "not_a_group")
    _write_rank(loose, [4], pointer=4, stamp=STAMP_1)
    assert _manager_view(ckpt.CheckpointManager, loose).group_rank_dirs() is None
    assert ckpt.CheckpointManager.newest_topology_stamp(
        _manager_view(ckpt.CheckpointManager, loose)
    ) == STAMP_1


def _state(seed=0, lr=0.1):
    model = MLP((4, 8, 3), generator=torch.Generator().manual_seed(seed))
    return TrainState.create(model=model, tx=make_optimizer("sgd", lr))


def _batches(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 3, 8))
        for _ in range(n)
    ]


def _gang_trees(root, world=2):
    """Real port checkpoints of a 2-rank group (steps 4 and 8 on both),
    stamped as a world-2 gang."""
    dirs = {}
    for r in range(world):
        state = _state()
        with ckpt.CheckpointManager(os.path.join(root, f"ckpt_r{r}")) as mgr:
            for step in (4, 8):
                state.step = step
                with torch.no_grad():
                    next(state.model.parameters()).add_(1.0)
                mgr.save(state, meta={"epoch": step // 4 - 1, "topology": STAMP_2})
            dirs[r] = mgr.directory
    return dirs


def test_restore_is_capped_at_the_group_agreed_step(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "_world_size", lambda: 2)
    monkeypatch.setattr(ckpt, "topology_stamp", lambda state=None: STAMP_2)
    dirs = _gang_trees(str(tmp_path))
    # Rank 1's pointer stands at step 4: rank 0 must not restore its 8.
    with open(os.path.join(dirs[1], ckpt.LATEST_POINTER), "w") as f:
        json.dump({"step": 4}, f)
    scope = {r: dirs[r] for r in (0, 1)}
    assert ckpt.group_agreed_step(scope) == jckpt.group_agreed_step(scope) == 4
    for r in (0, 1):
        state = _state()
        _, step, meta = ckpt.CheckpointManager(dirs[r]).restore_latest_valid(state)
        assert step == 4 and meta["epoch"] == 0 and state.step == 4
    # No pointer on rank 1: no step every rank agrees on, a fresh start on
    # each rank, logged as the JAX manager logs it.
    os.unlink(os.path.join(dirs[1], ckpt.LATEST_POINTER))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    ckpt.log.addHandler(handler)
    try:
        assert ckpt.CheckpointManager(dirs[0]).restore_latest_valid(_state()) is None
    finally:
        ckpt.log.removeHandler(handler)
    assert any("has no step complete on every rank; starting fresh" in m for m in seen)
    # The read of a peer's step without a manager on it.
    assert ckpt.read_raw_payload(dirs[1], 8)["step"] == 8


def test_topology_stamp_names_the_world_and_the_mesh(monkeypatch):
    state = _state()
    assert ckpt.topology_stamp(state) == STAMP_1
    monkeypatch.setattr(ckpt, "_world_size", lambda: 2)
    state.mesh = types.SimpleNamespace(shape={"data": 2})
    assert ckpt.topology_stamp(state) == STAMP_2
    assert ckpt.same_topology(ckpt.topology_stamp(state), STAMP_2)
    assert jckpt.same_topology(ckpt.topology_stamp(state), STAMP_2)
    assert ckpt.detached_payload(state)["model"]["dense_0.weight"].device.type == "cpu"


def test_crossed_topology_raises(tmp_path):
    batches = _batches()
    d = str(tmp_path / "ckpt")
    with ckpt.CheckpointManager(d) as mgr:
        fit(_state(), classification_loss(), batches, epochs=1, checkpointer=mgr, log_every=0)
    # The run is now a different topology from the one on disk.
    meta_path = os.path.join(d, "meta_4.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["topology"] = STAMP_2
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with ckpt.CheckpointManager(d) as mgr:
        with pytest.raises(ckpt.TopologyMismatch, match="written by a different topology") as e:
            fit(_state(), classification_loss(), batches, epochs=2, checkpointer=mgr,
                resume=True, log_every=0)
    assert str(STAMP_2) in str(e.value) and str(STAMP_1) in str(e.value)
    with ckpt.CheckpointManager(d) as mgr:
        with pytest.raises(NotImplementedError, match="train/reshard.py"):
            fit(_state(), classification_loss(), batches, epochs=2, checkpointer=mgr,
                resume=True, elastic=True, log_every=0)


def test_resume_epochs_finishes_a_retried_run_and_extends_a_new_one(tmp_path):
    state = _state()
    with ckpt.CheckpointManager(str(tmp_path), run="gang-a") as mgr:
        state.step = 4
        mgr.save(state, meta={"epoch": 0, "epochs": 2})
    assert ckpt.read_meta_at(str(tmp_path), 4)["run"] == "gang-a"
    # A retried attempt of run gang-a finishes its 2 epochs.
    assert resume_epochs(ckpt.CheckpointManager(str(tmp_path), run="gang-a"), 4, 2) == 2
    # A new run (or one outside a gang) trains 2 epochs on from epoch 0.
    assert resume_epochs(ckpt.CheckpointManager(str(tmp_path), run="gang-b"), 4, 2) == 3
    assert resume_epochs(ckpt.CheckpointManager(str(tmp_path)), 4, 2) == 3


def test_gang_recipe_two_plus_two_epochs_equal_four(tmp_path):
    ranks = Distributor(num_processes=2, platform="cpu", timeout=300).run(
        "torch_launcher_workers:mlp_recipe_two_plus_two", str(tmp_path), SAMPLE,
    )
    assert kill_stray_gangs() == 0
    for rank in ranks:
        runs = rank["runs"]
        assert runs["first"]["resumed_from_step"] is None
        assert runs["whole"]["resumed_from_step"] is None
        # The second run resumed the first's last step and trained 2 more.
        first_steps = len(runs["first"]["step_losses"])
        assert runs["second"]["resumed_from_step"] == first_steps
        assert runs["second"]["step_losses"] == runs["whole"]["step_losses"][first_steps:]
        for name, leaf in runs["whole"]["params"].items():
            for key in leaf:
                np.testing.assert_array_equal(runs["second"]["params"][name][key], leaf[key])
        # Each rank checkpoints in its own ckpt_r<rank>, nothing else.
        assert runs["second"]["dirs"] == ["ckpt_r0", "ckpt_r1"]
    # The replicas agree.
    for name, leaf in ranks[0]["runs"]["second"]["params"].items():
        for key in leaf:
            np.testing.assert_array_equal(ranks[1]["runs"]["second"]["params"][name][key],
                                          leaf[key])
    meta = ckpt.read_meta_at(str(tmp_path / "split" / "ckpt_r1"), 2 * first_steps)
    assert meta["topology"] == STAMP_2 and meta["epoch"] == 3


def test_fault_drill_crash_retry_resumes_and_matches_unfaulted(tmp_path, monkeypatch):
    """Kill rank 1 with an injected hard crash (``os._exit``) inside epoch
    2; the gang is retried whole, the crashed rank resumes from its group
    checkpoint, and every rank ends where the unfaulted run ends."""
    import torch_launcher_workers

    ref = torch_launcher_workers.fault_drill_train(str(tmp_path / "ref"), device="cpu")
    assert ref["resumed_step"] is None
    markers = tmp_path / "markers"
    monkeypatch.setenv(faults.ENV_PLAN, "crash@train_step:rank=1,step=9")
    monkeypatch.setenv(faults.ENV_MARKER_DIR, str(markers))
    out = Distributor(
        num_processes=2, platform="cpu", timeout=300, max_restarts=1,
        backoff_base=0.05, term_grace=2.0,
    ).run("torch_launcher_workers:fault_drill_train", str(tmp_path / "gang"))
    assert kill_stray_gangs() == 0
    assert out["rank"] == 0
    assert list(markers.iterdir()), "crash fault never fired"
    crashed = out["ranks"][1]
    # Rank 1 saved steps 4 and 8 before its crash at step 9. The ranks
    # train apart (no mesh), so how far rank 0 got before the teardown is
    # timing: rank 1 resumes the agreed step, and starts over only when
    # rank 0 had no checkpoint to agree on, in which case rank 0 did too.
    assert crashed["resumed_step"] in (None, 4, 8)
    assert crashed["resumed_step"] is not None or out["ranks"][0]["resumed_step"] is None
    for rank in out["ranks"]:
        assert rank["final_loss"] == ref["final_loss"]
        assert rank["epochs_run"] >= 1
        for name, leaf in ref["params"].items():
            for key in leaf:
                np.testing.assert_array_equal(rank["params"][name][key], leaf[key])
    shutil.rmtree(tmp_path / "gang", ignore_errors=True)
