"""The port's launcher (``launcher.{coordinator,runner,distributor,monitor}``)
held against the JAX package's on the same inputs: the rendezvous env, the
per-host commands, the heartbeat files each writes for the other's
reader; then real 2-rank gloo gangs on the CPU — rank 0's result, a rank's
failure named, a whole-gang restart, an unpicklable result — each leaving
no stray process group, and the knobs that stay unported raising with
their ROADMAP items.

Gang workers live in ``tests/torch_launcher_workers.py`` (no JAX).
"""

import os
import sys
import time
import types

import pytest

from machine_learning_apache_spark_tpu.launcher import Distributor as JaxDistributor
from machine_learning_apache_spark_tpu.launcher.coordinator import (
    RendezvousSpec as JaxSpec,
)
from machine_learning_apache_spark_tpu.launcher.monitor import (
    read_heartbeat as jax_read_heartbeat,
)
from machine_learning_apache_spark_tpu.launcher.runner import (
    _start_heartbeat as jax_start_heartbeat,
)
from machine_learning_apache_spark_tpu_torch.launcher import (
    Distributor,
    GangFailure,
    RendezvousSpec,
    choose_backend,
    fn_reference,
    kill_stray_gangs,
    read_heartbeat,
)
from machine_learning_apache_spark_tpu_torch.launcher.distributor import WorkerResult, gang_failure
from machine_learning_apache_spark_tpu_torch.launcher.runner import _start_heartbeat
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

PORT = "machine_learning_apache_spark_tpu_torch"
JAX = "machine_learning_apache_spark_tpu"


@pytest.mark.parametrize("spec", [("h:29500", 8, 3), ("10.0.0.1:1234", 2, 0), ("host", 4, 1)])
def test_apply_env_equals_the_jax_dict(spec):
    assert RendezvousSpec(*spec).apply_env({}) == JaxSpec(*spec).apply_env({})


@pytest.mark.parametrize(
    "env",
    [
        {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "2"},
        {"MLSPARK_COORDINATOR": "h:7", "MLSPARK_NUM_PROCESSES": "3", "MLSPARK_PROCESS_ID": "1"},
        {"MLSPARK_COORDINATOR": "h:7", "MLSPARK_NUM_PROCESSES": "1"},
        {},
    ],
    ids=["torch-style", "mlspark", "world-1", "none"],
)
def test_from_env_equals_jax(env, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "MLSPARK_COORDINATOR", "MLSPARK_NUM_PROCESSES", "MLSPARK_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = RendezvousSpec.from_env(), JaxSpec.from_env()
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert vars(ours) == vars(theirs)


def test_commands_for_hosts_are_jax_with_the_module_swapped():
    hosts = ["node0", "node1", "node2"]
    ours = Distributor(3).commands_for_hosts("m.n:train", hosts, coordinator_port=4321)
    theirs = JaxDistributor(3).commands_for_hosts("m.n:train", hosts, coordinator_port=4321)
    assert ours == [c.replace(f"-m {JAX}.launcher", f"-m {PORT}.launcher") for c in theirs]


def test_fn_reference_rules():
    assert fn_reference("a.b:c") == "a.b:c"
    with pytest.raises(ValueError):
        fn_reference("no_colon")
    with pytest.raises(ValueError):
        fn_reference(lambda: None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heartbeat_files_cross_read(writer, tmp_path):
    """The port's beat is read by the JAX reader, and the other way round:
    one payload format (rank, pid, wall, phase, step, http_port, world)."""
    hb = tmp_path / "heartbeat_3"
    start, reader = (
        (_start_heartbeat, jax_read_heartbeat) if writer == "port"
        else (jax_start_heartbeat, read_heartbeat)
    )
    start(str(hb), 0.05, rank=3, world=4)
    deadline = time.monotonic() + 5.0
    payload = {}
    while time.monotonic() < deadline and not payload:
        payload = reader(str(hb))
        time.sleep(0.02)
    assert payload["rank"] == 3 and payload["world"] == 4
    assert payload["pid"] == os.getpid()
    assert set(payload) == {"rank", "pid", "wall", "phase", "step", "http_port", "world"}


def test_heartbeat_outlives_a_faults_module_mid_import(tmp_path, monkeypatch):
    """The beat thread peeks at ``utils.faults`` in ``sys.modules`` while
    the worker's main thread may still be importing it: a module with no
    ``heartbeats_suspended`` yet must not end the beats (the monitor would
    then tear a healthy gang down as stalled)."""
    name = "machine_learning_apache_spark_tpu_torch.utils.faults"
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    hb = tmp_path / "heartbeat_0"
    beats = _start_heartbeat(str(hb), 0.02)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not read_heartbeat(str(hb)):
        time.sleep(0.02)
    time.sleep(0.1)
    assert beats.is_alive() and read_heartbeat(str(hb))["rank"] == 0


@pytest.mark.parametrize(
    "platform,local_world,cards,backend",
    [("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 1, 1, "nccl"),
     ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")],
)
def test_backend_rule(platform, local_world, cards, backend):
    assert choose_backend(platform, local_world, cards) == backend


def test_gang_returns_rank0_result():
    out = Distributor(num_processes=2, platform="cpu", timeout=120).run(
        "torch_launcher_workers:ok", "payload"
    )
    assert out == {
        "rank": 0, "world": 2, "x": "payload", "sum": 3.0,
        "backend": "gloo", "device": "cpu",
    }
    assert kill_stray_gangs() == 0


def test_failing_rank_is_named():
    with pytest.raises(GangFailure, match="boom from rank 1") as info:
        Distributor(num_processes=2, platform="cpu", timeout=120).run(
            "torch_launcher_workers:boom"
        )
    assert info.value.rank == 1 and info.value.cause == "exit"
    assert kill_stray_gangs() == 0


def test_rank_failing_mid_fit_is_named_not_its_peer():
    # Rank 0 is inside step 2's all-reduce when rank 1 raises; its
    # collective then fails too, often before the monitor polls.
    with pytest.raises(GangFailure, match="injected fault raise_train_step_r1") as info:
        Distributor(
            num_processes=2, platform="cpu", timeout=120,
            env={"MLSPARK_FAULTS": "raise@train_step:rank=1,step=2"},
        ).run("torch_launcher_workers:fit_fault")
    assert info.value.rank == 1 and info.value.cause == "exit"
    assert "\n[rank 1] " in str(info.value)
    assert kill_stray_gangs() == 0


def test_gang_failure_blames_the_rank_that_failed_first():
    # What the monitor saw first was rank 0's exit; the result files say
    # rank 1 raised 40 ms before rank 0's collective broke.
    results = [
        WorkerResult(rank=0, error="RuntimeError: Connection closed by peer", failed_at=100.04),
        WorkerResult(rank=1, error="RuntimeError: rank 1's own fault", failed_at=100.0),
    ]
    seen = GangFailure("rank 0 exited with code 1", rank=0, cause="exit", exit_code=1)
    e = gang_failure(results, seen, 0)
    assert e.rank == 1 and e.cause == "exit" and e.exit_code == 1
    assert "rank 1 failed first (rank 0 exited with code 1)" in str(e)
    assert str(e).endswith("[rank 1] RuntimeError: rank 1's own fault")
    # A deadline kills healthy ranks: placeholders only, nobody is blamed.
    placeholders = [WorkerResult(rank=r, error=f"rank {r} produced no result (crashed?)")
                    for r in (0, 1)]
    late = GangFailure("gang did not finish within 5s", cause="deadline")
    assert gang_failure(placeholders, late, 0).rank is None


def test_gang_failure_blames_a_hard_crash_seen_first():
    # A rank that dies without raising (os._exit, a segfault) leaves no
    # result; the monitor sees its exit first, and its peer raises later
    # in a collective the crash broke. The crash is the cause, as the JAX
    # monitor, which names the first exit it sees, reports it.
    results = [
        WorkerResult(rank=0, error="RuntimeError: Connection closed by peer", failed_at=100.04),
        WorkerResult(rank=1, error="rank 1 produced no result (crashed?)"),
    ]
    seen = GangFailure("rank 1 exited with code 23", rank=1, cause="exit", exit_code=23)
    e = gang_failure(results, seen, 0)
    assert e.rank == 1 and e.exit_code == 23
    assert str(e).endswith("[rank 1] rank 1 produced no result (crashed?)")


def test_max_restarts_recovers():
    out = Distributor(
        num_processes=2, platform="cpu", timeout=120, max_restarts=1, backoff_base=0.01,
    ).run("torch_launcher_workers:flaky")
    assert out == {"attempt": 1, "world": 2}
    assert kill_stray_gangs() == 0


def test_unpicklable_result_fails_the_gang():
    with pytest.raises(GangFailure, match="gang failed"):
        Distributor(num_processes=2, platform="cpu", timeout=120).run(
            "torch_launcher_workers:unpicklable"
        )
    assert kill_stray_gangs() == 0


@pytest.mark.parametrize(
    "kw,env",
    [(dict(dp_mode="zero1"), {"MLSPARK_DP_MODE": "zero1"}),
     (dict(dp_overlap=False), {"MLSPARK_ZERO1_OVERLAP": "0"}),
     (dict(elastic=True), {"MLSPARK_ELASTIC": "1"}),
     (dict(ingest={"buffer": 4, "tail": "drop"}),
      {"MLSPARK_INGEST_BUFFER": "4", "MLSPARK_INGEST_TAIL": "drop"})],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else None,
)
def test_zero1_knobs_reach_the_worker_env(kw, env, monkeypatch):
    """``Distributor(dp_mode=, dp_overlap=)`` become every worker's
    ``MLSPARK_DP_MODE`` / ``MLSPARK_ZERO1_OVERLAP`` (the JAX launcher's
    contract); an explicit ``env=`` still wins over them."""
    for name in ("MLSPARK_DP_MODE", "MLSPARK_ZERO1_OVERLAP", "MLSPARK_ELASTIC",
                 "MLSPARK_INGEST_BUFFER", "MLSPARK_INGEST_TAIL"):
        monkeypatch.delenv(name, raising=False)
    d = Distributor(num_processes=2, platform="cpu", **kw)
    for rank in range(2):
        got = d.worker_env("127.0.0.1:1234", "/tmp/run", 2, rank, 0, f"/tmp/run/hb_{rank}")
        assert {k: got.get(k) for k in env} == env
        assert got["MLSPARK_PROCESS_ID"] == str(rank)
    plain = Distributor(num_processes=2, platform="cpu").worker_env("h:1", "/tmp/run", 2, 0, 0, "hb")
    assert not any(k in plain for k in env)
    name, value = next(iter(env.items()))
    forced = Distributor(num_processes=2, platform="cpu", env={name: "x"}, **kw)
    assert forced.worker_env("h:1", "/tmp/run", 2, 0, 0, "hb")[name] == "x"


@pytest.mark.parametrize(
    "kw,item",
    [(dict(elastic=True, elastic_min_world=0), "elastic_min_world must be >= 1"),
     (dict(elastic_min_world=3), "elastic_min_world=3 exceeds num_processes=2"),
     (dict(rank_restart_budget=-1), "rank_restart_budget must be >= 0"),
     (dict(ingest={"bufer": 4}), "unknown ingest knob 'bufer'")],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else None,
)
def test_unported_knobs_raise_naming_their_item(kw, item):
    """The knobs that raised ``NotImplementedError`` before the elastic
    policy and the ingest pipeline were ported: a bad value now raises
    the JAX launcher's ``ValueError`` at construction, naming the knob
    (``TestElasticShrinkPolicy::test_constructor_validation``,
    ``TestEnvContract::test_distributor_rejects_bad_knobs_at_construction``)."""
    with pytest.raises(ValueError, match=item):
        Distributor(num_processes=2, platform="cpu", **kw)


def test_permanent_loss_without_elastic_names_rank_cause_budget():
    """The JAX ``TestElasticShrinkPolicy`` budget case: rank 1 always
    fails; with a budget of 0 and elastic off the first failure is a
    permanent loss, and the error says which knob would have shrunk."""
    with pytest.raises(GangFailure) as e:
        Distributor(num_processes=2, platform="cpu", timeout=120, rank_restart_budget=0,
                    backoff_base=0.05, term_grace=1.0).run("torch_launcher_workers:fail_rank", 1)
    f = e.value
    assert f.permanent is True and f.rank == 1 and f.cause == "exit"
    assert "permanently lost" in str(f) and "budget 0" in str(f) and "elastic" in str(f)
    assert kill_stray_gangs() == 0


def test_elastic_cannot_shrink_below_min_world():
    with pytest.raises(GangFailure) as e:
        Distributor(num_processes=2, platform="cpu", timeout=120, elastic=True,
                    rank_restart_budget=0, elastic_min_world=2, backoff_base=0.05,
                    term_grace=1.0).run("torch_launcher_workers:fail_rank", 1)
    assert e.value.permanent is True and e.value.rank == 1
    assert "elastic_min_world" in str(e.value)
    assert kill_stray_gangs() == 0


def test_knob_validation_is_the_jax_packages():
    with pytest.raises(ValueError, match="unknown dp_mode"):
        Distributor(2, dp_mode="zeroone")
    with pytest.raises(ValueError, match="serve_kv_mode"):
        Distributor(2, serve_kv_mode="ring")
    with pytest.raises(ValueError, match="telemetry_http"):
        Distributor(2, telemetry_http=70000)
    Distributor(2, dp_mode="replicated", serve_kv_mode="padded", telemetry_http=0)
