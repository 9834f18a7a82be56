"""The port's session layer (``config``, ``session``, ``submit``,
``recipes._common.resolve_mesh``) held against the JAX package on the same
env, argv and conf, and one recipe run under a 2-rank CPU gang the way
``examples/distributed_cnn.py`` runs it (Session conf → Distributor →
``train_cnn``), reporting ``world_processes == 2``."""

import argparse
import dataclasses
import os
import sys

import pytest

from machine_learning_apache_spark_tpu import config as jconfig
from machine_learning_apache_spark_tpu import session as jsession
from machine_learning_apache_spark_tpu import submit as jsubmit
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu_torch import Session, config, session, submit
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.parallel.mesh import make_mesh
from machine_learning_apache_spark_tpu_torch.recipes import _common
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {
    "MLSPARK_APP_NAME": "envapp",
    "MLSPARK_EXECUTOR_INSTANCES": "4",
    "MLSPARK_EXECUTOR_MEMORY": "2g",
    "MLSPARK_PLATFORM": "cpu",
    "MLSPARK_BATCH_SIZE": "64",
    "MLSPARK_LEARNING_RATE": "0.25",
    "MLSPARK_EPOCHS": "7",
    "MLSPARK_MODEL": "2",
}


@pytest.fixture
def env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", ["SessionConfig", "TrainConfig", "MeshConfig"])
def test_from_env_equals_jax(name, env):
    ours = getattr(config, name).from_env()
    theirs = getattr(jconfig, name).from_env()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize(
    "name,argv",
    [("SessionConfig", ["--app_name", "cli", "--num_processes", "3", "--platform", "cuda"]),
     ("TrainConfig", ["--epochs", "2", "--optimizer", "sgd", "--learning_rate", "0.5"]),
     ("MeshConfig", ["--data", "2", "--model", "1"])],
)
def test_from_args_equals_jax(name, argv, env):
    ours = getattr(config, name).from_args(argv)
    theirs = getattr(jconfig, name).from_args(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_builder_coerces_spark_submit_strings_like_jax():
    def build(mod):
        s = (mod.Session.builder.appName("Conf").config("spark.executor.instances", "3")
             .config("spark.executor.cores", "2").master("local[*]").getOrCreate())
        try:
            return dataclasses.asdict(s.conf), s.executor_count, s.process_index
        finally:
            s.stop()

    assert build(session) == build(jsession)


def test_get_or_create_returns_the_active_session():
    s = Session.builder.app_name("first").get_or_create()
    try:
        assert Session.builder.getOrCreate() is s
        assert session.active_session() is s
    finally:
        s.stop()
    assert session.active_session() is not s
    session.active_session().stop()


@pytest.mark.parametrize(
    "axes",
    [{"data": 3}, {"data": 0, "model": 0}, {"data": 0, "model": 3}, {"data": -1, "seq": 5}],
    ids=["uncovered", "two-wildcards", "indivisible", "indivisible-seq"],
)
def test_mesh_shape_errors_are_jax_valueerrors(axes):
    """The same shape errors for the same device count: the JAX package
    meshes the test process's 8 CPU devices, the port 8 processes."""
    with pytest.raises(ValueError) as theirs:
        j_make_mesh(dict(axes))
    with pytest.raises(ValueError) as ours:
        make_mesh(dict(axes), world=8)
    assert str(ours.value) == str(theirs.value)


def test_session_mesh_over_one_process():
    s = Session(config.SessionConfig(platform="cpu"))
    assert s.mesh().shape == {"data": 1}
    assert s.mesh(data=-1).axis_names == ("data",)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        s.mesh(data=2)
    assert (s.device_count, s.process_count, s.process_index, s.local_device_count) == (1, 1, 0, 1)
    assert str(s.device) == "cpu"


@pytest.mark.parametrize(
    "key,value",
    [("spark.executor.instances", "4"), ("executor_instances", "2"),
     ("spark.driver.memory", "3g"), (" spark.app.name ", "x")],
)
def test_conf_to_env_equals_jax(key, value):
    assert submit._conf_to_env(key, value) == jsubmit._conf_to_env(key, value)


@pytest.mark.parametrize(
    "ns",
    [dict(conf=None, name=None, platform=None, coordinator="h:1234", num_processes=4, process_id=1),
     dict(conf=["spark.executor.instances=3", "a.b=c=d"], name="N", platform="cpu",
          coordinator=None, num_processes=None, process_id=None)],
)
def test_build_env_equals_jax(ns):
    ns = argparse.Namespace(**ns)
    assert submit.build_env(ns) == jsubmit.build_env(ns)


def test_submit_bad_conf_and_missing_script(tmp_path):
    script = tmp_path / "s.py"
    script.write_text("pass")
    with pytest.raises(SystemExit, match="key=value"):
        submit.main(["--conf", "no-equals-sign", str(script)])
    with pytest.raises(SystemExit, match="not found"):
        submit.main(["/nonexistent/driver.py"])


def test_submit_empty_builder_reads_the_submitted_conf(tmp_path, monkeypatch):
    out_file = tmp_path / "result.txt"
    driver = tmp_path / "driver.py"
    driver.write_text(
        "import sys\n"
        "from machine_learning_apache_spark_tpu_torch import Session\n"
        "s = Session.builder.getOrCreate()\n"
        "open(sys.argv[1], 'w').write(\n"
        "    f'{s.conf.app_name}:{s.conf.executor_instances}:{s.conf.platform}')\n"
        "s.stop()\n"
    )
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rc = submit.main([
        "--conf", "spark.executor.instances=3", "--name", "SubmitSmoke",
        "--platform", "cpu", str(driver), str(out_file),
    ])
    assert rc == 0
    assert out_file.read_text() == "SubmitSmoke:3:cpu"


def test_resolve_mesh_rules(monkeypatch):
    assert _common.resolve_mesh(True) is None  # one process: nothing to shard
    assert _common.data_replicas(None) == (1, 0)
    with pytest.raises(ValueError, match="requested but only 1 device"):
        _common.resolve_mesh(True, model_parallel=2)
    with pytest.raises(ValueError, match="requires use_mesh=True"):
        _common.resolve_mesh(False, sequence_parallel=2)
    monkeypatch.setattr(_common, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="independent unsynchronized replicas"):
        _common.resolve_mesh(False)
    # Under a gang the model axis is ported: {data: world/M, model: M},
    # and each process is one replica's share of the rows.
    mesh = _common.resolve_mesh(True, model_parallel=2)
    assert mesh.shape == {"data": 1, "model": 2}
    assert _common.data_replicas(mesh) == (1, 0)
    # So is the seq axis: {data: world/N, seq: N}, the line's ranks one
    # replica's rows.
    mesh = _common.resolve_mesh(True, sequence_parallel=2)
    assert mesh.shape == {"data": 1, "seq": 2}
    assert _common.data_replicas(mesh) == (1, 0)
    monkeypatch.setattr(_common, "process_count", lambda: 4)
    # Beside the model axis too: {data: world/(N·M), seq: N, model: M},
    # model innermost, as the JAX resolve_mesh builds it.
    mesh = _common.resolve_mesh(True, sequence_parallel=2, model_parallel=2)
    assert mesh.shape == {"data": 1, "seq": 2, "model": 2}
    assert _common.data_replicas(mesh) == (1, 0)
    monkeypatch.setattr(_common, "process_count", lambda: 2)
    # The pipeline axis is ported too: {data: world/S, pipeline: S}.
    mesh = _common.resolve_mesh(True, pipeline_parallel=2)
    assert mesh.shape == {"data": 1, "pipeline": 2}
    assert _common.data_replicas(mesh) == (1, 0)
    # So is the expert axis: {data: world/N, expert: N}, an expert line
    # reading one replica's rows.
    mesh = _common.resolve_mesh(True, expert_parallel=2)
    assert mesh.shape == {"data": 1, "expert": 2}
    assert _common.data_replicas(mesh) == (1, 0)


def test_recipe_under_a_two_rank_gang_reports_its_world():
    spark = Session.builder.appName("DistributedCNN").config(
        "spark.executor.instances", "2"
    ).getOrCreate()
    try:
        out = Distributor(
            num_processes=spark.conf.executor_instances, local_mode=True,
            platform="cpu", timeout=240,
        ).run("torch_launcher_workers:session_cnn", os.path.join(REPO, "assets/fixtures"))
    finally:
        spark.stop()
    assert kill_stray_gangs() == 0
    assert out["world_processes"] == 2 and out["devices"] == 2
    assert out["executor_count"] == 2 and out["process_index"] == 0
    assert out["epochs"] == 1 and out["eval_samples"] > 0
    assert all(k in out for k in ("test_loss", "accuracy", "train_seconds"))
    assert sys.modules.get("machine_learning_apache_spark_tpu_torch.session") is session
