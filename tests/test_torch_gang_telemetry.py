"""The port's gang telemetry held against the JAX package: the merged gang
report (``aggregate.merge_gang_dir``, ``render_markdown``) over the same
per-rank JSONL files, the flight recorder's dump read by the JAX
``load_flight``, the live HTTP plane answering on an ephemeral port
(``/tracez`` serving the stitched tree of a traced span), the
fault plan grammar, and the ``train_step`` / ``decode_batch`` fault sites
firing from ``fit`` and from the serving engines."""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu import telemetry as jtelemetry
from machine_learning_apache_spark_tpu.telemetry import aggregate as jaggregate
from machine_learning_apache_spark_tpu.utils import faults as jfaults
from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_translation_pairs
from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models import MLP
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.serving import InternalError
from machine_learning_apache_spark_tpu_torch.telemetry import aggregate, tracectx
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.utils import faults


@pytest.fixture
def clean_telemetry(monkeypatch, tmp_path):
    monkeypatch.setenv("MLSPARK_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("MLSPARK_TELEMETRY", raising=False)
    telemetry.reset()
    faults.clear()
    yield tmp_path
    faults.clear()
    telemetry.reset()


def _rank_timeline(rank: int, steps: int) -> None:
    """What a gang rank's fit leaves on its event log: epoch and step
    spans, the two all-reduce spans per step, the bytes counter, an
    annotation."""
    log = telemetry.get_log()
    with telemetry.span("train.fit", epochs=1):
        with telemetry.span("train.epoch", epoch=0):
            for s in range(steps):
                with telemetry.span("train.step", step=s, count=1):
                    with telemetry.span("comms.loss_allreduce"):
                        pass
                    with telemetry.span("comms.grad_allreduce", bytes=4096):
                        pass
                    log.emit("counter", "comms.bytes_allreduced", value=4096,
                             attrs={"steps": 1})
    with telemetry.span("serving.batch", mode="padded", size=2 + rank):
        pass
    telemetry.annotate("launcher.dp_mode", mode="replicated", rank=rank)


def test_merged_gang_report_equals_jax(clean_telemetry, monkeypatch):
    d = clean_telemetry
    for rank, steps in ((0, 5), (1, 4)):
        telemetry.reset()
        monkeypatch.setenv("MLSPARK_PROCESS_ID", str(rank))
        _rank_timeline(rank, steps)
        aggregate.write_rank_file(str(d), rank=rank)
    assert sorted(aggregate.find_rank_files(str(d))) == [0, 1]
    ours = aggregate.merge_gang_dir(str(d))
    jaggregate.clear_parse_cache()
    theirs = jaggregate.merge_gang_dir(str(d))
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))
    assert aggregate.render_markdown(ours) == jaggregate.render_markdown(theirs)
    # both ranks' step spans are in the merged table, and the comms rollup
    # holds the all-reduce phases and bytes
    assert ours["phases"]["train.step"]["overall"]["count"] == 9
    assert sorted(ours["phases"]["train.step"]["ranks"]) == [0, 1]
    comms = aggregate.comms_report(aggregate.merge_rank_files(aggregate.find_rank_files(str(d))))
    assert comms["counters"]["comms.bytes_allreduced"][0]["total"] == 5 * 4096
    assert "comms.grad_allreduce" in comms["collectives"]


def test_jax_load_flight_reads_the_ports_dump(clean_telemetry, monkeypatch):
    monkeypatch.setenv("MLSPARK_PROCESS_ID", "1")
    telemetry.annotate("before.failure", step=3)
    path = telemetry.dump_flight("test.reason", extra={"why": "unit"})
    assert path == os.path.join(str(clean_telemetry), "flight_1.json")
    dump = jtelemetry.load_flight(path)
    assert dump == telemetry.load_flight(path)
    assert dump["artifact"] == "flight" and dump["reason"] == "test.reason"
    assert dump["rank"] == 1 and dump["extra"] == {"why": "unit"}
    assert any(ev["name"] == "before.failure" for ev in dump["events"])


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_plane_answers_on_an_ephemeral_port(clean_telemetry):
    telemetry.get_registry().counter("serving", "requests").inc(3)
    telemetry.register_status_provider("unit", lambda: {"answer": 42})
    telemetry.register_health_provider("unit", lambda: {"healthy": True})
    server = telemetry.start_http_server(port=0, rank=0)
    try:
        assert server is not None and server.port > 0
        status, text = _get(server.url("/metrics"))
        assert status == 200 and "requests" in text
        status, body = _get(server.url("/healthz"))
        payload = json.loads(body)
        assert status == 200 and payload["status"] == "ok"
        assert payload["checks"]["unit"] == {"healthy": True}
        status, body = _get(server.url("/statusz"))
        payload = json.loads(body)
        assert status == 200 and payload["sections"]["unit"] == {"answer": 42}
        assert "torch" in payload["build"]
        status, body = _get(server.url("/flightz?n=5"))
        assert status == 200 and json.loads(body)["artifact"] == "flightz"
        # /tracez stitches the live ring: one traced span is one complete
        # tree, rooted at that span, served whole under ?id=.
        ctx = tracectx.mint()
        with tracectx.use(ctx), telemetry.span("serving.submit"):
            pass
        status, body = _get(server.url("/tracez"))
        payload = json.loads(body)
        assert status == 200 and payload["artifact"] == "tracez"
        assert payload["completeness"] == {"traces": 1, "complete": 1, "fraction": 1.0}
        status, body = _get(server.url(f"/tracez?id={ctx.trace_id.upper()}"))
        tree = json.loads(body)
        assert status == 200 and tree["trace_id"] == ctx.trace_id
        assert [n["name"] for n in tree["roots"]] == ["serving.submit"]
        assert tree["orphans"] == [] and tree["annotations"] == []
        # the port sidecar for discovery, in the JAX format
        assert telemetry.http.find_port_sidecars(str(clean_telemetry))[0]["port"] == server.port
    finally:
        telemetry.stop_http_server()
    assert telemetry.get_http_server() is None


@pytest.mark.parametrize(
    "text",
    ["crash@train_step:rank=1,step=5", "raise@decode_batch:batch=2;stall@train_step:rank=0,step=3",
     "crash@train_step:world=8,rank=7,step=4;crash@train_step:world=7,rank=6,step=9",
     "delay@wire:rank=1,ms=500;blackhole@wire:rank=0,req=3,sticky=1",
     "raise@s", "raise@train_step:exit_code=5"],
)
def test_fault_plan_parsing_equals_jax(text, tmp_path):
    ours = faults.FaultPlan.from_spec(text, marker_dir=str(tmp_path))
    theirs = jfaults.FaultPlan.from_spec(text, marker_dir=str(tmp_path))
    assert [dataclasses.asdict(s) for s in ours.specs] == [
        dataclasses.asdict(s) for s in theirs.specs
    ]
    assert [s.key for s in ours.specs] == [s.key for s in theirs.specs]
    assert ours.marker_dir == theirs.marker_dir


@pytest.mark.parametrize(
    "text", ["explode@train_step:rank=0", "crash@train_step:epoch=3", "crash@:rank=0",
             "delay@train_step:ms=5"],
)
def test_bad_fault_plans_raise_like_jax(text):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.from_spec(text)
    with pytest.raises(ValueError):
        faults.FaultPlan.from_spec(text)


def test_train_step_fault_fires_from_fit(clean_telemetry):
    faults.install(faults.FaultPlan.from_spec("raise@train_step:step=2"))
    x = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    y = np.arange(20) % 3
    state = tstate.TrainState.create(model=MLP((4, 5, 3)), tx=tstate.make_optimizer("sgd", 0.1))
    batches = [(x[i:i + 4], y[i:i + 4]) for i in range(0, 20, 4)]
    with pytest.raises(faults.FaultInjected, match="train_step"):
        tloop.fit(state, tloop.classification_loss(), batches, epochs=1, log_every=0)
    assert state.step == 2  # steps 0 and 1 ran; the fault fired before step 2
    dump = telemetry.load_flight(os.path.join(str(clean_telemetry), "flight_driver.json"))
    assert dump["reason"].startswith("train.fit:FaultInjected")
    # one-shot: the same plan lets a second fit through
    tloop.fit(state, tloop.classification_loss(), batches, epochs=1, log_every=0)
    assert state.step == 7


@pytest.mark.parametrize("kv_mode", ["paged", "padded"])
def test_decode_batch_fault_quarantines_one_batch(kv_mode, clean_telemetry):
    pairs = synthetic_translation_pairs(32, min_len=3, max_len=6, seed=0)
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=14)
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
        d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16, dropout=0.0,
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    translator = Translator(model, src_pipe, trg_pipe, device="cpu")
    faults.install(faults.FaultPlan.from_spec("raise@decode_batch:batch=0"))
    with translator.serve(boundaries=(8, 16), max_batch=4, max_new_tokens=4,
                          kv_mode=kv_mode) as eng:
        first = eng.submit(pairs[0][0])
        with pytest.raises(InternalError):
            first.result(timeout=60)
        assert isinstance(eng.submit(pairs[1][0]).result(timeout=60), str)
        assert eng.metrics.completed == 1
    assert os.path.exists(os.path.join(str(clean_telemetry), "flight_driver.json"))
