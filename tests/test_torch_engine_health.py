"""The port's serving engine on the live plane, held against the JAX
engine on the CPU: the twins of the JAX package's
``test_healthz_flips_on_quarantine_then_recovers`` and
``test_healthz_survives_supervisor_restart`` on the port's engines, the
``/statusz`` sections and keys and ``/healthz`` check keys of both
engines on the same tiny config and weights (equal key sets), the four
live gauges on ``/metrics``, and ``/tracez`` serving a request's tree
rooted at its ``serving.submit`` span."""

import json
import time
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import numpy as np
import pytest

from machine_learning_apache_spark_tpu import telemetry as jtelemetry
from machine_learning_apache_spark_tpu.data.datasets import synthetic_translation_pairs
from machine_learning_apache_spark_tpu.data.text import TextPipeline as JPipeline
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import Transformer as JTransformer
from machine_learning_apache_spark_tpu.models import TransformerConfig as JConfig
from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline, Vocab
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.serving import InternalError
from machine_learning_apache_spark_tpu_torch.telemetry import recorder
from machine_learning_apache_spark_tpu_torch.utils import faults
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

ENGINE = dict(boundaries=(8, 16), max_batch=4, max_wait_s=0.01, max_new_tokens=8)
GAUGES = ("queue_depth_live", "kv_page_occupancy", "kv_mem_bytes_in_use", "active_rows")


@pytest.fixture(scope="module")
def translators():
    """One tiny untrained MT bundle in both packages, same weights."""
    pairs = synthetic_translation_pairs(32, min_len=3, max_len=6, seed=0)
    src_j = JPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_j = JPipeline.fit([t for _, t in pairs], max_seq_len=14)
    kw = dict(
        src_vocab_size=len(src_j.vocab.itos), trg_vocab_size=len(trg_j.vocab.itos),
        d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16, dropout=0.0,
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


@pytest.fixture(autouse=True)
def fresh_plane(monkeypatch, tmp_path):
    monkeypatch.delenv("MLSPARK_TELEMETRY", raising=False)
    monkeypatch.setenv("MLSPARK_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("MLSPARK_TELEMETRY_HTTP", "0")  # ephemeral port
    telemetry.reset()
    jtelemetry.reset()
    faults.clear()
    yield tmp_path
    faults.clear()
    telemetry.reset()
    jtelemetry.reset()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read().decode(), r.status
    except urllib.error.HTTPError as e:
        return e.read().decode(), e.code


def _get_json(url):
    body, code = _get(url)
    return json.loads(body), code


def _poll(url, want_code, seconds=10.0):
    deadline = time.monotonic() + seconds
    while True:
        payload, code = _get_json(url)
        if code == want_code or time.monotonic() > deadline:
            return payload, code
        time.sleep(0.01)


@pytest.mark.parametrize("kv_mode", ["paged", "padded"])
def test_healthz_flips_on_quarantine_then_recovers(translators, fresh_plane, kv_mode):
    """A quarantined launch or batch turns /healthz 503/degraded; the next
    successful one flips it back to 200/ok. The quarantine flight dump
    carries the victim's trace timeline."""
    _, t, texts = translators
    faults.install(faults.FaultPlan.from_spec("raise@decode_batch:batch=0"))
    with t.serve(kv_mode=kv_mode, **ENGINE) as eng:
        srv = telemetry.get_http_server()
        assert srv is not None
        assert _get_json(srv.url("/healthz"))[1] == 200
        victim = eng.submit(texts[0])
        with pytest.raises(InternalError):
            victim.result(timeout=120)
        payload, code = _poll(srv.url("/healthz"), 503)
        assert code == 503 and payload["status"] == "degraded"
        check = payload["checks"]["serving"]
        assert check["healthy"] is False and check["quarantine_recovered"] is False
        assert check["quarantined"] >= 1 and check["kv_mode"] == kv_mode
        deadline, dump = time.monotonic() + 10, {}
        while time.monotonic() < deadline:
            dump = recorder.load_flight(recorder.flight_path(str(fresh_plane)))
            if "request_traces" in dump.get("extra", {}):
                break
            time.sleep(0.01)
        traces = dump["extra"]["request_traces"]
        assert traces and traces[0]["trace_id"] == victim.trace.trace_id
        assert "failed" in [m["event"] for m in traces[0]["timeline"]]
        assert isinstance(eng.submit(texts[1]).result(timeout=120), str)
        payload, code = _poll(srv.url("/healthz"), 200)
        assert code == 200 and payload["status"] == "ok"
        assert payload["checks"]["serving"]["healthy"] is True
    # stop() takes the engine's sections off the plane.
    assert "serving" not in telemetry.http.statusz()["sections"]


def test_healthz_survives_supervisor_restart(translators):
    """A decode loop death is restarted by the supervisor and /healthz
    reports ok with the restart counted."""
    _, t, texts = translators
    eng = t.serve(start=False, **ENGINE)
    real = eng._decode_loop
    died = {"n": 0}

    def dying_then_real():
        if died["n"] == 0:
            died["n"] += 1
            raise RuntimeError("decode loop death (injected)")
        real()

    eng._decode_loop = dying_then_real
    eng.start()
    try:
        srv = telemetry.get_http_server()
        assert srv is not None
        assert isinstance(eng.submit(texts[0]).result(timeout=120), str)
        payload, code = _get_json(srv.url("/healthz"))
        assert code == 200 and payload["status"] == "ok"
        assert payload["checks"]["serving"]["loop_restarts"] == 1
        assert payload["checks"]["serving"]["worker_alive"] is True
    finally:
        eng.stop()


def _keys(tree):
    """Nested key paths of a JSON-like dict (lists are leaves)."""
    if not isinstance(tree, dict):
        return set()
    out = set()
    for k, v in tree.items():
        out.add(k)
        out |= {f"{k}.{sub}" for sub in _keys(v)}
    return out


@pytest.mark.parametrize("kv_mode", ["paged", "padded"])
def test_statusz_and_healthz_keys_equal_the_jax_engine(translators, kv_mode):
    jt, t, texts = translators
    with jt.serve(kv_mode=kv_mode, **ENGINE) as jeng:
        jeng.submit(texts[0]).result(timeout=300)
        jsections = jtelemetry.http.statusz()["sections"]
        jchecks = jtelemetry.http.healthz()[0]["checks"]
    with t.serve(kv_mode=kv_mode, **ENGINE) as eng:
        req = eng.submit(texts[0])
        req.result(timeout=120)
        srv = telemetry.get_http_server()
        status, code = _get_json(srv.url("/statusz"))
        assert code == 200
        health, code = _get_json(srv.url("/healthz"))
        assert code == 200
        metrics, code = _get(srv.url("/metrics"))
        assert code == 200
        tree, code = _get_json(srv.url(f"/tracez?id={req.trace.trace_id}"))
        assert code == 200
    sections = status["sections"]
    assert set(sections) == set(jsections)
    assert {"serving"} | ({"prefix_cache"} if kv_mode == "paged" else set()) <= set(sections)
    # The engine section's keys, nested ones included, are the JAX engine's.
    assert _keys(sections["serving"]) == _keys(jsections["serving"])
    if kv_mode == "paged":
        assert set(sections["prefix_cache"]) == set(jsections["prefix_cache"])
    assert set(health["checks"]["serving"]) == set(jchecks["serving"])
    for gauge in GAUGES if kv_mode == "paged" else GAUGES[:1]:
        assert f"serving_{gauge}" in metrics, gauge
    # The request's tree: rooted at its submit span, nothing orphaned.
    assert tree["trace_id"] == req.trace.trace_id
    assert [n["name"] for n in tree["roots"]] == ["serving.submit"]
    assert tree["orphans"] == [] and "annotations" in tree
