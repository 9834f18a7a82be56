"""The port's ``telemetry.traceview`` held against the JAX module on the
same event dicts: two processes joined by the ``ctx_span`` /
``remote_parent`` edge, an in-process child, an orphan whose parent id
resolves nowhere, an unfinished span, annotations, a counter and an
untraced span. Every payload must be equal (the functions are pure, so
the tolerance is exact equality), and the port's live ``/tracez``
payload must stitch the spans the port's own span layer writes."""

import json
import os

import pytest

from machine_learning_apache_spark_tpu.telemetry import traceview as jtraceview
from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.telemetry import http, traceview, tracectx

TID, TID_ORPHAN, TID_SLOW = "ab" * 16, "cd" * 16, "ef" * 16
WIRE = "11" * 8


def _span(name, pid, rank, span, parent, tid, t0, t1, attrs=None, end=True):
    start = {"kind": "span_start", "name": name, "ts": t0, "wall": 100.0 + t0,
             "rank": rank, "pid": pid, "span": span, "parent": parent}
    if tid is not None:
        start["trace"] = tid
    if attrs:
        start["attrs"] = attrs
    if not end:
        return [start]
    stop = dict(start, kind="span_end", ts=t1, wall=100.0 + t1, value=t1 - t0)
    stop.pop("attrs", None)
    return [start, stop]


def _events():
    """A router (pid 100) and a replica (pid 200, rank 1): one request
    across both, a trace whose replica span's parent cannot be found, a
    slower single-process trace with an unfinished child, and untraced
    spans and counters."""
    evs = []
    evs += _span("fleet.submit", 100, None, 1, None, TID, 0.0, 0.5)
    evs += _span("fleet.attempt", 100, None, 2, 1, TID, 0.01, 0.4,
                 attrs={"replica": 1, "ctx_span": WIRE})
    evs += _span("fleet.replica", 200, 1, 7, None, TID, 0.02, 0.35,
                 attrs={"remote_parent": WIRE})
    evs += _span("serving.submit", 200, 1, 8, 7, TID, 0.03, 0.05)
    evs.append({"kind": "annotation", "name": "fleet.request", "ts": 0.5,
                "wall": 100.5, "rank": None, "pid": 100, "trace": TID,
                "attrs": {"outcome": "completed"}})
    # An orphan: its in-process parent (span 99) is in no export.
    evs += _span("fleet.replica", 200, 1, 9, 99, TID_ORPHAN, 1.0, 1.2)
    evs += _span("serving.submit", 300, 0, 3, None, TID_SLOW, 2.0, 4.0)
    evs += _span("serving.batch", 300, 0, 4, 3, TID_SLOW, 2.5, 0.0, end=False)
    evs += _span("train.step", 300, 0, 5, None, None, 5.0, 5.1)
    evs.append({"kind": "counter", "name": "queue.depth", "ts": 0.1,
                "wall": 100.1, "rank": 1, "pid": 200, "value": 3.0})
    return evs


def _roundtrip(x):
    return json.loads(json.dumps(x, sort_keys=True))


def test_trees_summaries_and_completeness_equal_jax():
    evs = _events()
    got, want = traceview.assemble(evs), jtraceview.assemble(evs)
    assert _roundtrip(got) == _roundtrip(want)
    assert set(got) == {TID, TID_ORPHAN, TID_SLOW}
    # The cross-process edge joins the replica under the attempt; the
    # orphan stays an orphan.
    assert [n["name"] for n in got[TID]["roots"]] == ["fleet.submit"]
    assert got[TID]["orphans"] == []
    assert [n["name"] for n in got[TID_ORPHAN]["orphans"]] == ["fleet.replica"]
    for tid in got:
        assert traceview.trace_summary(got[tid]) == jtraceview.trace_summary(want[tid])
    assert traceview.completeness(got) == jtraceview.completeness(want)
    assert traceview.slowest(got, n=2) == jtraceview.slowest(want, n=2)


@pytest.mark.parametrize("trace_id", [None, TID])
def test_perfetto_export_equals_jax(trace_id):
    evs = _events()
    got = traceview.perfetto_export(evs, trace_id=trace_id)
    assert _roundtrip(got) == _roundtrip(jtraceview.perfetto_export(evs, trace_id=trace_id))
    assert any(e["ph"] == "s" for e in got["traceEvents"])  # the flow arrow


@pytest.mark.parametrize("trace_id", [None, TID, TID_ORPHAN, "ff" * 16])
def test_tracez_payload_equals_jax(trace_id):
    evs = _events()
    got = traceview.tracez_payload(evs, trace_id)
    assert _roundtrip(got) == _roundtrip(jtraceview.tracez_payload(evs, trace_id))


def test_load_dir_equals_jax(tmp_path):
    """Rank exports and a crashed rank's flight dump, merged alike."""
    evs = _events()
    with open(os.path.join(tmp_path, "telemetry_rank0.jsonl"), "w") as f:
        for ev in evs:
            if ev["pid"] in (100, 300):
                f.write(json.dumps(ev) + "\n")
    with open(os.path.join(tmp_path, "flight_1.json"), "w") as f:
        json.dump({"rank": 1, "events": [e for e in evs if e["pid"] == 200]}, f)
    got, want = traceview.load_dir(str(tmp_path)), jtraceview.load_dir(str(tmp_path))
    assert got == want and len(got) == len(evs)
    assert _roundtrip(traceview.assemble(got)) == _roundtrip(jtraceview.assemble(want))


def test_live_tracez_stitches_the_port_span_layer(monkeypatch):
    monkeypatch.delenv("MLSPARK_TELEMETRY", raising=False)
    telemetry.reset()
    try:
        ctx = tracectx.mint()
        with tracectx.use(ctx), telemetry.span("serving.submit"):
            with telemetry.span("serving.queue"):
                pass
        payload = http.tracez()
        assert payload["artifact"] == "tracez"
        assert payload["completeness"]["complete"] == 1
        tree = http.tracez(ctx.trace_id)
        assert [n["name"] for n in tree["roots"]] == ["serving.submit"]
        assert [c["name"] for c in tree["roots"][0]["children"]] == ["serving.queue"]
        events = [ev.to_dict() for ev in telemetry.get_log().snapshot()]
        assert _roundtrip(tree) == _roundtrip(
            dict(jtraceview.tracez_payload(events, ctx.trace_id), rank=tree["rank"],
                 pid=tree["pid"])
        )
    finally:
        telemetry.reset()
