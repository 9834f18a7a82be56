"""The port's report CLIs (``tools/torch_{telemetry_report,trace_report,
gang_status}.py``) against the JAX package's tools, and the two races
the ``locks`` pass guards, on the port's code.

One 2-rank telemetry directory is written by the port's
``telemetry.events`` from seeded events: a router rank and a replica
rank joined by one request's trace across the ``ctx_span`` /
``remote_parent`` edge, training steps (rank 1 the straggler), ingest,
comms and serving spans, gauges, counters and the request annotations.
Each CLI pair runs in this process over it, with the same arguments:
exit codes, printed text and written JSON / markdown / Perfetto files
must be equal (the reports are pure functions of the files, so the
tolerance is exact equality). ``torch_gang_status.py --smoke`` runs its
2-rank port gang in a subprocess. Then the races: the serving engine's
``_HealthWindow`` read from 3 threads while a 4th writes, and the port's
``telemetry.http`` server started and stopped from 4 threads.
"""

import glob
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.telemetry import events, http, tracectx
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
SEED = 21
STRESS_SECONDS = 0.4


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_report_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL_PAIRS = {
    name: (_tool(name), _tool(f"torch_{name}"))
    for name in ("telemetry_report", "trace_report", "gang_status")
}


class _Spans:
    """Span events with seeded durations on the port's event log. Both
    ranks are written from this one process, so their span ids come from
    one count (traceview keys a span by process and id)."""

    def __init__(self, log, ids):
        self.log, self.ids = log, ids

    def __call__(self, name, dur, parent=None, **attrs):
        sid = next(self.ids)
        self.log.emit("span_start", name, span=sid, parent=parent, attrs=attrs or None)
        self.log.emit("span_end", name, span=sid, parent=parent, value=float(dur))
        return sid


def _write_gang(directory: str) -> str:
    """Rank 0 routes one traced request to rank 1 and trains; rank 1
    serves it and trains 3x slower. Returns the request's trace id."""
    rng = np.random.default_rng(SEED)
    ids = itertools.count(1)
    ctx = None
    saved = os.environ.get("MLSPARK_PROCESS_ID")
    try:
        for rank in (0, 1):
            os.environ["MLSPARK_PROCESS_ID"] = str(rank)
            telemetry.reset()
            log = events.get_log()
            span = _Spans(log, ids)
            for step in range(6):
                span("train.step", (1 + 2 * rank) * rng.uniform(0.01, 0.02), step=step)
                span("data.read", rng.uniform(1e-4, 1e-3))
                span("data.wait", rng.uniform(1e-5, 1e-4))
                span("comms.grad_allreduce", rng.uniform(1e-3, 2e-3), bytes=4096)
                log.emit("gauge", "data.buffer_occupancy", value=float(rng.integers(0, 3)))
                log.emit("counter", "data.records", value=32.0)
                log.emit("counter", "comms.bytes_exposed", value=4096.0, attrs={"step": step})
            if rank == 0:
                ctx = tracectx.mint()
                assert ctx is not None
                with tracectx.use(ctx):
                    submit = span("fleet.submit", 0.5, tier="interactive")
                    wire = tracectx.child(ctx)
                    span("fleet.attempt", 0.4, parent=submit, replica=1, ctx_span=wire.span_id)
                    events.annotate("fleet.request", outcome="completed", replica=1,
                                    tier="interactive", tenant=None, retries=0, total_s=0.5,
                                    status=200)
            else:
                with tracectx.use(ctx):
                    replica = span("fleet.replica", 0.35, remote_parent=wire.span_id)
                    span("serving.submit", 0.02, parent=replica)
                    span("serving.batch", 0.3, parent=replica, mode="paged")
                    log.emit("counter", "serving.tokens_real", value=float(rng.integers(5, 20)))
                    events.annotate("serving.request", trace_id=ctx.trace_id, total_s=0.34,
                                    queue_wait_s=0.01, ttft_s=0.05, service_s=0.33,
                                    launches=7, prefill="chunked")
            log.export_jsonl(os.path.join(directory, f"telemetry_rank{rank}.jsonl"))
    finally:
        if saved is None:
            os.environ.pop("MLSPARK_PROCESS_ID", None)
        else:
            os.environ["MLSPARK_PROCESS_ID"] = saved
        telemetry.reset()
    return ctx.trace_id


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("gang")
    return str(d), _write_gang(str(d))


def _run_pair(name: str, capsys, argv_of):
    """Each package's CLI ``main`` over ``argv_of(tag)``: (exit code,
    stdout, stderr) per package, tag "jax" or "torch"."""
    out = {}
    for tag, mod in zip(("jax", "torch"), TOOL_PAIRS[name]):
        try:
            rc = mod.main(argv_of(tag))
        except SystemExit as e:  # argparse errors
            rc = e.code
        got = capsys.readouterr()
        out[tag] = (rc, got.out, got.err)
    return out


def _load(path: str):
    with open(path) as f:
        return json.load(f) if path.endswith(".json") else f.read()


# -- telemetry_report -------------------------------------------------------------


def test_the_written_gang_has_every_section(gang):
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    report = aggregate.merge_gang_dir(gang[0])
    assert report["ranks"] == [0, 1]
    assert report["skew"]["train.step"]["slowest_rank"] == 1
    for section in ("comms", "ingest", "serving", "requests", "fleet"):
        assert report[section], section


@pytest.mark.parametrize("mode", ["directory", "files"])
def test_telemetry_report_equals_the_jax_tool(gang, tmp_path, capsys, mode):
    d, _ = gang
    files = sorted(glob.glob(os.path.join(d, "telemetry_rank*.jsonl")))

    def argv(tag):
        src = [d] if mode == "directory" else ["--files", *files]
        return [*src, "--json", str(tmp_path / f"{tag}.json"), "--md", str(tmp_path / f"{tag}.md")]

    runs = _run_pair("telemetry_report", capsys, argv)
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 0
    assert "from ranks [0, 1]" in runs["torch"][1]
    for ext in ("json", "md"):
        assert _load(str(tmp_path / f"torch.{ext}")) == _load(str(tmp_path / f"jax.{ext}"))
    assert "## Rank skew" in _load(str(tmp_path / "torch.md"))


def test_telemetry_report_markdown_to_stdout_equals_the_jax_tool(gang, capsys):
    runs = _run_pair("telemetry_report", capsys, lambda tag: [gang[0]])
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 0
    assert "# Telemetry report" in runs["torch"][1]


@pytest.mark.parametrize("case", ["empty_dir", "missing_file", "both_sources", "no_source"])
def test_telemetry_report_exit_codes_equal_the_jax_tool(tmp_path, capsys, case):
    argv = {
        "empty_dir": [str(tmp_path)],
        "missing_file": ["--files", str(tmp_path / "telemetry_rank0.jsonl")],
        "both_sources": [str(tmp_path), "--files", "x.jsonl"],
        "no_source": [],
    }[case]
    runs = _run_pair("telemetry_report", capsys, lambda tag: argv)
    assert runs["torch"][0] == runs["jax"][0] != 0
    assert runs["torch"][1:] == runs["jax"][1:]


# -- trace_report -----------------------------------------------------------------


def test_trace_report_summary_equals_the_jax_tool(gang, capsys):
    runs = _run_pair("trace_report", capsys, lambda tag: [gang[0], "--slowest", "5"])
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 0
    assert "complete: 1" in runs["torch"][1]


def test_trace_report_tree_perfetto_and_payload_equal_the_jax_tool(gang, tmp_path, capsys):
    d, tid = gang

    def argv(tag):
        return [d, "--trace-id", tid, "--perfetto", str(tmp_path / f"{tag}.perfetto.json"),
                "--json", str(tmp_path / f"{tag}.json")]

    runs = _run_pair("trace_report", capsys, argv)
    assert runs["torch"][0] == runs["jax"][0] == 0
    # The printed file paths differ by the tag only.
    assert runs["torch"][1].replace("torch.", "jax.") == runs["jax"][1]
    assert "- fleet.submit [rank 0]" in runs["torch"][1]
    assert "- fleet.replica (remote) [rank 1]" in runs["torch"][1]
    for name in ("perfetto.json", "json"):
        assert _load(str(tmp_path / f"torch.{name}")) == _load(str(tmp_path / f"jax.{name}"))
    phases = {e["ph"] for e in _load(str(tmp_path / "torch.perfetto.json"))["traceEvents"]}
    assert {"X", "M", "s", "f"} <= phases


def test_trace_report_whole_perfetto_equals_the_jax_tool(gang, tmp_path, capsys):
    runs = _run_pair("trace_report", capsys,
                     lambda tag: [gang[0], "--perfetto", str(tmp_path / f"{tag}.json")])
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert _load(str(tmp_path / "torch.json")) == _load(str(tmp_path / "jax.json"))


@pytest.mark.parametrize("case", ["unknown_trace", "empty_dir"])
def test_trace_report_exit_codes_equal_the_jax_tool(gang, tmp_path, capsys, case):
    argv = [gang[0], "--trace-id", "00" * 16] if case == "unknown_trace" else [str(tmp_path)]
    runs = _run_pair("trace_report", capsys, lambda tag: argv)
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 1


# -- gang_status ------------------------------------------------------------------


def test_gang_status_over_heartbeats_equals_the_jax_tool(tmp_path, capsys):
    """Ranks with no HTTP plane show from their heartbeat payloads alone;
    an empty directory exits 1."""
    for rank, step in ((0, 7), (1, 5)):
        (tmp_path / f"heartbeat_{rank}").write_text(
            json.dumps({"rank": rank, "phase": "train", "step": step}))
    rows = {}
    for tag, mod in zip(("jax", "torch"), TOOL_PAIRS["gang_status"]):
        rows[tag] = [{k: v for k, v in r.items() if k != "heartbeat_age_s"}
                     for r in mod.collect_rows(str(tmp_path))]
    assert rows["torch"] == rows["jax"]
    assert [r["status"] for r in rows["torch"]] == ["no-http", "no-http"]
    empty = tmp_path / "empty"
    empty.mkdir()
    runs = _run_pair("gang_status", capsys, lambda tag: [str(empty)])
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 1


def test_gang_status_smoke_subprocess():
    """``--smoke``: a 2-rank gang of the port on the host, both ranks
    scraped over their HTTP planes."""
    proc = subprocess.run(
        [sys.executable, str(TOOLS / "torch_gang_status.py"), "--smoke"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke ok: scraped 2/2 ranks" in proc.stdout


# -- races: the serving engine's /healthz window ----------------------------------


def test_health_window_recovered_semantics():
    from machine_learning_apache_spark_tpu_torch.serving.engine import _HealthWindow

    w = _HealthWindow()
    assert w.recovered()  # never quarantined
    w.note_quarantine(1.0)
    assert not w.recovered()  # degraded until a batch lands
    w.note_ok_batch(2.0)
    assert w.recovered()
    w.note_quarantine(3.0)
    assert not w.recovered()  # re-quarantined after the ok batch
    assert w.snapshot() == (3.0, 2.0)


def test_health_window_pair_is_consistent_under_4_threads():
    """1 writer + 3 readers. The writer advances in lockstep pairs, so
    every true state has ``lq - 1 <= lok <= lq``; a torn read (a stale
    quarantine beside a fresh ok batch) would read ``lok > lq``."""
    from machine_learning_apache_spark_tpu_torch.serving.engine import _HealthWindow

    w = _HealthWindow()
    stop = threading.Event()
    violations: list[tuple] = []

    def writer():
        i = 0.0
        while not stop.is_set():
            i += 1.0
            w.note_quarantine(i)
            w.note_ok_batch(i)

    def reader():
        while not stop.is_set():
            lq, lok = w.snapshot()
            if lq is None:
                if lok is not None:
                    violations.append((lq, lok))
            elif lok is not None and not (lq - 1.0 <= lok <= lq):
                violations.append((lq, lok))

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(STRESS_SECONDS)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not violations, violations[:5]


# -- races: the telemetry HTTP server's publication and its sidecar ---------------


@pytest.fixture
def fresh_telemetry(monkeypatch):
    for name in (events.ENV_TELEMETRY, events.ENV_TELEMETRY_DIR, http.ENV_TELEMETRY_HTTP):
        monkeypatch.delenv(name, raising=False)
    telemetry.reset()
    yield
    telemetry.reset()


def test_concurrent_starts_yield_one_server(tmp_path, fresh_telemetry):
    barrier = threading.Barrier(4)
    results: list = [None] * 4

    def start(k):
        barrier.wait()
        results[k] = http.start_http_server(0, directory=str(tmp_path))

    threads = [threading.Thread(target=start, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(r is not None for r in results)
    assert len({id(r) for r in results}) == 1
    assert http.get_http_server() is results[0]
    http.stop_http_server()


def test_start_stop_race_never_leaks_a_sidecar(tmp_path, monkeypatch, fresh_telemetry):
    """2 starters against 2 stoppers, the sidecar write slowed past
    ``stop()``'s poll interval: every server a start created takes its
    ``http_rank<k>.json`` with it (the sidecar is written before the
    server is published)."""
    real_write = http.write_port_sidecar

    def slow_write(*args, **kwargs):
        time.sleep(0.75)
        return real_write(*args, **kwargs)

    monkeypatch.setattr(http, "write_port_sidecar", slow_write)
    ranks = iter(range(10_000))
    for _ in range(2):
        barrier = threading.Barrier(4)
        starters_done = threading.Event()

        def start():
            rank = next(ranks)
            barrier.wait()
            http.start_http_server(0, directory=str(tmp_path), rank=rank)

        def stop():
            barrier.wait()
            while not starters_done.is_set():
                http.stop_http_server()

        starters = [threading.Thread(target=start) for _ in range(2)]
        threads = starters + [threading.Thread(target=stop) for _ in range(2)]
        for t in threads:
            t.start()
        for t in starters:
            t.join(timeout=30)
        starters_done.set()
        for t in threads:
            t.join(timeout=30)
        http.stop_http_server()
        assert http.get_http_server() is None
        leaked = glob.glob(os.path.join(str(tmp_path), "http_rank*"))
        assert not leaked, leaked
