"""The port's serving fleet (``machine_learning_apache_spark_tpu_torch.fleet``,
``launcher/replica_gang.py``, ``utils/sysinfo.py``) against the JAX
package's, on the CPU.

The pure parts run side by side with the JAX package's on the same
scripted inputs: ``pick_replica`` over tables of snapshots,
``FleetAdmission`` and ``AffinityTable`` over scripts of calls,
``fleet_slo_rollup`` and ``find_fleet_sidecars`` over one directory, the
registered ``MLSPARK_FLEET_*`` / ``MLSPARK_AUTOSCALE_*`` knobs. Both
packages' ``ReplicaServer`` serve one scripted fake engine each over real
sockets, and both ``FleetRouter`` dispatch over one script of replica
outcomes; status codes, bodies, per-request outcomes and ledgers must be
equal. Then the slice end to end: one 2-replica port ``ReplicaGang`` on
the host (``platform="cpu"``) over a tiny MT model whose weights are the
Flax tree's, behind a ``FleetRouter(policy="affinity")``: routed outputs
token-identical to the JAX package's in-process paged engine,
conservation, affinity, and a ``kill_rank(1)`` that only rank 1's
in-flight requests may pay for.
"""

import importlib
import itertools
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

import machine_learning_apache_spark_tpu.fleet as jfleet
import machine_learning_apache_spark_tpu_torch.fleet as tfleet
from machine_learning_apache_spark_tpu.fleet import router as jrouter
from machine_learning_apache_spark_tpu.serving import queue as jqueue
from machine_learning_apache_spark_tpu.utils import env as jenv
from machine_learning_apache_spark_tpu_torch.fleet import router as trouter
from machine_learning_apache_spark_tpu_torch.serving import queue as tqueue
from machine_learning_apache_spark_tpu_torch.utils import env as tenv
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

pytestmark = pytest.mark.fleet

TOOLS = Path(__file__).resolve().parent.parent / "tools"
# Each package with its own classes: the side-by-side tests run one
# scenario through both and compare what comes out.
PACKAGES = {
    "jax": (jfleet, jrouter, jqueue),
    "torch": (tfleet, trouter, tqueue),
}
SLACK = int(trouter.AFFINITY_LOAD_SLACK)


def snap(fleet, rank, *, healthy=True, status=None, in_flight=0, port=None, digests=(), slo=None,
         queue_depth=0):
    return fleet.ReplicaSnapshot(
        rank=rank, port=port if port is not None else 10000 + rank, healthy=healthy,
        status=status or ("ok" if healthy else "degraded"), in_flight=in_flight,
        queue_depth=queue_depth, prefix_digests=frozenset(digests), slo=slo or {},
    )


# -- the package's surface -------------------------------------------------------


def test_public_names_are_the_jax_packages():
    assert tfleet.__all__ == jfleet.__all__
    assert tfleet.POLICIES == jfleet.POLICIES
    for name in set(tfleet.__all__) - {"POLICIES"}:
        assert getattr(tfleet, name).__module__.startswith("machine_learning_apache_spark_tpu_torch")
    from machine_learning_apache_spark_tpu_torch import launcher
    from machine_learning_apache_spark_tpu_torch.launcher.replica_gang import ReplicaGang

    assert "ReplicaGang" in launcher.__all__ and launcher.ReplicaGang is ReplicaGang


def _fleet_knobs(registry):
    return {
        name: (v.type, v.default, v.subsystem, v.choices)
        for name, v in registry.REGISTRY.items()
        if name.startswith(("MLSPARK_FLEET_", "MLSPARK_AUTOSCALE_"))
    }


def test_fleet_knobs_registered_as_in_the_jax_package():
    port = _fleet_knobs(tenv)
    assert len(port) == 23
    assert port == _fleet_knobs(jenv)


def test_host_load_is_the_jax_one():
    from machine_learning_apache_spark_tpu.utils import sysinfo as jsys
    from machine_learning_apache_spark_tpu_torch.utils import sysinfo as tsys

    got, want = tsys.host_load(), jsys.host_load()
    assert set(got) == set(want) and got["cores"] == want["cores"]
    assert tsys.CONTENTION_LOAD_FRACTION == jsys.CONTENTION_LOAD_FRACTION


@pytest.mark.parametrize("env", [
    {},
    {"MLSPARK_AUTOSCALE_MIN_REPLICAS": "2", "MLSPARK_AUTOSCALE_MAX_REPLICAS": "6",
     "MLSPARK_AUTOSCALE_BURN_UP": "0.3", "MLSPARK_AUTOSCALE_COOLDOWN_S": "1.5",
     "MLSPARK_AUTOSCALE_DRAIN_BATCH_SHED": "0.25", "MLSPARK_AUTOSCALE_HYSTERESIS_TICKS": "4",
     "MLSPARK_FLEET_INTERACTIVE_DEADLINE_S": "3.5", "MLSPARK_FLEET_BATCH_MAX_IN_FLIGHT": "9"},
], ids=["defaults", "set"])
def test_config_from_env_equals_the_jax_packages(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tfleet.AutoscaleConfig.from_env().__dict__ == jfleet.AutoscaleConfig.from_env().__dict__
    assert ({k: v.__dict__ for k, v in tfleet.default_tiers().items()}
            == {k: v.__dict__ for k, v in jfleet.default_tiers().items()})


# -- pick_replica: the same rank over the same table ---------------------------

# case -> (snapshots as {rank: snap keywords}, calls as pick_replica keywords)
PICK_CASES = {
    "least_loaded_min": ({0: dict(in_flight=5), 1: dict(in_flight=1), 2: dict(in_flight=3)},
                         [dict(policy="least_loaded")]),
    "tie_by_rank": ({2: dict(in_flight=1), 0: dict(in_flight=1)},
                    [dict(policy="least_loaded"), dict(policy="affinity")]),
    "round_robin": ({0: {}, 1: {}, 2: {}}, [dict(policy="round_robin")] * 7),
    "round_robin_skips_unhealthy": ({0: {}, 1: dict(healthy=False), 2: {}},
                                    [dict(policy="round_robin")] * 4),
    "affinity_warm_within_slack": ({0: dict(in_flight=0), 1: dict(in_flight=1)},
                                   [dict(policy="affinity", candidates={1})]),
    "affinity_cold": ({0: dict(in_flight=4), 1: dict(in_flight=1)},
                      [dict(policy="affinity", candidates=None), dict(policy="affinity", candidates=set())]),
    "slack_escape": ({0: dict(in_flight=SLACK + 1), 1: dict(in_flight=0)},
                     [dict(policy="affinity", candidates={0})]),
    "slack_edge": ({0: dict(in_flight=SLACK), 1: dict(in_flight=0)},
                   [dict(policy="affinity", candidates={0})]),
    "warm_pair_least_loaded": ({0: dict(in_flight=2), 1: dict(in_flight=1), 2: dict(in_flight=0)},
                               [dict(policy="affinity", candidates={0, 1})]),
    "unhealthy_never": ({0: dict(healthy=False, in_flight=0), 1: dict(in_flight=9)},
                        [dict(policy=p) for p in ("affinity", "least_loaded", "round_robin")]
                        + [dict(policy="affinity", candidates={0})]),
    "draining_never": ({0: dict(healthy=False, status="draining"), 1: dict(in_flight=3)},
                       [dict(policy="affinity", candidates={0}), dict(policy="least_loaded")]),
    "exclude": ({0: {}, 1: {}}, [dict(exclude={0}), dict(exclude={0, 1}),
                                 dict(exclude={1}, candidates={1})]),
    "empty": ({}, [dict(policy=p) for p in ("affinity", "least_loaded", "round_robin")]),
    "all_unhealthy": ({0: dict(healthy=False), 1: dict(healthy=False)}, [dict(policy="least_loaded")]),
    "candidates_not_in_fleet": ({0: dict(in_flight=1), 1: dict(in_flight=0)},
                                [dict(policy="affinity", candidates={5, 7})]),
    "unknown_load_sorts_last": ({0: dict(in_flight=None, queue_depth=None), 1: dict(in_flight=3),
                                 2: dict(in_flight=None, queue_depth=2)},
                                [dict(policy="least_loaded"), dict(policy="affinity", candidates={0})]),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_replica_picks_the_jax_rank(case):
    table, calls = PICK_CASES[case]
    picks = {}
    for name, (fleet, router, _) in PACKAGES.items():
        snaps = {r: snap(fleet, r, **kw) for r, kw in table.items()}
        rr = itertools.count()
        picks[name] = [router.pick_replica(snaps, rr_state=rr, **kw) for kw in calls]
    assert picks["torch"] == picks["jax"], case


def test_pick_replica_rejects_what_the_jax_one_rejects():
    errors = []
    for fleet, router, _ in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            router.pick_replica({0: snap(fleet, 0)}, policy="random")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- admission: the same grants over the same script ----------------------------

ADMISSION_SCRIPTS = {
    "tier_quota": (dict(tiers=[("interactive", 10.0, 2)]), [
        ("admit", "interactive", None), ("admit", "interactive", None), ("admit", "interactive", None),
        ("release", 0, None), ("admit", "interactive", None), ("admit", "interactive", None)]),
    "tenant_quota": (dict(tenant_max_in_flight=1), [
        ("admit", "batch", "acme"), ("admit", "interactive", "acme"), ("admit", "interactive", "other"),
        ("release", 0, None), ("admit", "interactive", "acme"), ("release", 2, None),
        ("admit", "batch", "other")]),
    "retry_after_follows_service_time": (dict(tiers=[("interactive", 10.0, 1)]), [
        ("admit", "interactive", None), ("release", 0, 2.0), ("admit", "interactive", None),
        ("admit", "interactive", None), ("release", 1, 0.5), ("admit", "interactive", None),
        ("admit", "interactive", None)]),
    "release_idempotent_and_unknown_tier": (dict(), [
        ("admit", "interactive", None), ("release", 0, None), ("release", 0, None),
        ("admit", "platinum", None), ("admit", "batch", "t")]),
    "shed_and_unshed": (dict(tiers=[("interactive", 10.0, 4), ("batch", 120.0, 4)]), [
        ("shed", "batch", 0.5), ("admit", "batch", None), ("admit", "batch", None),
        ("admit", "batch", None), ("admit", "interactive", None), ("admit", "interactive", None),
        ("admit", "interactive", None), ("admit", "interactive", None), ("admit", "interactive", None),
        ("shed", "batch", 0.01), ("release", 0, None), ("release", 1, None), ("admit", "batch", None),
        ("admit", "batch", None), ("unshed", "batch", None), ("admit", "batch", None),
        ("shed", "nope", 0.5), ("shed", "batch", 0.0), ("shed", "batch", 1.5)]),
}


def _run_admission(fleet, setup: dict, script: list) -> tuple[list, dict]:
    kw = {}
    if "tiers" in setup:
        kw["tiers"] = {n: fleet.SLOTier(n, d, m) for n, d, m in setup["tiers"]}
    adm = fleet.FleetAdmission(tenant_max_in_flight=setup.get("tenant_max_in_flight"),
                               clock=lambda: 0.0, **kw)
    leases, out = [], []
    for op, a, b in script:
        try:
            if op == "admit":
                lease = adm.admit(tier=a, tenant=b)
                leases.append(lease)
                out.append(("lease", lease.tier, lease.tenant, lease.deadline_s))
            elif op == "release":
                adm.release(leases[a], service_s=b)
                out.append(("released", a))
            elif op == "shed":
                adm.shed(a, b)
                out.append(("shed", a, b))
            else:
                adm.unshed(a)
                out.append(("unshed", a))
        except fleet.FleetBackpressure as e:
            out.append(("backpressure", e.depth, e.retry_after, e.scope, str(e)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out, adm.stats()


@pytest.mark.parametrize("script", sorted(ADMISSION_SCRIPTS))
def test_admission_grants_as_the_jax_one(script):
    setup, ops = ADMISSION_SCRIPTS[script]
    got = _run_admission(tfleet, setup, ops)
    want = _run_admission(jfleet, setup, ops)
    assert got == want
    assert any(o[0] == "lease" for o in got[0])


def test_fleet_backpressure_is_the_serving_contract():
    adm = tfleet.FleetAdmission(tiers={"interactive": tfleet.SLOTier("interactive", 10.0, 1)})
    adm.admit()
    with pytest.raises(tqueue.Backpressure) as e:
        adm.admit()
    assert isinstance(e.value, tfleet.FleetBackpressure) and e.value.scope == "tier:interactive"
    with pytest.raises(ValueError, match="deadline_s"):
        tfleet.SLOTier("x", 0.0, 1)
    with pytest.raises(ValueError, match="max_in_flight"):
        tfleet.SLOTier("x", 1.0, 0)


# -- affinity: the same candidates after the same history ------------------------

AFFINITY_SCRIPTS = {
    "memory_and_ttl": (dict(memory_ttl_s=5.0), [
        ("route", "d1", 0), ("cand", "d1"), ("tick", 3.0), ("route", "d1", 1), ("cand", "d1"),
        ("tick", 3.0), ("cand", "d1"), ("tick", 10.0), ("cand", "d1"), ("cand", None)]),
    "residency_replaces_and_forgets": (dict(), [
        ("scrape", 0, {"a", "b"}), ("scrape", 1, {"b"}), ("cand", "b"), ("scrape", 0, {"c"}),
        ("cand", "b"), ("cand", "c"), ("forget", 1), ("cand", "b"), ("route", "c", 2),
        ("cand", "c"), ("forget", 2), ("cand", "c")]),
    "memory_lru_bound": (dict(memory_capacity=2), [
        ("route", "a", 0), ("route", "b", 1), ("route", "a", 2), ("route", "c", 0),
        ("cand", "a"), ("cand", "b"), ("cand", "c")]),
    "no_memory": (dict(memory_capacity=0), [("route", "a", 0), ("cand", "a"), ("scrape", 1, {"a"}),
                                            ("cand", "a")]),
}


def _run_affinity(fleet, kw: dict, script: list) -> tuple[list, dict]:
    now = [0.0]
    table = fleet.AffinityTable(clock=lambda: now[0], **kw)
    out = []
    for op, *args in script:
        if op == "route":
            table.note_routed(*args)
        elif op == "scrape":
            table.observe_scrape(*args)
        elif op == "forget":
            table.forget_rank(*args)
        elif op == "tick":
            now[0] += args[0]
        else:
            out.append(sorted(table.candidates(*args)))
    return out, table.stats()


@pytest.mark.parametrize("script", sorted(AFFINITY_SCRIPTS))
def test_affinity_candidates_as_the_jax_table(script):
    kw, ops = AFFINITY_SCRIPTS[script]
    assert _run_affinity(tfleet, kw, ops) == _run_affinity(jfleet, kw, ops)


def test_affinity_rejects_a_negative_capacity():
    with pytest.raises(ValueError, match="memory_capacity"):
        tfleet.AffinityTable(memory_capacity=-1)


@pytest.mark.parametrize("ids", [[3, 1, 4, 1, 5], [], [7] * 40])
def test_prefix_digest_is_the_jax_digest(ids):
    assert tfleet.prefix_digest(ids) == jfleet.prefix_digest(ids)
    assert tfleet.prefix_digest(ids) == tfleet.prefix_digest(tuple(ids))


# -- the scrape plane's pure parts on one directory -------------------------------


def test_sidecars_read_alike_either_package_writing(tmp_path):
    d = str(tmp_path)
    jfleet.write_fleet_sidecar(4321, directory=d, rank=1)
    tfleet.write_fleet_sidecar(5432, directory=d, rank=2)
    for rank, port in ((1, 9999), (0, 1111), (3, 3333)):
        (tmp_path / f"http_rank{rank}.json").write_text(json.dumps({"port": port, "rank": rank}))
    (tmp_path / "fleet_rank4.json").write_text("{torn")
    got = tfleet.find_fleet_sidecars(d)
    assert got == jfleet.find_fleet_sidecars(d)
    assert got[1]["port"] == 4321 and got[1]["kind"] == "fleet"  # fleet_ wins over http_
    assert got[2]["port"] == 5432 and got[0]["kind"] == "http"


def test_slo_rollup_as_the_jax_one():
    slos = {
        0: {"interactive": {"ewma": 0.2, "window_count": 10, "window_missed": 2, "total": 40, "missed": 3},
            "batch": {"ewma": 0.0, "window_count": 4, "window_missed": 0, "total": 4, "missed": 0}},
        1: {"interactive": {"ewma": 0.5, "window_count": 30, "window_missed": 1, "total": 30, "missed": 1}},
        2: {"interactive": "not a dict"},
        3: {},
    }
    # The packages export a ``scrape`` function that shadows the module.
    tscrape = importlib.import_module("machine_learning_apache_spark_tpu_torch.fleet.scrape")
    jscrape = importlib.import_module("machine_learning_apache_spark_tpu.fleet.scrape")
    got = tscrape.fleet_slo_rollup({r: snap(tfleet, r, slo=s) for r, s in slos.items()})
    want = jscrape.fleet_slo_rollup({r: snap(jfleet, r, slo=s) for r, s in slos.items()})
    assert got == want and got["interactive"]["window_count"] == 40


def test_snapshot_properties_as_the_jax_ones():
    for kw in (dict(in_flight=3), dict(in_flight=None, queue_depth=2),
               dict(in_flight=None, queue_depth=None), dict(status="draining", healthy=False)):
        t, j = snap(tfleet, 0, **kw), snap(jfleet, 0, **kw)
        assert (t.load, t.draining) == (j.load, j.draining)


# -- ReplicaServer against the JAX one: one scripted engine each -----------------


class _FakeReq:
    def __init__(self, text, outcome, errors):
        self.text, self.outcome, self.errors = text, outcome, errors
        self.trace = type("T", (), {"trace_id": "t-1"})()
        self.deadline = None

    def result(self, timeout=None):
        if self.outcome == "deadline":
            raise self.errors.DeadlineExceeded("deadline of 1.000s passed")
        if self.outcome == "internal":
            raise RuntimeError("decode step failed")
        return self.text.upper()


class _FakeEngine:
    """Just enough engine for a ReplicaServer (the shape of the JAX
    package's fleet tests' fake): ``mode`` scripts what ``submit`` does
    and what the request's ``result`` gives; ``errors`` is the serving
    queue module of the server's own package."""

    def __init__(self, errors):
        self.errors = errors
        self.mode = "ok"
        self.submitted = []
        self.clock = time.monotonic
        self.expire_sweeps = 0
        eng = self

        class _Q:
            @staticmethod
            def expire_now():
                eng.expire_sweeps += 1
                return 0

        self.queue = _Q()
        pipe = type("P", (), {"ragged": staticmethod(lambda texts: [[1, 2, 3] for _ in texts])})()
        self.translator = type("Tr", (), {"trg_pipe": pipe})()

    def submit(self, text, deadline_s=None, tier=None):
        if self.mode == "backpressure":
            raise self.errors.Backpressure(7, 0.25)
        if self.mode == "bad_input":
            raise ValueError("input of 99 tokens exceeds the largest boundary 16")
        if self.mode == "stopped":
            raise RuntimeError("engine not started")
        self.submitted.append(text)
        return _FakeReq(text, self.mode, self.errors)

    def _health_snapshot(self):
        return {"healthy": True}


def _request(port, path, payload=None, method="POST", raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode()), resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers.get("Retry-After")


def _server_scenario(name, server, eng, healthy) -> list:
    """One scenario against one server: every exchange's status, body and
    Retry-After, and the server's counters."""
    port = server.port
    out = []
    if name == "complete":
        out.append(_request(port, "/v1/generate", {"text": "hello world", "tier": "batch",
                                                    "tenant": "acme"}))
    elif name in ("backpressure", "bad_input", "stopped", "deadline", "internal"):
        eng.mode = name
        out.append(_request(port, "/v1/generate", {"text": "x"}))
    elif name == "unhealthy_then_recovered":
        healthy["v"] = False
        out.append(_request(port, "/v1/generate", {"text": "x"}))
        out.append(("submitted", list(eng.submitted)))
        healthy["v"] = True
        out.append(_request(port, "/v1/generate", {"text": "x"}))
    elif name == "bad_body":
        out.append(_request(port, "/v1/generate", {"nope": 1}))
        out.append(_request(port, "/v1/generate", raw=b"{not json"))
    elif name == "unknown_path":
        out.append(_request(port, "/v1/nothing", {"text": "x"}))
        out.append(_request(port, "/nothing", method="GET"))
    elif name == "cancel_unknown":
        out.append(_request(port, "/v1/cancel", {"trace_id": "nope"}))
        out.append(("sweeps", eng.expire_sweeps))
    elif name == "cancel_in_flight":
        victim = _FakeReq("slow", "ok", eng.errors)
        victim.deadline = eng.clock() + 120.0
        with server._lock:
            server._inflight["t-cancel"] = victim
        out.append(_request(port, "/v1/cancel", {"trace_id": "t-cancel"}))
        out.append(("pulled", victim.deadline <= eng.clock(), eng.expire_sweeps))
    elif name == "cancel_bad_body":
        out.append(_request(port, "/v1/cancel", {"nope": 1}))
    elif name == "draining":
        server.set_draining(True)
        code, payload, _ = _request(port, "/healthz", method="GET")
        out.append((code, payload["status"]))
        out.append(_request(port, "/v1/generate", {"text": "hi"}))
        server.set_draining(False)
        out.append(_request(port, "/v1/generate", {"text": "hi"}))
    stats = server.stats()
    stats.pop("port")
    out.append(stats)
    return out


SERVER_SCENARIOS = ("complete", "backpressure", "bad_input", "stopped", "deadline", "internal",
                    "unhealthy_then_recovered", "bad_body", "unknown_path", "cancel_unknown",
                    "cancel_in_flight", "cancel_bad_body", "draining")


@pytest.mark.parametrize("scenario", SERVER_SCENARIOS)
def test_replica_server_answers_as_the_jax_one(scenario, tmp_path):
    results = {}
    for name, (fleet, _, errors) in PACKAGES.items():
        eng = _FakeEngine(errors)
        healthy = {"v": True}
        server = fleet.ReplicaServer(eng, rank=0, port=0, health_fn=lambda h=healthy: h["v"])
        server.start(directory=str(tmp_path / name))
        try:
            results[name] = _server_scenario(scenario, server, eng, healthy)
            assert fleet.find_fleet_sidecars(str(tmp_path / name))[0]["port"] == server.port
        finally:
            server.stop()
    assert results["torch"] == results["jax"]


# -- FleetRouter against the JAX one: one script of replica outcomes -------------


class _ScriptedFleet:
    """A scripted ``ReplicaClient`` backend (the shape of the JAX package's
    fleet tests' one): per-rank behaviour; snapshots carry port = 10000 +
    rank so dispatches map back."""

    def __init__(self, behaviors):
        self.behaviors = dict(behaviors)
        self.calls = []
        self.reaps = []
        self.lock = threading.Lock()

    def generate(self, port, text, **kw):
        rank = port - 10000
        with self.lock:
            self.calls.append((rank, text))
        b = self.behaviors.get(rank, "ok")
        if callable(b):
            b = b()
        if b == "ok":
            return "ok", 200, {"text": text.upper(), "rank": rank, "tokens": 3}
        if b == "refused":
            return "refused", 503, {"error": "replica degraded"}
        if b == "backpressure":
            return "backpressure", 429, {"retry_after": 0.5, "depth": 9}
        if b == "lost":
            return "lost", None, {"error": "socket died"}
        if b == "failed":
            return "failed", 500, {"error": "decode exploded"}
        if b == "expired":
            return "expired", 504, {"error": "deadline"}
        raise AssertionError(b)

    def cancel(self, port, trace_id, **kw):
        with self.lock:
            self.reaps.append(port - 10000)
        return True


def _sleep_then(seconds, outcome):
    def b():
        time.sleep(seconds)
        return outcome
    return b


HEDGE = dict(hedge=True, hedge_tiers=("interactive",), hedge_delay_factor=0.0, hedge_min_delay_s=0.05)

# scenario -> (behaviours, snapshots {rank: keywords}, router keywords,
#              steps: ("submit", text, submit keywords) | ("scrape", {rank: keywords})
#              | ("behave", rank, behaviour) | ("hold", tier))
ROUTER_SCENARIOS = {
    "least_loaded": ({}, {0: dict(in_flight=3), 1: dict(in_flight=0)}, dict(policy="least_loaded"),
                     [("submit", "hi", {}), ("submit", "yo", {"tier": "batch"})]),
    "drain_503_and_recover": ({0: "refused"}, {0: dict(in_flight=0), 1: dict(in_flight=5)},
                              dict(policy="least_loaded"),
                              [("submit", "x", {})] * 5 + [
                                  ("behave", 0, "ok"), ("scrape", {0: dict(in_flight=0)}),
                                  ("submit", "y", {})]),
    "all_backpressure": ({0: "backpressure", 1: "backpressure"}, {0: {}, 1: {}},
                         dict(policy="least_loaded"), [("submit", "x", {})]),
    "lost_mid_request": ({0: "lost"}, {0: dict(in_flight=0), 1: dict(in_flight=5)},
                         dict(policy="least_loaded"), [("submit", "x", {}), ("submit", "z", {})]),
    "failed_and_expired": ({0: "failed", 1: "expired"}, {0: dict(in_flight=0), 1: dict(in_flight=5)},
                           dict(policy="least_loaded"),
                           [("submit", "x", {}), ("scrape", {0: dict(in_flight=9), 1: {}}),
                            ("submit", "y", {})]),
    "no_healthy_replica": ({}, {0: dict(healthy=False), 1: dict(healthy=False)},
                           dict(policy="least_loaded"), [("submit", "x", {})]),
    "admission_rejection": ({}, {0: {}}, dict(policy="least_loaded", tiers=[("interactive", 10.0, 1)]),
                            [("hold", "interactive"), ("submit", "x", {}), ("release", None),
                             ("submit", "x", {})]),
    "pre_dispatch_deadline": ({}, {0: {}}, dict(policy="least_loaded"),
                              [("submit", "x", {"deadline_s": 0.0})]),
    "affinity_memory": ({}, {0: dict(in_flight=1), 1: dict(in_flight=0)}, dict(policy="affinity", keyed=True),
                        [("submit", "abc", {}), ("snaps", {0: dict(in_flight=0), 1: dict(in_flight=2)}),
                         ("submit", "abc", {}), ("submit", "zzz", {})]),
    "round_robin": ({}, {0: {}, 1: {}, 2: dict(healthy=False)}, dict(policy="round_robin"),
                    [("submit", t, {}) for t in "abcde"]),
    "hedge_rescues_straggler": ({0: _sleep_then(0.6, "ok")}, {0: dict(in_flight=0), 1: dict(in_flight=3)},
                                dict(policy="least_loaded", **HEDGE), [("submit", "hi", {})]),
    "hedge_not_for_batch": ({0: _sleep_then(0.3, "ok")}, {0: dict(in_flight=0), 1: dict(in_flight=3)},
                            dict(policy="least_loaded", **HEDGE), [("submit", "hi", {"tier": "batch"})]),
    "hedge_saves_lost_primary": ({0: _sleep_then(0.2, "lost"), 1: _sleep_then(0.3, "ok")},
                                 {0: dict(in_flight=0), 1: dict(in_flight=3)},
                                 dict(policy="least_loaded", **HEDGE), [("submit", "hi", {})]),
    "hedge_both_fail": ({0: _sleep_then(0.2, "failed"), 1: "failed"},
                        {0: dict(in_flight=0), 1: dict(in_flight=3)},
                        dict(policy="least_loaded", **HEDGE), [("submit", "hi", {})]),
}


def _run_router(name, monkeypatch) -> dict:
    behaviors, table, kw, steps = ROUTER_SCENARIOS[name]
    record = {}
    for pkg, (fleet, router_mod, _) in PACKAGES.items():
        scripted = _ScriptedFleet(behaviors)
        monkeypatch.setattr(router_mod.ReplicaClient, "generate", staticmethod(scripted.generate))
        monkeypatch.setattr(router_mod.ReplicaClient, "cancel", staticmethod(scripted.cancel))
        snaps = {r: snap(fleet, r, **k) for r, k in table.items()}
        kw2 = dict(kw)
        admission = None
        if "tiers" in kw2:
            admission = fleet.FleetAdmission(
                tiers={n: fleet.SLOTier(n, d, m) for n, d, m in kw2.pop("tiers")})
        if kw2.pop("keyed", False):
            kw2["key_fn"] = lambda text, f=fleet: f.prefix_digest([ord(c) for c in text])
        router = fleet.FleetRouter(snapshot_source=lambda s=snaps: dict(s), admission=admission, **kw2)
        outcomes, held = [], []
        for step, *args in steps:
            if step == "submit":
                try:
                    out = router.submit(args[0], **args[1])
                    outcomes.append(("ok", out["rank"], out["text"]))
                except fleet.FleetBackpressure as e:
                    outcomes.append(("FleetBackpressure", e.retry_after, e.scope, e.depth))
                except fleet.FleetRequestFailed as e:
                    outcomes.append(("FleetRequestFailed", e.rank, e.status, str(e)))
                except fleet.FleetUnavailable as e:
                    outcomes.append(("FleetUnavailable", str(e)))
                except Exception as e:  # noqa: BLE001 — DeadlineExceeded of either package
                    outcomes.append((type(e).__name__, str(e)))
            elif step == "scrape":
                router._on_scrape({r: snap(fleet, r, **k) for r, k in args[0].items()})
            elif step == "snaps":
                snaps.update({r: snap(fleet, r, **k) for r, k in args[0].items()})
            elif step == "behave":
                scripted.behaviors[args[0]] = args[1]
            elif step == "hold":
                held.append(router.admission.admit(tier=args[0]))
            elif step == "release":
                router.admission.release(held.pop())
        deadline = time.monotonic() + 5.0
        while len(scripted.reaps) < router.ledger()["cancelled"] and time.monotonic() < deadline:
            time.sleep(0.01)  # the loser's reap is fire-and-forget
        stats = router.stats()
        record[pkg] = dict(
            outcomes=outcomes, calls=sorted(scripted.calls) if kw.get("hedge") else scripted.calls,
            reaps=scripted.reaps, retries=router.retries, ledger=router.check_conservation(),
            down=stats["down"], per_replica=stats["per_replica"],
            slo={t: {k: v[k] for k in ("total", "missed")} for t, v in stats["slo"].items()},
        )
    return record


@pytest.mark.parametrize("scenario", sorted(ROUTER_SCENARIOS))
def test_router_outcomes_and_ledger_as_the_jax_one(scenario, monkeypatch):
    record = _run_router(scenario, monkeypatch)
    assert record["torch"] == record["jax"]
    assert record["torch"]["ledger"]["submitted"] == sum(
        1 for s in ROUTER_SCENARIOS[scenario][3] if s[0] == "submit")


def test_router_rejects_what_the_jax_one_rejects():
    for fleet in (jfleet, tfleet):
        with pytest.raises(ValueError, match="unknown policy"):
            fleet.FleetRouter(snapshot_source=dict, policy="random")
        with pytest.raises(ValueError, match="sidecar directory"):
            fleet.FleetRouter(policy="affinity")


class _HeldFleet:
    """Replicas that hold every dispatch until released: a burst stays in
    flight, and no scrape runs between its dispatches."""

    def __init__(self):
        self.calls: dict[int, int] = {}
        self.lock = threading.Lock()
        self.arrived = threading.Semaphore(0)
        self.release = threading.Event()

    def generate(self, port, text, **kw):
        rank = port - 10000
        with self.lock:
            self.calls[rank] = self.calls.get(rank, 0) + 1
        self.arrived.release()
        assert self.release.wait(30.0)
        return "ok", 200, {"text": text, "rank": rank, "tokens": 1}


def _held_burst(fleet, router, held, n):
    """``n`` submits on their own threads; returns them once every one
    is held at its replica."""
    threads = [threading.Thread(target=router.submit, args=(f"p{i}",)) for i in range(n)]
    for t in threads:
        t.start()
    for _ in range(n):
        assert held.arrived.acquire(timeout=30.0)
    return threads


@pytest.mark.parametrize("policy", ["affinity", "least_loaded"])
def test_a_burst_between_scrapes_spreads_over_the_replicas(monkeypatch, policy):
    """The router's herd, fixed in the port only: scraped loads frozen at
    0, a burst of 8 dispatches in flight over two replicas, then 6 more
    after a third is added. The port's router counts its own dispatches
    not answered yet into each load, so every replica gets its share and
    none more than ceil(total / replicas) + AFFINITY_LOAD_SLACK; the JAX
    router, reading the scraped load alone, sends all 14 to rank 0."""
    got = {}
    for pkg, (fleet, router_mod, _) in PACKAGES.items():
        held = _HeldFleet()
        monkeypatch.setattr(router_mod.ReplicaClient, "generate", staticmethod(held.generate))
        snaps = {r: snap(fleet, r, in_flight=0) for r in (0, 1)}
        router = fleet.FleetRouter(snapshot_source=lambda s=snaps: dict(s), policy=policy)
        threads = _held_burst(fleet, router, held, 8)
        first = dict(held.calls)
        snaps[2] = snap(fleet, 2, in_flight=0)
        threads += _held_burst(fleet, router, held, 6)
        held.release.set()
        for t in threads:
            t.join(timeout=30.0)
        assert router.check_conservation()["completed"] == 14
        got[pkg] = (first, dict(held.calls))
    assert got["jax"] == ({0: 8}, {0: 14})
    first, total = got["torch"]
    assert set(first) == {0, 1} and max(first.values()) <= -(-8 // 2) + SLACK
    assert set(total) == {0, 1, 2} and sum(total.values()) == 14
    assert total[2] >= 14 // 3 and max(total.values()) <= -(-14 // 3) + SLACK
    assert all(n == 0 for n in router._dispatched.values())


def test_dispatch_counts_survive_32_threads(monkeypatch):
    """The router's per-rank dispatch counts under contention: 32 submit
    threads (more than the cores) of 20 requests each over 3 replicas,
    with a short switch interval. A lost update would leave a count
    above 0 after the last answer, skewing every later pick."""
    scripted = _ScriptedFleet({})
    monkeypatch.setattr(trouter.ReplicaClient, "generate", staticmethod(scripted.generate))
    snaps = {r: snap(tfleet, r, in_flight=0) for r in range(3)}
    router = tfleet.FleetRouter(snapshot_source=lambda: dict(snaps), policy="least_loaded")

    def client(k):
        for i in range(20):
            router.submit(f"c{k}-{i}", tier="batch")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert router.check_conservation()["completed"] == 640
    assert sum(v["dispatched"] for v in router.stats()["per_replica"].values()) == 640
    assert router._dispatched == {0: 0, 1: 0, 2: 0}


def test_a_burst_of_connections_is_not_dropped(tmp_path):
    """The router herds a burst onto one replica between scrapes. With
    socketserver's listen backlog of 5 (the JAX replica's) the kernel
    drops the SYNs past it and each waits a 1 s retransmit; the port's
    replica queues a burst of 40 while its accept loop is busy."""
    import socket

    server = tfleet.ReplicaServer(_FakeEngine(tqueue), rank=0, port=0)  # not accepting yet
    socks, refused = [], 0
    try:
        for _ in range(40):
            s = socket.socket()
            s.settimeout(0.3)
            try:
                s.connect(("127.0.0.1", server.port))
            except OSError:
                refused += 1
            socks.append(s)
        assert refused == 0
    finally:
        for s in socks:
            s.close()
        server._httpd.server_close()


# -- the drain: a closed socket only after a scrape has seen "draining" ----------


class _ServedEngine(_FakeEngine):
    """A fake engine ``serve_replica`` can own: a context manager with an
    empty ledger."""

    def __init__(self):
        super().__init__(tqueue)
        self.metrics = type("M", (), {"ledger": staticmethod(lambda: {"in_flight": 0})})()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def test_a_draining_replica_answers_until_a_scrape_saw_it(tmp_path, monkeypatch):
    """The JAX replica closes its socket the moment a drain finds nothing
    in flight, before any scrape has read "draining": a router still
    dispatching on its last "ok" snapshot then loses the request in
    transit. The port's stays up answering 503 (which the router retries
    elsewhere) until a ``/healthz`` has said "draining", and then
    ``DRAIN_SEEN_GRACE_S`` more."""
    from machine_learning_apache_spark_tpu_torch.fleet import replica as trep

    monkeypatch.setenv("MLSPARK_PLATFORM", "cpu")
    translator = type("Tr", (), {"device": torch.device("cpu"),
                                 "serve": lambda self, start=False, **kw: _ServedEngine()})()
    done = {}
    thread = threading.Thread(target=lambda: done.update(trep.serve_replica(
        translator, {}, rank=0, directory=str(tmp_path), port=0, poll_s=0.02)), daemon=True)
    thread.start()
    deadline = time.monotonic() + 10.0
    while not tfleet.find_fleet_sidecars(str(tmp_path)) and time.monotonic() < deadline:
        time.sleep(0.02)
    port = tfleet.find_fleet_sidecars(str(tmp_path))[0]["port"]
    (tmp_path / trep.drain_marker_name(0)).write_text(json.dumps({"deadline": time.time() + 60}))
    time.sleep(0.3)
    assert thread.is_alive()  # nothing scraped yet: the socket stays open
    code, body, _ = _request(port, "/v1/generate", {"text": "x"})
    assert (code, body["error"]) == (503, "replica draining")
    t_seen = time.monotonic()
    code, body, _ = _request(port, "/healthz", method="GET")
    assert (code, body["status"]) == (503, "draining")
    thread.join(10.0)
    assert not thread.is_alive() and done["drained"] is True
    assert time.monotonic() - t_seen >= trep.DRAIN_SEEN_GRACE_S
    assert done["server"]["refused_503"] == 1 and not tfleet.find_fleet_sidecars(str(tmp_path))


# -- the launcher's side: the spawn environment, no fallback to the host ---------


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_gang_spawns_the_ports_runner_with_the_ports_platform(monkeypatch, tmp_path, platform):
    from machine_learning_apache_spark_tpu_torch.launcher import replica_gang

    spawned = []

    class _Popen:
        def __init__(self, cmd, env, start_new_session):
            spawned.append((cmd, env))
            self.pid = 990001

        def poll(self):
            return None

    monkeypatch.setattr(replica_gang.subprocess, "Popen", _Popen)
    monkeypatch.setattr(replica_gang, "_register_gang", lambda procs: None)
    for name in ("JAX_PLATFORMS", "MLSPARK_PLATFORM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    gang = replica_gang.ReplicaGang("os:getcwd", num_replicas=2, workdir=str(tmp_path),
                                    platform=platform)
    gang._spawn(1)
    cmd, env = spawned[0]
    assert cmd[2] == "machine_learning_apache_spark_tpu_torch.launcher.runner"
    assert env.get("MLSPARK_PLATFORM") == platform and "JAX_PLATFORMS" not in env
    assert "MASTER_ADDR" not in env and env["MLSPARK_PROCESS_ID"] == "1"
    assert env["MLSPARK_FLEET_DIR"] == str(tmp_path)


def test_a_fleet_started_without_a_platform_puts_its_replicas_on_the_card(monkeypatch, tmp_path):
    """``torch_fleet_bench.start_fleet`` defaults to the card, as
    ``ReplicaGang`` and ``Distributor`` do: no replica env asks for the
    host."""
    from machine_learning_apache_spark_tpu_torch.launcher import replica_gang

    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    import torch_fleet_bench as fb

    spawned = []

    class _Popen:
        def __init__(self, cmd, env, start_new_session):
            spawned.append(env)
            self.pid = 990001

        def poll(self):
            return None

    monkeypatch.setattr(replica_gang.subprocess, "Popen", _Popen)
    monkeypatch.setattr(replica_gang, "_register_gang", lambda procs: None)
    monkeypatch.delenv("MLSPARK_PLATFORM", raising=False)
    gang, router = fb.start_fleet(2, str(tmp_path), "os:getcwd")
    try:
        assert gang.platform is None
        assert len(spawned) == 2
        assert all(env.get("MLSPARK_PLATFORM") != "cpu" for env in spawned)
        assert all("MLSPARK_PLATFORM" not in env for env in spawned)
    finally:
        gang._stop.set()  # the fake ranks have no process to signal
        router.stop()


def test_a_replica_never_serves_from_the_host_unasked(monkeypatch, translator_spec):
    from machine_learning_apache_spark_tpu_torch.fleet.replica import replica_device, serve_replica

    import torch_fleet_bench as fb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MLSPARK_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match=r"device 'cuda'"):
        replica_device()
    host = fb.build_translator(translator_spec[0], "cpu")
    with pytest.raises(RuntimeError, match=r"device 'cuda'"):
        serve_replica(host, {})
    monkeypatch.setenv("MLSPARK_PLATFORM", "cpu")
    assert replica_device() == torch.device("cpu")
    # A card-asked replica handed a host translator raises too: nothing
    # moves to the host quietly.
    monkeypatch.setenv("MLSPARK_PLATFORM", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="serves on cuda"):
        serve_replica(host, {})


# -- the slice end to end: one 2-replica gang for the module ------------------------

ENGINE = dict(boundaries=(8, 16), max_batch=4, max_new_tokens=8, kv_mode="paged")
N_ROUTED = 16


@pytest.fixture(scope="module")
def translator_spec():
    """One tiny untrained MT model in both packages (the port's serving
    tests' widths): the JAX ``Translator`` and the spec a port replica
    builds its translator from, the Flax tree carried across as numpy."""
    from machine_learning_apache_spark_tpu.data.datasets import synthetic_translation_pairs
    from machine_learning_apache_spark_tpu.data.text import TextPipeline
    from machine_learning_apache_spark_tpu.inference import Translator
    from machine_learning_apache_spark_tpu.models import Transformer, TransformerConfig

    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    import torch_fleet_bench as fb

    pairs = synthetic_translation_pairs(64, min_len=3, max_len=8, seed=0)
    src = TextPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg = TextPipeline.fit([t for _, t in pairs], max_seq_len=14)
    config = dict(src_vocab_size=len(src.vocab.itos), trg_vocab_size=len(trg.vocab.itos),
                  d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16, dropout=0.0)
    jm = Transformer(TransformerConfig(**config))
    dummy = np.ones((2, 8), np.int32)
    params = nn.unbox(jax.jit(jm.init)(jax.random.key(0), dummy, dummy)["params"])
    spec = fb.translator_spec(jax.tree.map(np.asarray, params), src.vocab.itos, trg.vocab.itos, 14,
                              config)
    return spec, Translator(jm, params, src, trg), [s for s, _ in pairs]


@pytest.fixture(scope="module")
def live_fleet(translator_spec, tmp_path_factory):
    """The 2-replica port gang and its router; the JAX package's paged
    engine computes the oracle in this thread while the replicas start."""
    import torch_fleet_bench as fb

    spec, jt, texts = translator_spec
    workdir = str(tmp_path_factory.mktemp("fleet"))
    key_fn = fb.make_key_fn(fb.build_translator(spec, "cpu"))
    gang, router = fb.start_fleet(
        2, workdir, "torch_fleet_bench:replica_main", spec, ENGINE, platform="cpu",
        key_fn=key_fn, gang_kw=dict(backoff_base=0.1),
    )
    try:
        with jt.serve(**ENGINE) as eng:
            want = [f.result(timeout=120) for f in [eng.submit(s) for s in texts[:N_ROUTED]]]
        fb.wait_fleet(gang, router, 2, timeout=180.0)
        yield gang, router, texts, want, key_fn
    finally:
        router.stop()
        gang.stop(drain_s=5.0)


def test_routed_outputs_token_identical_to_the_jax_engine(live_fleet):
    import torch_fleet_bench as fb

    gang, router, texts, want, _ = live_fleet
    routed = fb.route(router, texts[:N_ROUTED], clients=4)
    assert not routed["errors"]
    assert routed["outs"] == want
    # A burst spreads over the replicas once the scrapes see one loaded
    # (a short sequence may all land on rank 0: least load is scraped).
    load = fb.drive_load(router, texts, clients=4, duration=1.5)
    assert load["failed"] == load["rejected"] == load["unavailable"] == 0
    assert fb.served_ranks(router) == [0, 1]
    gate = fb.conservation_gate(router)
    assert gate["ok"] and gate["router_ledger"]["completed"] == N_ROUTED + load["completed"]
    assert gate["replica_in_flight"] == {0: 0, 1: 0}
    status = fb.replica_sections(router)
    assert {r: s["device"] for r, s in status.items()} == {0: "cpu", 1: "cpu"}
    serving = fb.replica_sections(router, "serving")
    assert all(s["recompiles_after_warmup"] == 0 for s in serving.values())


def test_a_repeated_prompt_lands_on_its_warm_replica(live_fleet):
    import torch_fleet_bench as fb

    gang, router, texts, want, key_fn = live_fleet
    prompt = texts[N_ROUTED]
    first = router.submit(prompt, deadline_s=60.0)
    assert first["rank"] in router.affinity.candidates(key_fn(prompt))
    again = [router.submit(prompt, deadline_s=60.0)["rank"] for _ in range(3)]
    assert again == [first["rank"]] * 3
    stats = fb.fleet_prefix_stats(router)
    assert stats["per_replica"][first["rank"]]["hits"] >= 3


def test_kill_rank_costs_only_its_in_flight_and_restarts(live_fleet):
    import torch_fleet_bench as fb

    gang, router, texts, _, _ = live_fleet
    before = router.ledger()
    rank0 = router.stats()["per_replica"][0]["completed"]
    stop = threading.Event()
    load = {}
    driver = threading.Thread(target=lambda: load.update(fb.drive_load(
        router, texts, clients=4, stop=stop, deadline_s=60.0)), daemon=True)
    driver.start()
    time.sleep(0.5)
    assert gang.kill_rank(1)
    t_kill = time.monotonic()
    served_at_kill = router.stats()["per_replica"][1]["completed"]

    def rank1_back():
        st = gang.status()
        snap1 = router._scrape.snapshots().get(1)
        return (st["restarts"][1] >= 1 and snap1 is not None and snap1.healthy
                and router.stats()["per_replica"][1]["completed"] > served_at_kill)

    while not rank1_back() and time.monotonic() - t_kill < 120.0:
        time.sleep(0.1)
    stop.set()
    driver.join(120.0)
    assert rank1_back(), gang.status()
    assert set(load["failed_by_rank"]) <= {1} and load["failed"] <= 4  # one request a client
    assert load["unavailable"] == load["rejected"] == load["expired"] == 0
    assert router.stats()["per_replica"][0]["completed"] > rank0  # rank 0 served on
    deadline = time.monotonic() + 30.0
    while router.ledger()["in_flight"] and time.monotonic() < deadline:
        time.sleep(0.05)
    ledger = router.check_conservation()
    assert ledger["submitted"] - before["submitted"] == load["completed"] + load["failed"]
    status = gang.status()
    assert status["restarts"] == {0: 0, 1: 1} and status["alive"] == {0: True, 1: True}
