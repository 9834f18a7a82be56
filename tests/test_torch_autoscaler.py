"""The port's ``fleet/autoscaler.py`` against the JAX package's, on the CPU.

Both packages' ``FleetAutoscaler`` run through the same scenarios over a
fake gang and a fake clock (the shapes of the JAX package's autoscaler
tests): queue and burn triggers, hysteresis, cooldown, the clamps, the
coldest-replica drain with batch shedding and its completion, one drain
at a time, the last healthy replica kept, exhausted ranks absorbed as
observed scale-downs, and a churn of all of them. The observed signals,
the decision logs (action, target and inputs, decision by decision) and
the fakes' recorded calls must be equal. Then the port's own pieces: the
decisions as ``fleet.autoscaler`` annotations, ``ScrapeLoop`` membership
churn, the router's purge of a vanished rank, and the port's
``ReplicaGang`` membership rules (lowest free id, the drain marker, a
reap only after permanent death, files scrubbed).
"""

import importlib
import json
import types

import pytest

import machine_learning_apache_spark_tpu.fleet as jfleet
import machine_learning_apache_spark_tpu_torch.fleet as tfleet
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

pytestmark = pytest.mark.fleet


def snap(fleet, rank, *, healthy=True, status=None, in_flight=0, ewma=0.0):
    if status is None:
        status = "ok" if healthy else "degraded"
    return fleet.ReplicaSnapshot(
        rank=rank, port=10000 + rank, healthy=healthy, status=status, in_flight=in_flight,
        queue_depth=0,
        slo={"interactive": {"ewma": ewma, "window_count": 10, "window_missed": int(10 * ewma),
                             "total": 10, "missed": int(10 * ewma)}},
    )


class FakeGang:
    """The membership API the autoscaler drives, with recorded calls; a
    retiring rank is no longer live, as in the real gang."""

    def __init__(self, ranks=(0, 1)):
        self._live = set(ranks)
        self.exhausted = set()
        self.retired = set()
        self.added = []
        self.retire_calls = []
        self.reaped = []

    def live_ranks(self):
        return sorted(self._live)

    def add_rank(self):
        rank = 0
        while rank in self._live:
            rank += 1
        self._live.add(rank)
        self.added.append(rank)
        return rank

    def retire_rank(self, rank, *, drain=True, deadline_s=None):
        if rank not in self._live:
            return False
        self.retire_calls.append((rank, drain, deadline_s))
        self._live.discard(rank)
        return True

    def reap_rank(self, rank):
        if rank in self._live:
            return False
        self.reaped.append(rank)
        self.retired.add(rank)
        return True


class FakeAdmission:
    def __init__(self):
        self.sheds = []
        self.unsheds = []

    def shed(self, tier, factor):
        self.sheds.append((tier, factor))

    def unshed(self, tier):
        self.unsheds.append(tier)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


BASE = dict(min_replicas=1, max_replicas=4, burn_up=0.1, burn_down=0.01, queue_up=4.0,
            queue_down=1.0, hysteresis_ticks=2, cooldown_s=5.0, drain_deadline_s=20.0,
            drain_batch_shed=0.5)
HOT = dict(in_flight=9)

# scenario -> (gang ranks, config overrides, admission?, steps). Steps:
# ("obs", {rank: snap keywords}) observes exactly those snapshots;
# ("live", keywords) observes every live rank with the same keywords;
# ("tick", s) advances the clock; ("exhaust", rank) kills a rank for good.
SCENARIOS = {
    "queue_trigger_after_hysteresis": ((0, 1), dict(cooldown_s=0.0), False, [
        ("obs", {0: dict(in_flight=6), 1: dict(in_flight=6)}),
        ("obs", {0: dict(in_flight=6), 1: dict(in_flight=6)})]),
    "burn_trigger": ((0,), dict(hysteresis_ticks=1, cooldown_s=0.0), False, [
        ("obs", {0: dict(in_flight=0, ewma=0.5)})]),
    "cold_tick_resets_hysteresis": ((0,), dict(cooldown_s=0.0), False, [
        ("obs", {0: HOT}), ("obs", {0: dict(in_flight=2)}), ("obs", {0: HOT})]),
    "cooldown_blocks_back_to_back": ((0,), dict(hysteresis_ticks=1, cooldown_s=10.0), False, [
        ("obs", {0: HOT}), ("obs", {0: HOT}), ("tick", 11.0), ("obs", {0: HOT})]),
    "max_clamp": ((0, 1), dict(max_replicas=2, hysteresis_ticks=1, cooldown_s=0.0), False, [
        ("obs", {0: HOT, 1: HOT})]),
    "coldest_drained_batch_shed": ((0, 1, 2), dict(hysteresis_ticks=1, cooldown_s=0.0), True, [
        ("obs", {0: dict(in_flight=2), 1: dict(in_flight=0), 2: dict(in_flight=1)}),
        ("obs", {0: {}, 1: dict(healthy=False, status="draining"), 2: {}}),
        ("obs", {0: {}, 2: {}}), ("obs", {0: {}, 2: {}})]),
    "one_drain_at_a_time": ((0, 1, 2), dict(hysteresis_ticks=1, cooldown_s=0.0), True, [
        ("obs", {0: {}, 1: {}, 2: {}}), ("obs", {0: {}, 1: {}, 2: {}})]),
    "min_clamp": ((0,), dict(hysteresis_ticks=1, cooldown_s=0.0), True, [("obs", {0: {}})]),
    "last_healthy_kept": ((0, 1, 2), dict(hysteresis_ticks=1, cooldown_s=0.0), True, [
        ("obs", {0: {}, 1: dict(healthy=False), 2: dict(healthy=False, status="unreachable")})]),
    "draining_not_load_bearing": ((0, 1), dict(hysteresis_ticks=1, cooldown_s=0.0), True, [
        ("obs", {0: dict(in_flight=0), 1: dict(in_flight=50, status="draining", healthy=False)})]),
    "observed_scale_down": ((0, 2), dict(min_replicas=2), False, [
        ("exhaust", 1), ("obs", {0: {}, 2: {}}), ("obs", {0: {}, 2: {}})]),
    "churn": ((0, 1), dict(hysteresis_ticks=1, cooldown_s=5.0), True, [
        ("live", HOT), ("live", HOT), ("tick", 6.0), ("exhaust", 0), ("live", {}),
        ("tick", 6.0), ("live", {}), ("live", {}), ("tick", 6.0), ("live", {}),
        ("live", dict(in_flight=6)), ("tick", 6.0), ("live", dict(in_flight=6, ewma=0.2))]),
    "cycle_2_3_2": ((0, 1), dict(min_replicas=2, max_replicas=3, queue_up=1.5, queue_down=0.5,
                                 cooldown_s=2.0), True, [
        ("live", dict(in_flight=4)), ("live", dict(in_flight=4)), ("live", dict(in_flight=4)),
        ("tick", 3.0), ("live", {}), ("live", {}), ("live", {}), ("tick", 3.0), ("live", {}),
        ("live", {}), ("tick", 3.0), ("live", {})]),
}


def _run(fleet, scenario: str) -> dict:
    ranks, overrides, with_admission, steps = SCENARIOS[scenario]
    gang, clock = FakeGang(ranks), FakeClock()
    admission = FakeAdmission() if with_admission else None
    scaler = fleet.FleetAutoscaler(gang, config=fleet.AutoscaleConfig(**{**BASE, **overrides}),
                                   admission=admission, clock=clock)
    observed = []
    for step, arg in steps:
        if step == "obs":
            observed.append(scaler.observe({r: snap(fleet, r, **kw) for r, kw in arg.items()}))
        elif step == "live":
            observed.append(scaler.observe({r: snap(fleet, r, **arg) for r in gang.live_ranks()}))
        elif step == "tick":
            clock.now += arg
        else:
            gang.exhausted.add(arg)
            gang._live.discard(arg)
    decisions = [{k: v for k, v in d.items() if k != "wall"} for d in scaler.decisions]
    stats = scaler.stats()
    return dict(
        observed=observed, decisions=decisions, added=gang.added, retire_calls=gang.retire_calls,
        reaped=gang.reaped, sheds=admission and admission.sheds,
        unsheds=admission and admission.unsheds,
        stats={k: stats[k] for k in ("ticks", "scale_ups", "scale_downs", "observed_scale_downs",
                                     "draining", "shed_active", "decisions", "config")},
    )


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decision_log_equals_the_jax_autoscalers(scenario):
    got, want = _run(tfleet, scenario), _run(jfleet, scenario)
    assert got == want
    for d in got["decisions"]:
        for key in ("action", "burn", "queue_depth", "healthy", "live", "target"):
            assert key in d, (key, d)


def test_scenarios_reach_every_action():
    actions = {d["action"] for s in SCENARIOS for d in _run(tfleet, s)["decisions"]}
    assert actions >= {"scale_up", "hold_cooldown", "hold_at_max", "scale_down_start",
                       "scale_down_complete", "hold_at_min", "hold_last_healthy",
                       "observed_scale_down"}


def test_config_rejects_what_the_jax_config_rejects():
    for bad, match in ((dict(burn_down=0.5, burn_up=0.1), "burn_down"),
                       (dict(queue_down=9.0, queue_up=4.0), "queue_down"),
                       (dict(min_replicas=0), "min_replicas"),
                       (dict(min_replicas=3, max_replicas=2), "max_replicas"),
                       (dict(drain_batch_shed=0.0), "drain_batch_shed")):
        msgs = []
        for fleet in (tfleet, jfleet):
            with pytest.raises(ValueError, match=match) as e:
                fleet.AutoscaleConfig(**{**BASE, **bad})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_decisions_land_as_annotations():
    from machine_learning_apache_spark_tpu_torch.telemetry import events

    events.set_enabled(True)
    try:
        log = events.get_log()

        def mine():
            return [e for e in log.snapshot() if e.kind == "annotation" and e.name == "fleet.autoscaler"]

        before = len(mine())
        scaler = tfleet.FleetAutoscaler(
            FakeGang({0}), config=tfleet.AutoscaleConfig(**{**BASE, "hysteresis_ticks": 1,
                                                            "cooldown_s": 0.0}))
        scaler.observe({0: snap(tfleet, 0, **HOT)})
        auto = mine()
        assert len(auto) == before + 1
        attrs = auto[-1].attrs or {}
        assert attrs["action"] == "scale_up" and attrs["target"] == 2
        assert "burn" in attrs and "queue_depth" in attrs
    finally:
        events.set_enabled(None)


# -- ScrapeLoop membership churn, on the port --------------------------------------


class ScriptedScrape:
    """Stands in for ``snapshot_replica``: a scripted status per rank."""

    def __init__(self):
        self.status = {}

    def __call__(self, rank, port, *, timeout=2.0, retries=0):
        status = self.status.get(rank, "ok")
        s = tfleet.ReplicaSnapshot(rank=rank, port=port, status=status)
        if status != "unreachable":
            s.healthy = status == "ok"
            s.in_flight = 1
        return s


@pytest.fixture()
def scripted_loop(tmp_path, monkeypatch):
    smod = importlib.import_module("machine_learning_apache_spark_tpu_torch.fleet.scrape")
    scripted = ScriptedScrape()
    monkeypatch.setattr(smod, "snapshot_replica", scripted)

    def sidecar(rank):
        path = tmp_path / f"fleet_rank{rank}.json"
        path.write_text(json.dumps({"port": 10000 + rank, "rank": rank}))
        return path

    return smod.ScrapeLoop(str(tmp_path), unreachable_after=2), scripted, sidecar


def test_scrape_loop_follows_membership(scripted_loop):
    loop, scripted, sidecar = scripted_loop
    sidecar(0)
    p1 = sidecar(1)
    assert sorted(loop.tick()) == [0, 1]
    p1.unlink()  # the gang scrubbed a retired rank's sidecars
    assert sorted(loop.tick()) == [0] and 1 not in loop.snapshots()
    sidecar(2)  # a scale-up published its port
    snaps = loop.tick()
    assert sorted(snaps) == [0, 2] and snaps[2].healthy
    seen = []
    loop.add_observer(lambda s: (_ for _ in ()).throw(RuntimeError("never kills the plane")))
    loop.add_observer(lambda s: seen.append(sorted(s)))
    loop.tick()
    assert seen == [[0, 2]]


def test_draining_is_not_a_failure_and_grace_keeps_it(scripted_loop):
    loop, scripted, sidecar = scripted_loop
    sidecar(0)
    scripted.status[0] = "draining"
    s = loop.tick()[0]
    assert s.draining and not s.healthy and s.consecutive_failures == 0
    scripted.status[0] = "unreachable"  # the drained process exited
    s = loop.tick()[0]
    assert s.status == "draining" and s.consecutive_failures == 1
    s = loop.tick()[0]
    assert s.status == "unreachable" and s.consecutive_failures == 2


def test_router_purges_a_vanished_rank():
    s0, s1 = snap(tfleet, 0), snap(tfleet, 1)
    s1.prefix_digests = frozenset({"d1"})
    holder = {"snaps": {0: s0, 1: s1}}
    router = tfleet.FleetRouter(snapshot_source=lambda: dict(holder["snaps"]), policy="affinity")
    router._on_scrape({0: s0, 1: s1})
    router.affinity.note_routed("digest-x", 1)
    assert 1 in router.affinity.candidates("d1") and 1 in router.affinity.candidates("digest-x")
    router._box(1)
    holder["snaps"] = {0: s0}
    router._on_scrape({0: s0})
    assert 1 not in router._down
    assert 1 not in router.affinity.candidates("d1") | router.affinity.candidates("digest-x")
    assert 1 not in router.affinity.stats()["ranks_with_residency"]


# -- the port's ReplicaGang membership rules (no processes) ------------------------


@pytest.fixture()
def gang(tmp_path, monkeypatch):
    from machine_learning_apache_spark_tpu_torch.launcher.replica_gang import ReplicaGang

    spawned = []
    monkeypatch.setattr(ReplicaGang, "_spawn", lambda self, rank: spawned.append(rank))

    def make(ranks=(0, 1)):
        g = ReplicaGang("os:getcwd", num_replicas=len(ranks), workdir=str(tmp_path))
        for r in ranks:
            g._procs[r] = types.SimpleNamespace(poll=lambda: None, returncode=None, pid=990000 + r)
        return g, spawned

    return make


def test_add_rank_takes_the_lowest_free_id_and_starts_clean(gang, tmp_path):
    g, spawned = gang(ranks=(0, 2))
    assert g.add_rank() == 1 and spawned == [1]
    g, spawned = gang(ranks=(0,))
    g.exhausted.add(1)
    g.retired.add(1)
    g.restarts[1] = 2
    g._restart_at[1] = 999.0
    stale = tmp_path / "fleet_rank1.json"
    stale.write_text("{}")
    assert g.add_rank() == 1
    assert 1 not in g.exhausted | g.retired and g.restarts[1] == 0 and 1 not in g._restart_at
    assert not stale.exists()


def test_retire_rank_drops_a_drain_marker(gang, tmp_path):
    g, _ = gang()
    assert g.retire_rank(1, drain=True, deadline_s=5.0)
    payload = json.loads((tmp_path / "fleet_drain_rank1").read_text())
    assert payload["rank"] == 1 and payload["deadline"] > 0
    assert g.live_ranks() == [0]
    assert not g.retire_rank(1) and not g.retire_rank(7)


def test_reap_only_after_permanent_death(gang, tmp_path):
    g, _ = gang(ranks=(0,))
    assert not g.reap_rank(0) and not g.reap_rank(1)
    g.exhausted.add(1)
    side = tmp_path / "fleet_rank1.json"
    side.write_text("{}")
    assert g.reap_rank(1) and 1 in g.retired and not side.exists()


def test_retirement_scrubs_the_ranks_files(gang, tmp_path):
    g, _ = gang()
    names = ("fleet_rank1.json", "http_rank1.json", "heartbeat_1", "fleet_drain_rank1")
    for name in names:
        (tmp_path / name).write_text("{}")
    g._retiring[1] = 0.0
    g._finalize_retirement(1, g._procs[1])
    assert 1 not in g._procs and 1 not in g._retiring and 1 in g.retired
    assert not any((tmp_path / name).exists() for name in names)
