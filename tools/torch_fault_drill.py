#!/usr/bin/env python3
"""The port's fault drill: run the injection scenarios end to end.

    python3 tools/torch_fault_drill.py --smoke [--out P]        # the CPU: the two wire scenarios
    python3 tools/torch_fault_drill.py [--out P] [scenario ...] # the card: all eight
    python3 tools/torch_fault_drill.py --cpu [--out P] [...]    # all eight on the host

The twin of ``tools/fault_drill.py`` over the PyTorch port: the same
scenarios under the same names, fault plans and ``ok`` invariants, the
same artifact keys. Each scenario arms a deterministic fault plan
(``utils.faults``), runs the port's subsystem against it, and records
what the robustness layer did about it:

- ``gang_crash_resume`` — rank 1 of a 2-process training gang dies
  (``os._exit``) at step 9; the ``Distributor`` retries the gang, which
  resumes from its checkpoints and ends on the unfaulted run's loss.
- ``gang_stall`` — rank 1 goes silent at step 2 (heartbeats suspended, a
  hang); the heartbeat monitor names rank 1 and the cause.
- ``serving_poison`` — decode launch 0 raises; only its requests fail
  (``InternalError``), the loop keeps serving, zero recompiles.
- ``fleet_kill_replica`` — rank 1 of a 2-replica fleet is SIGKILLed under
  load; only its in-flight requests are lost, the router drains around
  it, the ``ReplicaGang`` supervisor restarts it and it serves again.
- ``preemption_as_scale_down`` — a 3-replica fleet with a restart budget
  of 0 loses rank 1; the ``FleetAutoscaler`` reaps it as an observed
  scale-down, the ledger conserves, the interactive tier never starves.
- ``elastic_shrink`` — an 8-rank ZeRO-1 gang loses rank 7 and then rank 6
  for good, shrinks 8 -> 7 -> 6 resharding its checkpoint group each
  time, and ends within 1e-3 of an unfaulted 6-rank run's loss (global
  batch 168 = lcm(8, 7, 6)).
- ``straggler_hedge`` — rank 1 carries a sticky 1.5 s wire delay; hedged
  duplicates on rank 0 win and the losers are reaped by
  ``POST /v1/cancel``; every request completes exactly once.
- ``torn_response_retry`` — rank 1 tears one response (a full
  Content-Length, half a body); the router books it terminal-``lost``
  and never replays it; the client resubmits under a new id.

Every drilled failure must also leave a non-empty ``flight_<rank>.json``
flight-recorder dump in the scenario's ``MLSPARK_TELEMETRY_DIR``.

The gangs and replicas run on the card unless ``--smoke`` or ``--cpu``
keeps them on the host; a run that asks for the card where there is none
raises. The fleet scenarios take their replica body, its arguments and
the platform as a ``ReplicaBody``: ``--smoke`` and ``--cpu`` pass the
tiny translator of ``torch_fleet_bench.smoke_spec``, the card's run the
reference MT model at full width (``chip_smoke.py``'s serving
configuration, random weights from the seed). Gang workers come from
``tests/torch_launcher_workers.py``. Nothing is written without
``--out``. Exits nonzero if any scenario's invariant does not hold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "tools", ROOT / "tests", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from machine_learning_apache_spark_tpu_torch.utils import faults  # noqa: E402
from torch_fleet_bench import ReplicaBody  # noqa: E402

#: The JAX drill's in-process engine for ``serving_poison`` (batches of 4).
POISON_KNOBS = dict(boundaries=(8, 16), max_batch=4, max_wait_s=0.01, max_new_tokens=8)


def _with_plan(plan: str, marker_dir: str, telemetry_dir: str | None = None):
    os.environ[faults.ENV_PLAN] = plan
    os.environ[faults.ENV_MARKER_DIR] = marker_dir
    if telemetry_dir:
        # The flight dumps must outlive the gang's workdir, which the
        # Distributor removes; workers inherit this directory.
        os.makedirs(telemetry_dir, exist_ok=True)
        os.environ["MLSPARK_TELEMETRY_DIR"] = telemetry_dir
    faults.clear()  # re-arm the lazy env read in this process too


def _clear_plan():
    os.environ.pop(faults.ENV_PLAN, None)
    os.environ.pop(faults.ENV_MARKER_DIR, None)
    os.environ.pop("MLSPARK_TELEMETRY_DIR", None)
    faults.clear()


def _flight_info(telemetry_dir: str, rank) -> dict:
    """One ``flight_<rank>.json`` for the artifact: does it exist, how
    many events, how many of them spans."""
    path = os.path.join(telemetry_dir, f"flight_{rank}.json")
    if not os.path.exists(path):
        return {"path": path, "exists": False, "events": 0}
    with open(path) as f:
        dump = json.load(f)
    events = dump.get("events", [])
    return {
        "path": path,
        "exists": True,
        "reason": dump.get("reason"),
        "events": len(events),
        "span_events": sum(1 for e in events if e.get("kind") in ("span_start", "span_end")),
    }


def _fired(markers: str) -> list[str]:
    return sorted(os.listdir(markers)) if os.path.isdir(markers) else []


# -- the gang scenarios -----------------------------------------------------------


def scenario_gang_crash_resume(workdir: str, platform: str | None = None) -> dict:
    import torch_launcher_workers

    from machine_learning_apache_spark_tpu_torch.launcher import Distributor

    t0 = time.monotonic()
    # The unfaulted reference on the gang's device, in this process.
    ref = torch_launcher_workers.fault_drill_train(
        os.path.join(workdir, "ref"), device="cpu" if platform == "cpu" else "cuda")

    plan = "crash@train_step:rank=1,step=9"
    markers = os.path.join(workdir, "markers")
    tdir = os.path.join(workdir, "telemetry")
    _with_plan(plan, markers, telemetry_dir=tdir)
    try:
        out = Distributor(
            num_processes=2, platform=platform, timeout=300, max_restarts=1,
            backoff_base=0.05, term_grace=2.0,
        ).run("torch_launcher_workers:fault_drill_train", os.path.join(workdir, "gang"))
        # Rank 1 dumped its event-log tail in maybe_fault before os._exit.
        flight = _flight_info(tdir, 1)
    finally:
        _clear_plan()
    fired = _fired(markers)
    loss_delta = abs(out["final_loss"] - ref["final_loss"])
    return {
        "scenario": "gang_crash_resume",
        "plan": plan,
        "fault_fired": fired,
        "unfaulted_final_loss": ref["final_loss"],
        "drilled_final_loss": out["final_loss"],
        "loss_delta": loss_delta,
        "rank0_resumed_step": out["resumed_step"],
        "flight": flight,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": bool(fired) and loss_delta < 1e-6 and flight["exists"] and flight["events"] > 0,
    }


def scenario_gang_stall(workdir: str, platform: str | None = None) -> dict:
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, GangFailure

    plan = "stall@train_step:rank=1,step=2"
    t0 = time.monotonic()
    tdir = os.path.join(workdir, "telemetry")
    _with_plan(plan, os.path.join(workdir, "markers"), telemetry_dir=tdir)
    failure = None
    try:
        # The timeout must exceed a rank's spawn-to-first-beat time: a
        # rank that has not beaten yet is judged from its spawn, and an
        # innocent rank 0 slow to start would be blamed.
        Distributor(
            num_processes=2, platform=platform, timeout=300,
            heartbeat_interval=0.2, heartbeat_timeout=8.0, term_grace=1.0,
        ).run("torch_launcher_workers:fault_drill_train", os.path.join(workdir, "gang"))
    except GangFailure as e:
        failure = e
    finally:
        # Rank 1 dumped flight_1.json before its stall loop; the driver's
        # monitor dumped flight_driver.json when the beats stopped.
        flight = _flight_info(tdir, 1)
        driver_flight = _flight_info(tdir, "driver")
        _clear_plan()
    return {
        "scenario": "gang_stall",
        "plan": plan,
        "detected": failure is not None,
        "cause": failure.cause if failure else None,
        "rank": failure.rank if failure else None,
        "flight": flight,
        "driver_flight": driver_flight,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            failure is not None
            and failure.cause == "heartbeat"
            and failure.rank == 1
            and flight["exists"]
            and flight["events"] > 0
            and driver_flight["exists"]
            and driver_flight["events"] > 0
        ),
    }


def scenario_elastic_shrink(workdir: str, platform: str | None = None) -> dict:
    """8 ranks -> rank 7 lost for good -> 7 -> rank 6 lost -> 6. A restart
    budget of 0 makes each crash a permanent loss, so the elastic policy
    is the only way back; the second crash only arms at world 7, so the
    drill runs two reshards one after the other. The unfaulted reference
    is a 6-rank gang on the same global batch schedule."""
    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor

    t0 = time.monotonic()
    kw = dict(epochs=4, global_batch=168, steps_per_epoch=2)
    ref = Distributor(num_processes=6, platform=platform, timeout=600).run(
        "torch_launcher_workers:elastic_drill_train", os.path.join(workdir, "ref"), **kw)
    t_ref = time.monotonic() - t0

    plan = "crash@train_step:world=8,rank=7,step=5;crash@train_step:world=7,rank=6,step=7"
    markers = os.path.join(workdir, "markers")
    tdir = os.path.join(workdir, "telemetry")
    _with_plan(plan, markers, telemetry_dir=tdir)
    t1 = time.monotonic()
    try:
        out = Distributor(
            num_processes=8, platform=platform, timeout=600,
            elastic=True, rank_restart_budget=0, elastic_min_world=6,
            backoff_base=0.05, term_grace=2.0,
        ).run("torch_launcher_workers:elastic_drill_train", os.path.join(workdir, "gang"), **kw)
        t_end = time.monotonic()
        flights = {r: _flight_info(tdir, r) for r in (7, 6)}
    finally:
        _clear_plan()
    # Each world's attempt, spawn to the crash that shrank it (the last,
    # to its result): the launcher's ``launcher.gang_attempt`` spans.
    worlds = {str((e.attrs or {}).get("num_processes")): round(e.value, 2)
              for e in telemetry.get_log().snapshot()
              if e.kind == "span_end" and e.name == "launcher.gang_attempt" and e.ts >= t1}
    fired = _fired(markers)
    loss_delta = abs(out["final_loss"] - ref["final_loss"])
    return {
        "scenario": "elastic_shrink",
        "plan": plan,
        "fault_fired": fired,
        "unfaulted_final_loss": ref["final_loss"],
        "drilled_final_loss": out["final_loss"],
        "loss_delta": loss_delta,
        "final_world": out["world"],
        "resumed_step": out["resumed_step"],
        "flights": {str(r): f for r, f in flights.items()},
        "reference_seconds": round(t_ref, 2),
        "drilled_seconds": round(t_end - t1, 2),
        "world_seconds": worlds,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            len(fired) == 2
            and out["world"] == 6
            and out["resumed_step"] in (2, 4, 6)
            and loss_delta < 1e-3
            and all(f["exists"] and f["events"] > 0 for f in flights.values())
        ),
    }


# -- the in-process engine ---------------------------------------------------------


def tiny_translator():
    """The JAX drill's in-process model at its sizes, on the host: 32
    synthetic pairs, pipelines of 14 ids, the MT model at d_model 32,
    weights from seed 0. Returns the translator and the 12 prompts."""
    import torch

    from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_translation_pairs
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig

    pairs = synthetic_translation_pairs(32, min_len=3, max_len=8, seed=0)
    src_pipe = TextPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg_pipe = TextPipeline.fit([t for _, t in pairs], max_seq_len=14)
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos), trg_vocab_size=len(trg_pipe.vocab.itos),
        d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16, dropout=0.0,
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    return Translator(model, src_pipe, trg_pipe, device="cpu"), [s for s, _ in pairs][:12]


def scenario_serving_poison(workdir: str, translator=None, texts=None, knobs: dict | None = None) -> dict:
    """Decode launch 0 raises. ``translator`` and ``texts`` default to
    ``tiny_translator()``'s, ``knobs`` to ``POISON_KNOBS`` (at most 4
    rows decode together, so at most 4 requests may fail)."""
    from machine_learning_apache_spark_tpu_torch.serving import InternalError

    t0 = time.monotonic()
    if translator is None:
        translator, default_texts = tiny_translator()
        texts = texts or default_texts
    knobs = dict(POISON_KNOBS if knobs is None else knobs)
    plan = "raise@decode_batch:batch=0"
    # In process (no gang rank): the quarantine's dump is flight_driver.json.
    tdir = os.path.join(workdir, "telemetry")
    os.makedirs(tdir, exist_ok=True)
    os.environ["MLSPARK_TELEMETRY_DIR"] = tdir
    faults.install(faults.FaultPlan.from_spec(plan))
    try:
        with translator.serve(**knobs) as eng:
            futs = [eng.submit(s) for s in texts]
            served = failed = 0
            for f in futs:
                try:
                    f.result(timeout=120)
                    served += 1
                except InternalError:
                    failed += 1
            summary = eng.metrics.summary()
            recompiles = eng.recompiles_after_warmup
            slots_leaked = eng.pool.in_use
    finally:
        faults.clear()
        flight = _flight_info(tdir, "driver")
        os.environ.pop("MLSPARK_TELEMETRY_DIR", None)
    return {
        "scenario": "serving_poison",
        "plan": plan,
        "submitted": len(texts),
        "served": served,
        "poisoned": failed,
        "quarantined": summary["quarantined"],
        "loop_restarts": summary["loop_restarts"],
        "recompiles_after_warmup": recompiles,
        "kv_slots_leaked": slots_leaked,
        "flight": flight,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            0 < failed <= 4
            and served == len(texts) - failed
            and summary["quarantined"] == failed
            and summary["loop_restarts"] == 0
            and recompiles == 0
            and slots_leaked == 0
            and flight["exists"]
            and flight["events"] > 0
        ),
    }


# -- the fleet scenarios -------------------------------------------------------------


def _fleet(fleet: ReplicaBody, n: int, workdir: str, **kw):
    """``fleet``'s body in an n-replica gang on its platform behind a
    router, every replica healthy: ``(gang, router, startup_s)``, the
    last each rank's seconds from spawn to its first healthy scrape."""
    import torch_fleet_bench as fb

    gang, router = fb.start_fleet(n, workdir, fleet.body, *fleet.args, platform=fleet.platform, **kw)
    return gang, router, fb.wait_fleet(gang, router, n)


def scenario_fleet_kill_replica(workdir: str, fleet: ReplicaBody) -> dict:
    """Kill rank 1 of a 2-replica fleet under closed-loop load: only its
    in-flight requests may be lost (the ledger conserves), the survivor
    serves through the outage, the supervisor restarts rank 1 on a fresh
    port and a burst after recovery reaches it."""
    import threading

    import torch_fleet_bench as fb

    t0 = time.monotonic()
    clients = 4
    texts = fleet.texts
    gang, router, _ = _fleet(fleet, 2, os.path.join(workdir, "fleet"), policy="affinity",
                             key_fn=fleet.key_fn)
    try:
        load_result: dict = {}

        def drive() -> None:
            load_result.update(fb.drive_load(router, texts, clients=clients, duration=8.0))

        loader = threading.Thread(target=drive, daemon=True)
        loader.start()
        time.sleep(2.0)
        before = router.stats()["per_replica"]
        killed = gang.kill_rank(1)
        time.sleep(2.0)
        during = router.stats()["per_replica"]
        loader.join(120.0)

        outage_completed = (during.get(0, {}).get("completed", 0)
                            - before.get(0, {}).get("completed", 0))
        per_replica = router.stats()["per_replica"]
        lost_on_survivor = per_replica.get(0, {}).get("lost", 0) + per_replica.get(0, {}).get("failed", 0)
        lost_total = load_result.get("failed", 0)

        recovered = router.wait_for_replicas(2, timeout=180.0)
        pre_burst = router.stats()["per_replica"]
        burst = fb.drive_load(router, texts, clients=clients, duration=3.0)
        post_burst = router.stats()["per_replica"]
        rank1_after_restart = (post_burst.get(1, {}).get("completed", 0)
                               - pre_burst.get(1, {}).get("completed", 0))
        conservation = fb.conservation_gate(router)
        ledger = conservation["router_ledger"]
        gang_status = gang.status()
        router_stats = router.stats()
    finally:
        router.stop()
        gang.stop()
    return {
        "scenario": "fleet_kill_replica",
        "clients": clients,
        "kill_acknowledged": killed,
        "load": load_result,
        "outage_completed_on_survivor": outage_completed,
        "lost_total": lost_total,
        "lost_on_survivor": lost_on_survivor,
        "router_retries": router_stats["retries"],
        "recovered_healthy": recovered,
        "recovery_burst": burst,
        "rank1_completed_after_restart": rank1_after_restart,
        "conservation": conservation,
        "gang": gang_status,
        "per_replica": router_stats["per_replica"],
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            killed
            and gang_status["restarts"].get(1, 0) >= 1
            and all(gang_status["alive"].values())
            and outage_completed > 0
            and lost_on_survivor == 0
            and lost_total <= clients
            and load_result.get("unavailable", 0) == 0
            and recovered
            and rank1_after_restart > 0
            and conservation["ok"]
            and ledger["in_flight"] == 0
        ),
    }


def scenario_preemption_as_scale_down(workdir: str, fleet: ReplicaBody) -> dict:
    """A 3-replica fleet with no restart budget loses rank 1 under mixed
    interactive and batch load: the autoscaler reaps it as an observed
    scale-down (decision logged with its inputs), exactly the victim's
    in-flight is lost, the ledger conserves, interactive never starves."""
    import threading

    import torch_fleet_bench as fb

    from machine_learning_apache_spark_tpu_torch.fleet import AutoscaleConfig, FleetAutoscaler

    t0 = time.monotonic()
    clients_per_tier = 3
    texts = fleet.texts
    gang, router = fb.start_fleet(
        3, os.path.join(workdir, "fleet"), fleet.body, *fleet.args, platform=fleet.platform,
        policy="least_loaded",
        gang_kw=dict(max_restarts_per_rank=0),  # the first death is permanent
    )
    # Thresholds out of reach: the one decision wanted is the observed
    # scale-down, not a load-driven resize.
    scaler = FleetAutoscaler(
        gang,
        config=AutoscaleConfig(
            min_replicas=2, max_replicas=3, burn_up=10.0, burn_down=0.0,
            queue_up=1000.0, queue_down=0.0, hysteresis_ticks=1000, cooldown_s=1.0,
            drain_deadline_s=15.0, drain_batch_shed=0.5,
        ),
        admission=router.admission,
    ).attach(router._scrape)
    try:
        if not router.wait_for_replicas(3, timeout=240.0):
            raise RuntimeError(f"fleet never came healthy: {gang.status()}")
        loads = {"interactive": {}, "batch": {}}

        def drive(tier: str) -> None:
            loads[tier].update(fb.drive_load(router, texts, clients=clients_per_tier, duration=10.0,
                                             tier=tier))

        loaders = [threading.Thread(target=drive, args=(tier,), daemon=True) for tier in loads]
        for t in loaders:
            t.start()
        time.sleep(2.0)
        killed = gang.kill_rank(1)

        deadline = time.monotonic() + 60.0
        converged = False
        while time.monotonic() < deadline:
            snaps = router._snapshot_source()
            if scaler.observed_scale_downs >= 1 and len(gang.live_ranks()) == 2 and 1 not in snaps:
                converged = True
                break
            time.sleep(0.25)
        for t in loaders:
            t.join(120.0)
        wait_deadline = time.monotonic() + 60.0
        while router.ledger()["in_flight"] != 0 and time.monotonic() < wait_deadline:
            time.sleep(0.2)
        conservation = fb.conservation_gate(router)
        per_replica = router.stats()["per_replica"]
        decision = next((d for d in scaler.decisions if d["action"] == "observed_scale_down"), None)
        scaler_stats = scaler.stats()
        gang_status = gang.status()
        router_stats = router.stats()
    finally:
        router.stop()
        gang.stop()
    lost_on_survivors = sum(per_replica.get(r, {}).get("lost", 0) + per_replica.get(r, {}).get("failed", 0)
                            for r in (0, 2))
    lost_total = sum(load.get("failed", 0) for load in loads.values())
    interactive = loads["interactive"]
    decision_has_inputs = decision is not None and all(
        k in decision for k in ("action", "burn", "queue_depth", "live", "target"))
    return {
        "scenario": "preemption_as_scale_down",
        "clients_per_tier": clients_per_tier,
        "kill_acknowledged": killed,
        "converged_to_new_target": converged,
        "loads": loads,
        "lost_total": lost_total,
        "lost_on_survivors": lost_on_survivors,
        "decision": decision,
        "scaler": scaler_stats,
        "conservation": conservation,
        "per_replica": per_replica,
        "gang": gang_status,
        "router_retries": router_stats["retries"],
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            killed
            and converged
            and gang_status["exhausted"] == [1]
            and gang_status["retired"] == [1]
            and scaler_stats["observed_scale_downs"] == 1
            and decision_has_inputs
            and decision["target"] == 2
            and lost_on_survivors == 0
            and lost_total <= 2 * clients_per_tier
            and interactive.get("unavailable", 0) == 0
            and interactive.get("completed", 0) > 0
            and conservation["ok"]
            and conservation["router_ledger"]["in_flight"] == 0
        ),
    }


def _wait_replicas_drained(router, timeout: float = 60.0) -> bool:
    """Until every replica scrapes zero in flight: a hedge's loser may
    still be decoding on the slow rank after its winner answered."""
    import torch_fleet_bench as fb

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snaps = fb.snapshots(router)
        if snaps and all((s.in_flight or 0) == 0 for s in snaps.values()):
            return True
        time.sleep(0.2)
    return False


def scenario_straggler_hedge(workdir: str, fleet: ReplicaBody, *, probe=None) -> dict:
    """Rank 1 of a 2-replica round-robin fleet carries a sticky 1.5 s wire
    delay on every ``/v1/generate`` (the plan rides to the replicas in the
    gang env). With hedging on for the interactive tier, each request
    whose primary lands on rank 1 gets one duplicate on rank 0, which
    answers; the loser is reaped through ``POST /v1/cancel``. Every
    request completes, at least one hedge and one cancel, the ledger
    conserves, and every trace id is distinct (exactly once per request
    id). ``probe(router)``, when given, is read with the fleet up, before
    the first request and after the last (the smoke reads each replica's
    kernel launches so)."""
    import torch_fleet_bench as fb

    t0 = time.monotonic()
    n_requests = 8
    plan = "delay@wire:rank=1,ms=1500,sticky=1"
    texts = fleet.texts
    markers = os.path.join(workdir, "markers")
    os.makedirs(markers, exist_ok=True)
    gang, router, startup = _fleet(
        fleet, 2, os.path.join(workdir, "fleet"), policy="round_robin",
        extra_env={faults.ENV_PLAN: plan, faults.ENV_MARKER_DIR: markers},
        router_kw=dict(hedge=True, hedge_tiers=("interactive",), hedge_delay_factor=3.0,
                       hedge_min_delay_s=0.05),
    )
    probed = {}
    try:
        if probe is not None:
            probed["before"] = probe(router)
        payloads = [router.submit(texts[i % len(texts)], tier="interactive", deadline_s=30.0)
                    for i in range(n_requests)]
        drained = _wait_replicas_drained(router)
        conservation = fb.conservation_gate(router)
        router_stats = router.stats()
        if probe is not None:
            probed["after"] = probe(router)
    finally:
        router.stop()
        gang.stop()
    fired = _fired(markers)
    ledger = conservation["router_ledger"]
    trace_ids = [p.get("trace_id") for p in payloads]
    out = {
        "scenario": "straggler_hedge",
        "plan": plan,
        "fault_fired": fired,
        "requests": n_requests,
        "ledger": ledger,
        "hedged": ledger["hedged"],
        "cancelled": ledger["cancelled"],
        "winner_ranks": sorted({p.get("rank") for p in payloads}),
        "distinct_trace_ids": len(set(trace_ids)),
        "replicas_drained": drained,
        "conservation": conservation,
        "per_replica": router_stats["per_replica"],
        "startup_s": startup,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            any(f.startswith("delay_wire") for f in fired)  # sticky: one marker, refires
            and ledger["submitted"] == n_requests
            and ledger["completed"] == n_requests
            and ledger["hedged"] >= 1
            and ledger["cancelled"] >= 1
            and ledger["failed"] == 0
            and ledger["expired"] == 0
            and ledger["unavailable"] == 0
            and drained
            and conservation["ok"]
            and ledger["in_flight"] == 0
            and len(set(trace_ids)) == n_requests
            and all(t for t in trace_ids)
        ),
    }
    if probed:
        out["probe"] = probed
    return out


def scenario_torn_response_retry(workdir: str, fleet: ReplicaBody, *, probe=None) -> dict:
    """Rank 1 tears its first response (one-shot ``torn`` wire fault). The
    replica did decode it, so the router books the short read ``lost``
    and never replays it; the client resubmits under a new request id and
    completes elsewhere. One ``failed`` on rank 1, zero router retries,
    the ledger conserves, the completed trace ids are distinct.
    ``probe`` as for ``scenario_straggler_hedge``."""
    import torch_fleet_bench as fb

    from machine_learning_apache_spark_tpu_torch.fleet import FleetRequestFailed

    t0 = time.monotonic()
    n_requests = 6
    plan = "torn@wire:rank=1,req=0"
    texts = fleet.texts
    markers = os.path.join(workdir, "markers")
    os.makedirs(markers, exist_ok=True)
    gang, router, startup = _fleet(
        fleet, 2, os.path.join(workdir, "fleet"), policy="round_robin",
        extra_env={faults.ENV_PLAN: plan, faults.ENV_MARKER_DIR: markers},
    )
    probed = {}
    try:
        if probe is not None:
            probed["before"] = probe(router)
        payloads = []
        failures = []
        for i in range(n_requests):
            text = texts[i % len(texts)]
            try:
                payloads.append(router.submit(text, tier="interactive", deadline_s=30.0))
            except FleetRequestFailed as e:
                # A lost request is dead: recovery is a fresh submission
                # (a new request id), never a replay of the old one.
                failures.append({"rank": e.rank, "status": e.status, "error": str(e)})
                payloads.append(router.submit(text, tier="interactive", deadline_s=30.0))
        drained = _wait_replicas_drained(router)
        conservation = fb.conservation_gate(router)
        router_stats = router.stats()
        if probe is not None:
            probed["after"] = probe(router)
    finally:
        router.stop()
        gang.stop()
    fired = _fired(markers)
    ledger = conservation["router_ledger"]
    trace_ids = [p.get("trace_id") for p in payloads]
    out = {
        "scenario": "torn_response_retry",
        "plan": plan,
        "fault_fired": fired,
        "requests": n_requests,
        "client_retries": len(failures),
        "failures": failures,
        "ledger": ledger,
        "router_retries": router_stats["retries"],
        "distinct_trace_ids": len(set(trace_ids)),
        "replicas_drained": drained,
        "conservation": conservation,
        "per_replica": router_stats["per_replica"],
        "startup_s": startup,
        "wall_seconds": round(time.monotonic() - t0, 2),
        "ok": (
            sum(1 for f in fired if f.startswith("torn_wire")) == 1  # one-shot
            and len(failures) == 1
            and failures[0]["rank"] == 1
            # n + 1 submitted (the client's retry), n completed, 1 failed.
            and ledger["submitted"] == n_requests + 1
            and ledger["completed"] == n_requests
            and ledger["failed"] == 1
            and ledger["expired"] == 0
            and ledger["unavailable"] == 0
            and router_stats["retries"] == 0  # no silent replay
            and ledger["hedged"] == 0
            and drained
            and conservation["ok"]
            and ledger["in_flight"] == 0
            and len(set(trace_ids)) == n_requests
            and all(t for t in trace_ids)
        ),
    }
    if probed:
        out["probe"] = probed
    return out


#: The wire scenarios double as the tier-1 ``--smoke``: the hedge, cancel
#: and wire-fault stack end to end over real sockets.
SMOKE_SCENARIOS = ("straggler_hedge", "torn_response_retry")

SCENARIOS = {
    "elastic_shrink": scenario_elastic_shrink,
    "gang_crash_resume": scenario_gang_crash_resume,
    "gang_stall": scenario_gang_stall,
    "serving_poison": scenario_serving_poison,
    "fleet_kill_replica": scenario_fleet_kill_replica,
    "preemption_as_scale_down": scenario_preemption_as_scale_down,
    "straggler_hedge": scenario_straggler_hedge,
    "torn_response_retry": scenario_torn_response_retry,
}
GANG_SCENARIOS = ("elastic_shrink", "gang_crash_resume", "gang_stall")
FLEET_SCENARIOS = ("fleet_kill_replica", "preemption_as_scale_down", "straggler_hedge",
                   "torn_response_retry")


# -- the run's configuration --------------------------------------------------------------


def card_setup() -> dict:
    """The card's run: replicas of the reference MT model at full width
    (``chip_smoke.py``'s serving configuration, weights from the seed) at
    phase 4's paged knobs, and the same model in process for
    ``serving_poison``. Raises, naming the device, where there is no card."""
    import torch

    import torch_fleet_bench as fb

    if not torch.cuda.is_available():
        raise RuntimeError("the drill's full run trains and serves on device 'cuda' and none is "
                           "available; --smoke or --cpu runs it on the host")
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    cs = fb._chip_smoke()
    fleet = fb.card_body(cs)
    spec, knobs = fleet.args
    return {
        "card": cs.card_line(),
        "platform": None,
        "fleet": fleet,
        # Built when ``serving_poison`` runs: the translator's arguments.
        "poison": lambda: dict(translator=fb.build_translator(spec, resolve_device(None)),
                               texts=fleet.texts[:12], knobs=card_poison_knobs(knobs)),
    }


def card_poison_knobs(serve: dict) -> dict:
    """``POISON_KNOBS``' batching (4 rows, 10 ms, 8 new tokens) over the
    card's serving knobs ``serve``."""
    return dict(serve, max_batch=4, max_active=4, max_wait_s=0.01, max_new_tokens=8)


def host_setup() -> dict:
    import torch_fleet_bench as fb

    return {"card": None, "platform": "cpu", "fleet": fb.host_body(), "poison": dict}


def run_scenario(name: str, workdir: str, setup: dict) -> dict:
    fn = SCENARIOS[name]
    if name in GANG_SCENARIOS:
        return fn(workdir, platform=setup["platform"])
    if name in FLEET_SCENARIOS:
        return fn(workdir, setup["fleet"])
    return fn(workdir, **setup["poison"]())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", default=None, help="artifact path (nothing is written without it)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"tier-1 self-test on the host: the wire scenarios {SMOKE_SCENARIOS}")
    ap.add_argument("--cpu", action="store_true",
                    help="run the chosen scenarios on the host (the JAX drill's sizes)")
    ap.add_argument("scenarios", nargs="*", default=None,
                    help=f"subset to run (default: all of {sorted(SCENARIOS)})")
    ns = ap.parse_args(argv)
    if ns.smoke and ns.scenarios:
        ap.error("--smoke picks its own scenarios; drop the positional args")
    names = list(SMOKE_SCENARIOS) if ns.smoke else (ns.scenarios or sorted(SCENARIOS))
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; pick from {sorted(SCENARIOS)}")
    # The driver process never serves; keep its telemetry server off.
    os.environ.setdefault("MLSPARK_TELEMETRY_HTTP", "")
    setup = host_setup() if (ns.smoke or ns.cpu) else card_setup()

    results = []
    for name in names:
        print(f"== drill: {name}", flush=True)
        with tempfile.TemporaryDirectory(prefix=f"torch_fault_drill_{name}_") as wd:
            results.append(run_scenario(name, wd, setup))
        print(json.dumps(results[-1], indent=2, default=str), flush=True)

    report = {
        "artifact": "FAULTS",
        "round": 6,
        "smoke": ns.smoke,
        "platform": "cpu" if setup["platform"] == "cpu" else "cuda",
        "card": setup["card"],
        "all_ok": all(r["ok"] for r in results),
        "scenarios": results,
    }
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(report, indent=2, default=str) + "\n")
        print(f"wrote {ns.out} (all_ok={report['all_ok']})")
    print(json.dumps({"smoke": ns.smoke, "all_ok": report["all_ok"]}), flush=True)
    if setup["card"]:
        print(setup["card"])
    return 0 if report["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
