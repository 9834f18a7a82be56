#!/usr/bin/env python3
"""The port's fleet autoscaling drill: a bursty open-loop replay.

    python3 tools/torch_fleet_drill.py --smoke [--out P]   # the CPU: 2 -> 3 -> 2
    python3 tools/torch_fleet_drill.py [--out P]           # the card: the open-loop burst
    python3 tools/torch_fleet_drill.py --hedge [--out P]   # the card: the hedging bench
    (--cpu runs the burst or the hedge bench on the host instead)

The twin of ``tools/fleet_drill.py`` over the PyTorch port. It stands up
a ``ReplicaGang`` and a ``FleetRouter`` (``torch_fleet_bench``'s
scaffolding) with a ``fleet.FleetAutoscaler`` riding the router's scrape
loop, then drives an **open-loop** arrival process through a load step —
baseline rate, a 4x burst, back to baseline — and measures what the
control loop did:

- **time to scale** — burst start to the first ``scale_up`` decision, and
  to full target membership live in the gang;
- **burn-rate recovery** — the router's interactive SLO burn EWMA rises
  while the burst outruns the fleet and must decay once capacity
  catches up;
- **conservation** — after the drain the router ledger balances exactly
  (scale-downs drain their victims, so nothing accepted vanishes);
- **decision log** — every scale decision carries its inputs (burn,
  queue depth, live count, target); the artifact embeds the log.

``--smoke`` is the tier-1 entry: a 2 -> 3 -> 2 cycle of the tiny
translator on the host (closed-loop load trips the queue-depth trigger,
removing it trips the drain), exiting nonzero if any gate fails.

``--hedge`` runs the **straggler-hedging bench** instead: a 2-replica
round-robin fleet with rank 1 slowed by a sticky wire delay of
``max(HEDGE_DELAY_FLOOR_MS, HEDGE_SLOW_FACTOR x`` a clean fleet's p50),
driven closed-loop on the interactive tier twice, hedging off then on.
Gates: the hedged p99 at least ``HEDGE_P99_GATE``x better, the winning
responses token-identical to the unfaulted fleet's, zero recompiles on
every replica, both ledgers conserve.

The full runs serve ``chip_smoke.py``'s serving configuration on the card
(the reference MT model at full width, weights from the seed, phase 4's
paged knobs) and raise where there is no card; ``--cpu`` runs them on the
host at the smoke's sizes. The replicas share one card and the host's
cores, so the drill measures the control loop (trigger latency, a
replica's start-up, drain correctness, conservation), not throughput
scaling. Nothing is written without ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "tools", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from torch_fleet_bench import (  # noqa: E402
    build_fleet,
    card_body,
    conservation_gate,
    drive_load,
    host_body,
    replica_sections,
    snapshots,
    start_fleet,
    wait_fleet,
)

from machine_learning_apache_spark_tpu_torch.utils import faults as _faults  # noqa: E402
from machine_learning_apache_spark_tpu_torch.utils.sysinfo import host_load  # noqa: E402

#: Required keys on every decision record: the "a decision carries its
#: inputs" gate, checked mechanically.
DECISION_INPUT_KEYS = ("action", "burn", "queue_depth", "live", "target")

#: Hedged interactive p99 must beat unhedged by at least this factor
#: with one replica slowed by the wire delay.
HEDGE_P99_GATE = 2.0
#: The slow rank's wire delay targets this multiple of the clean fleet's
#: measured p50 service time...
HEDGE_SLOW_FACTOR = 10.0
#: ...but never less than this (ms): the hedge delay itself sits around
#: 100-200 ms, so a smaller straggler would drown in the noise.
HEDGE_DELAY_FLOOR_MS = 800


def hedge_delay_ms(p50_s: float) -> int:
    """The slow rank's sticky wire delay for a clean fleet's p50 (s)."""
    return max(HEDGE_DELAY_FLOOR_MS, int(HEDGE_SLOW_FACTOR * p50_s * 1000))


def build_scaled_fleet(n: int, workdir: str, fleet, *, config, wait_timeout: float = 240.0):
    """Gang + router (``least_loaded``) + autoscaler riding the router's
    scrape loop, over ``fleet`` (a ``torch_fleet_bench.ReplicaBody``),
    every replica healthy. Returns ``(gang, router, scaler)``; the caller
    tears down in reverse."""
    from machine_learning_apache_spark_tpu_torch.fleet import FleetAutoscaler

    gang, router = start_fleet(n, workdir, fleet.body, *fleet.args, platform=fleet.platform,
                               policy="least_loaded", key_fn=fleet.key_fn)
    scaler = FleetAutoscaler(gang, config=config, admission=router.admission).attach(router._scrape)
    wait_fleet(gang, router, n, timeout=wait_timeout)
    return gang, router, scaler


class OpenLoopDriver:
    """Open-loop arrivals at a settable rate: requests fire on the clock
    whether or not earlier ones finished (the load shape that builds
    queues). Outstanding work is bounded; arrivals past the bound are
    counted ``driver_shed`` — shed by the client, never submitted, so
    outside the router's ledger."""

    def __init__(self, router, texts, *, deadline_s: float = 60.0, batch_every: int = 4,
                 max_outstanding: int = 96):
        self.router = router
        self.texts = texts
        self.deadline_s = deadline_s
        self.batch_every = batch_every
        self._sem = threading.Semaphore(max_outstanding)
        self._rate = 0.0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.counts = {"submitted": 0, "completed": 0, "rejected": 0, "unavailable": 0, "failed": 0,
                       "driver_shed": 0}
        self._threads: list[threading.Thread] = []
        self._pacer: threading.Thread | None = None
        self._n = 0

    def start(self) -> "OpenLoopDriver":
        self._pacer = threading.Thread(target=self._pace, name="drill-pacer", daemon=True)
        self._pacer.start()
        return self

    def set_rate(self, rate_hz: float) -> None:
        with self._lock:
            self._rate = max(0.0, float(rate_hz))

    def stop(self, timeout: float = 120.0) -> dict:
        self._stop.set()
        if self._pacer is not None:
            self._pacer.join(10.0)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.05, deadline - time.monotonic()))
        with self._lock:
            return dict(self.counts)

    def _pace(self) -> None:
        # A token bucket at 10 ms: a sleep of 1/rate per arrival cannot
        # hold hundreds of Hz against the OS's sleep granularity.
        credit = 0.0
        last = time.monotonic()
        while not self._stop.is_set():
            time.sleep(0.01)
            now = time.monotonic()
            with self._lock:
                rate = self._rate
            if rate <= 0:
                credit = 0.0
                last = now
                continue
            credit = min(credit + (now - last) * rate, max(1.0, rate))
            last = now
            while credit >= 1.0:
                credit -= 1.0
                if self._sem.acquire(blocking=False):
                    n = self._n
                    self._n += 1
                    t = threading.Thread(target=self._one, args=(n,), daemon=True)
                    t.start()
                    self._threads.append(t)
                else:
                    with self._lock:
                        self.counts["driver_shed"] += 1
            if len(self._threads) > 512:
                self._threads = [t for t in self._threads if t.is_alive()]

    def _one(self, n: int) -> None:
        from machine_learning_apache_spark_tpu_torch.fleet import (
            FleetBackpressure,
            FleetRequestFailed,
            FleetUnavailable,
        )

        tier = "batch" if n % self.batch_every == 0 else "interactive"
        outcome = "failed"
        try:
            with self._lock:
                self.counts["submitted"] += 1
            try:
                self.router.submit(self.texts[n % len(self.texts)], tier=tier, deadline_s=self.deadline_s)
                outcome = "completed"
            except FleetBackpressure:
                outcome = "rejected"
            except FleetUnavailable:
                outcome = "unavailable"
            except FleetRequestFailed:
                outcome = "failed"
            with self._lock:
                self.counts[outcome] += 1
        finally:
            self._sem.release()


def _burn_ewma(router, tier: str = "interactive") -> float:
    slo = router.stats().get("slo") or {}
    return float((slo.get(tier) or {}).get("ewma") or 0.0)


def _healthy_count(router) -> int:
    return len([s for s in router._snapshot_source().values() if s.healthy and not s.draining])


def _wait(pred, timeout: float, poll: float = 0.5) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return False


def _sampler(router, gang, scaler, samples: list, stop: threading.Event, t0: float,
             interval: float = 0.5) -> None:
    while not stop.is_set():
        samples.append({
            "t": round(time.monotonic() - t0, 2),
            "healthy": _healthy_count(router),
            "live": len(gang.live_ranks()),
            "burn_interactive": round(_burn_ewma(router), 6),
            "ledger_in_flight": router.ledger()["in_flight"],
        })
        stop.wait(interval)


def _decision_gate(decisions: list[dict]) -> dict:
    """Every decision must carry its inputs."""
    missing = [d.get("action", "?") for d in decisions if any(k not in d for k in DECISION_INPUT_KEYS)]
    return {"decisions": len(decisions), "missing_inputs": missing[:8], "ok": bool(decisions) and not missing}


def _write(out_path: str | None, artifact: dict) -> None:
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(artifact, indent=1, default=str))


def _card_fleet():
    """The card's replicas, and the card's name and power limit; raises,
    naming the device, where there is no card."""
    import torch

    import torch_fleet_bench as fb

    if not torch.cuda.is_available():
        raise RuntimeError("the drill's full run serves on device 'cuda' and none is available; "
                           "--smoke or --cpu runs it on the host")
    cs = fb._chip_smoke()
    return card_body(cs), cs.card_line()


def run_full(out_path: str | None, *, burst_s: float, settle_s: float, fleet, card: str | None) -> int:
    """1 replica at baseline, a 4x open-loop burst, then a quarter of the
    baseline: the autoscaler must grow to 4 and give the capacity back."""
    from machine_learning_apache_spark_tpu_torch.fleet import AutoscaleConfig

    host = host_load()  # preflight, before any replica spawns
    texts = fleet.texts
    workdir = tempfile.mkdtemp(prefix="mlspark_torch_fleet_drill_")
    config = AutoscaleConfig(
        min_replicas=1, max_replicas=4, burn_up=0.1, burn_down=0.05, queue_up=3.0, queue_down=1.0,
        hysteresis_ticks=2, cooldown_s=3.0, drain_deadline_s=20.0, drain_batch_shed=0.5,
    )
    gang, router, scaler = build_scaled_fleet(1, workdir, fleet, config=config)
    samples: list[dict] = []
    sample_stop = threading.Event()
    t0 = time.monotonic()
    threading.Thread(target=_sampler, args=(router, gang, scaler, samples, sample_stop, t0),
                     daemon=True).start()
    # A 1 s deadline is generous at baseline but burns once the burst's
    # queueing exceeds it: the burn gauge has something to recover from.
    driver = OpenLoopDriver(router, texts, deadline_s=1.0).start()
    try:
        # Calibrate the step to this fleet: a closed-loop probe measures
        # one replica's capacity, the baseline sits at half of it, and
        # the 4x burst lands at 2x capacity, so a queue must build.
        probe = drive_load(router, texts, clients=4, duration=5.0)
        cap_hz = max(2.0, float(probe.get("requests_per_sec") or 0.0))
        base_rate = 0.5 * cap_hz
        print(json.dumps({"phase": "calibrate", "capacity_hz": round(cap_hz, 1),
                          "base_rate_hz": round(base_rate, 1)}), flush=True)
        driver.set_rate(base_rate)
        time.sleep(5.0)
        t_burst = time.monotonic()
        wall_burst = time.time()
        driver.set_rate(4.0 * base_rate)
        print(json.dumps({"phase": "burst", "rate_hz": 4.0 * base_rate}), flush=True)
        scaled_4x = _wait(lambda: len(gang.live_ranks()) >= config.max_replicas, timeout=burst_s)
        burn_peak = _burn_ewma(router)
        t_peak = time.monotonic() - t_burst
        # Full membership serving: every added rank scrapes healthy.
        t_healthy = (time.monotonic() - t_burst
                     if _wait(lambda: _healthy_count(router) >= config.max_replicas, timeout=burst_s)
                     else None)
        first_up = next((d for d in scaler.decisions
                         if d["action"] == "scale_up" and d.get("wall", 0) >= wall_burst), None)
        print(json.dumps({"phase": "burst_done", "scaled_4x": scaled_4x, "healthy": _healthy_count(router),
                          "burn_peak": round(burn_peak, 6)}), flush=True)
        driver.set_rate(0.25 * base_rate)
        scaled_back = _wait(lambda: len(gang.live_ranks()) <= config.min_replicas, timeout=settle_s)
        driver.set_rate(0.0)
        load = driver.stop()
        _wait(lambda: router.ledger()["in_flight"] == 0, timeout=90.0)
        burn_final = _burn_ewma(router)
        conservation = conservation_gate(router)
        scaler_stats = scaler.stats()
        router_stats = router.stats()
        decisions = list(scaler.decisions)
    finally:
        sample_stop.set()
        driver.stop(timeout=5.0)
        router.stop()
        gang.stop()
    # The burn's peak is in the sampled timeline, not at the instant the
    # scale-up wait returned.
    burn_peak = max((s["burn_interactive"] for s in samples), default=burn_peak)
    decision_gate = _decision_gate(decisions)
    gates = {
        "scaled_4x_up": scaled_4x,
        "scaled_back_down": scaled_back,
        "time_to_scale": first_up is not None,
        "burn_recovered": burn_final <= config.burn_down or burn_final <= 0.8 * burn_peak,
        "zero_lost_non_in_flight": conservation["ok"],
        "decisions_carry_inputs": decision_gate["ok"],
    }
    ok = all(gates.values())
    artifact = {
        "bench": "fleet_autoscale",
        "round": 7,
        "smoke": False,
        "card": card,
        "host_load": host,
        "contended": host["contended"],
        "single_core_caveat": (
            "control-loop drill: on a 1-core host the replicas time-share the CPU, so this measures "
            "trigger latency, drain correctness and conservation, not throughput scaling"
            if (host.get("cores") or 1) < 2 else None),
        "config": scaler_stats["config"],
        "burst": {
            "capacity_probe": probe,
            "base_rate_hz": round(base_rate, 2),
            "burst_rate_hz": round(4.0 * base_rate, 2),
            "time_to_first_scale_up_s": round(first_up["wall"] - wall_burst, 2) if first_up else None,
            "time_to_max_live_s": round(t_peak, 2),
            "time_to_max_healthy_s": None if t_healthy is None else round(t_healthy, 2),
            "burn_peak": round(burn_peak, 6),
            "burn_final": round(burn_final, 6),
        },
        "load": load,
        "timeline": samples,
        "decisions": decisions,
        "decision_gate": decision_gate,
        "scaler": scaler_stats,
        "conservation": conservation,
        "router": router_stats,
        "gates": gates,
        "ok": ok,
    }
    _write(out_path, artifact)
    print(json.dumps({"wrote": out_path, "burst": artifact["burst"], "gates": gates, "ok": ok}), flush=True)
    if card:
        print(card)
    return 0 if ok else 1


def run_smoke(out_path: str | None) -> int:
    """Tier-1: 2 -> 3 -> 2 on the tiny translator on the host. Closed-loop
    clients trip the queue-depth trigger (a burn trigger would be noisy
    on a loaded host); removing the load trips the drain."""
    from machine_learning_apache_spark_tpu_torch.fleet import AutoscaleConfig

    host = host_load()  # preflight, before any replica spawns
    fleet = host_body()
    texts = fleet.texts
    workdir = tempfile.mkdtemp(prefix="mlspark_torch_fleet_drill_smoke_")
    config = AutoscaleConfig(
        min_replicas=2, max_replicas=3, burn_up=0.5, burn_down=0.05, queue_up=1.5, queue_down=0.5,
        hysteresis_ticks=2, cooldown_s=2.0, drain_deadline_s=15.0, drain_batch_shed=0.5,
    )
    gang, router, scaler = build_scaled_fleet(2, workdir, fleet, config=config)
    try:
        load_result: dict = {}

        def _load() -> None:
            load_result.update(drive_load(router, texts, clients=8, duration=40.0))

        load_thread = threading.Thread(target=_load, daemon=True)
        load_thread.start()
        # Membership: the control law fired and actuated (a third rank
        # spawned and live). Its warm-up may outlast the load step on a
        # contended host, so "it serves" is gated after the load.
        scaled_up = _wait(lambda: scaler.scale_ups >= 1 and len(gang.live_ranks()) >= 3, timeout=150.0)
        print(json.dumps({"scaled_up": scaled_up, "live": len(gang.live_ranks()),
                          "healthy": _healthy_count(router)}), flush=True)
        load_thread.join(180.0)
        scaled_down = _wait(
            lambda: scaler.scale_downs >= 1 and len(gang.live_ranks()) == config.min_replicas,
            timeout=240.0)
        print(json.dumps({"scaled_down": scaled_down, "live": len(gang.live_ranks())}), flush=True)
        # The drain picks a healthy victim, so the surviving pair may be an
        # old rank and the added one: the cycle counts only if it serves.
        replacement_serves = _wait(lambda: _healthy_count(router) >= config.min_replicas, timeout=240.0)
        print(json.dumps({"replacement_serves": replacement_serves, "healthy": _healthy_count(router)}),
              flush=True)
        _wait(lambda: router.ledger()["in_flight"] == 0, timeout=60.0)
        conservation = conservation_gate(router)
        scaler_stats = scaler.stats()
        decisions = list(scaler.decisions)
        gang_status = gang.status()
    finally:
        router.stop()
        gang.stop()
    decision_gate = _decision_gate(decisions)
    gates = {
        "scaled_up_2_to_3": scaled_up,
        "scaled_down_3_to_2": scaled_down,
        "replacement_rank_serves": replacement_serves,
        "zero_lost_non_in_flight": conservation["ok"],
        "decisions_carry_inputs": decision_gate["ok"],
    }
    ok = all(gates.values())
    artifact = {
        "bench": "fleet_autoscale",
        "smoke": True,
        "host_load": host,
        "contended": host["contended"],
        "config": scaler_stats["config"],
        "load": load_result,
        "decisions": decisions,
        "decision_gate": decision_gate,
        "scaler": scaler_stats,
        "conservation": conservation,
        "gang": gang_status,
        "gates": gates,
        "ok": ok,
    }
    _write(out_path, artifact)
    print(json.dumps({"gates": gates, "ok": ok}), flush=True)
    return 0 if ok else 1


def _replica_recompiles(router) -> dict:
    """Each replica's ``recompiles_after_warmup`` off its ``/statusz``
    ``serving`` section (a string where the scrape failed)."""
    out = {}
    for rank, section in replica_sections(router, "serving").items():
        out[rank] = (section or {}).get("recompiles_after_warmup", "scrape failed")
    return out


def _wait_fleet_drained(router, timeout: float = 90.0) -> bool:
    """The ledger at zero in flight and every replica scraped idle: hedge
    losers keep decoding on the slow rank after their winners answered."""
    def _idle() -> bool:
        if router.ledger()["in_flight"] != 0:
            return False
        snaps = snapshots(router)
        return bool(snaps) and all((s.in_flight or 0) == 0 for s in snaps.values())

    return _wait(_idle, timeout, poll=0.2)


def run_hedge(out_path: str | None, *, duration: float, fleet, card: str | None) -> int:
    """The interactive p99 with one replica slowed ~10x by a sticky wire
    delay, hedged against not, on straggler-blind round-robin. Token
    parity of the winners against an unfaulted fleet, zero recompiles
    and ledger conservation ride along as gates."""
    host = host_load()  # preflight, before any replica spawns
    texts = fleet.texts
    base = tempfile.mkdtemp(prefix="mlspark_torch_hedge_bench_")
    parity_texts = texts[:12]

    def fleet_of(name: str, **kw):
        return build_fleet(2, os.path.join(base, name), fleet.body, *fleet.args, platform=fleet.platform,
                           policy="round_robin", **kw)

    # A clean 2-replica fleet: the reference outputs (greedy decoding is
    # deterministic) and the p50 the slow rank's delay is set from.
    gang, router = fleet_of("calibrate")
    try:
        reference = [router.submit(t, tier="interactive", deadline_s=60.0)["text"] for t in parity_texts]
        probe = drive_load(router, texts, clients=4, duration=4.0, tier="interactive")
    finally:
        router.stop()
        gang.stop()
    p50 = float(probe.get("p50_latency_s") or 0.05)
    delay_ms = hedge_delay_ms(p50)
    plan = f"delay@wire:rank=1,ms={delay_ms},sticky=1"
    print(json.dumps({"phase": "calibrate", "p50_s": round(p50, 4), "delay_ms": delay_ms,
                      "slow_factor": round(delay_ms / 1000.0 / p50, 1) if p50 else None}), flush=True)

    # The same slowed fleet, hedging off then on; a fresh fleet a pass so
    # each owns its ledger and its programs.
    columns = {}
    for name, hedged in (("unhedged", False), ("hedged", True)):
        markers = os.path.join(base, f"markers_{name}")
        os.makedirs(markers, exist_ok=True)
        gang, router = fleet_of(
            name, extra_env={_faults.ENV_PLAN: plan, _faults.ENV_MARKER_DIR: markers},
            # Factor 1.0 converges under a persistent straggler: the EWMA
            # is fed by hedged totals, so a large factor chases its own
            # tail until no hedge fires.
            router_kw=(dict(hedge=True, hedge_tiers=("interactive",), hedge_delay_factor=1.0,
                            hedge_min_delay_s=0.05) if hedged else {}),
        )
        try:
            load = drive_load(router, texts, clients=4, duration=duration, tier="interactive")
            parity = None
            if hedged:
                routed = [router.submit(t, tier="interactive", deadline_s=60.0)["text"] for t in parity_texts]
                mismatches = [i for i, (a, b) in enumerate(zip(routed, reference)) if a != b]
                parity = {"checked": len(parity_texts), "identical": not mismatches,
                          "mismatches": mismatches[:8]}
            drained = _wait_fleet_drained(router)
            conservation = conservation_gate(router)
            recompiles = _replica_recompiles(router)
            router_stats = router.stats()
        finally:
            router.stop()
            gang.stop()
        columns[name] = {
            "hedge": hedged,
            "load": load,
            "parity": parity,
            "drained": drained,
            "conservation": conservation,
            "recompiles_after_warmup": recompiles,
            "ledger": router_stats["ledger"],
            "per_replica": router_stats["per_replica"],
            "fault_fired": sorted(os.listdir(markers)),
        }
        print(json.dumps({"phase": name, "p99_s": load["p99_latency_s"], "p50_s": load["p50_latency_s"],
                          "hedged": router_stats["ledger"]["hedged"],
                          "cancelled": router_stats["ledger"]["cancelled"]}), flush=True)

    p99_un = columns["unhedged"]["load"]["p99_latency_s"]
    p99_he = columns["hedged"]["load"]["p99_latency_s"]
    ratio = round(p99_un / p99_he, 3) if (p99_un and p99_he) else None
    gates = {
        "p99_improvement": ratio is not None and ratio >= HEDGE_P99_GATE,
        "hedges_fired": columns["hedged"]["ledger"]["hedged"] >= 1,
        "losers_cancelled": columns["hedged"]["ledger"]["cancelled"] >= 1,
        "token_parity": bool((columns["hedged"]["parity"] or {}).get("identical")),
        "zero_recompiles": all(v == 0 for c in columns.values() for v in c["recompiles_after_warmup"].values()),
        "conservation": all(c["drained"] and c["conservation"]["ok"] and c["ledger"]["in_flight"] == 0
                            for c in columns.values()),
        "fault_armed_both_passes": all(any(f.startswith("delay_wire") for f in c["fault_fired"])
                                       for c in columns.values()),
    }
    ok = all(gates.values())
    artifact = {
        "bench": "fleet_hedge",
        "round": 8,
        "smoke": False,
        "card": card,
        "host_load": host,
        "contended": host["contended"],
        "plan": plan,
        "calibration": {"probe": probe, "p50_s": round(p50, 4), "delay_ms": delay_ms,
                        "slow_factor": round(delay_ms / 1000.0 / p50, 1) if p50 else None},
        "p99_unhedged_s": p99_un,
        "p99_hedged_s": p99_he,
        "p99_ratio": ratio,
        "gate_ratio": HEDGE_P99_GATE,
        "columns": columns,
        "gates": gates,
        "ok": ok,
    }
    _write(out_path, artifact)
    print(json.dumps({"wrote": out_path, "p99_unhedged_s": p99_un, "p99_hedged_s": p99_he, "p99_ratio": ratio,
                      "gates": gates, "ok": ok}), flush=True)
    if card:
        print(card)
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true", help="tier-1 self-test on the host: 2 -> 3 -> 2")
    ap.add_argument("--hedge", action="store_true", help="the straggler-hedging bench")
    ap.add_argument("--cpu", action="store_true", help="the burst or hedge bench on the host, at the smoke's sizes")
    ap.add_argument("--out", default=None, help="artifact path (nothing is written without it)")
    ap.add_argument("--burst", type=float, default=180.0, help="max seconds to wait for the 4x scale-up")
    ap.add_argument("--settle", type=float, default=240.0, help="max seconds to wait for the scale-back-down")
    ap.add_argument("--duration", type=float, default=8.0, help="seconds per closed-loop window (--hedge)")
    ns = ap.parse_args(argv)
    os.environ.setdefault("MLSPARK_TELEMETRY_HTTP", "")
    if ns.smoke and ns.hedge:
        ap.error("--smoke and --hedge are separate entries; pick one")
    if ns.smoke:
        return run_smoke(ns.out)
    fleet, card = (host_body(), None) if ns.cpu else _card_fleet()
    if ns.hedge:
        return run_hedge(ns.out, duration=ns.duration, fleet=fleet, card=card)
    return run_full(ns.out, burst_s=ns.burst, settle_s=ns.settle, fleet=fleet, card=card)


if __name__ == "__main__":
    sys.exit(main())
