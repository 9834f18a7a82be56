#!/usr/bin/env python3
"""The port's fleet bench: N paged engines behind one router.

    python3 tools/torch_fleet_bench.py --smoke [--out P]        # the CPU, gates only
    python3 tools/torch_fleet_bench.py --out P [--replicas N]   # the card

The port's twin of ``tools/fleet_bench.py``. It stands up a real fleet —
``launcher.ReplicaGang`` ranks, each one ``fleet.serve_replica`` process
with one paged ``ServingEngine`` and its HTTP front door, on the card
unless the gang's platform is ``"cpu"`` — with a ``fleet.FleetRouter``
dispatching over the live scrape plane, and checks what the fleet layer
adds:

- **parity** — prompts routed through the fleet give the tokens of an
  in-process engine over the same weights (identical on the CPU; token
  agreement >= ``AGREEMENT_MIN`` on the card, where the replicas' batches
  differ from the in-process engine's);
- **conservation** — after a concurrent load burst the router ledger
  balances and every replica scrapes zero in flight;
- **both replicas served** — a router that pinned everything to one
  rank would still conserve.

The full run (on the card) adds the JAX bench's affinity phase
(prefix-cache hit rate under ``affinity`` against ``round_robin`` on a
shared-prefix workload, a fresh fleet each) and its scaling phase
(closed-loop tokens/s through N replicas against one, with the per-rank
skew of the scrape rows). Every replica shares the one card and the
host, so the scaling ratio is recorded, not gated. The full run serves
``chip_smoke.py``'s serving configuration (the reference MT model at full
width, random weights from the seed, its prompts and paged knobs), and
writes its artifact only where ``--out`` says.

Helpers used by the port's tier-1 fleet test and by the smoke's phase
7k: ``build_fleet`` / ``start_fleet``, ``drive_load``, ``route``,
``parity_gate``, ``conservation_gate``, ``fleet_prefix_stats``,
``replica_status``, and the replica body ``replica_main``, which builds
its translator from Flax-layout weights handed over through the gang's
arguments (``translator_spec``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from machine_learning_apache_spark_tpu_torch.utils.sysinfo import host_load  # noqa: E402

AGREEMENT_MIN = 0.99
#: Affinity hit rate must beat round-robin by at least this factor.
AFFINITY_GATE_RATIO = 1.5
#: The smoke's model (the JAX bench's tiny translator's widths) and knobs
#: (the JAX bench's paged profile).
SMOKE_MODEL = dict(d_model=32, ffn_hidden=64, num_heads=2, num_layers=1, max_len=16, dropout=0.0)
SMOKE_KNOBS = dict(
    boundaries=(8, 16), max_batch=8, max_wait_s=0.005, max_queue_depth=128,
    max_new_tokens=10, prefix_cache_size=256, steps_per_launch=10,
    max_active=16, kv_mode="paged",
)
#: Where the replica body reports its device, kernel launches and memory
#: (``/statusz`` section): the router process cannot read another
#: process's counters.
STATUS_SECTION = "replica"


# -- the replica body --------------------------------------------------------


def translator_spec(params, src_itos, trg_itos, max_seq_len: int, config: dict) -> dict:
    """Everything a replica needs to build its translator, picklable:
    Flax-layout weights as numpy arrays, the two vocabularies and the
    ``TransformerConfig`` keywords."""
    return dict(params=params, src_itos=list(src_itos), trg_itos=list(trg_itos),
                max_seq_len=int(max_seq_len), config=dict(config))


def build_translator(spec: dict, device):
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline, Vocab
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    model = load_flax_params(Transformer(TransformerConfig(**spec["config"])), spec["params"])

    def pipe(itos):
        return TextPipeline(Vocab(itos, specials=()), max_seq_len=spec["max_seq_len"])

    return Translator(model, pipe(spec["src_itos"]), pipe(spec["trg_itos"]), device=device)


def replica_status(device) -> dict:
    """This replica's device, its kernel launches so far and, on the card,
    its memory: the ``/statusz`` section the replica body registers."""
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    out = {"device": str(device), "pid": os.getpid(), "launches": dict(hop.LAUNCHES)}
    if device.type == "cuda":
        import torch

        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        out["allocated_bytes"] = int(torch.cuda.memory_allocated(device))
    return out


def serve_counted(translator, knobs: dict, max_s: float = 900.0) -> dict:
    """``serve_replica`` with this replica's ``replica_status`` on its
    ``/statusz``; the result carries the final status too."""
    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.fleet.replica import serve_replica

    device = translator.device
    telemetry.register_status_provider(STATUS_SECTION, lambda: replica_status(device))
    out = serve_replica(translator, dict(knobs), max_s=max_s)
    out[STATUS_SECTION] = replica_status(device)
    return out


def replica_main(spec: dict, knobs: dict, max_s: float = 900.0) -> dict:
    """Gang-worker body (run by reference in each replica process): the
    translator from ``spec`` on ``fleet.replica.replica_device()`` — the
    card unless ``MLSPARK_PLATFORM=cpu`` — served behind the fleet data
    plane until the stop marker lands."""
    from machine_learning_apache_spark_tpu_torch.fleet.replica import replica_device

    return serve_counted(build_translator(spec, replica_device()), knobs, max_s=max_s)


def make_key_fn(translator):
    """The router's affinity key: the tokens the engine keys its
    ``PrefixCache`` on (``src_pipe.ragged``), through the same digest."""
    from machine_learning_apache_spark_tpu_torch.serving.kv_pages import prefix_digest

    src_pipe = translator.src_pipe
    return lambda text: prefix_digest(src_pipe.ragged([text])[0])


class ReplicaBody(NamedTuple):
    """What a fleet's replicas run, for the drills: the gang body
    (``module:fn``) and its arguments, the gang's platform (None: the
    card), the prompts the clients send and the router's affinity key."""

    body: str
    args: tuple
    platform: str | None
    texts: list
    key_fn: Callable | None


# -- the fleet ----------------------------------------------------------------


def start_fleet(n: int, workdir: str, body: str, *args, platform: str | None = None,
                policy: str = "affinity", key_fn=None, scrape_interval: float = 0.25,
                extra_env: dict | None = None, router_kw: dict | None = None,
                gang_kw: dict | None = None):
    """Spawn an n-replica gang running ``body(*args)`` and start a router
    over its sidecar directory; returns ``(gang, router)`` at once (the
    replicas come up on their own — see ``wait_fleet``). ``platform=None``
    (the default, as for ``ReplicaGang`` and ``Distributor``) puts every
    replica on the card; ``"cpu"`` keeps them on the host."""
    from machine_learning_apache_spark_tpu_torch.fleet import FleetRouter
    from machine_learning_apache_spark_tpu_torch.launcher import ReplicaGang

    gang = ReplicaGang(
        body, *args, num_replicas=n, workdir=workdir, platform=platform,
        # Replicas serve observability through the data-plane port; the
        # runner's separate telemetry server would only cost threads.
        telemetry_http=None,
        env={"MLSPARK_TELEMETRY_HTTP": "", **(extra_env or {})},
        **(gang_kw or {}),
    ).start()
    router = FleetRouter(
        workdir, policy=policy, key_fn=key_fn, scrape_interval=scrape_interval,
        **(router_kw or {}),
    ).start()
    return gang, router


def wait_fleet(gang, router, n: int, timeout: float = 240.0) -> dict:
    """Block until n replicas scrape healthy and return each rank's
    seconds from this call (made right after the spawn) to the first
    scrape that saw it healthy; tear both down and raise if they do not
    come up."""
    t0 = time.monotonic()
    startup: dict = {}
    while time.monotonic() - t0 <= timeout:
        ready = router.wait_for_replicas(n, timeout=0.05)
        seen = router._scrape.snapshots() if router._scrape is not None else router._snapshot_source()
        for rank, snap in seen.items():
            if snap.healthy:
                startup.setdefault(rank, time.monotonic() - t0)
        if ready:
            return startup
    router.stop()
    gang.stop()
    raise RuntimeError(f"fleet of {n} never came healthy in {gang.workdir} (gang status: {gang.status()})")


def build_fleet(n: int, workdir: str, body: str, *args, timeout: float = 240.0, **kw):
    """``start_fleet`` then ``wait_fleet``: both started, every replica
    healthy. The caller owns teardown (router.stop() then gang.stop())."""
    gang, router = start_fleet(n, workdir, body, *args, **kw)
    wait_fleet(gang, router, n, timeout=timeout)
    return gang, router


def snapshots(router) -> dict:
    """A fresh scrape of every replica (one inline tick)."""
    if router._scrape is not None:
        return router._scrape.tick()
    return router._snapshot_source()


def replica_sections(router, section: str = STATUS_SECTION) -> dict:
    """Each replica's ``/statusz`` section ``section`` (None where absent)."""
    from machine_learning_apache_spark_tpu_torch.fleet.scrape import scrape

    out = {}
    for rank, snap in sorted(snapshots(router).items()):
        status = scrape(snap.port, "/statusz", timeout=5.0, retries=2) or {}
        out[rank] = (status.get("sections") or {}).get(section)
    return out


def drive_load(router, texts, *, clients: int, duration: float | None = None, stop=None,
               tier: str = "batch", deadline_s: float = 60.0) -> dict:
    """Closed-loop load: ``clients`` threads each submit → wait → repeat
    for ``duration`` seconds or until ``stop`` (a ``threading.Event``) is
    set. Client-observed requests/s and tokens/s (the replicas' own token
    counts over the wall window), per-outcome tallies, the rank of every
    lost request (``failed_by_rank``) and the first lost ones' errors."""
    from machine_learning_apache_spark_tpu_torch.fleet import (
        FleetBackpressure,
        FleetRequestFailed,
        FleetUnavailable,
    )
    from machine_learning_apache_spark_tpu_torch.serving.metrics import percentile
    from machine_learning_apache_spark_tpu_torch.serving.queue import DeadlineExceeded

    if (duration is None) == (stop is None):
        raise ValueError("pass exactly one of duration= and stop=")
    lock = threading.Lock()
    counts = {"completed": 0, "rejected": 0, "unavailable": 0, "failed": 0, "expired": 0, "tokens": 0}
    failed_by_rank: dict = {}
    failures: list[str] = []
    latencies: list[float] = []
    stop_at = None if duration is None else time.monotonic() + duration

    def running() -> bool:
        return time.monotonic() < stop_at if stop is None else not stop.is_set()

    def client(i: int) -> None:
        n = i  # stagger the starting prompts so clients don't lockstep
        while running():
            t0 = time.monotonic()
            try:
                out = router.submit(texts[n % len(texts)], tier=tier, deadline_s=deadline_s)
                with lock:
                    counts["completed"] += 1
                    counts["tokens"] += int(out.get("tokens") or 0)
                    latencies.append(time.monotonic() - t0)
            except FleetBackpressure as e:
                with lock:
                    counts["rejected"] += 1
                time.sleep(min(e.retry_after, 0.25))
            except FleetUnavailable:
                with lock:
                    counts["unavailable"] += 1
                time.sleep(0.1)
            except FleetRequestFailed as e:
                with lock:
                    counts["failed"] += 1
                    failed_by_rank[e.rank] = failed_by_rank.get(e.rank, 0) + 1
                    if len(failures) < 8:
                        failures.append(str(e))
            except DeadlineExceeded:
                with lock:
                    counts["expired"] += 1
            n += clients

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,), daemon=True, name=f"fleet-client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    return {
        "clients": clients,
        "duration_s": elapsed,
        **counts,
        "failed_by_rank": failed_by_rank,
        "failures": failures,
        "tokens_per_sec": counts["tokens"] / elapsed,
        "requests_per_sec": counts["completed"] / elapsed,
        "p50_latency_s": percentile(latencies, 50),
        "p99_latency_s": percentile(latencies, 99),
    }


def route(router, texts, *, clients: int = 1, tier: str = "interactive",
          deadline_s: float = 120.0) -> dict:
    """Route every text once, from ``clients`` threads taking them in
    turn: the outputs in the texts' order, the serving ranks, the wall
    and the tokens the replicas counted."""
    outs: list = [None] * len(texts)
    ranks: list = [None] * len(texts)
    tokens = [0] * len(texts)
    errors: list = []
    lock = threading.Lock()
    state = {"next": 0}

    def client() -> None:
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if i >= len(texts):
                return
            try:
                out = router.submit(texts[i], tier=tier, deadline_s=deadline_s)
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(f"request {i}: {e!r}")
                continue
            outs[i], ranks[i], tokens[i] = out["text"], out.get("rank"), int(out.get("tokens") or 0)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(outs=outs, ranks=ranks, tokens=sum(tokens), wall=time.monotonic() - t0,
                errors=errors)


def local_route(translator, knobs: dict, texts, *, clients: int) -> dict:
    """``route``'s load on one in-process engine: ``clients`` threads
    taking the texts in turn, each waiting for its answer. The fleet's
    baseline at the same offered load."""
    outs: list = [None] * len(texts)
    lock = threading.Lock()
    state = {"next": 0}
    with translator.serve(**knobs) as eng:

        def client() -> None:
            while True:
                with lock:
                    i = state["next"]
                    state["next"] += 1
                if i >= len(texts):
                    return
                outs[i] = eng.submit(texts[i]).result(timeout=600)

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return dict(outs=outs, wall=time.monotonic() - t0)


def parity_gate(routed: list, want: list) -> dict:
    """Routed outputs against an oracle's on the same prompts: identical,
    and the share of token positions that agree (``chip_smoke.agreement``)."""
    share, notes = _chip_smoke().agreement([o or "" for o in routed], want)
    mismatches = [i for i, (a, b) in enumerate(zip(routed, want)) if a != b]
    return {"checked": len(want), "identical": not mismatches and len(routed) == len(want),
            "agreement": share, "mismatches": mismatches[:8], "notes": notes[:8]}


def conservation_gate(router, settle_s: float = 2.0) -> dict:
    """Router ledger balanced + zero in-flight scraped on every replica.
    An engine resolves a request's future just before it books the
    completion, so a scrape right after the last answer may still count
    it: the replicas get ``settle_s`` to read 0."""
    ledger = router.check_conservation(in_flight=0)
    deadline = time.monotonic() + settle_s
    while True:
        replica_in_flight = {rank: snap.in_flight for rank, snap in sorted(snapshots(router).items())}
        drained = all((v or 0) == 0 for v in replica_in_flight.values())
        if drained or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    return {"ok": drained, "router_ledger": ledger, "replica_in_flight": replica_in_flight}


def fleet_prefix_stats(router) -> dict:
    """Fleet-wide prefix-cache hit rate from a fresh scrape."""
    hits = misses = 0
    per_replica = {}
    for rank, snap in sorted(snapshots(router).items()):
        st = snap.prefix_stats or {}
        h, m = int(st.get("hits") or 0), int(st.get("misses") or 0)
        hits += h
        misses += m
        per_replica[rank] = dict(st)
    lookups = hits + misses
    return {"hits": hits, "misses": misses, "hit_rate": hits / lookups if lookups else None,
            "per_replica": per_replica}


def served_ranks(router) -> list[int]:
    return sorted(r for r, v in router.stats()["per_replica"].items() if v.get("completed"))


# -- the runs -------------------------------------------------------------------


def smoke_spec(seed: int = 0) -> tuple[dict, list[str]]:
    """The smoke's translator spec (random weights from the seed, at the
    JAX bench's tiny widths) and its prompts."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_translation_pairs
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.models import TransformerConfig
    from machine_learning_apache_spark_tpu_torch.weights import random_flax_params

    pairs = synthetic_translation_pairs(64, min_len=3, max_len=8, seed=seed)
    src = TextPipeline.fit([s for s, _ in pairs], max_seq_len=14)
    trg = TextPipeline.fit([t for _, t in pairs], max_seq_len=14)
    config = dict(src_vocab_size=len(src.vocab.itos), trg_vocab_size=len(trg.vocab.itos), **SMOKE_MODEL)
    params = random_flax_params(TransformerConfig(**config), seed)
    return translator_spec(params, src.vocab.itos, trg.vocab.itos, 14, config), [s for s, _ in pairs]


def local_outputs(translator, knobs: dict, texts) -> list[str]:
    """An in-process engine over the same translator: the oracle."""
    with translator.serve(**knobs) as eng:
        futs = [eng.submit(t) for t in texts]
        return [f.result(timeout=600) for f in futs]


def host_body() -> ReplicaBody:
    """Replicas of the smoke's translator (``smoke_spec``) on the host, at
    ``SMOKE_KNOBS``."""
    spec, texts = smoke_spec()
    return ReplicaBody("torch_fleet_bench:replica_main", (spec, dict(SMOKE_KNOBS)), "cpu", texts,
                       make_key_fn(build_translator(spec, "cpu")))


def card_body(cs) -> ReplicaBody:
    """Replicas of ``chip_smoke.py``'s serving configuration on the card:
    the reference MT model at full width (weights from the seed) at phase
    4's paged knobs, and its prompts."""
    spec, texts = reference_spec(cs)
    return ReplicaBody("torch_fleet_bench:replica_main", (spec, dict(cs.SERVE)), None, texts,
                       make_key_fn(build_translator(spec, "cpu")))


def run_smoke(out_path: str | None) -> int:
    """On the CPU: a 2-replica gang + router; parity, conservation, both
    replicas served."""
    host = host_load()  # preflight — before any replica spawns
    spec, texts = smoke_spec()
    knobs = dict(SMOKE_KNOBS)
    translator = build_translator(spec, "cpu")
    workdir = tempfile.mkdtemp(prefix="mlspark_torch_fleet_smoke_")
    gang, router = start_fleet(2, workdir, "torch_fleet_bench:replica_main", spec, knobs,
                               platform="cpu", key_fn=make_key_fn(translator))
    try:
        want = local_outputs(translator, knobs, texts[:8])  # while the replicas come up
        wait_fleet(gang, router, 2)
        routed = route(router, texts[:8])
        parity = parity_gate(routed["outs"], want)
        print(json.dumps({"parity": parity}), flush=True)
        load = drive_load(router, texts, clients=4, duration=2.0)
        print(json.dumps({"load": load}), flush=True)
        conservation = conservation_gate(router)
        print(json.dumps({"conservation": conservation}), flush=True)
        router_stats = router.stats()
        spread = served_ranks(router)
    finally:
        router.stop()
        gang.stop()
    gates = {"parity": parity["identical"], "conservation": conservation["ok"],
             "both_replicas_served": len(spread) >= 2}
    ok = all(gates.values())
    artifact = {"bench": "torch_fleet", "smoke": True, "host_load": host, "parity": parity,
                "load": load, "conservation": conservation, "router": router_stats,
                "gang": gang.status(), "gates": gates, "ok": ok}
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(artifact, indent=1, default=str))
    print(json.dumps({"gates": gates, "ok": ok}), flush=True)
    return 0 if ok else 1


def _chip_smoke():
    """This tree's ``chip_smoke.py``, for its serving configuration."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_fleet_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_spec(cs) -> tuple[dict, list[str]]:
    """``chip_smoke.py``'s phase-4 translator as a spec, and its prompts."""
    src_words, src, trg = cs.serving_pipes()
    config = dict(src_vocab_size=len(src.vocab.itos), trg_vocab_size=len(trg.vocab.itos), **cs.MODEL)
    spec = translator_spec(cs.model_params(src, trg), src.vocab.itos, trg.vocab.itos,
                           cs.SERVE["boundaries"][-1] - 1, config)
    return spec, cs.make_prompts(src_words)


def run_full(out_path: str | None, *, replicas: int, clients: int, duration: float) -> int:
    """On the card: parity, affinity against round-robin, and closed-loop
    throughput through ``replicas`` replicas against one."""
    from machine_learning_apache_spark_tpu_torch.telemetry.aggregate import replica_skew
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    host = host_load()
    device = resolve_device(None)
    cs = _chip_smoke()
    card = cs.card_line()
    spec, texts = reference_spec(cs)
    knobs = dict(cs.SERVE)
    translator = build_translator(spec, device)
    key_fn = make_key_fn(translator)
    base = tempfile.mkdtemp(prefix="mlspark_torch_fleet_bench_")
    want = local_outputs(translator, knobs, texts)
    del translator
    body = "torch_fleet_bench:replica_main"
    result = {"bench": "torch_fleet", "smoke": False, "card": card, "host_load": host,
              "replicas": replicas, "clients": clients, "duration_s": duration}

    affinity = {}
    for policy in ("round_robin", "affinity"):
        gang, router = build_fleet(2, os.path.join(base, f"affinity_{policy}"), body, spec, knobs,
                                   platform=None, policy=policy, key_fn=key_fn)
        try:
            prompts = texts[:11]  # odd: strict round-robin alternates every prompt
            for _ in range(3):
                route(router, prompts)
            affinity[policy] = fleet_prefix_stats(router)
        finally:
            router.stop()
            gang.stop()
    rr, af = affinity["round_robin"]["hit_rate"] or 0.0, affinity["affinity"]["hit_rate"] or 0.0
    affinity["hit_rate_ratio"] = af / rr if rr else None
    affinity["ok"] = rr > 0 and af / rr >= AFFINITY_GATE_RATIO
    result["affinity"] = affinity
    print(json.dumps({"affinity": affinity}), flush=True)

    columns = {}
    for n in (replicas, 1):
        gang, router = build_fleet(n, os.path.join(base, f"scale_{n}"), body, spec, knobs,
                                   platform=None, key_fn=key_fn)
        try:
            routed = route(router, texts, clients=8)
            load = drive_load(router, texts, clients=clients, duration=duration)
            columns[n] = {"routed": {k: routed[k] for k in ("wall", "tokens", "errors")},
                          "parity": parity_gate(routed["outs"], want), "load": load,
                          "conservation": conservation_gate(router), "router": router.stats(),
                          "replica_skew": replica_skew(router._scrape.rows()),
                          "replicas": replica_sections(router)}
        finally:
            router.stop()
            gang.stop()
        print(json.dumps({"replicas": n, "load": columns[n]["load"],
                          "agreement": columns[n]["parity"]["agreement"]}, default=str), flush=True)
    result["scaling"] = columns
    result["scaling_ratio"] = columns[replicas]["load"]["tokens_per_sec"] / max(
        columns[1]["load"]["tokens_per_sec"], 1e-9)
    gates = {"parity": all(c["parity"]["agreement"] >= AGREEMENT_MIN for c in columns.values()),
             "conservation": all(c["conservation"]["ok"] for c in columns.values()),
             "affinity": affinity["ok"]}
    result["gates"], result["ok"] = gates, all(gates.values())
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps({"gates": gates, "ok": result["ok"], "scaling_ratio": result["scaling_ratio"]}))
    print(card)
    return 0 if result["ok"] else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true", help="the CPU gates: parity, conservation, spread")
    ap.add_argument("--out", default=None, help="artifact path (nothing is written without it)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--duration", type=float, default=10.0, help="seconds per closed-loop window")
    ns = ap.parse_args(argv)
    # The driver process never decodes for the fleet; keep its telemetry
    # server off unless the caller asked for it.
    os.environ.setdefault("MLSPARK_TELEMETRY_HTTP", "")
    if ns.smoke:
        return run_smoke(ns.out)
    return run_full(ns.out, replicas=ns.replicas, clients=ns.clients, duration=ns.duration)


if __name__ == "__main__":
    sys.exit(main())
