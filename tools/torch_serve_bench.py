#!/usr/bin/env python3
"""The port's serving engines, closed-loop, for one or more trees in turns.

    python3 tools/torch_serve_bench.py OLD NEW NEW OLD     # on the card
    python3 tools/torch_serve_bench.py --smoke             # gates only, on the CPU

The port's twin of ``tools/serve_bench.py``. Each argument is the root of
a checkout of this repo (for example a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists, and ``.``); with
none, this tree. For each, in the order given, a fresh process imports
that tree's package (its kernels built from its own ``csrc/`` into its
own ``build/``) and measures four engines on the card — paged with fp32
pages, paged with int8 pages, padded, and beam — at ``chip_smoke.py``'s
serving configuration: the reference MT model at full width with random
weights from the seed, this tree's ``chip_smoke.py`` prompts, and its
engine settings. Per engine, after a warm pass over every prompt:

- a closed-loop window: as many client threads as the engine has rows
  (beam: prompts per batch), each submitting its next request when the
  last one returns, ``--requests`` requests in all (beam: a quarter):
  requests/s, generated tokens/s, p50/p99 latency, the device memory
  the warmed engine holds (its page stores or slots, and its programs)
  and the window's peak (``max_memory_allocated``), both above what was
  allocated before the engine was built;
- the same window under the profiler: device busy seconds and the idle
  share;
- paged engines: the same window once more on a fresh engine, the
  decode thread's host time per launch split by activity
  (``chip_smoke.host_split``; a tree without staging or replay reports
  those as null);
- the gates of ``tools/serve_bench.py`` but the HTTP scrape (which the
  port lacks): ``parity`` (the paged fp32 engine's outputs against the
  one-shot ``Translator``, token agreement >= 0.99 on the card, identical
  on the CPU), ``token_match`` (int8 against fp32 pages, >= 0.99; both
  by ``chip_smoke.agreement``, position by position, the port's int8
  gate; the JAX bench's prefix rate is printed beside it),
  ``zero_recompiles`` (``recompiles_after_warmup == 0`` for every engine;
  null where a tree's engines expose no program count) and
  ``conservation`` (every request accounted for).

Prints each run as a JSON line, then a table of every number, one column
per run, with the card's name and power limit; ``--out`` also writes all
runs as JSON. Exits nonzero if a run fails or a gate is false.
``--smoke`` runs the gates alone, in this process, at a tiny size on the
CPU (plain versions of the kernels).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MARK = "SERVE_BENCH_RESULT "
AGREEMENT_MIN = 0.99
REQUESTS = 256
# The smoke's model and engines: small, on the CPU. At a width of 32 the
# random weights' logits sit so near ties that int8 rounding flips some
# argmaxes (the JAX bench trains its smoke model for that reason); at 128
# they have margins.
SMOKE_MODEL = dict(d_model=128, ffn_hidden=256, num_heads=4, num_layers=1, max_len=24, dropout=0.0)
SMOKE_ENGINE = dict(boundaries=(8, 16), max_new_tokens=8)


def _chip_smoke():
    """This tree's ``chip_smoke.py``, under its own name, so that a tree
    on ``sys.path`` cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_serve_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engines(cs, smoke: bool) -> dict:
    """Engine label -> (engine keywords, clients, share of the requests)."""
    if smoke:
        paged = dict(kv_mode="paged", max_active=4, page_size=4, **SMOKE_ENGINE)
        return {
            "paged fp32": (dict(kv_dtype="float32", **paged), 4, 1.0),
            "paged int8": (dict(kv_dtype="int8", **paged), 4, 1.0),
            "padded": (dict(kv_mode="padded", max_batch=4, max_wait_s=0.005, **SMOKE_ENGINE), 4, 1.0),
            "beam": (dict(method="beam", beam_size=2, max_batch=2, max_wait_s=0.005, **SMOKE_ENGINE), 2, 0.5),
        }
    return {
        "paged fp32": (dict(kv_dtype="float32", **cs.SERVE), cs.SERVE["max_active"], 1.0),
        "paged int8": (dict(kv_dtype="int8", **cs.SERVE), cs.SERVE["max_active"], 1.0),
        "padded": (cs.SERVE_PADDED, cs.SERVE_PADDED["max_batch"], 1.0),
        "beam": (cs.SERVE_BEAM, cs.SERVE_BEAM["max_batch"], 0.25),
    }


def closed_loop(torch, eng, prompts, n: int, clients: int) -> dict:
    """``n`` requests from ``clients`` threads, each submitting its next
    prompt (in turn through ``prompts``) when its last one returns: wall
    seconds (synchronised card to synchronised card), per-request
    latencies, and the engine's generated tokens in the window."""
    cuda = eng.device.type == "cuda"
    lock = threading.Lock()
    state = {"next": 0, "error": None}
    latencies = []

    def client():
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if i >= n or state["error"] is not None:
                return
            t0 = time.perf_counter()
            try:
                eng.submit(prompts[i % len(prompts)]).result(timeout=600)
            except Exception as e:  # noqa: BLE001 — reported and re-raised below
                state["error"] = e
                return
            with lock:
                latencies.append(time.perf_counter() - t0)

    tokens0 = eng.metrics.tokens_out
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, name=f"bench-client-{k}") for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if state["error"] is not None:
        raise state["error"]
    if any(t.is_alive() for t in threads) or len(latencies) != n:
        raise RuntimeError(f"closed loop finished {len(latencies)} of {n} requests")
    return dict(wall=wall, latencies=latencies, tokens=eng.metrics.tokens_out - tokens0)


def prefix_agreement(a: list[str], b: list[str]) -> float:
    """The JAX bench's token match: per request, the agreeing prefix over
    the longer output; summed over requests. Reported beside the gate: it
    assumes a trained model, and with random weights one near-tie flip
    early in a long output counts every later position against it."""
    matched = total = 0
    for x, y in zip(a, b):
        xs, ys = x.split(), y.split()
        agree = 0
        for p, q in zip(xs, ys):
            if p != q:
                break
            agree += 1
        matched += agree
        total += max(len(xs), len(ys))
    return matched / total if total else 1.0


def measure(smoke: bool = False, requests: int = REQUESTS) -> dict:
    """Every engine of this process's package: gates, and (on the card)
    the closed-loop, profiled and host-split windows."""
    import torch

    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline

    cs = _chip_smoke()
    words, corpus = cs.make_vocab_texts("s")
    _, trg_corpus = cs.make_vocab_texts("t")
    if smoke:
        cs.MODEL = SMOKE_MODEL
        max_src = SMOKE_ENGINE["boundaries"][-1]
        rng = np.random.default_rng(cs.SEED + 1)
        prompts = [" ".join(rng.choice(words[:200], int(n))) for n in rng.integers(2, max_src - 1, 24)]
        device, mnt = "cpu", SMOKE_ENGINE["max_new_tokens"]
    else:
        max_src = cs.SERVE["boundaries"][-1]
        prompts = cs.make_prompts(words)
        device, mnt = None, cs.SERVE["max_new_tokens"]
    src_pipe = TextPipeline.fit(corpus, max_seq_len=max_src - 1)
    trg_pipe = TextPipeline.fit(trg_corpus, max_seq_len=max_src - 1)
    translator = cs.build_translator(device, cs.model_params(src_pipe, trg_pipe), src_pipe, trg_pipe)
    cuda = translator.device.type == "cuda"
    card = cs.card_line() if cuda else "cpu"
    oracle = translator(prompts, max_new_tokens=mnt)
    tree = Path(sys.modules[TextPipeline.__module__].__file__).resolve().parents[2]
    out = dict(tree=str(tree), card=card, engines={}, gates={})
    outs = {}
    for label, (kw, clients, share) in engines(cs, smoke).items():
        eng_prompts = prompts[: len(prompts) // 4] if label == "beam" else prompts
        n = max(int(requests * share), clients)

        def window(torch, eng, prompts, n=n, clients=clients):
            return closed_loop(torch, eng, prompts, n, clients)["wall"]

        if cuda:  # what earlier engines left is freed before this one
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
        eng = translator.serve(**kw)
        try:
            outs[label] = [f.result(timeout=600) for f in [eng.submit(p) for p in eng_prompts]]
            if cuda:
                held = torch.cuda.memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
            run = closed_loop(torch, eng, eng_prompts, n, clients)
            peak = torch.cuda.max_memory_allocated() - base if cuda else None
            prof = cs.profiled_window(torch, eng, eng_prompts, window=window) if cuda else None
            recompiles = eng.recompiles_after_warmup
            programs = eng.compile_count()
        finally:
            eng.stop()
        conserved = eng.metrics.check_conservation(in_flight=0)
        paged = eng.runtime is not None
        del eng  # so that the next engine's baseline holds none of it
        lat = sorted(run["latencies"])
        row = dict(
            requests=n, clients=clients, wall_s=run["wall"],
            requests_per_s=n / run["wall"], tokens_per_s=run["tokens"] / run["wall"],
            p50_latency_s=lat[len(lat) // 2], p99_latency_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            held_mib=held / 2**20 if cuda else None,
            peak_mib=None if peak is None else peak / 2**20,
            profiled_wall_s=None if prof is None else prof["wall"],
            device_busy_s=None if prof is None else prof["busy"],
            idle_share=None if prof is None else prof["idle_share"],
            programs=programs, recompiles_after_warmup=recompiles,
            completed=conserved["completed"],
        )
        if cuda and paged:
            split = cs.host_split(torch, translator, kw, eng_prompts, window=window)
            row["host_launches"] = split["launches"]
            row["host_ms_per_launch"] = split["per_launch_ms"]
        out["engines"][label] = row
    parity = cs.agreement(outs["paged fp32"], oracle)[0]
    match = cs.agreement(outs["paged int8"], outs["paged fp32"])[0]
    out["gates"] = dict(
        parity=(outs["paged fp32"] == oracle) if not cuda else parity >= AGREEMENT_MIN,
        token_match=match >= AGREEMENT_MIN,
        zero_recompiles=None if any(r["recompiles_after_warmup"] is None for r in out["engines"].values())
        else all(r["recompiles_after_warmup"] == 0 for r in out["engines"].values()),
        conservation=True,  # check_conservation raised already if not
    )
    out["parity_rate"] = parity
    out["token_match_rate"] = match
    out["token_match_prefix_rate"] = prefix_agreement(outs["paged int8"], outs["paged fp32"])
    return out


def worker(tree: Path, requests: int) -> dict:
    """Measures one tree: its package comes first on the path."""
    sys.path.insert(0, str(tree))
    from machine_learning_apache_spark_tpu_torch.serving import engine

    if not Path(engine.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {engine.__file__}, not the package of {tree}")
    return measure(requests=requests)


def _cell(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def table(runs: list[dict]) -> None:
    print(f"serving engines per run [{runs[0]['card']}]; runs: "
          + ", ".join(f"{i} = {r['tree']}" for i, r in enumerate(runs)))
    print(f"{'engine / metric':52s} " + " ".join(f"{f'run {i}':>12s}" for i in range(len(runs))))
    for label, row in runs[0]["engines"].items():
        keys = [k for k in row if k != "host_ms_per_launch"]
        keys += [f"host_ms_per_launch.{k}" for k in row.get("host_ms_per_launch") or {}]
        for key in keys:
            cells = []
            for r in runs:
                v = r["engines"][label]
                for part in key.split("."):
                    v = v.get(part) if isinstance(v, dict) else None
                cells.append(f"{_cell(v):>12s}")
            print(f"{label + ' ' + key:52s} " + " ".join(cells))
    for gate in runs[0]["gates"]:
        print(f"{'gate ' + gate:52s} " + " ".join(f"{_cell(r['gates'][gate]):>12s}" for r in runs))


def failed_gates(run: dict) -> list[str]:
    return [g for g, ok in run["gates"].items() if ok is False]


def main(argv: list[str]) -> int:
    requests = REQUESTS
    if "--requests" in argv:
        i = argv.index("--requests")
        requests = int(argv[i + 1])
        del argv[i:i + 2]
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        del argv[i:i + 2]
    if argv[:1] == ["--worker"]:
        print(MARK + json.dumps(worker(Path(argv[1]), requests)), flush=True)
        return 0
    if argv[:1] == ["--smoke"]:
        sys.path.insert(0, str(ROOT))
        result = measure(smoke=True, requests=32)
        print(json.dumps(result))
        bad = failed_gates(result)
        print(json.dumps({"gates": result["gates"], "ok": not bad}))
        return 1 if bad else 0
    runs = []
    for tree in argv or [str(ROOT)]:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", tree, "--requests", str(requests)],
            capture_output=True, text=True,
        )
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"torch_serve_bench: the run of {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        result = json.loads(lines[-1][len(MARK):])
        print(json.dumps(result), flush=True)
        runs.append(result)
    table(runs)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(runs, indent=1))
    bad = {r["tree"]: failed_gates(r) for r in runs if failed_gates(r)}
    if bad:
        print(f"torch_serve_bench: gates failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
