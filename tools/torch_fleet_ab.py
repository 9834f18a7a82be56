#!/usr/bin/env python
"""The serving fleet's autoscale cycle (``chip_smoke.py`` phase 7k) on
two or more trees, in turns, on the card.

Usage (from the repo root, the other tree unpacked under ``build/``)::

    python3 tools/torch_fleet_ab.py build/<parent> . . build/<parent>

Each tree runs in a process of its own (its working directory and
``PYTHONPATH`` the tree): the tree's ``chip_smoke`` builds its kernels,
serves phase 4's prompts through one paged fp32 engine (the fleet's
oracle) and runs its ``fleet_slice`` — (a) routed prompts, (b) rank 1
killed and restarted, (c) the autoscaler's 2 -> 3 -> 2 cycle under 16
closed-loop clients — with the phase's failed gates recorded instead of
ending the run. Printed per run: the rank the autoscaler added, the
dispatches the router sent it by the end of the hot load, their share of
the hot load's completed requests, the hot load's requests/s, the
scale-up and the added replica's start-up seconds, and the failed gates;
then one JSON line with every run. Compare trees only inside one call:
the host's speed moves host-bound numbers up to 2x between calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MARK = "FLEET_AB "


def one() -> dict:
    """This tree's phase 4 paged fp32 run and phase 7k."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    cs.cache_bytecode()
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    resolve_device(None)
    LIBRARY.kernels()
    card = cs.card_line()
    src_words, src_pipe, trg_pipe = cs.serving_pipes()
    prompts = cs.make_prompts(src_words)
    translator = cs.build_translator(None, cs.model_params(src_pipe, trg_pipe), src_pipe, trg_pipe)
    single = cs.serve_once(torch, hop, translator, prompts, "paged float32", kv_dtype="float32",
                           **cs.SERVE)
    failed: list[str] = []
    cs.fail = failed.append  # keep the phase's result when a gate fails
    out = cs.fleet_slice(torch, hop, card, translator, prompts, single)
    c = out.get("c", {})
    hot = c.get("hot", {})
    done = hot.get("completed")
    return dict(
        tree=os.getcwd(), card=card, seconds=out.get("seconds"), added=c.get("added"),
        added_dispatched=c.get("added_dispatched"),
        added_share=c.get("added_dispatched") / done if done else None,
        hot_completed=done, hot_requests_per_s=hot.get("requests_per_sec"),
        scale_up_s=c.get("scale_up_s"), added_startup_s=c.get("added_startup_s"),
        fleet_requests_per_s=out.get("a", {}).get("requests_per_s"), failed=failed,
    )


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(MARK + json.dumps(one(), default=str), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.abspath(__file__)
    runs = []
    for tree in argv:
        root = os.path.abspath(tree)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, here, "--one"], cwd=root, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": root}, timeout=1500,
        )
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(f"{tree}: exit {proc.returncode} after {wall:.1f} s\n{proc.stdout[-4000:]}\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        run = json.loads(lines[-1][len(MARK):])
        run["wall"] = wall
        runs.append(run)
        for ln in proc.stdout.splitlines():
            if ln.lstrip().startswith(("(c)", "at the end of the hot load", "the added rank")):
                print(f"  [{tree}] {ln.strip()}")
        print(f"{tree}: added rank {run['added']} took {run['added_dispatched']} dispatches, share "
              f"{run['added_share']} of the hot load's {run['hot_completed']} requests; hot load "
              f"{run['hot_requests_per_s']} requests/s; scale-up {run['scale_up_s']} s, added start-up "
              f"{run['added_startup_s']} s; (a) {run['fleet_requests_per_s']} requests/s; failed gates "
              f"{run['failed']}; {wall:.1f} s [{run['card']}]", flush=True)
    print(json.dumps({"runs": runs}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
