"""Distributed trace report CLI — stitch a run's traces, export Perfetto.

The PyTorch/CUDA port's twin of ``tools/trace_report.py``, over the
port's own ``telemetry.traceview``: the same flags, output and exit
codes, no JAX. The offline half of ``telemetry.traceview``: point it at a directory
holding ``telemetry_rank<k>.jsonl`` exports (and/or ``flight_*.json``
dumps) from a fleet run — router and replicas writing into the same
``MLSPARK_TELEMETRY_DIR`` — and get the request trees stitched back
across processes.

Usage::

    python tools/torch_trace_report.py <dir>                     # summary table
    python tools/torch_trace_report.py <dir> --slowest 20        # worst traces
    python tools/torch_trace_report.py <dir> --trace-id <32hex>  # one tree
    python tools/torch_trace_report.py <dir> --perfetto out.json # Perfetto JSON
    python tools/torch_trace_report.py <dir> --json out.json     # raw payload

``--perfetto`` writes Chrome trace-event JSON (open in
https://ui.perfetto.dev or ``chrome://tracing``): one process row per
rank, request spans on per-trace tracks, flow arrows over every
router→replica dispatch edge. Without ``--trace-id`` ALL spans ride
along — train.step / comms.* timelines land on the same view as the
serving traces. Exits nonzero when the directory yields no events.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from machine_learning_apache_spark_tpu_torch.telemetry import traceview  # noqa: E402


def _render_node(n: dict, depth: int, lines: list[str]) -> None:
    dur = "-" if n["dur_s"] is None else f"{n['dur_s'] * 1e3:.3f} ms"
    where = f"rank {n['rank']}" if n["rank"] is not None \
        else f"pid {n['pid']}"
    via = " (remote)" if n.get("via") == "remote" else ""
    attrs = {
        k: v for k, v in n["attrs"].items()
        if k not in (traceview.CTX_SPAN_ATTR, traceview.REMOTE_PARENT_ATTR)
    }
    extra = f"  {attrs}" if attrs else ""
    lines.append(
        f"{'  ' * depth}- {n['name']}{via} [{where}] {dur}{extra}"
    )
    for c in n["children"]:
        _render_node(c, depth + 1, lines)


def render_tree(tree: dict) -> str:
    lines = [f"# Trace {tree['trace_id']}", ""]
    for root in tree["roots"]:
        _render_node(root, 0, lines)
    if tree["orphans"]:
        lines += ["", "## Orphans (unresolved parent)", ""]
        for n in tree["orphans"]:
            _render_node(n, 0, lines)
    if tree["annotations"]:
        lines += ["", "## Annotations", ""]
        for ev in tree["annotations"]:
            lines.append(f"- {ev.get('name')}  {ev.get('attrs') or {}}")
    return "\n".join(lines) + "\n"


def render_summary(trees: dict, top: int) -> str:
    comp = traceview.completeness(trees)
    lines = ["# Distributed traces", ""]
    lines.append(
        f"- traces: {comp['traces']}  complete: {comp['complete']}"
        f"  fraction: {comp['fraction']}"
    )
    lines += ["", f"## Slowest {top}", ""]
    lines.append("| trace | root | total (ms) | spans | procs | complete |")
    lines.append("|---|---|---|---|---|---|")
    for r in traceview.slowest(trees, top):
        total = "-" if r["total_s"] is None else f"{r['total_s'] * 1e3:.3f}"
        lines.append(
            f"| {r['trace_id']} | {r['root']} | {total} "
            f"| {r['spans']} | {r['processes']} | {r['complete']} |"
        )
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", help="run dir with telemetry_rank*.jsonl")
    ap.add_argument("--trace-id", help="render one trace's stitched tree")
    ap.add_argument("--slowest", type=int, default=10, metavar="N",
                    help="rows in the summary table (default 10)")
    ap.add_argument("--perfetto", metavar="OUT.json",
                    help="write Chrome trace-event JSON for Perfetto")
    ap.add_argument("--json", metavar="OUT.json",
                    help="write the raw payload as JSON")
    args = ap.parse_args(argv)

    events = traceview.load_dir(args.directory)
    if not events:
        print(f"no telemetry events found in {args.directory!r}",
              file=sys.stderr)
        return 1
    trees = traceview.assemble(events)

    if args.perfetto:
        doc = traceview.perfetto_export(events, args.trace_id)
        with open(args.perfetto, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} trace events "
              f"-> {args.perfetto}")

    if args.json:
        payload = traceview.tracez_payload(events, args.trace_id)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")

    if args.trace_id:
        tree = trees.get(args.trace_id)
        if tree is None:
            print(f"unknown trace id {args.trace_id!r} "
                  f"({len(trees)} traces in dir)", file=sys.stderr)
            return 1
        print(render_tree(tree), end="")
    elif not args.perfetto and not args.json:
        print(render_summary(trees, args.slowest), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
