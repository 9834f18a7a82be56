"""Telemetry report CLI — merge per-rank JSONL exports into one report.

The PyTorch/CUDA port's twin of ``tools/telemetry_report.py``, over the
port's own ``telemetry.aggregate``: the same flags, output and exit
codes, no JAX. The offline half of ``telemetry.aggregate``: point it at a directory of
``telemetry_rank<k>.jsonl`` files (a gang workdir, or wherever
``MLSPARK_TELEMETRY_DIR`` pointed) and get the gang-wide per-phase
p50/p99 table, the rank-skew (straggler attribution) report, a comms
section (zero1 wire bytes per step, overlapped-vs-exposed byte split,
collective span p50/p99, and a comms-bound vs compute-bound verdict —
the comms twin of the ingest input-bound verdict) when the run recorded
any ``comms.*`` events, an ingest section (``data.*``
stage durations, prefetch-buffer occupancy, input-bound vs compute-bound
verdict) when it recorded any ``data.*`` events, and serving + per-request
latency-breakdown sections (queue wait / ttft / service / total stats,
slowest-request exemplars) when it recorded any ``serving.*`` events.

Usage::

    python tools/torch_telemetry_report.py <dir> [--json out.json] [--md out.md]
    python tools/torch_telemetry_report.py --files telemetry_rank0.jsonl ...

With no ``--json``/``--md``, the markdown report goes to stdout. Exits
nonzero if the directory holds no rank files — an empty report is a
broken pipeline, not a quiet success.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from machine_learning_apache_spark_tpu_torch.telemetry import aggregate  # noqa: E402


def _report_from_files(paths: list[str]) -> dict:
    """Build the same report shape as ``merge_gang_dir`` from an explicit
    file list; ranks are parsed from the file names."""
    by_rank: dict[int, str] = {}
    for p in paths:
        m = aggregate.RANK_FILE_RE.search(os.path.basename(p))
        if m:
            by_rank[int(m.group(1))] = p
        else:
            # Non-canonical name: assign the next free rank slot so ad-hoc
            # exports still merge.
            m2 = re.search(r"(\d+)", os.path.basename(p))
            rank = int(m2.group(1)) if m2 else len(by_rank)
            while rank in by_rank:
                rank += 1
            by_rank[rank] = p
    events = aggregate.merge_rank_files(by_rank)
    table = aggregate.phase_table(events)
    return {
        "artifact": "telemetry_report",
        "files": [os.path.abspath(p) for p in paths],
        "ranks": sorted(by_rank),
        "event_count": len(events),
        "phases": table,
        "skew": aggregate.skew_report(table),
        "comms": aggregate.comms_report(events, table),
        "ingest": aggregate.ingest_report(events, table),
        "serving": aggregate.serving_report(events, table),
        "requests": aggregate.request_report(events),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "directory", nargs="?", default=None,
        help="directory holding telemetry_rank<k>.jsonl files",
    )
    ap.add_argument(
        "--files", nargs="+", default=None,
        help="explicit rank JSONL files (instead of a directory scan)",
    )
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the full report as JSON here")
    ap.add_argument("--md", dest="md_out", default=None,
                    help="write the markdown report here")
    ns = ap.parse_args(argv)

    if bool(ns.directory) == bool(ns.files):
        ap.error("pass exactly one of: a directory, or --files ...")

    if ns.directory:
        if not aggregate.find_rank_files(ns.directory):
            print(
                f"error: no telemetry_rank<k>.jsonl files in {ns.directory}",
                file=sys.stderr,
            )
            return 1
        report = aggregate.merge_gang_dir(ns.directory)
    else:
        missing = [p for p in ns.files if not os.path.exists(p)]
        if missing:
            print(f"error: missing file(s): {missing}", file=sys.stderr)
            return 1
        report = _report_from_files(ns.files)

    md = aggregate.render_markdown(report)
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if ns.md_out:
        with open(ns.md_out, "w") as f:
            f.write(md)
    if not ns.json_out and not ns.md_out:
        print(md, end="")
    else:
        print(
            f"merged {report['event_count']} events from ranks "
            f"{report['ranks']} ({len(report['phases'])} phases)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
