"""Live gang status — scrape every rank's observability plane into one table.

The PyTorch/CUDA port's twin of ``tools/gang_status.py``, over the port's
``fleet.scrape``, ``telemetry.http.find_port_sidecars`` and
``launcher.monitor.read_heartbeat``: the same flags, output and exit
codes, no JAX; ``--smoke`` runs a 2-rank gang of the port on the host
(``launcher.Distributor(platform="cpu")``).

The online counterpart of ``tools/torch_telemetry_report.py``: instead of
merging post-hoc JSONL exports, this scrapes each rank's HTTP endpoints
(``/healthz`` + ``/statusz``, served when ``MLSPARK_TELEMETRY_HTTP`` is
set) **while the gang runs** and renders a per-rank table: phase, step,
health, heartbeat age, queue depth, tokens/sec, KV-page occupancy, and
the step skew across ranks.

Discovery is file-based, matching the launcher's contracts: each rank
publishes its bound port in an ``http_rank<k>.json`` sidecar (written by
``telemetry.http.start_http_server``) in the telemetry dir, next to the
``heartbeat_<k>`` files whose JSON payloads (rank, phase, step) enrich
ranks whose HTTP plane is unreachable.

Usage::

    python tools/torch_gang_status.py <telemetry-dir> [--json out.json] [--md out.md]
    python tools/torch_gang_status.py --smoke   # 2-rank end-to-end self-test

With no ``--json``/``--md`` the markdown table goes to stdout. Exits
nonzero when no rank could be discovered — an empty table means the gang
is gone (or the plane was never enabled), not that all is well.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from machine_learning_apache_spark_tpu_torch.fleet.scrape import (  # noqa: E402
    scrape as _fleet_scrape,
)
from machine_learning_apache_spark_tpu_torch.launcher.monitor import (  # noqa: E402
    read_heartbeat,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (  # noqa: E402
    aggregate,
)
from machine_learning_apache_spark_tpu_torch.telemetry.http import (  # noqa: E402
    find_port_sidecars,
)

HEARTBEAT_RE = re.compile(r"heartbeat_(\d+)$")


def scrape(
    port: int,
    path: str,
    timeout: float = 2.0,
    *,
    retries: int = 2,
) -> dict | None:
    """GET one endpoint off a rank's local plane; None on failure after
    retries (a dead rank must not kill the whole table). The scrape
    logic proper lives in ``fleet.scrape`` now — this wrapper keeps the
    tool's historical signature and defaults retries on, closing the
    sidecar-discovery race: a rank writes its port sidecar in the same
    instant its server binds, so a scrape landing a moment early sees
    one connection-refused and must try again, not report the rank
    unreachable forever."""
    return _fleet_scrape(port, path, timeout, retries=retries)


def find_heartbeats(directory: str) -> dict[int, str]:
    """``{rank: path}`` for every ``heartbeat_<k>`` file in a dir."""
    out: dict[int, str] = {}
    for path in glob.glob(os.path.join(directory, "heartbeat_*")):
        m = HEARTBEAT_RE.search(os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return dict(sorted(out.items()))


def collect_rows(directory: str, *, timeout: float = 2.0) -> list[dict]:
    """One status row per discovered rank: sidecar ports are scraped
    live; ranks without a reachable plane fall back to their heartbeat
    payload (phase/step/mtime age) so a wedged rank still shows up —
    the rank you most need to see."""
    sidecars = find_port_sidecars(directory)
    heartbeats = find_heartbeats(directory)
    rows: list[dict] = []
    for rank in sorted(set(sidecars) | set(heartbeats)):
        row: dict = {"rank": rank}
        hb_path = heartbeats.get(rank)
        if hb_path:
            payload = read_heartbeat(hb_path)
            row["phase"] = payload.get("phase")
            row["step"] = payload.get("step")
            try:
                row["heartbeat_age_s"] = round(
                    max(0.0, time.time() - os.stat(hb_path).st_mtime), 3
                )
            except OSError:
                pass
        side = sidecars.get(rank)
        if side:
            row["port"] = side.get("port")
            health = scrape(side["port"], "/healthz", timeout=timeout)
            if health is None:
                row["status"] = "unreachable"
                rows.append(row)
                continue
            row["status"] = health.get("status")
            for key in ("phase", "step", "heartbeat_age_s"):
                if health.get(key) is not None:
                    row[key] = health[key]
            status = scrape(side["port"], "/statusz", timeout=timeout)
            serving = ((status or {}).get("sections") or {}).get("serving")
            if isinstance(serving, dict) and "error" not in serving:
                row["queue_depth"] = serving.get("queue_depth")
                row["in_flight"] = (serving.get("ledger") or {}).get(
                    "in_flight"
                )
                row["tokens_per_sec"] = (serving.get("metrics") or {}).get(
                    "tokens_per_sec"
                )
                pool = serving.get("page_pool") or {}
                row["occupancy"] = pool.get("mem_occupancy") or pool.get(
                    "occupancy"
                )
        else:
            row["status"] = "no-http"
        rows.append(row)
    return rows


# -- smoke mode ----------------------------------------------------------------
def _smoke_worker(max_s: float = 60.0) -> int:
    """2-rank self-test worker (run via ``Distributor`` with the tools
    dir on the workers' PYTHONPATH): tick the beacon until the launching process
    drops a stop marker in the telemetry dir. The runner already started
    this rank's HTTP server and heartbeat thread — the worker only has
    to stay alive and keep its step moving."""
    from machine_learning_apache_spark_tpu_torch.telemetry import events

    tdir = os.environ.get("MLSPARK_TELEMETRY_DIR", ".")
    stop_marker = os.path.join(tdir, "smoke_stop")
    deadline = time.monotonic() + max_s
    step = 0
    while time.monotonic() < deadline:
        events.beacon_update(phase="smoke", step=step)
        if os.path.exists(stop_marker):
            return step
        step += 1
        time.sleep(0.1)
    return step


def run_smoke() -> int:
    """End-to-end self-test: spawn a 2-rank gang with the HTTP plane on
    ephemeral ports, wait for both sidecars, scrape both ranks, render
    the table, tear down. Exit 0 iff both ranks answered."""
    from machine_learning_apache_spark_tpu_torch.launcher.distributor import (
        Distributor,
    )

    tdir = tempfile.mkdtemp(prefix="mlspark_gang_status_smoke_")
    dist = Distributor(
        num_processes=2,
        platform="cpu",
        telemetry_http=0,
        heartbeat_interval=0.2,
        timeout=120.0,
        env={"MLSPARK_TELEMETRY_DIR": tdir, "MLSPARK_TELEMETRY": "1"},
    )
    result: dict = {}

    def drive() -> None:
        try:
            result["value"] = dist.run("torch_gang_status:_smoke_worker")
        except Exception as e:  # noqa: BLE001 — reported below
            result["error"] = e

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if len(find_port_sidecars(tdir)) >= 2 or "error" in result:
                break
            time.sleep(0.2)
        rows = collect_rows(tdir, timeout=5.0)
    finally:
        with open(os.path.join(tdir, "smoke_stop"), "w") as f:
            f.write("stop\n")
        t.join(60.0)

    print(aggregate.render_status_markdown(rows))
    if "error" in result:
        print(f"smoke gang failed: {result['error']!r}", file=sys.stderr)
        return 1
    scraped = [r for r in rows if r.get("status") in ("ok", "degraded")]
    if len(scraped) < 2:
        print(
            f"smoke: scraped {len(scraped)}/2 ranks ({rows})",
            file=sys.stderr,
        )
        return 1
    print(f"smoke ok: scraped {len(scraped)}/2 ranks")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "directory", nargs="?", default=None,
        help="telemetry dir holding http_rank<k>.json / heartbeat_<k> files",
    )
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the rows as JSON here")
    ap.add_argument("--md", dest="md_out", default=None,
                    help="write the markdown table here")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint scrape timeout (seconds)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the 2-rank end-to-end self-test and exit")
    ns = ap.parse_args(argv)

    if ns.smoke:
        return run_smoke()
    if not ns.directory:
        ap.error("pass a telemetry directory (or --smoke)")

    rows = collect_rows(ns.directory, timeout=ns.timeout)
    if not rows:
        print(
            f"error: no http_rank<k>.json or heartbeat_<k> files in "
            f"{ns.directory}",
            file=sys.stderr,
        )
        return 1
    md = aggregate.render_status_markdown(rows)
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            json.dump({"artifact": "gang_status", "rows": rows}, f, indent=2)
            f.write("\n")
    if ns.md_out:
        with open(ns.md_out, "w") as f:
            f.write(md)
    if not ns.json_out and not ns.md_out:
        print(md, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
