"""Gang-wide telemetry aggregation: merge per-rank JSONL into one report;
the port of ``machine_learning_apache_spark_tpu/telemetry/aggregate.py``
(the same functions over the same files, so either package reads the
other's exports).

Each rank exports its event log as ``telemetry_rank<k>.jsonl`` (the
launcher's runner does this in its exit path, next to the heartbeat
files). This module merges those files into:

- a **per-phase table** — for every span name, per-rank and overall
  count / mean / p50 / p99 durations;
- a **skew report** — for every phase seen on >1 rank, which rank is
  slowest (by mean duration), the slowest/fastest ratio, and the spread.
  In an SPMD gang every rank runs the same program, so a phase whose
  mean differs across ranks is a straggler signature — the slowest-rank
  attribution comms work needs.

Percentiles are nearest-rank via the same ``percentile`` definition the
registry and serving ledger use. Consumed by rank 0 in-process or by
``tools/telemetry_report.py`` offline; pure functions over plain dicts,
stdlib-only.
"""

from __future__ import annotations

import glob
import json
import os
import re

from machine_learning_apache_spark_tpu_torch.telemetry.registry import _percentile

RANK_FILE_RE = re.compile(r"telemetry_rank(\d+)\.jsonl$")


def rank_file_name(rank: int) -> str:
    return f"telemetry_rank{rank}.jsonl"


def write_rank_file(directory: str, rank: int | None = None) -> str:
    """Export this process's event log as ``telemetry_rank<k>.jsonl`` in
    ``directory``; returns the path. Rank defaults to the env rank (0 when
    running outside a gang)."""
    from machine_learning_apache_spark_tpu_torch.telemetry import events as _events

    if rank is None:
        r = _events._env_rank()
        rank = 0 if r is None else r
    path = os.path.join(directory, rank_file_name(rank))
    _events.get_log().export_jsonl(path)
    return path


# Parse cache for rank exports, keyed on (mtime_ns, size). Live status
# tooling (gang_status --watch, the bench's periodic merges) re-merges
# the same directory on an interval, and most rank files are unchanged
# between ticks — exports are written once by atomic os.replace, so an
# (mtime_ns, size) match means byte-identical content. Entries hold the
# parsed event dicts; every consumer that mutates an event copies it
# first (merge_rank_files stamps rank onto a dict() copy), so sharing
# the parsed lists is safe.
_PARSE_CACHE: dict[str, tuple[tuple[int, int], list[dict]]] = {}
_PARSE_CACHE_MAX = 64


def clear_parse_cache() -> None:
    """Drop the JSONL parse cache (test hook)."""
    _PARSE_CACHE.clear()


def load_jsonl(path: str) -> list[dict]:
    """Read one rank's JSONL export (cached by mtime+size — see
    ``_PARSE_CACHE``). Tolerates a trailing partial line (a killed
    writer) but raises on malformed interior lines."""
    path = os.path.abspath(path)
    try:
        st = os.stat(path)
        stamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    if stamp is not None:
        hit = _PARSE_CACHE.get(path)
        if hit is not None and hit[0] == stamp:
            # Fresh outer list per hit — a caller appending to its result
            # must not grow the cached copy.
            return list(hit[1])
    out: list[dict] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn final line from a killed process
            raise
    if stamp is not None:
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            # Bounded: evict the oldest insertion (a watch loop touches
            # the same few files; anything beyond the bound is churn).
            _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
        # The cache keeps its own outer list: the miss path hands the
        # caller the same isolation a hit does.
        _PARSE_CACHE[path] = (stamp, list(out))
    return out


def find_rank_files(directory: str) -> dict[int, str]:
    """``{rank: path}`` for every ``telemetry_rank<k>.jsonl`` in a dir."""
    out: dict[int, str] = {}
    for path in glob.glob(os.path.join(directory, "telemetry_rank*.jsonl")):
        m = RANK_FILE_RE.search(os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return dict(sorted(out.items()))


def merge_rank_files(paths: dict[int, str]) -> list[dict]:
    """Concatenate rank exports into one event list, stamping each event's
    ``rank`` with the rank from the FILE NAME (authoritative — an event
    recorded before the env contract was set carries rank=None)."""
    merged: list[dict] = []
    for rank, path in sorted(paths.items()):
        for ev in load_jsonl(path):
            ev = dict(ev)
            ev["rank"] = rank
            merged.append(ev)
    return merged


def _stats(durations: list[float]) -> dict:
    return {
        "count": len(durations),
        "mean": round(sum(durations) / len(durations), 6),
        "p50": _percentile(durations, 50),
        "p99": _percentile(durations, 99),
        "max": max(durations),
    }


def phase_table(events: list[dict]) -> dict:
    """Per-span-name duration stats: ``{phase: {"overall": stats,
    "ranks": {rank: stats}}}``, built from ``span_end`` events."""
    by_phase: dict[str, dict[int | None, list[float]]] = {}
    for ev in events:
        if ev.get("kind") != "span_end" or ev.get("value") is None:
            continue
        by_phase.setdefault(ev["name"], {}).setdefault(
            ev.get("rank"), []
        ).append(float(ev["value"]))
    table: dict[str, dict] = {}
    for phase in sorted(by_phase):
        per_rank = by_phase[phase]
        all_durs = [d for durs in per_rank.values() for d in durs]
        table[phase] = {
            "overall": _stats(all_durs),
            "ranks": {
                rank: _stats(durs)
                for rank, durs in sorted(
                    per_rank.items(), key=lambda kv: (kv[0] is None, kv[0])
                )
            },
        }
    return table


def skew_report(table: dict) -> dict:
    """Straggler attribution from a ``phase_table``: for every phase with
    >1 rank, the slowest rank by mean duration and the slow/fast ratio."""
    report: dict[str, dict] = {}
    for phase, entry in table.items():
        ranks = {
            r: s for r, s in entry["ranks"].items() if r is not None
        }
        if len(ranks) < 2:
            continue
        slowest = max(ranks, key=lambda r: ranks[r]["mean"])
        fastest = min(ranks, key=lambda r: ranks[r]["mean"])
        fast_mean = ranks[fastest]["mean"]
        slow_mean = ranks[slowest]["mean"]
        report[phase] = {
            "slowest_rank": slowest,
            "fastest_rank": fastest,
            "slowest_mean": slow_mean,
            "fastest_mean": fast_mean,
            "skew_ratio": round(slow_mean / fast_mean, 4)
            if fast_mean > 0 else None,
            "spread": round(slow_mean - fast_mean, 6),
        }
    return report


#: Exposed-comms fraction above which a run is called comms-bound: more
#: than this share of (exposed-collective + step) time spent in collectives
#: the schedule could not hide behind compute.
COMMS_BOUND_THRESHOLD = 0.25


def comms_report(events: list[dict], table: dict | None = None) -> dict:
    """Comms rollup for the gang report: per-rank totals of the ``comms.*``
    counter events (wire bytes the zero1 step moved, with bytes/step where
    the emitter recorded a step count in ``attrs``), the pipeline line's
    hops per kind (``pipeline``, when a pipelined fit ran: bytes and
    window ms per step), the seq line's ring rotations, all-to-alls and
    gathers per kind (``sequence``, when a fit ran under
    ``sequence_parallel``: the same figures), the expert line's
    all-reduces (``expert``, when a fit ran on an expert axis: calls,
    bytes and window ms per step) and the model line's (``model``, when a
    fit ran on a model axis: the same figures) plus the duration
    stats of any ``comms.*`` span phases (the collective p50/p99 the
    comms-bench emits). Empty dicts when the run had no comms activity —
    the renderer then omits the section's tables.

    The ``overlap`` block splits the same wire bytes into overlapped vs
    exposed (the ``comms.bytes_overlapped`` / ``comms.bytes_exposed``
    counters the zero1 step emits — the static pipeline model, overlap on
    hides ``(nb-1)/nb`` of each collective behind compute). ``verdict``
    mirrors the ingest input-bound verdict: exposed-collective time —
    measured ``comms.*`` span time scaled by the exposed byte fraction —
    as a share of exposed + ``train.step`` time, comms-bound above
    ``COMMS_BOUND_THRESHOLD``. ``None`` when the run recorded no
    ``comms.*`` spans (a fused training step cannot time its in-program
    collectives; only the bench's standalone collectives produce spans).
    """
    table = phase_table(events) if table is None else table
    counters: dict[str, dict] = {}
    for ev in events:
        name = str(ev.get("name", ""))
        if ev.get("kind") != "counter" or not name.startswith("comms."):
            continue
        per_rank = counters.setdefault(name, {})
        entry = per_rank.setdefault(
            ev.get("rank"), {"total": 0.0, "steps": 0}
        )
        entry["total"] += float(ev.get("value") or 0.0)
        entry["steps"] += int((ev.get("attrs") or {}).get("steps") or 0)
    for per_rank in counters.values():
        for entry in per_rank.values():
            entry["per_step"] = (
                round(entry["total"] / entry["steps"], 1)
                if entry["steps"] else None
            )
    collectives = {
        phase: entry
        for phase, entry in table.items()
        if phase.startswith("comms.")
    }

    def _counter_total(name: str) -> float:
        return sum(
            entry["total"] for entry in counters.get(name, {}).values()
        )

    overlap: dict = {}
    exposed_b = _counter_total("comms.bytes_exposed")
    overlapped_b = _counter_total("comms.bytes_overlapped")
    if exposed_b or overlapped_b:
        wire = exposed_b + overlapped_b
        overlap = {
            "bytes_exposed": int(exposed_b),
            "bytes_overlapped": int(overlapped_b),
            "overlapped_fraction": round(overlapped_b / wire, 4) if wire else None,
        }

    def _phase_total(phase: str) -> float:
        entry = table.get(phase)
        if not entry:
            return 0.0
        return entry["overall"]["mean"] * entry["overall"]["count"]

    comms_time = sum(_phase_total(phase) for phase in collectives)
    exposed_fraction_of_bytes = (
        exposed_b / (exposed_b + overlapped_b)
        if (exposed_b + overlapped_b) > 0 else 1.0
    )
    exposed_time = comms_time * exposed_fraction_of_bytes
    step_time = _phase_total("train.step") + _phase_total("train.step_group")
    comms_fraction = (
        round(exposed_time / (exposed_time + step_time), 4)
        if (exposed_time + step_time) > 0 and comms_time > 0 else None
    )
    verdict = None
    if comms_fraction is not None and step_time > 0:
        verdict = (
            "comms-bound"
            if comms_fraction > COMMS_BOUND_THRESHOLD
            else "compute-bound"
        )
    out = {
        "counters": {
            name: dict(sorted(
                per_rank.items(), key=lambda kv: (kv[0] is None, kv[0])
            ))
            for name, per_rank in sorted(counters.items())
        },
        "collectives": collectives,
        "overlap": overlap,
        "comms_fraction": comms_fraction,
        "verdict": verdict,
    }
    for section, prefix in (("pipeline", "pp_"), ("sequence", "sp_"), ("expert", "ep_"),
                            ("model", "tp_")):
        hops = _line_hops(counters, prefix)
        if hops:
            out[section] = hops
    return out


def _line_hops(counters: dict, prefix: str) -> dict:
    """A mesh line's collectives per kind — the pipeline's (``pp_send``,
    ``pp_recv``, ``pp_bcast``, ``pp_allreduce``), the seq line's
    (``sp_ring``, ``sp_a2a``, ``sp_gather``), the expert line's
    (``ep_allreduce``) or the model line's (``tp_allreduce``), the kinds
    named with ``prefix``; the
    ``comms.<kind>_calls``, ``comms.<kind>_bytes`` and
    ``comms.<kind>_window_seconds`` counters a ``fit`` emits — per rank:
    calls, bytes and window ms per step. Empty without them."""
    out: dict = {}
    for name, per_rank in counters.items():
        for suffix, key, scale in (("_calls", "calls_per_step", 1.0),
                                   ("_bytes", "bytes_per_step", 1.0),
                                   ("_window_seconds", "window_ms_per_step", 1e3)):
            kind = name[len("comms."):-len(suffix)]
            if not (name.endswith(suffix) and kind.startswith(prefix)):
                continue
            for rank, entry in per_rank.items():
                per_step = entry["total"] / entry["steps"] if entry["steps"] else None
                out.setdefault(kind, {}).setdefault(rank, {})[key] = (
                    None if per_step is None else round(scale * per_step, 3))
    return out


#: Stall fraction above which a run is called input-bound: more than this
#: share of (step + data-wait) time spent waiting on the input pipeline.
INPUT_BOUND_THRESHOLD = 0.1


def ingest_report(events: list[dict], table: dict | None = None) -> dict:
    """Input-pipeline rollup for the gang report, from the ``data.*``
    event family the ingest subsystem emits:

    - ``phases``: the ``data.*`` rows of the phase table (read/pack/h2d
      stage durations plus ``data.wait``, the consumer's time blocked on
      the host prefetch buffer);
    - ``buffer_occupancy``: per-rank stats over the
      ``data.buffer_occupancy`` gauge (sampled at every producer put —
      a buffer pinned at 0 means the producer can't keep up, pinned at
      capacity means the device is the bottleneck);
    - ``counters``: per-rank totals of the ``data.*`` counter events
      (records/batches per epoch, H2D bytes);
    - ``stall_fraction`` / ``verdict``: the input-bound vs compute-bound
      classification — stall time (``data.wait``, or ``data.read`` for an
      unbuffered pipeline, which then blocks the step loop directly) as a
      fraction of stall + ``train.step`` time, input-bound above
      ``INPUT_BOUND_THRESHOLD``.

    Empty sub-dicts when the run had no ingest activity — the renderer
    then omits the section.
    """
    table = phase_table(events) if table is None else table
    occupancy: dict[int | None, list[float]] = {}
    counters: dict[str, dict] = {}
    for ev in events:
        name = str(ev.get("name", ""))
        if not name.startswith("data."):
            continue
        if ev.get("kind") == "gauge" and name == "data.buffer_occupancy":
            occupancy.setdefault(ev.get("rank"), []).append(
                float(ev.get("value") or 0.0)
            )
        elif ev.get("kind") == "counter":
            per_rank = counters.setdefault(name, {})
            entry = per_rank.setdefault(ev.get("rank"), {"total": 0.0})
            entry["total"] += float(ev.get("value") or 0.0)
    phases = {
        phase: entry
        for phase, entry in table.items()
        if phase.startswith("data.")
    }

    def _total(phase: str) -> float:
        entry = table.get(phase)
        if not entry:
            return 0.0
        return entry["overall"]["mean"] * entry["overall"]["count"]

    stall = _total("data.wait") or _total("data.read")
    step = _total("train.step") + _total("train.step_group")
    stall_fraction = (
        round(stall / (stall + step), 4) if (stall + step) > 0 else None
    )
    verdict = None
    if stall_fraction is not None and step > 0:
        verdict = (
            "input-bound"
            if stall_fraction > INPUT_BOUND_THRESHOLD
            else "compute-bound"
        )
    return {
        "phases": phases,
        "buffer_occupancy": {
            rank: _stats(vals)
            for rank, vals in sorted(
                occupancy.items(), key=lambda kv: (kv[0] is None, kv[0])
            )
        },
        "counters": {
            name: dict(sorted(
                per_rank.items(), key=lambda kv: (kv[0] is None, kv[0])
            ))
            for name, per_rank in sorted(counters.items())
        },
        "stall_fraction": stall_fraction,
        "verdict": verdict,
    }


def serving_report(events: list[dict], table: dict | None = None) -> dict:
    """Serving rollup for the gang report, from the ``serving.*`` event
    family the engine emits:

    - ``phases``: the ``serving.*`` rows of the phase table (submit and
      batch/launch span durations);
    - ``batches_by_mode``: span counts and mean duration split by the
      ``mode`` attr ("padded" vs "paged") — a mixed-mode gang shows both;
    - ``counters``: per-rank totals of ``serving.*`` counter events
      (today: ``tokens_real``/``tokens_padded``, the padding-waste pair
      ``ServingMetrics.on_token_slots`` mirrors into the event stream);
    - ``padding_waste``: computed-slot waste across every rank, the
      fraction of slots the compiled programs spent on padding;
    - ``quarantines`` / ``rejects`` / ``expired``: containment and
      admission annotations, summed.

    Empty sub-dicts when the run served nothing — the renderer then
    omits the section.
    """
    table = phase_table(events) if table is None else table
    counters: dict[str, dict] = {}
    by_mode: dict[str, dict] = {}
    quarantines = rejects = expired = 0
    for ev in events:
        name = str(ev.get("name", ""))
        if not name.startswith("serving."):
            continue
        kind = ev.get("kind")
        attrs = ev.get("attrs") or {}
        if kind == "counter":
            per_rank = counters.setdefault(name, {})
            entry = per_rank.setdefault(ev.get("rank"), {"total": 0.0})
            entry["total"] += float(ev.get("value") or 0.0)
        elif kind == "span_end" and name == "serving.batch":
            mode = str(attrs.get("mode") or "padded")
            entry = by_mode.setdefault(mode, {"count": 0, "total_s": 0.0})
            entry["count"] += 1
            entry["total_s"] += float(ev.get("value") or 0.0)
        elif kind == "annotation":
            if name == "serving.quarantine":
                quarantines += 1
            elif name == "serving.queue.reject":
                rejects += 1
            elif name == "serving.queue.expire":
                expired += int(attrs.get("count") or 0)
    for entry in by_mode.values():
        entry["mean_s"] = (
            round(entry["total_s"] / entry["count"], 6)
            if entry["count"] else None
        )
        entry["total_s"] = round(entry["total_s"], 6)

    def _sum(name: str) -> float:
        return sum(
            e["total"] for e in counters.get(name, {}).values()
        )

    real, padded = _sum("serving.tokens_real"), _sum("serving.tokens_padded")
    return {
        "phases": {
            phase: entry
            for phase, entry in table.items()
            if phase.startswith("serving.")
        },
        "batches_by_mode": dict(sorted(by_mode.items())),
        "counters": {
            name: dict(sorted(
                per_rank.items(), key=lambda kv: (kv[0] is None, kv[0])
            ))
            for name, per_rank in sorted(counters.items())
        },
        "padding_waste": round(1.0 - real / padded, 4) if padded else None,
        "quarantines": quarantines,
        "rejects": rejects,
        "expired": expired,
    }


#: How many slowest requests the gang-level request report lists.
REQUEST_REPORT_SLOWEST = 8


def request_report(events: list[dict]) -> dict:
    """Per-request latency breakdown across the gang, from the
    ``serving.request`` annotations ``ServingMetrics.on_trace`` emits
    (one per retired request, attrs = the trace's breakdown dict):

    - ``breakdown``: stats over each latency component — queue_wait
      (submit → admit), ttft (submit → first token), service (admit →
      retire), total (submit → retire);
    - ``by_prefill``: request counts split by prefill kind ("hit" for
      prefix-cache attach, "miss"/"padded" for computed prefill);
    - ``slowest``: the ``REQUEST_REPORT_SLOWEST`` worst requests by total
      latency, with rank and trace id — the exemplars to chase.

    Empty dicts when no requests retired — the renderer omits the section.
    """
    fields = ("queue_wait_s", "ttft_s", "service_s", "total_s")
    samples: dict[str, list[float]] = {f: [] for f in fields}
    by_prefill: dict[str, int] = {}
    rows: list[dict] = []
    for ev in events:
        if ev.get("kind") != "annotation" or ev.get("name") != "serving.request":
            continue
        attrs = ev.get("attrs") or {}
        for f in fields:
            v = attrs.get(f)
            if v is not None:
                samples[f].append(float(v))
        kind = attrs.get("prefill")
        if kind is not None:
            by_prefill[str(kind)] = by_prefill.get(str(kind), 0) + 1
        rows.append({
            "rank": ev.get("rank"),
            "trace_id": attrs.get("trace_id"),
            "total_s": attrs.get("total_s"),
            "queue_wait_s": attrs.get("queue_wait_s"),
            "ttft_s": attrs.get("ttft_s"),
            "launches": attrs.get("launches"),
            "prefill": kind,
        })
    rows.sort(key=lambda r: r.get("total_s") or 0.0, reverse=True)
    return {
        "breakdown": {
            f: _stats(vals) for f, vals in samples.items() if vals
        },
        "by_prefill": dict(sorted(by_prefill.items())),
        "slowest": rows[:REQUEST_REPORT_SLOWEST],
    }


def fleet_report(events: list[dict]) -> dict:
    """Router-side rollup from the ``fleet.request`` annotations
    ``FleetRouter.submit`` emits (one per routed request, attrs =
    outcome / replica / tier / tenant / retries / total_s / status):

    - ``by_outcome`` / ``by_tier`` / ``by_tenant``: request counts —
      the admission and drain story in numbers;
    - ``per_replica``: how many requests each replica actually served,
      with end-to-end latency stats — the routing-skew evidence;
    - ``retries``: total re-dispatches (refused/backpressured replicas
      the router routed around);
    - ``latency``: end-to-end (admission → response) stats across all
      completed requests.

    Empty dict when no ``fleet.request`` annotations exist — the
    renderer then omits the section.
    """
    outcomes: dict[str, int] = {}
    tiers: dict[str, int] = {}
    tenants: dict[str, int] = {}
    per_replica: dict[int, dict] = {}
    totals: list[float] = []
    retries = 0
    n = 0
    for ev in events:
        if ev.get("kind") != "annotation" or ev.get("name") != "fleet.request":
            continue
        attrs = ev.get("attrs") or {}
        n += 1
        outcome = str(attrs.get("outcome"))
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        tier = attrs.get("tier")
        if tier is not None:
            tiers[str(tier)] = tiers.get(str(tier), 0) + 1
        tenant = attrs.get("tenant")
        if tenant is not None:
            tenants[str(tenant)] = tenants.get(str(tenant), 0) + 1
        retries += int(attrs.get("retries") or 0)
        total_s = attrs.get("total_s")
        if total_s is not None:
            totals.append(float(total_s))
        replica = attrs.get("replica")
        if replica is not None:
            entry = per_replica.setdefault(
                int(replica), {"requests": 0, "_totals": []}
            )
            entry["requests"] += 1
            if total_s is not None:
                entry["_totals"].append(float(total_s))
    if not n:
        return {}
    return {
        "requests": n,
        "by_outcome": dict(sorted(outcomes.items())),
        "by_tier": dict(sorted(tiers.items())),
        "by_tenant": dict(sorted(tenants.items())),
        "retries": retries,
        "latency": _stats(totals) if totals else None,
        "per_replica": {
            rank: {
                "requests": entry["requests"],
                "latency": _stats(entry["_totals"])
                if entry["_totals"] else None,
            }
            for rank, entry in sorted(per_replica.items())
        },
    }


def replica_skew(rows: list[dict]) -> dict:
    """Fleet-level load-skew verdict from scrape-plane status rows (the
    ``ScrapeLoop.rows()`` / ``tools/gang_status.py`` shape): which
    replica ran hottest/coldest by tokens/sec and how lopsided the split
    was. ``hottest_share`` is the hottest replica's fraction of fleet
    throughput — 1/N is a perfectly balanced fleet. Empty dict below two
    replicas with throughput numbers (skew needs a comparison)."""
    usable = [
        r for r in rows
        if isinstance(r.get("tokens_per_sec"), (int, float))
    ]
    if len(usable) < 2:
        return {}
    hottest = max(usable, key=lambda r: r["tokens_per_sec"])
    coldest = min(usable, key=lambda r: r["tokens_per_sec"])
    fleet_tps = sum(r["tokens_per_sec"] for r in usable)
    cold_tps = coldest["tokens_per_sec"]
    return {
        "replicas": {
            r["rank"]: {
                "tokens_per_sec": r.get("tokens_per_sec"),
                "in_flight": r.get("in_flight"),
                "queue_depth": r.get("queue_depth"),
                "occupancy": r.get("occupancy"),
                "prefix_hit_rate": r.get("prefix_hit_rate"),
            }
            for r in sorted(usable, key=lambda r: r["rank"])
        },
        "hottest_rank": hottest["rank"],
        "coldest_rank": coldest["rank"],
        "skew_ratio": round(hottest["tokens_per_sec"] / cold_tps, 4)
        if cold_tps > 0 else None,
        "hottest_share": round(hottest["tokens_per_sec"] / fleet_tps, 4)
        if fleet_tps > 0 else None,
        "fleet_tokens_per_sec": round(fleet_tps, 3),
    }


def merge_gang_dir(directory: str) -> dict:
    """One-call report over a gang workdir: find rank files, merge, build
    the phase table, skew report, and the comms/ingest/serving/fleet
    rollups."""
    paths = find_rank_files(directory)
    events = merge_rank_files(paths)
    table = phase_table(events)
    return {
        "artifact": "telemetry_report",
        "directory": os.path.abspath(directory),
        "ranks": sorted(paths),
        "event_count": len(events),
        "phases": table,
        "skew": skew_report(table),
        "comms": comms_report(events, table),
        "ingest": ingest_report(events, table),
        "serving": serving_report(events, table),
        "requests": request_report(events),
        "fleet": fleet_report(events),
    }


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v * 1e3:.3f}" if v < 10 else f"{v:.3f}"
    return str(v)


def render_markdown(report: dict) -> str:
    """Human-readable form of ``merge_gang_dir``'s output: a per-phase
    p50/p99 table (durations in ms) and the rank-skew table."""
    lines = ["# Telemetry report", ""]
    lines.append(f"- ranks: {report['ranks']}")
    lines.append(f"- events merged: {report['event_count']}")
    lines += ["", "## Per-phase durations (ms)", ""]
    lines.append("| phase | rank | count | mean | p50 | p99 | max |")
    lines.append("|---|---|---|---|---|---|---|")
    for phase, entry in report["phases"].items():
        o = entry["overall"]
        lines.append(
            f"| {phase} | all | {o['count']} | {_fmt(o['mean'])} "
            f"| {_fmt(o['p50'])} | {_fmt(o['p99'])} | {_fmt(o['max'])} |"
        )
        for rank, s in entry["ranks"].items():
            lines.append(
                f"| {phase} | {rank} | {s['count']} | {_fmt(s['mean'])} "
                f"| {_fmt(s['p50'])} | {_fmt(s['p99'])} | {_fmt(s['max'])} |"
            )
    skew = report.get("skew") or {}
    lines += ["", "## Rank skew (straggler attribution)", ""]
    if skew:
        lines.append(
            "| phase | slowest rank | fastest rank | skew ratio | spread (ms) |"
        )
        lines.append("|---|---|---|---|---|")
        for phase, s in skew.items():
            ratio = s["skew_ratio"]
            lines.append(
                f"| {phase} | {s['slowest_rank']} | {s['fastest_rank']} "
                f"| {ratio if ratio is not None else '-'} "
                f"| {_fmt(s['spread'])} |"
            )
    else:
        lines.append("(no phase seen on more than one rank)")
    comms = report.get("comms") or {}
    if comms.get("counters") or comms.get("collectives"):
        lines += ["", "## Comms", ""]
        if comms.get("verdict"):
            lines.append(
                f"- verdict: **{comms['verdict']}** "
                f"(exposed-comms fraction {comms['comms_fraction']})"
            )
            lines.append("")
        if comms.get("overlap"):
            ov = comms["overlap"]
            lines.append(
                f"- overlap: {ov['bytes_overlapped']} bytes hidden behind "
                f"compute, {ov['bytes_exposed']} exposed "
                f"(overlapped fraction {ov['overlapped_fraction']})"
            )
            lines.append("")
        if comms.get("counters"):
            lines.append("| counter | rank | total bytes | steps | bytes/step |")
            lines.append("|---|---|---|---|---|")
            for name, per_rank in comms["counters"].items():
                for rank, entry in per_rank.items():
                    per_step = entry.get("per_step")
                    lines.append(
                        f"| {name} | {rank} | {int(entry['total'])} "
                        f"| {entry['steps'] or '-'} "
                        f"| {per_step if per_step is not None else '-'} |"
                    )
        for section, title in (("pipeline", "pipeline hop"), ("sequence", "seq line")):
            if not comms.get(section):
                continue
            lines.append("")
            lines.append(f"| {title} | rank | bytes/step | window ms/step |")
            lines.append("|---|---|---|---|")
            for kind, per_rank in comms[section].items():
                for rank, entry in per_rank.items():
                    lines.append(
                        f"| {kind} | {rank} | {entry.get('bytes_per_step', '-')} "
                        f"| {entry.get('window_ms_per_step', '-')} |"
                    )
        for section, title in (("expert", "expert line"), ("model", "model line")):
            if not comms.get(section):
                continue
            lines.append("")
            lines.append(f"| {title} | rank | calls/step | bytes/step | window ms/step |")
            lines.append("|---|---|---|---|---|")
            for kind, per_rank in comms[section].items():
                for rank, entry in per_rank.items():
                    lines.append(
                        f"| {kind} | {rank} | {entry.get('calls_per_step', '-')} "
                        f"| {entry.get('bytes_per_step', '-')} "
                        f"| {entry.get('window_ms_per_step', '-')} |"
                    )
        if comms.get("collectives"):
            lines.append("")
            lines.append("| collective | rank | count | mean | p50 | p99 |")
            lines.append("|---|---|---|---|---|---|")
            for phase, entry in comms["collectives"].items():
                o = entry["overall"]
                lines.append(
                    f"| {phase} | all | {o['count']} | {_fmt(o['mean'])} "
                    f"| {_fmt(o['p50'])} | {_fmt(o['p99'])} |"
                )
                for rank, s in entry["ranks"].items():
                    lines.append(
                        f"| {phase} | {rank} | {s['count']} | {_fmt(s['mean'])} "
                        f"| {_fmt(s['p50'])} | {_fmt(s['p99'])} |"
                    )
    ingest = report.get("ingest") or {}
    if (
        ingest.get("phases")
        or ingest.get("buffer_occupancy")
        or ingest.get("counters")
    ):
        lines += ["", "## Ingest (data.*)", ""]
        if ingest.get("verdict"):
            lines.append(
                f"- verdict: **{ingest['verdict']}** "
                f"(stall fraction {ingest['stall_fraction']})"
            )
            lines.append("")
        if ingest.get("phases"):
            lines.append("| stage | rank | count | mean | p50 | p99 | max |")
            lines.append("|---|---|---|---|---|---|---|")
            for phase, entry in ingest["phases"].items():
                o = entry["overall"]
                lines.append(
                    f"| {phase} | all | {o['count']} | {_fmt(o['mean'])} "
                    f"| {_fmt(o['p50'])} | {_fmt(o['p99'])} | {_fmt(o['max'])} |"
                )
                for rank, s in entry["ranks"].items():
                    lines.append(
                        f"| {phase} | {rank} | {s['count']} | {_fmt(s['mean'])} "
                        f"| {_fmt(s['p50'])} | {_fmt(s['p99'])} | {_fmt(s['max'])} |"
                    )
        if ingest.get("buffer_occupancy"):
            lines.append("")
            lines.append(
                "| buffer occupancy | rank | samples | mean | p50 | p99 | max |"
            )
            lines.append("|---|---|---|---|---|---|---|")
            for rank, s in ingest["buffer_occupancy"].items():
                # Occupancies are batch counts, not durations — render raw.
                lines.append(
                    f"| data.buffer_occupancy | {rank} | {s['count']} "
                    f"| {s['mean']:.2f} | {s['p50']:g} | {s['p99']:g} "
                    f"| {s['max']:g} |"
                )
        if ingest.get("counters"):
            lines.append("")
            lines.append("| counter | rank | total |")
            lines.append("|---|---|---|")
            for name, per_rank in ingest["counters"].items():
                for rank, entry in per_rank.items():
                    lines.append(
                        f"| {name} | {rank} | {int(entry['total'])} |"
                    )
    serving = report.get("serving") or {}
    if serving.get("batches_by_mode") or serving.get("counters"):
        lines += ["", "## Serving", ""]
        if serving.get("padding_waste") is not None:
            lines.append(
                f"- padding waste: **{serving['padding_waste']}** of "
                "computed token slots"
            )
        for key in ("quarantines", "rejects", "expired"):
            if serving.get(key):
                lines.append(f"- {key}: {serving[key]}")
        if serving.get("batches_by_mode"):
            lines.append("")
            lines.append("| kv mode | dispatches | mean (ms) | total (s) |")
            lines.append("|---|---|---|---|")
            for mode, entry in serving["batches_by_mode"].items():
                lines.append(
                    f"| {mode} | {entry['count']} "
                    f"| {_fmt(entry['mean_s'])} | {entry['total_s']:.3f} |"
                )
        if serving.get("counters"):
            lines.append("")
            lines.append("| counter | rank | total |")
            lines.append("|---|---|---|")
            for name, per_rank in serving["counters"].items():
                for rank, entry in per_rank.items():
                    lines.append(
                        f"| {name} | {rank} | {int(entry['total'])} |"
                    )
    requests = report.get("requests") or {}
    if requests.get("breakdown"):
        lines += ["", "## Request latency breakdown (ms)", ""]
        if requests.get("by_prefill"):
            parts = ", ".join(
                f"{k}: {v}" for k, v in requests["by_prefill"].items()
            )
            lines.append(f"- prefill kinds: {parts}")
            lines.append("")
        lines.append("| component | count | mean | p50 | p99 | max |")
        lines.append("|---|---|---|---|---|---|")
        for field, s in requests["breakdown"].items():
            lines.append(
                f"| {field} | {s['count']} | {_fmt(s['mean'])} "
                f"| {_fmt(s['p50'])} | {_fmt(s['p99'])} | {_fmt(s['max'])} |"
            )
        if requests.get("slowest"):
            lines.append("")
            lines.append(
                "| slowest | rank | total | queue wait | ttft | launches "
                "| prefill |"
            )
            lines.append("|---|---|---|---|---|---|---|")
            for r in requests["slowest"]:
                lines.append(
                    f"| {r.get('trace_id') or '-'} | {r.get('rank')} "
                    f"| {_fmt(r.get('total_s'))} "
                    f"| {_fmt(r.get('queue_wait_s'))} "
                    f"| {_fmt(r.get('ttft_s'))} "
                    f"| {r.get('launches') if r.get('launches') is not None else '-'} "
                    f"| {r.get('prefill') or '-'} |"
                )
    fleet = report.get("fleet") or {}
    if fleet.get("requests"):
        lines += ["", "## Fleet (routed requests)", ""]
        parts = ", ".join(
            f"{k}: {v}" for k, v in fleet["by_outcome"].items()
        )
        lines.append(
            f"- routed: {fleet['requests']} requests "
            f"({parts}; {fleet['retries']} retries)"
        )
        if fleet.get("by_tier"):
            tiers = ", ".join(
                f"{k}: {v}" for k, v in fleet["by_tier"].items()
            )
            lines.append(f"- tiers: {tiers}")
        if fleet.get("per_replica"):
            lines.append("")
            lines.append("| replica | requests | mean (ms) | p50 | p99 |")
            lines.append("|---|---|---|---|---|")
            for rank, entry in fleet["per_replica"].items():
                s = entry.get("latency") or {}
                lines.append(
                    f"| {rank} | {entry['requests']} "
                    f"| {_fmt(s.get('mean'))} | {_fmt(s.get('p50'))} "
                    f"| {_fmt(s.get('p99'))} |"
                )
    return "\n".join(lines) + "\n"


def render_status_markdown(rows: list[dict]) -> str:
    """Live gang-status table for ``tools/gang_status.py``: one row per
    rank, from scraped /healthz + /statusz payloads (plus heartbeat
    sidecar enrichment). Each row dict may carry: rank, status, phase,
    step, heartbeat_age_s, queue_depth, tokens_per_sec, in_flight,
    occupancy, port."""
    lines = ["# Gang status", ""]
    lines.append(
        "| rank | status | phase | step | beat age (s) | queue "
        "| in flight | tok/s | kv occ | port |"
    )
    lines.append("|---|---|---|---|---|---|---|---|---|---|")

    def cell(v):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.3f}" if v < 100 else f"{v:.1f}"
        return str(v)

    for r in sorted(rows, key=lambda r: (r.get("rank") is None, r.get("rank"))):
        lines.append(
            f"| {cell(r.get('rank'))} | {cell(r.get('status'))} "
            f"| {cell(r.get('phase'))} | {cell(r.get('step'))} "
            f"| {cell(r.get('heartbeat_age_s'))} "
            f"| {cell(r.get('queue_depth'))} | {cell(r.get('in_flight'))} "
            f"| {cell(r.get('tokens_per_sec'))} | {cell(r.get('occupancy'))} "
            f"| {cell(r.get('port'))} |"
        )
    steps = [r.get("step") for r in rows if isinstance(r.get("step"), (int, float))]
    if len(steps) > 1:
        lines.append("")
        lines.append(f"- step skew (max - min): {max(steps) - min(steps):g}")
    return "\n".join(lines) + "\n"


__all__ = [
    "COMMS_BOUND_THRESHOLD",
    "INPUT_BOUND_THRESHOLD",
    "REQUEST_REPORT_SLOWEST",
    "comms_report",
    "find_rank_files",
    "fleet_report",
    "ingest_report",
    "load_jsonl",
    "merge_gang_dir",
    "merge_rank_files",
    "phase_table",
    "rank_file_name",
    "render_markdown",
    "render_status_markdown",
    "replica_skew",
    "request_report",
    "serving_report",
    "skew_report",
    "write_rank_file",
]
