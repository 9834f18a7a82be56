"""Distributed trace stitching: per-rank event exports → request trees;
the port of ``machine_learning_apache_spark_tpu/telemetry/traceview.py``
(the same functions over the same event dicts, so either package stitches
the other's exports).

The tracing substrate leaves one breadcrumb trail per process: the
router's ``telemetry_rank<k>.jsonl`` (or a flight dump) holds
``fleet.submit``/``fleet.attempt`` spans, each replica's export holds its
``fleet.replica``/``serving.*`` spans, and every event carries the
128-bit ``trace`` id that ``tracectx`` stamped. This module is the read
side: merge those files, group by trace id, pair span_start/span_end
records, and rebuild each request's cross-process tree.

Two kinds of parent edge exist and both are honored:

- **in-process** — a span's ``parent`` field is the span id of the
  enclosing span on the same thread stack (same ``pid``);
- **cross-process** — the router's ``fleet.attempt`` span records the
  child span id it sent in the ``traceparent`` header as a ``ctx_span``
  attr, and the replica's ``fleet.replica`` span records the same id as
  ``remote_parent``. Matching the two joins the processes — and is the
  edge the Perfetto export draws a flow arrow over.

A trace is **complete** when it stitches into exactly one rooted tree
with no orphans (a span whose parent id cannot be resolved anywhere).
``completeness`` over a run's traces is the ``trace_complete`` gate the
serving bench pins.

Everything here is pure functions over plain dicts, stdlib-only (the
router process reads this without the framework imported).
"""

from __future__ import annotations

import glob
import json
import os

from machine_learning_apache_spark_tpu_torch.telemetry import aggregate as _agg

#: Span attr names forming the cross-process edge (see module docstring).
CTX_SPAN_ATTR = "ctx_span"
REMOTE_PARENT_ATTR = "remote_parent"


# -- loading -------------------------------------------------------------------

def load_dir(directory: str) -> list[dict]:
    """Every event in a run directory: rank JSONL exports merged (rank
    stamped from the file name) plus any ``flight_*.json`` dumps, since a
    crashed process's only export is its flight recording. Events seen in
    both (the flight dump is a tail of the same log) are deduplicated on
    ``(pid, kind, name, ts, span)``."""
    events = _agg.merge_rank_files(_agg.find_rank_files(directory))
    seen = {
        (e.get("pid"), e.get("kind"), e.get("name"), e.get("ts"),
         e.get("span"))
        for e in events
    }
    for path in sorted(glob.glob(os.path.join(directory, "flight_*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue  # torn write — a flight dump is best-effort anyway
        rank = payload.get("rank")
        for ev in payload.get("events") or []:
            key = (ev.get("pid"), ev.get("kind"), ev.get("name"),
                   ev.get("ts"), ev.get("span"))
            if key in seen:
                continue
            seen.add(key)
            ev = dict(ev)
            if ev.get("rank") is None:
                ev["rank"] = rank
            events.append(ev)
    return events


# -- stitching -----------------------------------------------------------------

def _span_nodes(events: list[dict]) -> dict[tuple, dict]:
    """Pair span_start/span_end by ``(pid, span id)`` into node dicts.
    A span_end alone is enough (it carries parent, duration, and attrs);
    a span_start alone is a still-open span (dur_s None)."""
    nodes: dict[tuple, dict] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind not in ("span_start", "span_end") or ev.get("span") is None:
            continue
        key = (ev.get("pid"), ev["span"])
        node = nodes.get(key)
        if node is None:
            node = nodes[key] = {
                "name": ev.get("name"),
                "span": ev["span"],
                "parent": ev.get("parent"),
                "pid": ev.get("pid"),
                "rank": ev.get("rank"),
                "trace": ev.get("trace"),
                "start_wall": None,
                "dur_s": None,
                "attrs": dict(ev.get("attrs") or {}),
                "children": [],
            }
        if kind == "span_start":
            node["start_wall"] = ev.get("wall")
        else:
            node["dur_s"] = ev.get("value")
            node["attrs"].update(ev.get("attrs") or {})
            if node["start_wall"] is None and ev.get("wall") is not None:
                # Flight tails can miss the start record; back-derive.
                node["start_wall"] = ev["wall"] - (ev.get("value") or 0.0)
        if ev.get("trace") and not node.get("trace"):
            node["trace"] = ev["trace"]
    return nodes


def assemble(events: list[dict]) -> dict[str, dict]:
    """``{trace_id: tree}`` over every traced span in ``events``. Each
    tree is ``{"trace_id", "roots": [node...], "orphans": [node...],
    "annotations": [event...], "span_count"}`` with nodes nested under
    ``children`` (in-process and resolved cross-process edges alike;
    remote children carry ``via: "remote"``)."""
    nodes = _span_nodes(events)
    by_trace: dict[str, list[dict]] = {}
    for node in nodes.values():
        if node.get("trace"):
            by_trace.setdefault(node["trace"], []).append(node)
    annotations: dict[str, list[dict]] = {}
    for ev in events:
        if ev.get("kind") == "annotation" and ev.get("trace"):
            annotations.setdefault(ev["trace"], []).append(ev)

    out: dict[str, dict] = {}
    for trace_id, tnodes in by_trace.items():
        by_key = {(n["pid"], n["span"]): n for n in tnodes}
        by_ctx_span = {
            n["attrs"][CTX_SPAN_ATTR]: n
            for n in tnodes
            if n["attrs"].get(CTX_SPAN_ATTR) is not None
        }
        roots: list[dict] = []
        orphans: list[dict] = []
        for n in sorted(
            tnodes, key=lambda n: (n.get("start_wall") or 0.0, n["span"])
        ):
            remote = n["attrs"].get(REMOTE_PARENT_ATTR)
            if remote is not None:
                attempt = by_ctx_span.get(remote)
                if attempt is not None:
                    n["via"] = "remote"
                    attempt["children"].append(n)
                else:
                    orphans.append(n)
                continue
            if n["parent"] is None:
                roots.append(n)
            elif (n["pid"], n["parent"]) in by_key:
                by_key[(n["pid"], n["parent"])]["children"].append(n)
            else:
                orphans.append(n)
        out[trace_id] = {
            "trace_id": trace_id,
            "roots": roots,
            "orphans": orphans,
            "annotations": annotations.get(trace_id, []),
            "span_count": len(tnodes),
        }
    return out


def trace_summary(tree: dict) -> dict:
    """One row per trace for the ``--slowest`` table: root span name and
    duration, span/process counts, completeness verdict."""
    roots = tree["roots"]
    root = roots[0] if roots else None
    pids = set()

    def _walk(n):
        pids.add(n["pid"])
        for c in n["children"]:
            _walk(c)

    for n in roots:
        _walk(n)
    for n in tree["orphans"]:
        pids.add(n["pid"])
    return {
        "trace_id": tree["trace_id"],
        "root": None if root is None else root["name"],
        "total_s": None if root is None else root["dur_s"],
        "spans": tree["span_count"],
        "processes": len(pids),
        "roots": len(roots),
        "orphans": len(tree["orphans"]),
        "complete": len(roots) == 1 and not tree["orphans"],
    }


def completeness(trees: dict[str, dict]) -> dict:
    """The ``trace_complete`` gate metric: the fraction of traces that
    stitch into exactly one rooted tree with zero orphans."""
    total = len(trees)
    complete = sum(
        1 for t in trees.values() if trace_summary(t)["complete"]
    )
    return {
        "traces": total,
        "complete": complete,
        "fraction": round(complete / total, 6) if total else None,
    }


def slowest(trees: dict[str, dict], n: int = 10) -> list[dict]:
    """The ``n`` slowest traces by root duration (undated roots last)."""
    rows = [trace_summary(t) for t in trees.values()]
    rows.sort(
        key=lambda r: (r["total_s"] is None, -(r["total_s"] or 0.0))
    )
    return rows[:n]


# -- Perfetto / Chrome trace-event export --------------------------------------

def _proc_key(ev: dict) -> int:
    """Perfetto row id: gang rank when stamped (small, stable, sorted
    first), else the OS pid (router / driver processes)."""
    rank = ev.get("rank")
    return int(rank) if rank is not None else int(ev.get("pid") or 0)


def _proc_name(ev: dict) -> str:
    rank = ev.get("rank")
    if rank is not None:
        return f"rank {rank}"
    return f"driver pid={ev.get('pid')}"


def perfetto_export(
    events: list[dict], trace_id: str | None = None
) -> dict:
    """Chrome ``trace_event`` JSON over ``events`` — load the returned
    dict (serialized) in Perfetto / ``chrome://tracing``.

    One process row per gang rank (driver/router processes row by OS
    pid); spans become ``ph:"X"`` complete slices on wall-clock
    microseconds; traced annotations become instants; ``counter`` events
    become ``ph:"C"`` tracks; and every resolved router→replica edge
    (``ctx_span`` == ``remote_parent``) becomes an ``s``/``f`` flow
    arrow, which is what makes a fanned-out request legible as one
    object in the UI.

    With ``trace_id`` the export narrows to that request's events; by
    default **all** spans ride along, so train.step / comms.* timelines
    land on the same view as the serving traces.
    """
    if trace_id is not None:
        events = [e for e in events if e.get("trace") == trace_id]
    nodes = _span_nodes(events)
    out: list[dict] = []
    procs: dict[int, str] = {}

    def _note_proc(ev: dict) -> int:
        pid = _proc_key(ev)
        if pid not in procs:
            procs[pid] = _proc_name(ev)
        return pid

    def _tid(node_or_ev: dict) -> int:
        # One thread row per trace within a process: requests render as
        # parallel tracks instead of interleaving on one line. Untraced
        # spans (train.step, the batcher) share track 0.
        t = node_or_ev.get("trace")
        return (int(t[:8], 16) & 0x3FFFFFFF) if t else 0

    for node in nodes.values():
        if node["start_wall"] is None:
            continue
        pid = _note_proc(node)
        ev_out = {
            "ph": "X",
            "name": node["name"],
            "pid": pid,
            "tid": _tid(node),
            "ts": node["start_wall"] * 1e6,
            "dur": (node["dur_s"] or 0.0) * 1e6,
            "cat": (node["name"] or "span").split(".")[0],
            "args": {**node["attrs"], "span": node["span"],
                     **({"trace": node["trace"]} if node["trace"] else {})},
        }
        out.append(ev_out)

    # Flow arrows over resolved cross-process edges.
    by_ctx_span = {
        n["attrs"][CTX_SPAN_ATTR]: n
        for n in nodes.values()
        if n["attrs"].get(CTX_SPAN_ATTR) is not None
    }
    for node in nodes.values():
        remote = node["attrs"].get(REMOTE_PARENT_ATTR)
        src = by_ctx_span.get(remote) if remote is not None else None
        if src is None or src["start_wall"] is None \
                or node["start_wall"] is None:
            continue
        common = {"cat": "trace", "name": "dispatch", "id": str(remote)}
        out.append({
            **common, "ph": "s", "pid": _proc_key(src), "tid": _tid(src),
            "ts": src["start_wall"] * 1e6,
        })
        out.append({
            **common, "ph": "f", "bp": "e", "pid": _proc_key(node),
            "tid": _tid(node), "ts": node["start_wall"] * 1e6,
        })

    for ev in events:
        kind = ev.get("kind")
        if kind == "annotation" and (trace_id is None or ev.get("trace")):
            pid = _note_proc(ev)
            out.append({
                "ph": "i", "s": "p", "name": ev.get("name"), "pid": pid,
                "tid": _tid(ev), "ts": (ev.get("wall") or 0.0) * 1e6,
                "cat": "annotation",
                "args": dict(ev.get("attrs") or {}),
            })
        elif kind == "counter" and trace_id is None:
            pid = _note_proc(ev)
            out.append({
                "ph": "C", "name": ev.get("name"), "pid": pid, "tid": 0,
                "ts": (ev.get("wall") or 0.0) * 1e6,
                "args": {"value": ev.get("value") or 0.0},
            })

    meta = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": name}}
        for pid, name in sorted(procs.items())
    ]
    meta += [
        {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
         "args": {"sort_index": i}}
        for i, pid in enumerate(sorted(procs))
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# -- live /tracez payload ------------------------------------------------------

def tracez_payload(events: list[dict], trace_id: str | None = None) -> dict:
    """The ``/tracez`` endpoint body: with ``trace_id``, that trace's
    full tree; without, a summary row per known trace (newest-rooted
    first is not guaranteed — callers sort client-side)."""
    trees = assemble(events)
    if trace_id is not None:
        tree = trees.get(trace_id)
        if tree is None:
            return {"artifact": "tracez", "trace_id": trace_id,
                    "error": "unknown trace id"}
        return {"artifact": "tracez", "trace_id": trace_id, **tree}
    return {
        "artifact": "tracez",
        "completeness": completeness(trees),
        "traces": [trace_summary(t) for t in trees.values()],
    }


__all__ = [
    "CTX_SPAN_ATTR",
    "REMOTE_PARENT_ATTR",
    "assemble",
    "completeness",
    "load_dir",
    "perfetto_export",
    "slowest",
    "trace_summary",
    "tracez_payload",
]
