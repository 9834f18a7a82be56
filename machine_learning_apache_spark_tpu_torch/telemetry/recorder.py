"""Flight recorder — dump the last ~512 events at the moment of failure;
the port of ``machine_learning_apache_spark_tpu/telemetry/recorder.py``.

A ``GangFailure`` says *which* rank died; the flight recorder says
*what it was doing*: the tail of the event log (recent spans, counters,
annotations) written to ``flight_<rank>.json`` the instant something
goes wrong. Dump sites:

- ``utils.faults.maybe_fault`` — BEFORE executing a crash/stall action
  (an ``os._exit`` process cannot dump afterwards);
- ``train.loop.fit`` — unhandled exception out of the training loop;
- ``serving.engine._quarantine`` / ``_paged_quarantine`` — a poisoned
  batch or launch;
- ``launcher.runner`` — worker exception / SIGTERM from gang teardown;
- ``launcher.monitor.GangMonitor`` — driver-side, on gang failure
  (``flight_driver.json``).

Dumps go to ``MLSPARK_TELEMETRY_DIR`` (the Distributor points it at the
gang workdir, next to the heartbeat files, unless the caller set it);
with no directory configured the dump is skipped. ``dump_flight`` must
never raise — it runs on paths that are already failing.
"""

from __future__ import annotations

import json
import os
import time

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events

#: How many trailing events a flight dump carries.
FLIGHT_CAPACITY = 512


def _flight_name() -> str:
    rank = _events._env_rank()
    return f"flight_{'driver' if rank is None else rank}.json"


def flight_path(directory: str | None = None) -> str | None:
    """Where this process's flight dump would land, or None if nowhere."""
    d = directory or _events.telemetry_dir()
    return os.path.join(d, _flight_name()) if d else None


def dump_flight(
    reason: str,
    directory: str | None = None,
    extra: dict | None = None,
    capacity: int = FLIGHT_CAPACITY,
) -> str | None:
    """Write the event-log tail to ``flight_<rank>.json``; returns the path
    (None if disabled / no directory). Swallows all errors — this runs on
    failure paths and must not mask the original exception."""
    try:
        if not _events.enabled():
            return None
        path = flight_path(directory)
        if path is None:
            return None
        log = _events.get_log()
        events = [ev.to_dict() for ev in log.tail(capacity)]
        payload = {
            "artifact": "flight",
            "reason": reason,
            "rank": _events._env_rank(),
            "pid": os.getpid(),
            "wall": round(time.time(), 6),
            "dropped": log.dropped,
            "event_count": len(events),
            "events": events,
        }
        if extra:
            payload["extra"] = extra
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def load_flight(path: str) -> dict:
    """Read a flight dump back (report tooling / tests)."""
    with open(path) as f:
        return json.load(f)


__all__ = ["FLIGHT_CAPACITY", "dump_flight", "flight_path", "load_flight"]
