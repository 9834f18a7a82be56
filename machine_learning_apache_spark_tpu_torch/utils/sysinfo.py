"""Host-level machine context for benchmark artifacts
(the port of ``machine_learning_apache_spark_tpu/utils/sysinfo.py``).

Every BENCH_*.json gate in this repo compares throughput numbers across
rounds, and the single biggest source of phantom regressions is the
machine itself: a bench run while a sibling job hogs the cores produces
a knee 20% low and a gate failure nothing in the code caused. The fix
is not to refuse to run — CI machines are shared by design — but to
**stamp the evidence**: every bench artifact carries the load average
observed at preflight and a ``contended`` verdict, so the first
question about a regression ("was the machine busy?") is answered by
the artifact instead of by archaeology.

stdlib-only; ``os.getloadavg`` is POSIX-only and absence degrades to
``None`` fields rather than a crash (the verdict is then ``False`` —
unknown is not evidence of contention).
"""

from __future__ import annotations

import os

#: 1-minute load above this fraction of the core count reads as "another
#: workload is competing for CPU". 0.5 is deliberately sensitive: a bench
#: should saturate its own cores from a quiet start, so even half-busy
#: at preflight means the numbers are suspect.
CONTENTION_LOAD_FRACTION = 0.5


def host_load() -> dict:
    """One preflight snapshot: load averages, core count, and the
    ``contended`` verdict (1-minute load > ``CONTENTION_LOAD_FRACTION``
    × cores). JSON-ready — benches embed it verbatim."""
    cores = os.cpu_count()
    try:
        load_1m, load_5m, load_15m = os.getloadavg()
    except (OSError, AttributeError):
        load_1m = load_5m = load_15m = None
    contended = bool(
        load_1m is not None
        and cores
        and load_1m > CONTENTION_LOAD_FRACTION * cores
    )
    return {
        "load_1m": None if load_1m is None else round(load_1m, 2),
        "load_5m": None if load_5m is None else round(load_5m, 2),
        "load_15m": None if load_15m is None else round(load_15m, 2),
        "cores": cores,
        "contended": contended,
    }


__all__ = ["CONTENTION_LOAD_FRACTION", "host_load"]
