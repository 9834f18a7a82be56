"""Deterministic fault injection — the chaos the robustness layer is tested by.

Fault tolerance that has never seen a fault is a comment, not a feature.
This module gives every crash-containment path in the repo (gang
restart, checkpoint resume, serving quarantine, heartbeat detection) a
deterministic trigger: a *plan* of faults, each pinned to an exact site
and coordinate ("crash rank 1 at train step 5", "raise in decode batch
2", "stall rank 0's heartbeats at step 3"), installed either
programmatically (tests) or through the environment (spawned gang
workers, the fault drill).

Grammar (``MLSPARK_FAULTS``, semicolon-separated)::

    action@site:key=value,key=value;action@site:...

    crash@train_step:rank=1,step=5     # os._exit(23) — a hard kill
    raise@decode_batch:batch=2         # raise FaultInjected in the engine
    stall@train_step:rank=0,step=3     # suspend heartbeats + hang

Sites are the instrumented ``maybe_fault(site, ...)`` call points:
``train_step`` (train.loop, per optimizer step) and ``decode_batch``
(serving.engine, per formed batch). ``rank`` matches
``MLSPARK_PROCESS_ID`` (absent -> matches any process); ``world``
matches ``MLSPARK_NUM_PROCESSES`` — the elastic-drill lever: a plan
like ``crash@train_step:world=8,rank=7,...;crash@train_step:world=7,
rank=6,...`` kills one rank per world size, so each shrunken gang
meets exactly its own fault and the drill walks 8 -> 7 -> 6
deterministically.

**Wire faults.** A second action family targets one HTTP exchange on
the fleet data plane instead of a process::

    delay@wire:rank=1,ms=500          # hold the exchange 500ms (straggler)
    blackhole@wire:rank=0,req=3       # swallow the request, never respond
    torn@wire:rank=0,req=2            # full Content-Length, half a body
    corrupt@wire:rank=1,req=5         # right length, unparseable JSON
    drip@wire:rank=0,req=1,ms=2000    # trickle the body out over 2s

Wire specs live only at the ``wire`` site and are *queried* (via
:func:`wire_fault`) by ``ReplicaServer``'s request handler, which
implements the behavior itself — ``maybe_fault`` never executes them.
Coordinates are deterministic: ``rank`` is the replica's rank, ``req``
the zero-based ordinal of the exchange on that server (absent = every
exchange). ``ms`` is the action's magnitude (delay/drip duration).
``sticky=1`` exempts a spec from one-shot semantics — the persistent
slow replica a straggler-hedging drill needs; the marker file still
records the first firing as proof.

**One-shot semantics.** A fault fires once. In-process that's a set of
fired keys; across process restarts (the gang-retry case — the retried
worker re-executes the same step numbers) it's a marker file under
``MLSPARK_FAULTS_DIR``, written *before* the action so even an
``os._exit`` can't re-arm itself. Without a marker dir, ``crash``/
``stall`` faults would re-fire on every gang attempt and no retry could
ever succeed — ``FaultPlan.from_env`` therefore logs a warning when a
crash/stall plan has no marker dir.

The hot-path cost when no plan is installed is one global ``is None``
check in ``maybe_fault``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time


def _log():
    # Lazy: this module must stay stdlib-importable — the runner's
    # heartbeat thread polls heartbeats_suspended() before the worker's
    # heavy imports (torch) are done.
    from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

    return get_logger(__name__)


ENV_PLAN = "MLSPARK_FAULTS"
ENV_MARKER_DIR = "MLSPARK_FAULTS_DIR"

_ACTIONS = ("crash", "raise", "stall")
WIRE_ACTIONS = ("delay", "blackhole", "torn", "corrupt", "drip")
WIRE_SITE = "wire"


class FaultInjected(RuntimeError):
    """An injected failure (the ``raise`` action) — never raised by real
    code paths, so tests can assert provenance."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``action`` at ``site`` when every given
    coordinate matches (``None`` = wildcard)."""

    action: str
    site: str
    rank: int | None = None
    step: int | None = None
    batch: int | None = None
    world: int | None = None
    req: int | None = None
    ms: int = 0
    sticky: int = 0
    exit_code: int = 23

    @property
    def key(self) -> str:
        """Stable marker-file name for one-shot bookkeeping."""
        return (
            f"{self.action}_{self.site}"
            f"_r{'any' if self.rank is None else self.rank}"
            f"_s{'any' if self.step is None else self.step}"
            f"_b{'any' if self.batch is None else self.batch}"
            + ("" if self.world is None else f"_w{self.world}")
            + ("" if self.req is None else f"_q{self.req}")
            + ("" if not self.ms else f"_m{self.ms}")
        )

    def matches(self, site: str, rank: int | None, step: int | None,
                batch: int | None, world: int | None = None,
                req: int | None = None) -> bool:
        if self.site != site:
            return False
        for want, got in (
            (self.rank, rank), (self.step, step), (self.batch, batch),
            (self.world, world), (self.req, req),
        ):
            if want is not None and want != got:
                return False
        return True


class FaultPlan:
    """An installed set of ``FaultSpec``s with one-shot bookkeeping."""

    def __init__(self, specs: list[FaultSpec], *, marker_dir: str | None = None):
        self.specs = list(specs)
        self.marker_dir = marker_dir
        self._fired: set[str] = set()
        self._lock = threading.Lock()

    # -- parsing -------------------------------------------------------------
    @classmethod
    def from_spec(cls, text: str, *, marker_dir: str | None = None) -> "FaultPlan":
        specs = []
        for entry in filter(None, (e.strip() for e in text.split(";"))):
            action, _, rest = entry.partition("@")
            if action not in _ACTIONS and action not in WIRE_ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r} in {entry!r} "
                    f"(expected one of {_ACTIONS + WIRE_ACTIONS})"
                )
            site, _, kvs = rest.partition(":")
            if not site:
                raise ValueError(f"fault entry {entry!r} has no site")
            if (action in WIRE_ACTIONS) != (site == WIRE_SITE):
                raise ValueError(
                    f"fault entry {entry!r}: wire actions {WIRE_ACTIONS} "
                    f"pair only with site {WIRE_SITE!r} and vice versa"
                )
            fields: dict = {"action": action, "site": site}
            for kv in filter(None, (p.strip() for p in kvs.split(","))):
                k, _, v = kv.partition("=")
                if k not in ("rank", "step", "batch", "world", "req", "ms",
                             "sticky", "exit_code"):
                    raise ValueError(f"unknown fault field {k!r} in {entry!r}")
                fields[k] = int(v)
            specs.append(FaultSpec(**fields))
        return cls(specs, marker_dir=marker_dir)

    @classmethod
    def from_env(cls, environ=os.environ) -> "FaultPlan | None":
        # Direct read by design: must stay importable before the package
        # __init__ (which imports torch) has run (see _log). Names ARE
        # registered; only the accessor differs.
        # mlspark-lint: ok env-direct-read -- pre-platform module, see above
        text = environ.get(ENV_PLAN)
        if not text:
            return None
        plan = cls.from_spec(
            text,
            marker_dir=environ.get(ENV_MARKER_DIR),  # mlspark-lint: ok env-direct-read -- pre-platform module, see from_env
        )
        if plan.marker_dir is None and any(
            s.action in ("crash", "stall") for s in plan.specs
        ):
            _log().warning(
                "%s has crash/stall faults but no %s marker dir: they will "
                "re-fire on every process restart (gang retries cannot "
                "succeed)", ENV_PLAN, ENV_MARKER_DIR,
            )
        return plan

    # -- one-shot bookkeeping ------------------------------------------------
    def _already_fired(self, spec: FaultSpec) -> bool:
        if spec.key in self._fired:
            return True
        return bool(
            self.marker_dir
            and os.path.exists(os.path.join(self.marker_dir, spec.key))
        )

    def _mark_fired(self, spec: FaultSpec) -> None:
        self._fired.add(spec.key)
        if self.marker_dir:
            # Marker lands BEFORE the action: an os._exit fault must not be
            # able to re-arm on the retried attempt. Atomic rename so a kill
            # mid-write can't leave a half-marker.
            os.makedirs(self.marker_dir, exist_ok=True)
            tmp = os.path.join(self.marker_dir, f".{spec.key}.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                f.write(str(time.time()))
            os.replace(tmp, os.path.join(self.marker_dir, spec.key))

    def pending(self, site: str, *, rank: int | None = None,
                step: int | None = None, batch: int | None = None,
                world: int | None = None,
                req: int | None = None) -> FaultSpec | None:
        """The first matching not-yet-fired spec, or None. Marks it fired.

        ``sticky`` specs are exempt from one-shot consumption: they match
        on every call, but the marker is still written once so a drill
        can prove the fault actually engaged."""
        with self._lock:
            for spec in self.specs:
                if not spec.matches(site, rank, step, batch, world, req):
                    continue
                fired = self._already_fired(spec)
                if fired and not spec.sticky:
                    continue
                if not fired:
                    self._mark_fired(spec)
                return spec
        return None


# -- process-global plan ------------------------------------------------------
_PLAN: FaultPlan | None = None
_PLAN_LOADED = False
_HEARTBEATS_SUSPENDED = threading.Event()


def install(plan: FaultPlan | None) -> None:
    """Install (or, with None, clear) the process-global plan — the test
    hook; spawned workers get theirs from the environment instead."""
    global _PLAN, _PLAN_LOADED
    _PLAN = plan
    _PLAN_LOADED = True
    if plan is None:
        _HEARTBEATS_SUSPENDED.clear()


def clear() -> None:
    install(None)
    global _PLAN_LOADED
    _PLAN_LOADED = False  # next maybe_fault re-reads the environment


def active_plan() -> FaultPlan | None:
    """The installed plan, lazily falling back to ``MLSPARK_FAULTS``."""
    global _PLAN, _PLAN_LOADED
    if not _PLAN_LOADED:
        _PLAN = FaultPlan.from_env()
        _PLAN_LOADED = True
    return _PLAN


def heartbeats_suspended() -> bool:
    """True once a ``stall`` fault fired — the runner's heartbeat thread
    polls this so a stalled worker goes silent exactly like a hung one."""
    return _HEARTBEATS_SUSPENDED.is_set()


def _env_rank() -> int | None:
    # mlspark-lint: ok env-direct-read -- pre-platform module, see from_env
    v = os.environ.get("MLSPARK_PROCESS_ID")
    return int(v) if v is not None else None


def _env_world() -> int | None:
    # mlspark-lint: ok env-direct-read -- pre-platform module, see from_env
    v = os.environ.get("MLSPARK_NUM_PROCESSES")
    return int(v) if v is not None else None


def maybe_fault(site: str, *, step: int | None = None,
                batch: int | None = None, rank: int | None = None,
                world: int | None = None) -> None:
    """Instrumentation point: fire the first pending fault matching this
    site/coordinate, else return immediately. ``rank`` defaults to this
    process's ``MLSPARK_PROCESS_ID``, ``world`` to
    ``MLSPARK_NUM_PROCESSES`` (how elastic drills pin a fault to one
    world size along the shrink path)."""
    if site == WIRE_SITE:
        raise ValueError(
            "wire faults are queried via wire_fault(), not executed by "
            "maybe_fault() — the HTTP handler owns the behavior"
        )
    plan = active_plan()
    if plan is None:
        return
    spec = plan.pending(
        site, rank=_env_rank() if rank is None else rank, step=step,
        batch=batch, world=_env_world() if world is None else world,
    )
    if spec is None:
        return
    _log().warning("fault injection firing: %s (site=%s step=%s batch=%s)",
                spec.key, site, step, batch)
    # Flight recorder BEFORE the action: an os._exit'd (or stalled) process
    # gets no later chance, so the dump must happen while we still run. The
    # failing step's span_start is already in the event log (instrumented
    # call sites open their span before maybe_fault). Lazy import + broad
    # swallow: this module must stay stdlib-importable and a recorder
    # problem must never mask the drill itself.
    try:
        from machine_learning_apache_spark_tpu_torch.telemetry import recorder

        recorder.dump_flight(
            f"fault:{spec.key}",
            extra={"site": site, "step": step, "batch": batch,
                   "action": spec.action},
        )
    except Exception:
        pass
    if spec.action == "raise":
        raise FaultInjected(f"injected fault {spec.key}")
    if spec.action == "crash":
        # os._exit: no atexit, no finally, no result file — the closest
        # in-process stand-in for SIGKILL/OOM/preemption.
        os._exit(spec.exit_code)
    if spec.action == "stall":
        # Go silent: heartbeats stop (the monitor's missed-heartbeat path
        # must notice), and this thread hangs until the gang teardown's
        # SIGTERM/SIGKILL reaps the process.
        _HEARTBEATS_SUSPENDED.set()
        while True:
            time.sleep(3600)


def wire_fault(*, rank: int | None = None,
               req: int | None = None) -> FaultSpec | None:
    """Query the plan for a wire fault matching this HTTP exchange.

    Unlike :func:`maybe_fault` this *returns* the matched spec instead of
    executing it — wire behaviors (delay / black-hole / torn / corrupt /
    drip) are implemented by the caller (``ReplicaServer``'s handler),
    which owns the socket. ``rank`` defaults to ``MLSPARK_PROCESS_ID``;
    ``req`` is the caller's per-server exchange ordinal. One-shot (or
    sticky) bookkeeping is consumed exactly as for process faults."""
    plan = active_plan()
    if plan is None:
        return None
    spec = plan.pending(
        WIRE_SITE, rank=_env_rank() if rank is None else rank, req=req,
    )
    if spec is None or spec.action not in WIRE_ACTIONS:
        # A crash/raise/stall spec can never parse with site "wire", so a
        # non-wire action here means a hand-built plan; refuse quietly.
        return None
    if spec.key not in getattr(wire_fault, "_logged", set()):
        wire_fault._logged = getattr(wire_fault, "_logged", set()) | {spec.key}
        _log().warning("wire fault engaging: %s (rank=%s req=%s)",
                       spec.key, rank, req)
    return spec


__all__ = [
    "ENV_MARKER_DIR",
    "ENV_PLAN",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "WIRE_ACTIONS",
    "WIRE_SITE",
    "active_plan",
    "clear",
    "heartbeats_suspended",
    "install",
    "maybe_fault",
    "wire_fault",
]
