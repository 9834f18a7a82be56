"""Replica-gang launch mode — N independent workers, per-rank restart
(the port of ``machine_learning_apache_spark_tpu/launcher/replica_gang.py``).

The ``Distributor`` implements Spark-barrier semantics on purpose: one
dead rank fails the gang, the gang retries whole. That is right for
training (a collective missing one participant deadlocks) and exactly
wrong for a serving fleet, where the whole point of running N replicas
is that losing one costs one replica's in-flight work and *nothing
else*. ``ReplicaGang`` is the launcher's second launch mode for that
shape:

- Each rank is a standalone ``launcher.runner`` subprocess (same entry
  point, same heartbeat/telemetry/platform plumbing) with **no
  rendezvous env** — ``initialize_from_env`` no-ops, so replicas never
  form a collective and one dying cannot wedge the rest.
- A supervisor thread watches exits and heartbeat staleness **per
  rank** and restarts only the dead rank, with exponential backoff and
  a per-rank restart budget. A restarted replica re-binds an ephemeral
  port and overwrites its sidecars; discovery (``fleet/scrape.py``)
  follows it there.
- ``kill_rank`` is the fault-drill hook: SIGKILL one replica's process
  group and let supervision prove the recovery story.

Process-group hygiene matches the Distributor: every worker is a
session leader, registered in the module-level stray-gang registry so
the atexit/conftest sweeps reap leftovers from a crashed driver.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any

from machine_learning_apache_spark_tpu_torch.launcher.distributor import (
    _register_gang,
    _unregister_gang,
    fn_reference,
)
from machine_learning_apache_spark_tpu_torch.launcher.monitor import (
    _signal_proc,
    terminate_gang,
)
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Env vars that would make a replica try to rendezvous — scrubbed from
#: every spawn (replicas are world-size-1 by construction).
_RENDEZVOUS_ENV = (
    "MLSPARK_COORDINATOR", "MASTER_ADDR", "MASTER_PORT",
    "WORLD_SIZE", "RANK", "MLSPARK_NUM_PROCESSES",
)


class ReplicaGang:
    """Spawn and supervise ``num_replicas`` independent serving workers.

    ``fn`` is run by importable reference in every rank (the
    ``fleet.replica.serve_replica`` wrapper, usually). The gang does not
    block: ``start()`` returns once every rank is spawned; the replicas
    announce themselves through their own sidecars. ``stop()`` drops the
    ``fleet_stop`` marker for a clean drain, then escalates.
    """

    def __init__(
        self,
        fn,
        *args: Any,
        num_replicas: int = 2,
        workdir: str | None = None,
        platform: str | None = None,
        env: dict[str, str] | None = None,
        telemetry_http: int | None = 0,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float | None = None,
        max_restarts_per_rank: int = 2,
        backoff_base: float = 0.5,
        backoff_max: float = 10.0,
        term_grace: float = 5.0,
        **kwargs: Any,
    ):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}"
            )
        self.ref = fn_reference(fn)
        self.call_args = (args, kwargs)
        self.num_replicas = num_replicas
        self.workdir = workdir or tempfile.mkdtemp(prefix="mlspark_fleet_")
        self.platform = platform
        self.extra_env = env or {}
        self.telemetry_http = telemetry_http
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts_per_rank = max_restarts_per_rank
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.term_grace = term_grace
        self._lock = threading.Lock()
        self._procs: dict[int, subprocess.Popen] = {}
        self._restart_at: dict[int, float] = {}  # rank -> not-before time
        self.restarts: dict[int, int] = {r: 0 for r in range(num_replicas)}
        self.exhausted: set[int] = set()
        # Dynamic membership (the autoscaler's levers): a retiring rank
        # sits in ``_retiring`` (rank -> kill-backstop deadline) until its
        # process exits, then moves to ``retired`` after sidecar cleanup.
        self._retiring: dict[int, float] = {}
        self.retired: set[int] = set()
        self._stop = threading.Event()
        self._supervisor: threading.Thread | None = None
        os.makedirs(self.workdir, exist_ok=True)
        self._args_path = os.path.join(self.workdir, "fleet_args.pkl")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaGang":
        if self._supervisor is not None:
            raise RuntimeError("replica gang already started")
        import pickle

        with open(self._args_path, "wb") as f:
            pickle.dump(self.call_args, f)
        stop_marker = os.path.join(self.workdir, "fleet_stop")
        if os.path.exists(stop_marker):
            os.unlink(stop_marker)  # stale marker from a previous gang
        self._stop.clear()
        for rank in range(self.num_replicas):
            self._spawn(rank)
        self._supervisor = threading.Thread(
            target=self._supervise, name="replica-gang-supervisor",
            daemon=True,
        )
        self._supervisor.start()
        log.info(
            "replica gang up: %d rank(s) in %s",
            self.num_replicas, self.workdir,
        )
        return self

    def stop(self, *, drain_s: float = 15.0) -> None:
        """Graceful drain: drop the stop marker, give replicas
        ``drain_s`` to exit on their own, then SIGTERM→SIGKILL."""
        self._stop.set()
        try:
            with open(os.path.join(self.workdir, "fleet_stop"), "w") as f:
                f.write("stop\n")
        except OSError:
            pass
        t = self._supervisor
        if t is not None:
            t.join(5.0)
        self._supervisor = None
        with self._lock:
            procs = list(self._procs.values())
        deadline = time.monotonic() + drain_s
        for p in procs:
            remaining = max(0.05, deadline - time.monotonic())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                pass
        terminate_gang(procs, grace=self.term_grace)
        _unregister_gang(procs)
        with self._lock:
            self._procs.clear()

    def __enter__(self) -> "ReplicaGang":
        if self._supervisor is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- spawn/supervise -----------------------------------------------------
    def _spawn(self, rank: int) -> None:
        # A stale drain marker for this rank id would make the fresh
        # replica retire itself on its first poll — scrub it first.
        try:
            os.unlink(os.path.join(self.workdir, f"fleet_drain_rank{rank}"))
        except OSError:
            pass
        heartbeat_path = os.path.join(self.workdir, f"heartbeat_{rank}")
        env = dict(os.environ)
        for name in _RENDEZVOUS_ENV:
            env.pop(name, None)
        env.update(self.extra_env)
        env.setdefault("MLSPARK_TELEMETRY_DIR", self.workdir)
        env.setdefault("MLSPARK_FLEET_DIR", self.workdir)
        env.setdefault("MLSPARK_FLEET_PORT", "0")
        env["MLSPARK_PROCESS_ID"] = str(rank)
        env["MLSPARK_GANG_ATTEMPT"] = str(self.restarts[rank])
        env["MLSPARK_HEARTBEAT_FILE"] = heartbeat_path
        env["MLSPARK_HEARTBEAT_INTERVAL"] = str(self.heartbeat_interval)
        if self.telemetry_http is not None:
            env["MLSPARK_TELEMETRY_HTTP"] = str(self.telemetry_http)
        if self.platform:
            # As the Distributor maps it: None is the card (the replica
            # raises where there is none), "cpu" keeps the replica on the
            # host. ``fleet.replica.replica_device`` reads it.
            envcfg.put_into(env, "MLSPARK_PLATFORM", self.platform)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        cmd = [
            sys.executable,
            "-m",
            "machine_learning_apache_spark_tpu_torch.launcher.runner",
            "--fn", self.ref,
            "--args-file", self._args_path,
            "--result-file",
            os.path.join(self.workdir, f"fleet_result_{rank}.pkl"),
        ]
        proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        with self._lock:
            self._procs[rank] = proc
        _register_gang([proc])

    def _supervise(self) -> None:
        """Per-rank detection + restart. First failure of rank k costs
        rank k a restart, nothing else — the anti-barrier."""
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                ranks = dict(self._procs)
            for rank, proc in ranks.items():
                dead = proc.poll() is not None
                backstop = self._retiring.get(rank)
                if backstop is not None:
                    # Deliberate retirement: never restart. Finalize on
                    # exit, or SIGKILL past the drain-deadline backstop
                    # (a wedged replica must not block the scale-down).
                    if dead:
                        self._finalize_retirement(rank, proc)
                    elif now >= backstop:
                        log.warning(
                            "replica %d missed its drain deadline; "
                            "killing to finish retirement", rank,
                        )
                        _signal_proc(proc, signal.SIGKILL)
                        try:
                            proc.wait(timeout=10.0)
                        except subprocess.TimeoutExpired:
                            pass
                        self._finalize_retirement(rank, proc)
                    continue
                stalled = (
                    not dead
                    and self.heartbeat_timeout is not None
                    and self._heartbeat_age(rank, now) > self.heartbeat_timeout
                )
                if not (dead or stalled):
                    continue
                if stalled:
                    log.warning(
                        "replica %d stalled (heartbeat silent > %.1fs); "
                        "killing for restart", rank, self.heartbeat_timeout,
                    )
                    _signal_proc(proc, signal.SIGKILL)
                    proc.wait(timeout=10.0)
                _unregister_gang([proc])
                if self.restarts[rank] >= self.max_restarts_per_rank:
                    if rank not in self.exhausted:
                        self.exhausted.add(rank)
                        with self._lock:
                            self._procs.pop(rank, None)
                        log.error(
                            "replica %d exhausted its restart budget "
                            "(%d); leaving it down",
                            rank, self.max_restarts_per_rank,
                        )
                    continue
                not_before = self._restart_at.get(rank, 0.0)
                if now < not_before:
                    continue
                self.restarts[rank] += 1
                delay = min(
                    self.backoff_max,
                    self.backoff_base * (2 ** (self.restarts[rank] - 1)),
                )
                self._restart_at[rank] = now + delay
                log.warning(
                    "replica %d down (exit=%s); restart %d/%d",
                    rank, proc.returncode, self.restarts[rank],
                    self.max_restarts_per_rank,
                )
                self._spawn(rank)
            self._stop.wait(0.2)

    def _heartbeat_age(self, rank: int, now: float) -> float:
        path = os.path.join(self.workdir, f"heartbeat_{rank}")
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            # No beat yet: age since spawn is unknowable here; treat as
            # young — exit detection covers a worker that died pre-beat.
            return 0.0

    # -- dynamic membership (the autoscaler's levers) ------------------------
    def add_rank(self) -> int:
        """Scale up by one: spawn a fresh replica on the lowest free rank
        id. A reused id (previously retired or exhausted) starts clean —
        restart budget reset, stale sidecars/markers scrubbed — so an old
        rank's history can't haunt its successor."""
        with self._lock:
            taken = set(self._procs) | set(self._retiring)
            rank = 0
            while rank in taken:
                rank += 1
        self.retired.discard(rank)
        self.exhausted.discard(rank)
        self.restarts[rank] = 0
        self._restart_at.pop(rank, None)
        self._cleanup_rank_files(rank)
        self._spawn(rank)
        log.info("replica %d added (scale-up)", rank)
        return rank

    def retire_rank(
        self, rank: int, *, drain: bool = True, deadline_s: float = 30.0
    ) -> bool:
        """Scale down by one: mark ``rank`` draining (marker file → the
        replica 503s new work, finishes in-flight, exits) and hand it to
        the supervisor for finalization. ``drain=False`` kills it
        outright. Returns False if the rank isn't live."""
        with self._lock:
            proc = self._procs.get(rank)
            if proc is None or rank in self._retiring:
                return False
            # Backstop is the replica's own deadline plus slack for its
            # exit path; the supervisor SIGKILLs past it.
            self._retiring[rank] = (
                time.monotonic() + (deadline_s if drain else 0.0) + 10.0
            )
        if not drain or proc.poll() is not None:
            _signal_proc(proc, signal.SIGKILL)
            return True
        marker = os.path.join(self.workdir, f"fleet_drain_rank{rank}")
        try:
            tmp = f"{marker}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"deadline": time.time() + deadline_s,
                           "rank": rank}, f)
                f.write("\n")
            os.replace(tmp, marker)
        except OSError:
            # Can't signal the drain — kill rather than leak the rank.
            _signal_proc(proc, signal.SIGKILL)
        log.info(
            "replica %d retiring (drain deadline %.1fs)", rank, deadline_s
        )
        return True

    def reap_rank(self, rank: int) -> bool:
        """Absorb a permanently-dead rank (restart budget exhausted) as an
        observed scale-down: scrub its sidecars so discovery drops it and
        the router purges its routing state. The rank id becomes free for
        reuse by a later ``add_rank``. Returns False unless the rank is
        actually down for good."""
        with self._lock:
            if rank in self._procs or rank in self._retiring:
                return False
        if rank not in self.exhausted and rank not in self.retired:
            return False
        self.retired.add(rank)
        self._cleanup_rank_files(rank)
        log.info("replica %d reaped (observed scale-down)", rank)
        return True

    def _finalize_retirement(self, rank: int, proc) -> None:
        _unregister_gang([proc])
        with self._lock:
            self._procs.pop(rank, None)
            self._retiring.pop(rank, None)
        self.retired.add(rank)
        self._cleanup_rank_files(rank)
        log.info("replica %d retired (exit=%s)", rank, proc.returncode)

    def _cleanup_rank_files(self, rank: int) -> None:
        """Remove one rank's discovery/heartbeat droppings so a retired
        rank vanishes from the scrape plane and a reused id starts
        clean."""
        for name in (
            f"fleet_rank{rank}.json",
            f"http_rank{rank}.json",
            f"heartbeat_{rank}",
            f"fleet_drain_rank{rank}",
        ):
            try:
                os.unlink(os.path.join(self.workdir, name))
            except OSError:
                pass

    # -- drill hooks / introspection -----------------------------------------
    def kill_rank(self, rank: int) -> bool:
        """SIGKILL one replica's process group (the fault-drill lever).
        Supervision notices and restarts it within a poll interval."""
        with self._lock:
            proc = self._procs.get(rank)
        if proc is None or proc.poll() is not None:
            return False
        _signal_proc(proc, signal.SIGKILL)
        return True

    def alive(self) -> dict[int, bool]:
        with self._lock:
            return {
                rank: proc.poll() is None
                for rank, proc in sorted(self._procs.items())
            }

    def live_ranks(self) -> list[int]:
        """Ranks with a running process that are *not* mid-retirement —
        the autoscaler's notion of current fleet size."""
        with self._lock:
            return sorted(
                rank for rank, proc in self._procs.items()
                if proc.poll() is None and rank not in self._retiring
            )

    def status(self) -> dict:
        return {
            "num_replicas": self.num_replicas,
            "alive": self.alive(),
            "restarts": dict(self.restarts),
            "exhausted": sorted(self.exhausted),
            "retiring": sorted(self._retiring),
            "retired": sorted(self.retired),
            "workdir": self.workdir,
        }
