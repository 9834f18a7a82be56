"""Gang health monitoring — failure *detection* for the Distributor; the
port of ``machine_learning_apache_spark_tpu/launcher/monitor.py``.

The Spark barrier scheduler's contract (SURVEY.md §5) is all-or-nothing:
one dead task fails the stage, the stage retries whole. The seed
reproduction had the teardown half of that contract but only one
detector (exit codes, polled inline) and one escalation level (SIGKILL).
This module completes it:

- ``GangMonitor`` — a daemon thread watching every worker for the three
  ways a gang member dies: **exit** (nonzero return code), **stalled
  heartbeat** (the worker's heartbeat file — touched by
  ``runner``'s beat thread — goes stale past ``heartbeat_timeout``; the
  hung-not-dead case exit codes can never catch), and **deadline** (the
  whole gang overrunning its budget). First detection wins, is recorded
  as a structured ``GangFailure``, and triggers teardown.
- ``terminate_gang`` — SIGTERM first (workers get to flush result files
  and die cleanly), SIGKILL whatever is still alive after the grace
  period. Workers are spawned as session leaders, so signals go to the
  whole process group — a worker's own children can't orphan past the
  gang.

The monitor never raises; it records. The Distributor reads
``monitor.failure`` after joining and turns it into the exception, with
the result files' tracebacks attached.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def read_heartbeat(path: str) -> dict:
    """Parse one heartbeat file's JSON payload (rank, pid, phase, step,
    http_port — written by ``runner._start_heartbeat``). Returns ``{}``
    for legacy empty-touch beats, torn writes, or unreadable files: the
    payload is enrichment, the mtime is the liveness contract."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return {}
    return payload if isinstance(payload, dict) else {}


class GangFailure(RuntimeError):
    """A gang attempt failed. Structured fields over string parsing:

    - ``rank`` — the first rank detected failing (None for whole-gang
      causes like deadline expiry);
    - ``cause`` — ``"exit"`` | ``"heartbeat"`` | ``"deadline"``;
    - ``attempt`` — 0-based gang attempt this failure ended;
    - ``exit_code`` — the failing rank's exit code (exit cause only);
    - ``permanent`` — the rank exhausted its per-rank restart budget
      (``Distributor``'s elastic policy judged it permanently lost and
      either could not shrink further or elastic resume was disabled).
    """

    def __init__(
        self,
        message: str,
        *,
        rank: int | None = None,
        cause: str = "exit",
        attempt: int = 0,
        exit_code: int | None = None,
        permanent: bool = False,
    ):
        super().__init__(message)
        self.rank = rank
        self.cause = cause
        self.attempt = attempt
        self.exit_code = exit_code
        self.permanent = permanent


def _signal_proc(proc: subprocess.Popen, sig: int) -> None:
    """Deliver ``sig`` to the worker's whole process group (it was
    spawned as a session leader), falling back to the single pid."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def terminate_gang(
    procs: list[subprocess.Popen], *, grace: float = 5.0
) -> None:
    """Fail-fast teardown with escalation: SIGTERM every live worker,
    give the gang ``grace`` seconds to exit (enough to flush a result
    file), SIGKILL the rest, and reap everything."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        _signal_proc(p, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in live:
        remaining = deadline - time.monotonic()
        try:
            p.wait(timeout=max(remaining, 0.01))
        except subprocess.TimeoutExpired:
            pass
    killed = 0
    for p in live:
        if p.poll() is None:
            _signal_proc(p, signal.SIGKILL)
            killed += 1
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover - kernel refuses
            log.warning("worker pid %d survived SIGKILL reap window", p.pid)
    if live:
        log.info(
            "gang teardown: %d SIGTERMed, %d escalated to SIGKILL",
            len(live), killed,
        )


class GangMonitor(threading.Thread):
    """Watch a spawned gang until it finishes or a failure is detected.

    One monitor per gang attempt. ``join()`` it, then read ``failure``:
    None means every rank exited 0. On the first failure the monitor
    tears the remaining workers down itself (fail-fast: a gang missing a
    rank can only hang at the next collective — killing it immediately
    converts a silent stall into a structured, retryable error).

    Heartbeat accounting starts at spawn time: a worker that never
    produces its first beat (import wedged, rendezvous hung) is judged
    against the same ``heartbeat_timeout``, with mtimes older than the
    spawn (stale files from a previous attempt) ignored.
    """

    def __init__(
        self,
        procs: list[subprocess.Popen],
        heartbeat_paths: list[str] | None = None,
        *,
        timeout: float,
        heartbeat_timeout: float | None = None,
        grace: float = 5.0,
        poll_interval: float = 0.05,
    ):
        super().__init__(name="mlspark-gang-monitor", daemon=True)
        self.procs = procs
        self.heartbeat_paths = heartbeat_paths or []
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.heartbeat_timeout = heartbeat_timeout or None
        self.grace = grace
        self.poll_interval = poll_interval
        self.failure: GangFailure | None = None
        self._spawned_at = time.monotonic()

    # -- detectors -----------------------------------------------------------
    def _last_beat(self, rank: int) -> float:
        """Monotonic-clock estimate of rank's most recent heartbeat."""
        try:
            mtime = os.stat(self.heartbeat_paths[rank]).st_mtime
        except (OSError, IndexError):
            return self._spawned_at
        # Heartbeat files carry wall-clock mtimes; convert the age to the
        # monotonic timeline the deadline math runs on.
        age = max(0.0, time.time() - mtime)
        return max(self._spawned_at, time.monotonic() - age)

    def _check_once(self, pending: set[int]) -> GangFailure | None:
        now = time.monotonic()
        for rank in sorted(pending):
            code = self.procs[rank].poll()
            if code is None:
                continue
            pending.discard(rank)
            if code != 0:
                return GangFailure(
                    f"rank {rank} exited with code {code}",
                    rank=rank, cause="exit", exit_code=code,
                )
        if self.heartbeat_timeout is not None:
            for rank in sorted(pending):
                silent = now - self._last_beat(rank)
                if silent > self.heartbeat_timeout:
                    # The stalled rank's last payload says what it was
                    # doing when it went quiet — the first question any
                    # postmortem asks.
                    last = (
                        read_heartbeat(self.heartbeat_paths[rank])
                        if rank < len(self.heartbeat_paths) else {}
                    )
                    where = ""
                    if last.get("phase") is not None:
                        where = f" (last phase {last['phase']!r}"
                        if last.get("step") is not None:
                            where += f", step {last['step']}"
                        where += ")"
                    return GangFailure(
                        f"rank {rank} missed heartbeats for {silent:.1f}s "
                        f"(timeout {self.heartbeat_timeout}s) — "
                        f"stalled{where}",
                        rank=rank, cause="heartbeat",
                    )
        if now > self.deadline:
            return GangFailure(
                f"gang did not finish within {self.timeout}s",
                cause="deadline",
            )
        return None

    def run(self) -> None:
        pending = set(range(len(self.procs)))
        while pending:
            failure = self._check_once(pending)
            if failure is not None:
                self.failure = failure
                log.warning("gang failure detected: %s", failure)
                telemetry.annotate(
                    "launcher.gang_failure",
                    rank=failure.rank, cause=failure.cause,
                    exit_code=failure.exit_code,
                )
                # Driver-side flight dump (flight_driver.json): what the
                # driver observed around the failure. Falls back to the
                # heartbeat dir (the gang workdir) when no telemetry dir is
                # configured — next to the files that triggered detection.
                tdir = telemetry.telemetry_dir() or (
                    os.path.dirname(self.heartbeat_paths[0])
                    if self.heartbeat_paths else None
                )
                telemetry.dump_flight(
                    f"launcher.gang_failure:{failure.cause}",
                    directory=tdir,
                    extra={"rank": failure.rank, "cause": failure.cause,
                           "exit_code": failure.exit_code},
                )
                telemetry.annotate("launcher.gang_teardown")
                terminate_gang(self.procs, grace=self.grace)
                return
            if pending:
                time.sleep(self.poll_interval)


__all__ = ["GangFailure", "GangMonitor", "read_heartbeat", "terminate_gang"]
