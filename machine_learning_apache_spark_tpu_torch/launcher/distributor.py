"""Distributor — the TorchDistributor equivalent (reference C12); the port
of ``machine_learning_apache_spark_tpu/launcher/distributor.py``.

The reference launches distributed training with
``TorchDistributor(num_processes=executors_n, local_mode=..., use_gpu=False)
.run(train_func)`` (``distributed_cnn.py:227-231``): Spark gang-schedules one
barrier task per process, sets the torch rendezvous env vars, pickles
``train_func`` with its module globals, and returns rank 0's result.

Design deltas (SURVEY.md §7 design stance):

- **Function by reference, not pickle-by-value**: the train function must be
  importable (``module:qualname`` or a module-level callable). This kills the
  reference's accidental re-execution of module-level downloads on every
  executor (quirk Q13) — each worker imports the module once, deliberately.
- **Rendezvous**: the launcher picks a free coordinator port and writes the
  ``{MLSPARK_COORDINATOR, NUM_PROCESSES, PROCESS_ID}`` env contract (plus the
  torch-style aliases) that ``launcher.coordinator`` maps onto
  ``torch.distributed.init_process_group`` (SURVEY.md §2.4).
- **Result**: rank 0's return value is actually returned (the reference's
  ``train_func``s return None yet assign the result — quirk Q7).
- **Gang failure semantics**: any worker dying kills the gang and raises —
  the Spark-barrier all-or-nothing behavior (SURVEY.md §5 failure detection).

``local_mode=True`` (the reference's bring-up path,
``distributed_multilayer_perceptron.py:179``) spawns all ranks on this host.
Multi-host mode emits the per-host command lines instead (control-plane
integration with an external scheduler; see ``commands_for_hosts``).

``platform=None`` puts the ranks on the card (``launcher.coordinator``
picks each rank's device and the backend); ``platform="cpu"`` keeps them
on the host over gloo. ``dp_mode`` and ``dp_overlap`` reach every
worker's ``fit`` as ``MLSPARK_DP_MODE`` / ``MLSPARK_ZERO1_OVERLAP``
(``dp_mode="zero1"``: the ZeRO-1 step of ``parallel.zero``), and
``ingest={...}`` every worker's ``StreamingPipeline`` as
``MLSPARK_INGEST_*`` (validated here, ``ingest.validate_ingest_knobs``).

Elastic shrink: a rank that fails more than ``rank_restart_budget``
times since the last shrink (default ``max_restarts``; a deadline
expiry blames the gang, not a rank) is permanently lost. Without
``elastic`` that raises ``GangFailure(permanent=True)`` when a budget
was set; with ``elastic=True`` the gang retries at ``world - 1`` on a
fresh coordinator port (never below ``elastic_min_world``), and every
worker sees ``MLSPARK_ELASTIC=1``, so ``fit(resume=True)`` reshards the
old world's checkpoints onto the smaller mesh (``train.reshard``).

``max_restarts=N`` retries a failed gang whole, up to N times, with the
same function and arguments. A retried gang resumes rather than starts
over when its workers checkpoint: each rank saves to its own
``<root>/ckpt_r<rank>`` (a recipe's ``checkpoint_dir`` does so in a
gang) and ``fit(resume=True)`` restores the newest step complete on
every rank (``train.checkpoint.group_agreed_step``). Every attempt of
one ``run()`` carries the same ``MLSPARK_GANG_RUN`` id, from which a
recipe tells a retry of its own run (finish it) from a new run over an
old checkpoint directory (train its epochs more).
"""

from __future__ import annotations

import atexit
import os
import pickle
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.launcher.monitor import (
    GangFailure,
    GangMonitor,
    terminate_gang,
)
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Process groups of gangs this interpreter spawned and has not yet reaped.
# Safety net against orphaned workers: the normal path unregisters after
# reaping, and the atexit sweep (plus tests/conftest.py's session-finish
# sweep) SIGKILLs whatever a crashed/interrupted driver left behind —
# otherwise a timed-out pytest run leaves rogue ranks burning CPU past the
# CI timeout.
_LIVE_PGIDS: set[int] = set()
_PGIDS_LOCK = threading.Lock()


def _register_gang(procs: Sequence[subprocess.Popen]) -> None:
    with _PGIDS_LOCK:
        _LIVE_PGIDS.update(p.pid for p in procs)


def _unregister_gang(procs: Sequence[subprocess.Popen]) -> None:
    with _PGIDS_LOCK:
        _LIVE_PGIDS.difference_update(p.pid for p in procs)


def kill_stray_gangs() -> int:
    """SIGKILL every registered-but-unreaped gang process group. Returns
    the number of groups signalled (0 in any healthy run)."""
    with _PGIDS_LOCK:
        pgids, stray = list(_LIVE_PGIDS), len(_LIVE_PGIDS)
        _LIVE_PGIDS.clear()
    for pgid in pgids:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            stray -= 1
    if stray:
        log.warning("killed %d stray gang process group(s)", stray)
    return stray


atexit.register(kill_stray_gangs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fn_reference(fn: Callable | str) -> str:
    """``module:qualname`` reference for an importable function."""
    if isinstance(fn, str):
        if ":" not in fn:
            raise ValueError(f"function reference must be 'module:qualname', got {fn!r}")
        return fn
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", None)
    if not module or not qualname or "<" in qualname:
        raise ValueError(
            f"{fn!r} is not an importable module-level function; the launcher "
            "runs functions by reference (no closure pickling — SURVEY.md Q13)"
        )
    return f"{module}:{qualname}"


def resolve_fn(ref: str) -> Callable:
    """Import a ``module:qualname`` reference (shared by Distributor and the
    per-worker runner)."""
    import importlib

    module, _, qual = fn_reference(ref).partition(":")
    obj: Any = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


@dataclass
class WorkerResult:
    rank: int
    value: Any = None
    error: str | None = None
    # Wall-clock time the rank's function raised (None: it did not).
    failed_at: float | None = None


def gang_failure(
    results: list[WorkerResult], failure: GangFailure | None, attempt: int
) -> GangFailure:
    """The ``GangFailure`` of a failed attempt, from every rank's result
    and what the monitor saw (``failure``; None when every rank exited 0
    yet some result holds an error)."""
    errors = [r for r in results if r.error]
    # Ranks killed by the gang teardown leave placeholder errors;
    # surface the rank that actually crashed (its real traceback). A
    # rank with only a placeholder is an EFFECT of teardown, never the
    # blamed cause — a deadline expiry, where every rank is healthy but
    # slow, must keep rank=None. Of the ranks that raised, the first
    # to fail is the cause: when one rank raises, its peers' pending
    # collectives break within milliseconds, often before the monitor
    # polls, so the first exit the monitor sees may be a peer's. A rank
    # that died WITHOUT raising (a hard crash: no result file) and is the
    # exit the monitor saw first is the cause itself: its peers' raises
    # came after, when their collectives broke.
    raised = sorted(
        (r for r in errors if r.failed_at is not None), key=lambda r: r.failed_at
    )
    seen_first = (
        next((r for r in errors if r.rank == failure.rank), None)
        if failure is not None and failure.cause == "exit" else None
    )
    if seen_first is not None and seen_first.failed_at is None:
        real = seen_first
    else:
        real = raised[0] if raised else next(
            (r for r in errors if "produced no result" not in r.error), None
        )
    primary = real or (errors[0] if errors else None)
    detail = (
        f"\n[rank {primary.rank}] {primary.error}" if primary else ""
    )
    cause = failure.cause if failure is not None else "exit"
    if cause == "exit" and real is not None:
        rank = real.rank
        seen = "" if failure is None else (
            f": {failure}" if failure.rank == rank
            else f": rank {rank} failed first ({failure})"
        )
    else:
        rank = (
            failure.rank if failure is not None and failure.rank is not None
            else (real.rank if real else None)
        )
        seen = f": {failure}" if failure is not None else ""
    return GangFailure(
        "gang failed on rank(s) "
        + (", ".join(str(r.rank) for r in errors) or "?")
        + f" (cause={cause}, attempt={attempt})"
        + seen
        + detail,
        rank=rank,
        cause=cause,
        attempt=attempt,
        exit_code=failure.exit_code if failure is not None else None,
    )


class Distributor:
    """``Distributor(num_processes=N, local_mode=True).run(train_fn, *args)``.

    ``use_gpu`` is accepted for API parity with TorchDistributor and ignored
    (``platform`` decides: None is the card, ``"cpu"`` the host; the
    reference always passed ``use_gpu=False`` anyway,
    ``distributed_cnn.py:230``).
    """

    def __init__(
        self,
        num_processes: int | None = None,
        *,
        local_mode: bool = True,
        use_gpu: bool = False,  # noqa: ARG002 - API parity
        platform: str | None = None,
        env: dict[str, str] | None = None,
        dp_mode: str | None = None,
        dp_overlap: bool | None = None,
        serve_kv_mode: str | None = None,
        serve_kv_dtype: str | None = None,
        telemetry_http: int | None = None,
        ingest: dict | None = None,
        timeout: float = 600.0,
        max_restarts: int = 0,
        heartbeat_interval: float = 1.0,
        heartbeat_timeout: float | None = 300.0,
        term_grace: float = 5.0,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        elastic: bool = False,
        elastic_min_world: int = 1,
        rank_restart_budget: int | None = None,
    ) -> None:
        self.num_processes = num_processes or 1
        self.local_mode = local_mode
        self.platform = platform
        self.extra_env = env or {}
        # Data-parallel update mode for the workers' fit() (parallel.zero
        # env contract): "zero1" opts the whole gang into the ZeRO-1 step
        # via MLSPARK_DP_MODE. Validated here so a typo fails at
        # construction, not inside every rank after rendezvous.
        if dp_mode is not None and dp_mode not in ("replicated", "zero1"):
            raise ValueError(
                f"unknown dp_mode {dp_mode!r} (expected 'replicated' or "
                "'zero1')"
            )
        self.dp_mode = dp_mode
        # The zero1 overlap schedule rides the same contract: the boolean
        # becomes MLSPARK_ZERO1_OVERLAP in every worker (Zero1Config.from_env
        # resolves it; overlap is on when neither knob nor env is set).
        if dp_overlap is not None and not isinstance(dp_overlap, bool):
            raise ValueError(f"dp_overlap must be a bool or None, got {dp_overlap!r}")
        self.dp_overlap = dp_overlap
        # Serving KV-cache mode and store dtype ride the env contract
        # (MLSPARK_SERVE_KV_MODE / _DTYPE in every worker, resolved by
        # ServingEngine when kv_mode/kv_dtype are not passed).
        if serve_kv_mode is not None and serve_kv_mode not in (
            "padded", "paged"
        ):
            raise ValueError(
                f"unknown serve_kv_mode {serve_kv_mode!r} (expected "
                "'padded' or 'paged')"
            )
        self.serve_kv_mode = serve_kv_mode
        if serve_kv_dtype is not None and serve_kv_dtype not in (
            "float32", "int8"
        ):
            raise ValueError(
                f"unknown serve_kv_dtype {serve_kv_dtype!r} (expected "
                "'float32' or 'int8')"
            )
        self.serve_kv_dtype = serve_kv_dtype
        # Live observability plane, same env-contract shape: the knob
        # becomes MLSPARK_TELEMETRY_HTTP in every worker, which runner.main
        # resolves into a per-rank HTTP server. 0 means "ephemeral port per
        # rank" (the only sane choice for a local gang — fixed ports would
        # collide); each rank publishes its bound port in an
        # http_rank<k>.json sidecar.
        if telemetry_http is not None and not (
            0 <= int(telemetry_http) <= 65535
        ):
            raise ValueError(
                f"telemetry_http must be a port in [0, 65535] or None, "
                f"got {telemetry_http!r}"
            )
        self.telemetry_http = telemetry_http
        # Input-pipeline plumbing, same shape as dp_mode: the
        # Distributor(ingest={"buffer": 4, "tail": "pad", ...}) knob
        # becomes MLSPARK_INGEST_* in every worker's environment (the
        # contract ingest.IngestConfig.from_env resolves), validated at
        # construction so a typo'd knob fails in the driver, not inside
        # every rank after rendezvous.
        if ingest:
            from machine_learning_apache_spark_tpu_torch.ingest.config import (
                validate_ingest_knobs,
            )

            self.ingest_env = validate_ingest_knobs(ingest)
        else:
            self.ingest_env = {}
        self.timeout = timeout
        # Spark-barrier recovery semantics (SURVEY.md §5 failure detection):
        # a failed stage is retried whole — all-or-nothing gang restarts.
        self.max_restarts = max_restarts
        # Liveness detection (docs/FAULT_TOLERANCE.md): each worker touches
        # a per-rank heartbeat file every `heartbeat_interval`; a rank silent
        # past `heartbeat_timeout` is declared stalled and the gang torn
        # down (None disables — exit codes and the deadline still apply).
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        # Teardown escalation: SIGTERM, wait `term_grace`, then SIGKILL.
        self.term_grace = term_grace
        # Restart pacing: exponential backoff with jitter, so co-failing
        # gangs on one host don't re-stampede the same resource in lockstep.
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        # Elastic shrink policy: when one rank keeps failing past its
        # per-rank restart budget (`rank_restart_budget`, defaulting to
        # `max_restarts`), it is judged PERMANENTLY LOST — a preempted
        # card, a bad host. With elastic=True the gang retries at world-1
        # (never below `elastic_min_world`) instead of raising, and the
        # workers see MLSPARK_ELASTIC=1 so fit(resume=True) reshards the
        # old world's checkpoints onto the shrunken mesh
        # (train/reshard.py). With elastic=False (but a budget set) the
        # exhaustion raises a GangFailure with permanent=True naming the
        # rank, cause, and attempt count. Deadline expiries never count
        # against a rank — they blame the whole gang, not a member.
        self.elastic = bool(elastic)
        if int(elastic_min_world) < 1:
            raise ValueError(
                f"elastic_min_world must be >= 1, got {elastic_min_world}"
            )
        if int(elastic_min_world) > self.num_processes:
            raise ValueError(
                f"elastic_min_world={elastic_min_world} exceeds "
                f"num_processes={self.num_processes}"
            )
        self.elastic_min_world = int(elastic_min_world)
        if rank_restart_budget is not None and int(rank_restart_budget) < 0:
            raise ValueError(
                f"rank_restart_budget must be >= 0 or None, got "
                f"{rank_restart_budget}"
            )
        self.rank_restart_budget = (
            None if rank_restart_budget is None else int(rank_restart_budget)
        )

    # -- multi-host control plane --------------------------------------------
    def commands_for_hosts(
        self, fn: Callable | str, hosts: Sequence[str], coordinator_port: int = 29500
    ) -> list[str]:
        """One launch command per host for an external scheduler (the analogue
        of spark-submit's role): host 0 is the coordinator."""
        ref = fn_reference(fn)
        coord = f"{hosts[0]}:{coordinator_port}"
        return [
            sys.executable
            + " -m machine_learning_apache_spark_tpu_torch.launcher.runner"
            + f" --fn {ref} --coordinator {coord}"
            + f" --num-processes {len(hosts)} --process-id {rank}"
            for rank, _ in enumerate(hosts)
        ]

    # -- local gang spawn ----------------------------------------------------
    def run(self, fn: Callable | str, *args: Any, **kwargs: Any) -> Any:
        """Spawn the gang, wait, return rank 0's result
        (``distributor.run(train_func)`` contract, ``distributed_cnn.py:231``)."""
        if not self.local_mode:
            raise RuntimeError(
                "cluster mode is driven by an external scheduler: use "
                "commands_for_hosts() to obtain per-host launch commands"
            )
        n = self.num_processes
        if n == 1 and not (self.platform or self.extra_env):
            # Single process: run inline, as the reference's sequential
            # scripts do (no rendezvous needed). With platform/env overrides
            # we must still spawn (they only apply to a fresh interpreter).
            fn = self._resolve(fn)
            return fn(*args, **kwargs)

        ref = fn_reference(fn)
        coord = f"127.0.0.1:{_free_port()}"
        workdir = tempfile.mkdtemp(prefix="mlspark_gang_")
        args_path = os.path.join(workdir, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump((args, kwargs), f)

        try:
            attempt = 0
            # Per-rank failure counts since the last shrink — the elastic
            # policy's permanent-loss ledger (deadline expiries excluded:
            # they blame the gang, not a member).
            rank_failures: dict[int, int] = {}
            while True:
                # Clear any stale result/heartbeat files from a failed
                # attempt so a restart can't return a dead rank's leftovers
                # (or judge liveness off a corpse's last beat). Sweep the
                # ORIGINAL world's files — after a shrink, a departed
                # rank's leftovers must not linger either.
                for rank in range(self.num_processes):
                    for name in (f"result_{rank}.pkl", f"heartbeat_{rank}"):
                        stale = os.path.join(workdir, name)
                        if os.path.exists(stale):
                            os.unlink(stale)
                try:
                    with telemetry.span(
                        "launcher.gang_attempt",
                        attempt=attempt, num_processes=n,
                    ):
                        value = self._run_gang(
                            ref, coord, workdir, args_path, n, attempt
                        )
                    self._write_telemetry_report(workdir)
                    return value
                except GangFailure as failure:
                    attempt += 1
                    budget = (
                        self.max_restarts
                        if self.rank_restart_budget is None
                        else self.rank_restart_budget
                    )
                    lost: int | None = None
                    if failure.rank is not None and failure.cause != "deadline":
                        rank_failures[failure.rank] = rank_failures.get(failure.rank, 0) + 1
                        if rank_failures[failure.rank] > budget:
                            lost = failure.rank
                    if lost is not None and (
                        self.elastic or self.rank_restart_budget is not None
                    ):
                        n = self._shrink(failure, lost, rank_failures[lost], budget, n, attempt)
                        attempt = 0
                        rank_failures.clear()
                        time.sleep(min(self.backoff_max, self.backoff_base))
                        coord = f"127.0.0.1:{_free_port()}"
                        continue
                    telemetry.annotate(
                        "launcher.gang_retry" if attempt <= self.max_restarts
                        else "launcher.gang_exhausted",
                        attempt=attempt, rank=failure.rank,
                        cause=failure.cause,
                    )
                    if attempt > self.max_restarts:
                        raise
                    delay = min(
                        self.backoff_max,
                        self.backoff_base * (2 ** (attempt - 1)),
                    ) * (0.5 + random.random() / 2)  # full-jitter-lite
                    log.warning(
                        "gang attempt %d/%d failed (rank=%s cause=%s); "
                        "restarting whole gang in %.2fs (Spark-barrier "
                        "all-or-nothing semantics)",
                        attempt, self.max_restarts, failure.rank,
                        failure.cause, delay,
                    )
                    time.sleep(delay)
                    coord = f"127.0.0.1:{_free_port()}"  # stale port may linger
        finally:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)

    def _shrink(self, failure: GangFailure, lost: int, fails: int, budget: int,
                n: int, attempt: int) -> int:
        """The world after rank ``lost`` is judged permanently lost: raise
        ``GangFailure(permanent=True)`` when the gang may not shrink
        (elastic off, or ``elastic_min_world`` reached), else ``n - 1``,
        with a ``launcher.gang_shrink`` annotation."""
        why = None
        if not self.elastic:
            why = (f"per-rank restart budget {budget} exhausted and elastic "
                   "resume is disabled")
        elif n - 1 < self.elastic_min_world:
            why = (f"the gang cannot shrink below elastic_min_world="
                   f"{self.elastic_min_world} (world is {n})")
        if why is not None:
            telemetry.annotate(
                "launcher.gang_exhausted", attempt=attempt, rank=lost, cause=failure.cause,
            )
            raise GangFailure(
                f"rank {lost} permanently lost (cause={failure.cause}) after "
                f"{fails} failed attempt(s) — {why}",
                rank=lost, cause=failure.cause, attempt=attempt,
                exit_code=failure.exit_code, permanent=True,
            ) from failure
        telemetry.annotate(
            "launcher.gang_shrink", old_world=n, new_world=n - 1, rank=lost,
            cause=failure.cause, failures=fails,
        )
        log.warning(
            "rank %d permanently lost (cause=%s, %d failure(s) > budget %d); "
            "shrinking gang %d -> %d and resuming elastically from the group "
            "checkpoints", lost, failure.cause, fails, budget, n, n - 1,
        )
        return n - 1

    def _telemetry_out_dir(self, workdir: str) -> str:
        """Where this gang's telemetry files land — the same precedence the
        worker env gets in ``_run_gang`` (explicit env= > inherited env >
        the ephemeral workdir)."""
        return (
            self.extra_env.get("MLSPARK_TELEMETRY_DIR")
            or envcfg.get_str("MLSPARK_TELEMETRY_DIR")
            or workdir
        )

    def _write_telemetry_report(self, workdir: str) -> None:
        """Rank-0-side gang merge: after a successful run, fold the per-rank
        ``telemetry_rank<k>.jsonl`` exports into ``telemetry_report.json``
        (+ ``.md``) in the telemetry dir. Best-effort — reporting must never
        fail a run that trained fine."""
        if not telemetry.enabled():
            return
        try:
            tdir = self._telemetry_out_dir(workdir)
            from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

            if not aggregate.find_rank_files(tdir):
                return
            report = aggregate.merge_gang_dir(tdir)
            import json

            with open(os.path.join(tdir, "telemetry_report.json"), "w") as f:
                json.dump(report, f, indent=2)
                f.write("\n")
            with open(os.path.join(tdir, "telemetry_report.md"), "w") as f:
                f.write(aggregate.render_markdown(report))
            log.info(
                "telemetry report merged from %d rank(s) into %s",
                len(report["ranks"]), tdir,
            )
        except Exception:
            log.exception("telemetry report generation failed (ignored)")

    def worker_env(
        self, coord: str, workdir: str, n: int, rank: int, attempt: int, heartbeat_path: str
    ) -> dict[str, str]:
        """The environment of rank ``rank``'s worker: the inherited one,
        the constructor knobs' contract variables, the explicit ``env=``
        above them, then the gang's rendezvous and liveness variables."""
        env = dict(os.environ)
        # Constructor knobs ride the env contract (inherited env below
        # them, explicit env= above them). Writes go through the
        # registry (envcfg.put_into): a typo'd contract name fails
        # here, not as a silently ignored variable in every rank.
        if self.dp_mode is not None:
            envcfg.put_into(env, "MLSPARK_DP_MODE", self.dp_mode)
        if self.dp_overlap is not None:
            envcfg.put_into(env, "MLSPARK_ZERO1_OVERLAP", "1" if self.dp_overlap else "0")
        if self.serve_kv_mode is not None:
            envcfg.put_into(env, "MLSPARK_SERVE_KV_MODE", self.serve_kv_mode)
        if self.serve_kv_dtype is not None:
            envcfg.put_into(env, "MLSPARK_SERVE_KV_DTYPE", self.serve_kv_dtype)
        if self.telemetry_http is not None:
            envcfg.put_into(env, "MLSPARK_TELEMETRY_HTTP", self.telemetry_http)
        # Elastic opt-in rides the same contract: the workers' fit()
        # resolves MLSPARK_ELASTIC when elastic= isn't passed, so a
        # shrunken gang reshards old-topology checkpoints instead of
        # refusing them (train/reshard.py).
        if self.elastic:
            envcfg.put_into(env, "MLSPARK_ELASTIC", "1")
        # Ingest knobs: constructor > inherited env (explicit env= wins).
        for name, value in self.ingest_env.items():
            envcfg.put_into(env, name, value)
        # Local mode: every rank is on this host, so gloo's sockets
        # go over loopback. Pinned here because gloo otherwise binds
        # to the interface the hostname resolves to, which a host
        # without a resolvable name (or without a network) lacks.
        # Not a user knob: an inherited or explicit value wins.
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.update(self.extra_env)
        # Workers default their telemetry output (rank JSONLs, flight
        # dumps) next to the heartbeat files; an inherited or explicit
        # MLSPARK_TELEMETRY_DIR (e.g. a persistent dir from the fault
        # drill) wins — the workdir is ephemeral (rmtree'd below).
        env.setdefault("MLSPARK_TELEMETRY_DIR", workdir)
        envcfg.put_into(env, "MLSPARK_COORDINATOR", coord)
        envcfg.put_into(env, "MLSPARK_NUM_PROCESSES", n)
        envcfg.put_into(env, "MLSPARK_PROCESS_ID", rank)
        envcfg.put_into(env, "MLSPARK_GANG_ATTEMPT", attempt)
        # One id per run() call, the same on every attempt.
        envcfg.put_into(env, "MLSPARK_GANG_RUN", os.path.basename(workdir))
        envcfg.put_into(env, "MLSPARK_HEARTBEAT_FILE", heartbeat_path)
        envcfg.put_into(
            env, "MLSPARK_HEARTBEAT_INTERVAL", self.heartbeat_interval
        )
        host, _, port = coord.partition(":")
        env["MASTER_ADDR"], env["MASTER_PORT"] = host, port
        env["WORLD_SIZE"], env["RANK"] = str(n), str(rank)
        if self.platform:
            # The coordinator reads it for the rank's device and the
            # group's backend.
            envcfg.put_into(env, "MLSPARK_PLATFORM", self.platform)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in sys.path if p
        )
        return env

    def _run_gang(
        self,
        ref: str,
        coord: str,
        workdir: str,
        args_path: str,
        n: int,
        attempt: int = 0,
    ) -> Any:
        procs: list[subprocess.Popen] = []
        result_paths, heartbeat_paths = [], []
        for rank in range(n):
            result_path = os.path.join(workdir, f"result_{rank}.pkl")
            heartbeat_path = os.path.join(workdir, f"heartbeat_{rank}")
            result_paths.append(result_path)
            heartbeat_paths.append(heartbeat_path)
            env = self.worker_env(coord, workdir, n, rank, attempt, heartbeat_path)
            cmd = [
                sys.executable,
                "-m",
                "machine_learning_apache_spark_tpu_torch.launcher.runner",
                "--fn", ref,
                "--args-file", args_path,
                "--result-file", result_path,
            ]
            # start_new_session: each worker leads its own process group, so
            # teardown signals reach the worker AND anything it spawned.
            procs.append(
                subprocess.Popen(cmd, env=env, start_new_session=True)
            )
        _register_gang(procs)
        log.info(
            "spawned %d-process gang (coordinator %s, attempt %d)",
            n, coord, attempt,
        )

        try:
            failure = self._wait_gang(procs, heartbeat_paths)
        finally:
            # Belt and suspenders for non-GangFailure exits (KeyboardInterrupt
            # etc.): nothing outlives the attempt.
            terminate_gang(procs, grace=0.0)
            _unregister_gang(procs)

        results = [self._read_result(path, rank) for rank, path in enumerate(result_paths)]
        errors = [r for r in results if r.error]
        if failure is None and not errors:
            return results[0].value

        raise gang_failure(results, failure, attempt)

    def _wait_gang(
        self,
        procs: list[subprocess.Popen],
        heartbeat_paths: list[str] | None = None,
    ) -> GangFailure | None:
        """All-or-nothing barrier semantics, delegated to a ``GangMonitor``
        thread: the first nonzero exit, stalled heartbeat, or deadline
        expiry tears the gang down (SIGTERM -> SIGKILL). Returns the
        detected failure, or None if every rank exited 0."""
        watcher = GangMonitor(
            procs,
            heartbeat_paths,
            timeout=self.timeout,
            heartbeat_timeout=self.heartbeat_timeout,
            grace=self.term_grace,
        )
        watcher.start()
        while watcher.is_alive():
            # join with a timeout so the driver stays interruptible
            # (Ctrl-C in a notebook must not wedge behind a daemon join).
            watcher.join(timeout=1.0)
        return watcher.failure

    @staticmethod
    def _resolve(fn: Callable | str) -> Callable:
        return fn if callable(fn) else resolve_fn(fn)

    @staticmethod
    def _read_result(path: str, rank: int) -> WorkerResult:
        if not os.path.exists(path):
            return WorkerResult(rank=rank, error=f"rank {rank} produced no result (crashed?)")
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception as e:
            # Truncated/corrupt file (e.g. the worker died mid-dump, or its
            # return value wasn't picklable): treat as a worker failure so the
            # gang error carries the rank, not a bare unpickling traceback.
            return WorkerResult(
                rank=rank, error=f"rank {rank} produced no result (unreadable result file: {e!r})"
            )


# API-parity alias: reference user code says TorchDistributor
# (distributed_cnn.py:227).
TorchDistributor = Distributor
