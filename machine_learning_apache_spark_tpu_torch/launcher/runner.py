"""Per-worker entry point for the Distributor gang; the port of
``machine_learning_apache_spark_tpu/launcher/runner.py`` (same argv and env
contract).

Keep module-scope imports stdlib-only: this module is imported in every
spawned worker, the heartbeat starts before torch is imported, and the
heavy framework import happens only after the rendezvous env is in place.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import threading
import time
import traceback


def _start_heartbeat(
    path: str, interval: float, rank: int = 0, world: int | None = None
) -> threading.Thread:
    """Rewrite ``path`` every ``interval`` seconds from a daemon thread —
    the liveness signal ``launcher.monitor.GangMonitor`` watches (by
    mtime) and, since each beat is now a JSON payload (rank, pid, phase,
    step, http_port), also the gang-status signal ``tools/gang_status.py``
    reads for content. Atomic tmp+replace so a reader never sees a torn
    beat; the mtime contract is unchanged, so old monitors keep working.

    Started before the heavy framework imports so a wedged import counts
    as the stall it is only after the full ``heartbeat_timeout``, not as
    instant death. The beat loop holds no lock and touches nothing
    shared, so it keeps beating through compiles and collectives (which
    release the GIL); it stops only when the process truly wedges — or
    when a ``stall`` fault suspends it to simulate exactly that.
    """

    def suspended() -> bool:
        # sys.modules peek instead of an import: this thread must stay
        # stdlib-only and never be the one that imports a module. If user
        # code never imported the faults module, no stall fault can have
        # fired. A module the main thread is still importing is in
        # sys.modules before its functions are: not suspended either.
        mod = sys.modules.get("machine_learning_apache_spark_tpu_torch.utils.faults")
        fn = getattr(mod, "heartbeats_suspended", None)
        return bool(fn is not None and fn())

    def beacon() -> dict:
        # Same peek discipline for the telemetry beacon (phase, step,
        # http_port). Before the worker's framework import, the module is
        # absent and the beat carries liveness only.
        mod = sys.modules.get(
            "machine_learning_apache_spark_tpu_torch.telemetry.events"
        )
        if mod is None:
            return {}
        try:
            return mod.beacon()
        except Exception:
            return {}

    def beat() -> None:
        while True:
            if not suspended():
                b = beacon()
                payload = {
                    "rank": rank,
                    "pid": os.getpid(),
                    "wall": round(time.time(), 3),
                    "phase": b.get("phase"),
                    "step": b.get("step"),
                    "http_port": b.get("http_port"),
                    # World size as this worker sees it — after an
                    # elastic shrink the scrape tables show the gang's
                    # CURRENT world, not the launch-time one.
                    "world": world,
                }
                tmp = f"{path}.tmp.{os.getpid()}"
                try:
                    with open(tmp, "w") as f:
                        json.dump(payload, f)
                        f.write("\n")
                    os.replace(tmp, path)
                except OSError:
                    pass  # workdir tearing down — the gang is over anyway
            time.sleep(interval)

    t = threading.Thread(target=beat, name="mlspark-heartbeat", daemon=True)
    t.start()
    return t


def _install_sigterm_flight(tm, rank: int) -> None:
    """On the gang teardown's SIGTERM, dump this worker's flight recorder
    and export its rank timeline before dying with the default disposition
    — the innocent ranks of a failed gang ship their last events too.
    Best-effort: a worker without a main-thread signal context keeps the
    default handler."""
    import signal

    def handler(signum, frame):  # noqa: ARG001
        try:
            tm.dump_flight("launcher.sigterm")
            tdir = tm.telemetry_dir()
            if tdir and tm.enabled():
                tm.write_rank_file(tdir, rank=rank)
        except Exception:
            pass
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, handler)
    except (ValueError, OSError):  # non-main thread / exotic host
        pass


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fn", required=True, help="module:qualname")
    parser.add_argument("--args-file", default=None)
    parser.add_argument("--result-file", default=None)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    ns = parser.parse_args(argv)

    # CLI rendezvous flags (multi-host path) take precedence over env.
    # This whole pre-import section keeps direct os.environ access: the
    # heartbeat must start BEFORE any framework import (import time is
    # covered by liveness). The names are still registered in utils.env;
    # only the accessor differs here.
    if ns.coordinator:
        os.environ["MLSPARK_COORDINATOR"] = ns.coordinator  # mlspark-lint: ok env-direct-read -- pre-import section, see above
    if ns.num_processes is not None:
        os.environ["MLSPARK_NUM_PROCESSES"] = str(ns.num_processes)  # mlspark-lint: ok env-direct-read -- pre-import section
    if ns.process_id is not None:
        os.environ["MLSPARK_PROCESS_ID"] = str(ns.process_id)  # mlspark-lint: ok env-direct-read -- pre-import section

    rank = int(os.environ.get("MLSPARK_PROCESS_ID", "0"))  # mlspark-lint: ok env-direct-read -- pre-import section

    # Liveness beacon for the driver's GangMonitor — started before the
    # framework imports so rendezvous/import time is covered too.
    heartbeat_file = os.environ.get("MLSPARK_HEARTBEAT_FILE")  # mlspark-lint: ok env-direct-read -- pre-import section
    if heartbeat_file:
        world_raw = os.environ.get("MLSPARK_NUM_PROCESSES")  # mlspark-lint: ok env-direct-read -- pre-import section
        _start_heartbeat(
            heartbeat_file,
            float(os.environ.get("MLSPARK_HEARTBEAT_INTERVAL", "1.0")),  # mlspark-lint: ok env-direct-read -- pre-import section
            rank=rank,
            world=int(world_raw) if world_raw else None,
        )

    args, kwargs = ((), {})
    if ns.args_file:
        with open(ns.args_file, "rb") as f:
            args, kwargs = pickle.load(f)

    result: dict = {"rank": rank, "value": None, "error": None, "failed_at": None}
    code = 0
    tm = None  # telemetry module, bound inside the try
    try:
        # Telemetry first: it is stdlib-only, so the flight dump and the
        # live plane are up before torch loads.
        from machine_learning_apache_spark_tpu_torch import telemetry as tm

        _install_sigterm_flight(tm, rank)

        # Live observability plane: start this rank's HTTP server (no-op
        # with zero threads unless MLSPARK_TELEMETRY_HTTP is set) and seed
        # the beacon so the very next heartbeat carries phase + http_port.
        tm.beacon_update(phase="startup")
        tm.start_http_server(rank=rank)

        from machine_learning_apache_spark_tpu_torch.utils import env as envcfg

        # Rendezvous before user code touches devices — the
        # dist.init_process_group call of distributed_cnn.py:152 (the
        # process group's backend and this rank's device are picked
        # there; MLSPARK_PLATFORM=cpu keeps the rank on the host).
        from machine_learning_apache_spark_tpu_torch.launcher import coordinator

        spec = coordinator.initialize_from_env()
        # What the rendezvous chose, on this rank's timeline: the merged
        # gang report shows each rank's backend and device.
        tm.annotate(
            "launcher.rendezvous", rank=rank,
            world=None if spec is None else spec.num_processes,
            backend=coordinator.current_backend(),
            device=str(coordinator.current_device()),
        )

        from machine_learning_apache_spark_tpu_torch.launcher.distributor import (
            resolve_fn,
        )

        with tm.span(
            "launcher.worker", fn=ns.fn, rank=rank,
            attempt=envcfg.get_int("MLSPARK_GANG_ATTEMPT"),
        ):
            result["value"] = resolve_fn(ns.fn)(*args, **kwargs)
    except BaseException:  # noqa: BLE001 - worker must report, not die silently
        # When it failed, on the wall clock the driver shares: the driver
        # blames the rank that failed first, not a peer whose collective
        # broke when this rank went away.
        result["failed_at"] = time.time()
        result["error"] = traceback.format_exc()
        code = 1
        if tm is not None:
            tm.dump_flight("launcher.worker_exception")
    finally:
        # Per-rank timeline export (telemetry_rank<k>.jsonl, next to the
        # heartbeat files unless MLSPARK_TELEMETRY_DIR points elsewhere) —
        # the input to telemetry.aggregate / tools/telemetry_report.py.
        if tm is not None and tm.enabled():
            tdir = tm.telemetry_dir()
            if tdir:
                try:
                    tm.write_rank_file(tdir, rank=rank)
                except Exception:
                    traceback.print_exc()
        if ns.result_file:
            from machine_learning_apache_spark_tpu_torch.launcher.distributor import (
                WorkerResult,
            )

            payload = WorkerResult(**result)
            if code == 0 and rank != 0:
                # Only rank 0's value crosses back (distributor.run contract,
                # distributed_cnn.py:231); other ranks report success only.
                payload.value = None
            try:
                with open(ns.result_file, "wb") as f:
                    pickle.dump(payload, f)
            except Exception:
                # Unpicklable return value: replace the (possibly truncated)
                # file with an error result so the driver reports this rank's
                # real failure rather than an unpickling artifact.
                traceback.print_exc()
                code = code or 1
                payload = WorkerResult(
                    rank=rank,
                    error=f"rank {rank} result not picklable:\n{traceback.format_exc()}",
                    failed_at=time.time(),
                )
                try:
                    with open(ns.result_file, "wb") as f:
                        pickle.dump(payload, f)
                except Exception:
                    traceback.print_exc()
        # The group goes last, after the result is on disk: a rank that
        # hangs here has already reported.
        coordinator = sys.modules.get(
            "machine_learning_apache_spark_tpu_torch.launcher.coordinator"
        )
        if coordinator is not None:
            try:
                coordinator.shutdown()
            except Exception:
                traceback.print_exc()
    return code


if __name__ == "__main__":
    sys.exit(main())
