"""``mlspark-submit`` — the spark-submit analogue (reference L0, submit mode).

The reference's distributed scripts build their session from an EMPTY conf and
rely on ``spark-submit`` to inject resources, then read
``spark.executor.instances`` back as the world size
(``distributed_cnn.py:41-43``; SURVEY.md §1 L0 "spark-submit config" mode).
This CLI is that injection point for the port (the JAX package's
``submit.py`` with the module name swapped):

    python -m machine_learning_apache_spark_tpu_torch.submit \
        --conf spark.executor.instances=4 examples/distributed_cnn.py

Mechanism: every ``--conf`` key is normalized onto the ``MLSPARK_*`` env
contract that ``SessionConfig.from_env`` already reads (``config.py``), and
the driver script runs once in a child interpreter with that environment —
exactly spark-submit's division of labor: the submitter owns resources, the
script's empty ``Session.builder`` reads them back, and any gang spawning
happens inside via the Distributor (C12).

Multi-host rendezvous flags (``--coordinator``, ``--num-processes``,
``--process-id``) map onto the MASTER_ADDR/WORLD_SIZE/RANK analogues
(``distributed_cnn.py:22-27`` commented block; SURVEY.md §2.4) so one
``mlspark-submit`` per host also covers the torchrun-style launch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _conf_to_env(key: str, value: str) -> tuple[str, str]:
    """``spark.executor.instances`` / ``executor_instances`` →
    ``MLSPARK_EXECUTOR_INSTANCES`` (the ``SessionConfig.from_env`` contract)."""
    norm = key.strip()
    if norm.startswith("spark."):
        norm = norm[len("spark."):]
    norm = norm.replace(".", "_").upper()
    return f"MLSPARK_{norm}", value


def build_env(ns: argparse.Namespace) -> dict[str, str]:
    env = dict(os.environ)
    for item in ns.conf or []:
        if "=" not in item:
            raise SystemExit(f"--conf expects key=value, got {item!r}")
        key, _, value = item.partition("=")
        ek, ev = _conf_to_env(key, value)
        env[ek] = ev
    if ns.name:
        env["MLSPARK_APP_NAME"] = ns.name
    if ns.platform:
        env["MLSPARK_PLATFORM"] = ns.platform
    if ns.coordinator:
        env["MLSPARK_COORDINATOR"] = ns.coordinator
    if ns.num_processes is not None:
        env["MLSPARK_NUM_PROCESSES"] = str(ns.num_processes)
        # the conf-derived world size the reference reads back (:43)
        env.setdefault("MLSPARK_EXECUTOR_INSTANCES", str(ns.num_processes))
    if ns.process_id is not None:
        env["MLSPARK_PROCESS_ID"] = str(ns.process_id)
    return env


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mlspark-submit",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--conf", action="append", metavar="KEY=VALUE",
        help="session conf entry; spark.* keys are accepted and normalized",
    )
    parser.add_argument("--name", help="application name")
    parser.add_argument(
        "--platform", help="force the run's platform (cuda/cpu)"
    )
    parser.add_argument(
        "--coordinator", help="host:port rendezvous (multi-host runs)"
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("script", help="driver script to run")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)

    if not os.path.exists(ns.script):
        raise SystemExit(f"script not found: {ns.script}")
    env = build_env(ns)
    # A child interpreter (not runpy in-process): the submitter may itself
    # have touched the card, and platform/conf choices must reach the
    # driver before ITS first device use.
    cmd = [sys.executable, ns.script, *ns.script_args]
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
