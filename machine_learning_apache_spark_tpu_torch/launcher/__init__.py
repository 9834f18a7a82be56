"""launcher — gang spawn + rendezvous (the TorchDistributor layer, C12);
the port of ``machine_learning_apache_spark_tpu/launcher``, with the
serving fleet's replica gang (``replica_gang.py``: N independent ranks,
each restarted on its own).

The names load on first use: every rank starts as
``python -m machine_learning_apache_spark_tpu_torch.launcher.runner``,
which imports this package first, and the runner's heartbeat must be
beating before torch loads (``launcher.coordinator`` imports it).
"""

import importlib

_EXPORTS = {
    "RendezvousSpec": "coordinator",
    "choose_backend": "coordinator",
    "initialize_from_env": "coordinator",
    "shutdown": "coordinator",
    "Distributor": "distributor",
    "TorchDistributor": "distributor",
    "fn_reference": "distributor",
    "kill_stray_gangs": "distributor",
    "GangFailure": "monitor",
    "GangMonitor": "monitor",
    "read_heartbeat": "monitor",
    "terminate_gang": "monitor",
    "ReplicaGang": "replica_gang",
}


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)


__all__ = sorted(_EXPORTS)
