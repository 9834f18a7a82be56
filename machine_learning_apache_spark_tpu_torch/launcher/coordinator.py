"""Rendezvous coordination — env vars → ``torch.distributed.init_process_group``;
the port of ``machine_learning_apache_spark_tpu/launcher/coordinator.py``.

The reference bootstraps its process group from
``{MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK}`` env vars set
either manually (``pytorch_multilayer_perceptron.py:15-21``) or by
TorchDistributor under spark-submit (commented fallback block,
``distributed_cnn.py:22-27``). The same env contract as the JAX package:

    MLSPARK_COORDINATOR (MASTER_ADDR:MASTER_PORT) → init_method tcp://host:port
    MLSPARK_NUM_PROCESSES (WORLD_SIZE)            → world_size
    MLSPARK_PROCESS_ID (RANK)                     → rank

Single-process runs (no env vars, world size 1) skip initialization
entirely, like the reference's sequential scripts.

The backend rule (``choose_backend``): gloo on the host; on the card NCCL
only when every rank of this host has a device of its own, and gloo over
CUDA tensors when ranks share one (NCCL refuses two ranks on one GPU with
"Duplicate GPU detected"). gloo is also the reference's own backend
(``distributed_cnn.py:152``). A card rank's device is
``cuda:{local_rank % device_count}``, made the current device, so
``torch.device("cuda")`` in the rank's code means its own card.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from machine_learning_apache_spark_tpu_torch.config import SessionConfig
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

# Framework-native env names, with the reference's torch names as fallbacks.
ENV_COORDINATOR = "MLSPARK_COORDINATOR"
ENV_NUM_PROCESSES = "MLSPARK_NUM_PROCESSES"
ENV_PROCESS_ID = "MLSPARK_PROCESS_ID"

#: How long a collective may wait for its peers before the group raises;
#: the gang monitor's heartbeat and deadline watch the same hang from the
#: launching process.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

# What initialize_from_env set up in this process: the spec, the backend
# and the rank's device. Empty outside a gang.
_STATE: dict = {}


@dataclass
class RendezvousSpec:
    coordinator_address: str  # "host:port"
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls, conf: SessionConfig | None = None) -> "RendezvousSpec | None":
        """Resolve the rendezvous from (in priority order) explicit session
        conf, framework env vars, then the reference's torch-style env vars.
        Returns None when this is a single-process run."""
        conf = conf or SessionConfig()
        if conf.coordinator_address and conf.num_processes > 1:
            return cls(conf.coordinator_address, conf.num_processes, max(conf.process_id, 0))

        addr = envcfg.get_str(ENV_COORDINATOR)
        if addr is None and "MASTER_ADDR" in os.environ:
            addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        world = envcfg.get_int(ENV_NUM_PROCESSES, default=None)
        if world is None:
            world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = envcfg.get_int(ENV_PROCESS_ID, default=None)
        if rank is None:
            rank = int(os.environ.get("RANK", "0"))
        if addr is None or world <= 1:
            return None
        return cls(addr, world, rank)

    def apply_env(self, env: dict[str, str]) -> dict[str, str]:
        """Write this spec into an env mapping (what the launcher sets on each
        spawned worker — TorchDistributor's env distribution step)."""
        env[ENV_COORDINATOR] = self.coordinator_address
        env[ENV_NUM_PROCESSES] = str(self.num_processes)
        env[ENV_PROCESS_ID] = str(self.process_id)
        # Torch-style aliases so reference-shaped user code keeps working.
        host, _, port = self.coordinator_address.partition(":")
        env["MASTER_ADDR"] = host
        env["MASTER_PORT"] = port or "29500"
        env["WORLD_SIZE"] = str(self.num_processes)
        env["RANK"] = str(self.process_id)
        return env


def choose_backend(platform: str, local_world: int, device_count: int) -> str:
    """The process group's backend: ``gloo`` on the host
    (``platform="cpu"``); on the card ``nccl`` only when each of the
    ``local_world`` ranks on this host has a device of its own, else
    ``gloo`` over CUDA tensors."""
    if platform == "cpu":
        return "gloo"
    return "nccl" if 0 < local_world <= device_count else "gloo"


def _local_rank(spec: RendezvousSpec) -> tuple[int, int]:
    """(local rank, ranks on this host): torchrun's ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` when set, else every rank on one host (the
    launcher's local mode)."""
    local_rank = int(os.environ.get("LOCAL_RANK", spec.process_id))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", spec.num_processes))
    return local_rank, local_world


def rank_device(platform: str | None, local_rank: int) -> torch.device:
    """This rank's device: the host for ``platform="cpu"``, else
    ``cuda:{local_rank % device_count}`` — which raises when there is no
    card (``utils.device.resolve_device``): a card rank never falls back
    to the host."""
    if platform == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return resolve_device(f"cuda:{local_rank % max(count, 1)}")


def initialize_from_env(conf: SessionConfig | None = None) -> RendezvousSpec | None:
    """The ``dist.init_process_group('gloo')`` analogue
    (``distributed_cnn.py:152``): idempotent multi-process bootstrap.
    Returns the spec, or None for a single process."""
    spec = RendezvousSpec.from_env(conf)
    if spec is None:
        return None
    if dist.is_initialized():
        return spec
    platform = (conf.platform if conf and conf.platform else None) or envcfg.get_str(
        "MLSPARK_PLATFORM"
    )
    local_rank, local_world = _local_rank(spec)
    device = rank_device(platform, local_rank)
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend("cpu" if device.type == "cpu" else "cuda", local_world, count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend,
        init_method=f"tcp://{spec.coordinator_address}",
        world_size=spec.num_processes,
        rank=spec.process_id,
        timeout=COLLECTIVE_TIMEOUT,
        **kwargs,
    )
    _STATE.update(spec=spec, backend=backend, device=device)
    return spec


def current_backend() -> str | None:
    """The backend ``initialize_from_env`` chose (None outside a gang)."""
    return _STATE.get("backend") if dist.is_initialized() else None


def current_device() -> torch.device | None:
    """This rank's device as ``initialize_from_env`` set it (None outside
    a gang)."""
    return _STATE.get("device") if dist.is_initialized() else None


def shutdown() -> None:
    """``destroy_process_group()`` analogue (``distributed_cnn.py:193``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()
