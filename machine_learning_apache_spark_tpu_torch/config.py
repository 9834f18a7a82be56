"""Run configuration — the port of ``machine_learning_apache_spark_tpu/config.py``.

The reference uses three ad-hoc config mechanisms (SURVEY.md §5): Spark conf
keys (``mllib_multilayer_perceptron_classifier.py:12-19``), rendezvous env vars
(``pytorch_multilayer_perceptron.py:15-21``), and module-level constants
(``pytorch_lstm.py:28-43``). Here all three collapse into dataclasses with
env/CLI override; device and world counts are derived from torch and the
process group, never from config. Same env prefix and field names as the
JAX package, so one environment configures either. Stdlib only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Any


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class ConfigBase:
    """Dataclass base with env/CLI override, mirroring spark-submit conf reads
    (``distributed_cnn.py:41-43`` reads ``spark.executor.instances`` back from
    the submitted conf)."""

    @classmethod
    def from_env(cls, prefix: str = "MLSPARK_", **overrides: Any) -> "ConfigBase":
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            env_key = prefix + f.name.upper()
            if env_key in os.environ:
                kwargs[f.name] = _coerce(os.environ[env_key], type(f.default))
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_args(cls, argv: list[str] | None = None, **overrides: Any) -> "ConfigBase":
        parser = argparse.ArgumentParser(description=cls.__doc__)
        for f in dataclasses.fields(cls):
            typ = type(f.default)
            if typ is bool:
                parser.add_argument(f"--{f.name}", type=lambda v: _coerce(v, bool), default=None)
            else:
                parser.add_argument(f"--{f.name}", type=typ, default=None)
        ns = parser.parse_args(argv)
        base = cls.from_env()
        kwargs = {k: v for k, v in vars(ns).items() if v is not None}
        kwargs.update(overrides)
        return dataclasses.replace(base, **kwargs)

    def replace(self, **kw: Any) -> "ConfigBase":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class SessionConfig(ConfigBase):
    """The L0 session layer config — the SparkSession.builder equivalent.

    ``executor_instances`` mirrors ``spark.executor.instances``
    (``distributed_cnn.py:43``); it is only a *request* — the actual world
    size always comes from the process group
    (``torch.distributed.get_world_size()``).
    """

    app_name: str = "mlspark-tpu"
    executor_instances: int = 0  # 0 = derive from runtime
    executor_cores: int = 1
    executor_memory: str = "1g"
    driver_memory: str = "1g"
    coordinator_address: str = ""  # MASTER_ADDR:MASTER_PORT analogue
    process_id: int = -1  # RANK analogue; -1 = derive
    num_processes: int = 0  # WORLD_SIZE analogue; 0 = derive
    platform: str = ""  # "", "cuda", "cpu" — "" means the card
    # The JAX package's persistent XLA compilation cache directory. Kept so
    # one conf drives either package; the port has no XLA programs to
    # cache (its kernels cache their builds under build/), so Session logs
    # that a non-empty value does nothing here.
    compilation_cache_dir: str = ""


@dataclass
class TrainConfig(ConfigBase):
    """Hyperparameters shared by the training recipes (reference module-level
    constants, e.g. ``pytorch_lstm.py:28-43``)."""

    batch_size: int = 32
    epochs: int = 3
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "sgd"
    seed: int = 1234
    log_every: int = 100  # per-100-batch print cadence (pytorch_lstm.py:171)
    dtype: str = "float32"  # compute dtype


@dataclass
class MeshConfig(ConfigBase):
    """Logical mesh shape. 0 on the data axis = all remaining devices."""

    data: int = 0
    model: int = 1
    seq: int = 1
    pipeline: int = 1
    expert: int = 1
