"""Session layer — the SparkSession equivalent (reference L0); the port of
``machine_learning_apache_spark_tpu/session.py``.

The reference opens every script with either an inline-configured
``SparkSession.builder`` (``mllib_multilayer_perceptron_classifier.py:12-19``)
or an empty ``SparkConf`` populated by spark-submit whose
``spark.executor.instances`` is read back as the world size
(``distributed_cnn.py:41-43``). Here the session wraps torch and the
``torch.distributed`` process group: the "cluster" is the gang, one device
per process, so the world size is the group's size, and the ``read``
attribute exposes the Spark-style ``session.read.format("libsvm").load(path)``
ingestion API.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch

from machine_learning_apache_spark_tpu_torch.config import SessionConfig, _coerce
from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    process_count,
    process_index,
)
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_ACTIVE_SESSION: Optional["Session"] = None
_LOCK = threading.Lock()


class SessionBuilder:
    """``Session.builder.app_name(...).config(k, v).get_or_create()``.

    Mirrors ``SparkSession.builder.appName(...).config(...).getOrCreate()``
    (``pytorch_multilayer_perceptron.py:24-30``). Both snake_case and the
    Spark-style camelCase method names are provided.
    """

    def __init__(self) -> None:
        self._conf: dict[str, Any] = {}

    def app_name(self, name: str) -> "SessionBuilder":
        self._conf["app_name"] = name
        return self

    appName = app_name

    def config(self, key: str, value: Any) -> "SessionBuilder":
        # Accept Spark-style dotted keys ("spark.executor.instances") and
        # map them onto SessionConfig fields.
        norm = key.replace("spark.", "").replace(".", "_")
        self._conf[norm] = value
        return self

    def master(self, _url: str) -> "SessionBuilder":
        # Spark's master URL has no meaning here; accepted for API parity.
        return self

    def get_or_create(self) -> "Session":
        global _ACTIVE_SESSION
        with _LOCK:
            if _ACTIVE_SESSION is not None and self._conf:
                # Spark semantics: getOrCreate() returns the existing
                # session and conf on the builder is NOT applied. Silent
                # drops are expensive (a platform that never applies) — but only
                # keys that actually DIFFER from the active session are
                # dropped in any meaningful sense; idempotent re-creation
                # with identical conf should stay quiet.
                active = _ACTIVE_SESSION.conf
                fields = {f.name: f for f in dataclasses.fields(SessionConfig)}

                def _resolved(k, v):
                    # Compare post-coercion, the way creation would apply it
                    # ("8" matches an active executor count of 8). An
                    # uncoercible value can't match anything — return it
                    # raw so it counts as differing (warn, never raise:
                    # the conf is ignored either way under Spark
                    # getOrCreate semantics).
                    if k in fields and isinstance(v, str):
                        try:
                            return _coerce(v, type(fields[k].default))
                        except (TypeError, ValueError):
                            return v
                    return v

                unknown = sorted(k for k in self._conf if k not in fields)
                differing = sorted(
                    k for k, v in self._conf.items()
                    if k in fields and getattr(active, k) != _resolved(k, v)
                )
                if differing:
                    log.warning(
                        "getOrCreate(): active session exists; builder conf "
                        "%s ignored (stop() the session first to apply it)",
                        differing,
                    )
                if unknown:
                    # Not a stop()-and-retry situation: creation would drop
                    # these too. Distinct message so the user isn't sent on
                    # a futile restart cycle.
                    log.warning(
                        "getOrCreate(): conf keys %s match no SessionConfig "
                        "field and are unsupported (ignored on creation too)",
                        unknown,
                    )
            if _ACTIVE_SESSION is None:
                fields = {f.name: f for f in dataclasses.fields(SessionConfig)}
                kwargs = {}
                for k, v in self._conf.items():
                    if k not in fields:
                        continue
                    # spark-submit hands every conf value over as a string;
                    # coerce to the field's declared type like Spark does.
                    target = type(fields[k].default)
                    kwargs[k] = _coerce(v, target) if isinstance(v, str) else v
                _ACTIVE_SESSION = Session(SessionConfig.from_env(**kwargs))
            return _ACTIVE_SESSION

    getOrCreate = get_or_create


class _BuilderDescriptor:
    def __get__(self, obj: Any, objtype: Any = None) -> SessionBuilder:
        return SessionBuilder()


class Session:
    """A live handle on torch and, in a gang, its process group.

    Interface up (SURVEY.md §1 L0): the session object plus the world size —
    the reference's ``executors_n`` (``distributed_cnn.py:43``) is
    ``session.executor_count`` here, derived from the process group rather
    than conf. ``conf.platform`` (``"cpu"``, ``"cuda"``; empty = the card)
    is where this process's work runs; the gang's own ranks take it from
    ``MLSPARK_PLATFORM``, which ``Distributor(platform=...)`` sets.
    """

    builder = _BuilderDescriptor()

    def __init__(self, conf: SessionConfig | None = None) -> None:
        self.conf = conf or SessionConfig()
        if self.conf.compilation_cache_dir:
            log.warning(
                "compilation_cache_dir=%r has nothing to do in the PyTorch "
                "port: it caches XLA programs in the JAX package (kernel "
                "builds are cached under build/ regardless)",
                self.conf.compilation_cache_dir,
            )
        if self.conf.platform not in ("", "cpu", "cuda"):
            raise ValueError(
                f"platform={self.conf.platform!r}: expected '', 'cpu' or 'cuda'"
            )
        self._stopped = False

    # -- cluster facts (derived from the runtime, never from conf) ------------
    @property
    def device_count(self) -> int:
        """Devices the gang trains on: one per process."""
        return process_count()

    @property
    def local_device_count(self) -> int:
        """Cards this process can see (1 on the host)."""
        if self.conf.platform == "cpu" or not torch.cuda.is_available():
            return 1
        return torch.cuda.device_count()

    @property
    def process_count(self) -> int:
        return process_count()

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def executor_count(self) -> int:
        """The reference's ``executors_n``: one 'executor' per participating
        process (``distributed_multilayer_perceptron.py:39``)."""
        return process_count()

    @property
    def device(self) -> torch.device:
        """This process's device: the gang's choice for its rank, else
        the conf's platform (empty: the card, which raises without one)."""
        from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
            current_device,
        )

        gang = current_device()
        if gang is not None:
            return gang
        return resolve_device("cpu" if self.conf.platform == "cpu" else None)

    # -- ingestion ------------------------------------------------------------
    @property
    def read(self):
        from machine_learning_apache_spark_tpu_torch.data.reader import DataReader

        return DataReader(self)

    # -- mesh -----------------------------------------------------------------
    def mesh(self, **axes: int):
        """Build a mesh over the gang, e.g. ``session.mesh(data=2)``. Axis
        size 0 or -1 means "all remaining processes"; bad shapes raise the
        JAX package's ``ValueError``s."""
        from machine_learning_apache_spark_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(axes or None)

    # -- distributed bootstrap ------------------------------------------------
    def initialize_distributed(self) -> None:
        """Multi-process bootstrap: the ``MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK``
        env-var rendezvous of the reference (``pytorch_multilayer_perceptron.py:15-21``,
        commented block ``distributed_cnn.py:22-27``) →
        ``torch.distributed.init_process_group`` (``launcher.coordinator``)."""
        from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
            initialize_from_env,
        )

        initialize_from_env(self.conf)

    def stop(self) -> None:
        """``spark.stop()`` equivalent (``distributed_cnn.py:232``)."""
        global _ACTIVE_SESSION
        with _LOCK:
            if _ACTIVE_SESSION is self:
                _ACTIVE_SESSION = None
        self._stopped = True

    def __repr__(self) -> str:
        return (
            f"Session(app={self.conf.app_name!r}, devices={self.device_count}, "
            f"processes={self.process_count}, torch={torch.__version__})"
        )


def active_session() -> Session:
    """The current session, creating a default one if needed."""
    return Session.builder.get_or_create()
