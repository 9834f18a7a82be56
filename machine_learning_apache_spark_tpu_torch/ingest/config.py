"""Ingest env contract — ``MLSPARK_INGEST_*`` resolution; the port of
``machine_learning_apache_spark_tpu/ingest/config.py``.

Same precedence rule as the rest of the stack (``parallel.zero``):
explicit argument > environment variable > default. The launcher's
``Distributor(ingest={...})`` knob writes these variables into every
worker's environment (like ``MLSPARK_DP_MODE``), so a driver script
configures the gang's input pipeline in one place and each rank's
``StreamingPipeline`` picks it up at construction. The variables are
declared in ``utils.env``.

Stdlib-only: imported by the launcher before torch loads.
"""

from __future__ import annotations

from dataclasses import dataclass

from machine_learning_apache_spark_tpu_torch.utils import env as envcfg

ENV_PREFIX = "MLSPARK_INGEST_"

TAIL_POLICIES = ("pad", "drop")

#: Knobs the launcher accepts in ``Distributor(ingest={...})``.
INGEST_KNOBS = ("buffer", "device_prefetch", "tail", "chunk_lines")


def _env_int(name: str, default: int) -> int:
    return envcfg.get_int(ENV_PREFIX + name, default)


@dataclass(frozen=True)
class IngestConfig:
    """Resolved input-pipeline knobs.

    - ``buffer``: host-side prefetch depth in batches (the bounded
      producer/consumer queue). 0 = synchronous batch assembly.
    - ``device_prefetch``: batches copied to the device ahead of
      consumption (double buffering at the default 2). 0 disables the
      device stage (the pipeline yields host arrays).
    - ``tail``: epoch-tail policy, ``"pad"`` (wrap-pad the final batch so
      every rank yields the same count — collective-safe default, the
      ``DistributedSampler`` convention) or ``"drop"`` (drop ragged
      tails; still rank-equalized, see ``ingest.pipeline``).
    - ``chunk_lines``: lines per parser call in the streaming file
      readers (the native-parser batching grain).
    """

    buffer: int = 2
    device_prefetch: int = 2
    tail: str = "pad"
    chunk_lines: int = 1024

    def __post_init__(self):
        if self.buffer < 0:
            raise ValueError(f"ingest buffer must be >= 0, got {self.buffer}")
        if self.device_prefetch < 0:
            raise ValueError(
                f"ingest device_prefetch must be >= 0, got "
                f"{self.device_prefetch}"
            )
        if self.tail not in TAIL_POLICIES:
            raise ValueError(
                f"unknown ingest tail policy {self.tail!r} "
                f"(expected one of {TAIL_POLICIES})"
            )
        if self.chunk_lines < 1:
            raise ValueError(
                f"ingest chunk_lines must be >= 1, got {self.chunk_lines}"
            )

    @classmethod
    def from_env(
        cls,
        *,
        buffer: int | None = None,
        device_prefetch: int | None = None,
        tail: str | None = None,
        chunk_lines: int | None = None,
    ) -> "IngestConfig":
        """Explicit argument > ``MLSPARK_INGEST_*`` env > default."""
        return cls(
            buffer=buffer if buffer is not None else _env_int("BUFFER", 2),
            device_prefetch=(
                device_prefetch
                if device_prefetch is not None
                else _env_int("DEVICE_PREFETCH", 2)
            ),
            # Read raw: a bad value fails in __post_init__ with the
            # policy's own message.
            tail=tail if tail is not None else (envcfg.raw(ENV_PREFIX + "TAIL") or "pad"),
            chunk_lines=(
                chunk_lines
                if chunk_lines is not None
                else _env_int("CHUNK_LINES", 1024)
            ),
        )


def validate_ingest_knobs(knobs: dict) -> dict[str, str]:
    """Launcher-side validation of ``Distributor(ingest={...})``: unknown
    keys and bad values fail at Distributor construction, not inside every
    worker after rendezvous. Returns the ``{env var: value}`` mapping to
    write into worker environments."""
    out: dict[str, str] = {}
    for key, value in knobs.items():
        if key not in INGEST_KNOBS:
            raise ValueError(
                f"unknown ingest knob {key!r} (expected one of {INGEST_KNOBS})"
            )
        if key == "tail":
            if value not in TAIL_POLICIES:
                raise ValueError(
                    f"unknown ingest tail policy {value!r} "
                    f"(expected one of {TAIL_POLICIES})"
                )
        else:
            try:
                value = int(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"ingest knob {key!r} must be an integer, got {value!r}"
                ) from None
            if value < 0:
                raise ValueError(
                    f"ingest knob {key!r} must be >= 0, got {value}"
                )
        out[ENV_PREFIX + key.upper()] = str(value)
    return out
