"""Wall-clock timing spans (``Timer``, ``timed_span``), re-exported from
``telemetry.spans`` where they live — the counterpart of the JAX
package's ``utils/timing.py`` import surface."""

from __future__ import annotations

from machine_learning_apache_spark_tpu_torch.telemetry.spans import (  # noqa: F401
    Timer,
    timed_span,
)

__all__ = ["Timer", "timed_span"]
