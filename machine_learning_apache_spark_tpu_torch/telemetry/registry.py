"""Process-global metrics registry: counters, gauges, raw-sample histograms.

Where ``spans`` answers "what was this process doing and for how long",
the registry answers "how much / how many right now": requests admitted,
tokens emitted, queue depth, step time distribution. Metrics live in
named scopes (``serving``, ``train``, ``launcher``) so two subsystems can
both own a ``requests`` counter without colliding.

Histograms keep raw samples (bounded) and compute percentiles with the
same nearest-rank ``percentile`` the serving ledger uses — one
definition of p99 across the whole repo. The import is lazy: serving's
metrics module is jax-free but lives under the heavy package root, and
the registry must stay importable in stdlib-only contexts.

Exports: ``snapshot()`` (plain dicts, JSON-ready) and
``to_prometheus_text()`` (text exposition format, one scrape surface for
the whole process).

Disabled mode (``MLSPARK_TELEMETRY=0``) hands out module-level no-op
metric singletons — counter bumps in hot loops cost one cached-boolean
check and a method call, no allocation, no lock.
"""

from __future__ import annotations

import threading

from machine_learning_apache_spark_tpu_torch.telemetry import events as _events

_DEFAULT_HIST_SAMPLES = 4096


def _fallback_percentile(samples, p):
    if not samples:
        return None
    xs = sorted(samples)
    k = max(0, min(len(xs) - 1, int(round(p / 100.0 * len(xs) + 0.5)) - 1))
    return xs[k]


_PERCENTILE_FN = None


def _percentile(samples, p):
    """Nearest-rank percentile — the serving ledger's definition, reused.
    Falls back to a local copy if serving isn't importable (it is in every
    supported environment; the fallback keeps stdlib-only contexts safe).
    The import resolves once, at first use, and the function is cached —
    histogram summaries call this per quantile, and an import-machinery
    round-trip per call is measurable under scrape load."""
    global _PERCENTILE_FN
    if _PERCENTILE_FN is None:
        try:
            from machine_learning_apache_spark_tpu_torch.serving.metrics import (
                percentile,
            )

            _PERCENTILE_FN = percentile
        except Exception:
            _PERCENTILE_FN = _fallback_percentile
    return _PERCENTILE_FN(samples, p)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "scope", "_lock", "_value")

    def __init__(self, scope: str, name: str):
        self.scope = scope
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time level; goes up and down."""

    __slots__ = ("name", "scope", "_lock", "_value")

    def __init__(self, scope: str, name: str):
        self.scope = scope
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramMetric:
    """Raw-sample histogram (bounded ring of recent samples) with
    nearest-rank percentiles. Count/sum are cumulative over all observed
    samples even after the ring evicts old ones."""

    __slots__ = ("name", "scope", "_lock", "_samples", "_max", "count", "sum")

    def __init__(
        self, scope: str, name: str, max_samples: int = _DEFAULT_HIST_SAMPLES
    ):
        self.scope = scope
        self.name = name
        self._lock = threading.Lock()
        self._samples: list[float] = []
        self._max = max_samples
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            if len(self._samples) >= self._max:
                # Overwrite in ring order; cheaper than pop(0) on a list.
                self._samples[(self.count - 1) % self._max] = value
            else:
                self._samples.append(value)

    def percentile(self, p: float):
        with self._lock:
            samples = list(self._samples)
        return _percentile(samples, p)

    def summary(self) -> dict:
        with self._lock:
            samples = list(self._samples)
            count, total = self.count, self.sum
        return {
            "count": count,
            "sum": round(total, 6),
            "p50": _percentile(samples, 50),
            "p90": _percentile(samples, 90),
            "p99": _percentile(samples, 99),
            "max": max(samples) if samples else None,
        }


class _NoopMetric:
    """Stands in for Counter/Gauge/Histogram when telemetry is off."""

    __slots__ = ()
    name = scope = ""
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1.0) -> None:  # noqa: ARG002
        pass

    def dec(self, amount: float = 1.0) -> None:  # noqa: ARG002
        pass

    def set(self, value: float) -> None:  # noqa: ARG002
        pass

    def observe(self, value: float) -> None:  # noqa: ARG002
        pass

    def percentile(self, p: float):  # noqa: ARG002
        return None

    def summary(self) -> dict:
        return {"count": 0, "sum": 0.0, "p50": None, "p90": None,
                "p99": None, "max": None}


NOOP_METRIC = _NoopMetric()


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


class MetricsRegistry:
    """Named scopes of metrics, one registry per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, str], object] = {}

    def _get(self, cls, scope: str, name: str, **kw):
        key = (scope, name)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(scope, name, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {scope}.{name} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
        return m

    def counter(self, scope: str, name: str) -> Counter:
        return self._get(Counter, scope, name)

    def gauge(self, scope: str, name: str) -> Gauge:
        return self._get(Gauge, scope, name)

    def histogram(
        self, scope: str, name: str,
        max_samples: int = _DEFAULT_HIST_SAMPLES,
    ) -> HistogramMetric:
        return self._get(
            HistogramMetric, scope, name, max_samples=max_samples
        )

    def snapshot(self) -> dict:
        """Plain-dict view, scope → name → value/summary. JSON-ready."""
        with self._lock:
            metrics = dict(self._metrics)
        out: dict[str, dict] = {}
        for (scope, name), m in sorted(metrics.items()):
            bucket = out.setdefault(scope, {})
            if isinstance(m, HistogramMetric):
                bucket[name] = m.summary()
            else:
                bucket[name] = m.value
        return out

    def to_prometheus_text(self) -> str:
        """Text exposition format. Counters/gauges one sample each;
        histograms as summary-style quantile lines plus _count/_sum.
        Each sample carries a ``rank`` label when running inside a gang."""
        rank = _events._env_rank()
        labels = f'{{rank="{rank}"}}' if rank is not None else ""
        with self._lock:
            metrics = dict(self._metrics)
        lines: list[str] = []
        for (scope, name), m in sorted(metrics.items()):
            full = _sanitize(f"mlspark_{scope}_{name}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full}{labels} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full}{labels} {m.value:g}")
            elif isinstance(m, HistogramMetric):
                s = m.summary()
                lines.append(f"# TYPE {full} summary")
                for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                    v = s[key]
                    if v is None:
                        continue
                    if labels:
                        qlabels = labels[:-1] + f',quantile="{q}"}}'
                    else:
                        qlabels = f'{{quantile="{q}"}}'
                    lines.append(f"{full}{qlabels} {v:g}")
                lines.append(f"{full}_count{labels} {s['count']}")
                lines.append(f"{full}_sum{labels} {s['sum']:g}")
        return "\n".join(lines) + ("\n" if lines else "")


class _NoopRegistry:
    """Disabled-mode registry: every lookup returns the shared no-op metric."""

    def counter(self, scope: str, name: str):  # noqa: ARG002
        return NOOP_METRIC

    def gauge(self, scope: str, name: str):  # noqa: ARG002
        return NOOP_METRIC

    def histogram(self, scope: str, name: str, max_samples: int = 0):  # noqa: ARG002
        return NOOP_METRIC

    def snapshot(self) -> dict:
        return {}

    def to_prometheus_text(self) -> str:
        return ""


NOOP_REGISTRY = _NoopRegistry()

_REGISTRY: MetricsRegistry | None = None
_REGISTRY_LOCK = threading.Lock()


def get_registry():
    """The process-global registry (no-op singleton when disabled)."""
    global _REGISTRY
    if not _events.enabled():
        return NOOP_REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def reset() -> None:
    """Drop the global registry — test hook."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = None


__all__ = [
    "Counter",
    "Gauge",
    "HistogramMetric",
    "MetricsRegistry",
    "NOOP_METRIC",
    "NOOP_REGISTRY",
    "get_registry",
    "reset",
]
