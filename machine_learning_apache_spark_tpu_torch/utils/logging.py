"""Rank-aware logging.

The reference's observability is bare ``print()`` (SURVEY.md §5). Here the
same metric vocabulary is emitted through one module, gated to rank 0 by
default so multi-host runs don't interleave N copies of every line.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGERS: dict[str, logging.Logger] = {}
# stdout by default: the examples' metric lines (Training Time, accuracy)
# reproduce the reference's print vocabulary on the reference's stream.
_DEFAULT_STREAM = sys.stdout


def get_logger(name: str = "mlspark") -> logging.Logger:
    if name not in _LOGGERS:
        logger = logging.getLogger(name)
        if not logger.handlers:
            handler = logging.StreamHandler(_DEFAULT_STREAM)
            handler.setFormatter(
                logging.Formatter("[%(asctime)s %(name)s] %(message)s", "%H:%M:%S")
            )
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            logger.propagate = False
        _LOGGERS[name] = logger
    return _LOGGERS[name]


class _StderrProxy:
    """File-like object resolving ``sys.stderr`` at EVERY write.

    Binding the stderr *object* at reroute time breaks under test
    harnesses that swap/close ``sys.stderr`` per test (pytest capture): a
    later log line would hit a closed stream and spray '--- Logging
    error ---'. Late binding always reaches whatever stderr currently is.
    """

    def write(self, s):  # noqa: D102 — file protocol
        return sys.stderr.write(s)

    def flush(self):  # noqa: D102
        return sys.stderr.flush()


def route_logging_to_stderr() -> None:
    """Retarget every package logger (existing and future) to stderr.

    For processes whose stdout is a machine-parsed artifact — bench.py's
    contract is ONE JSON line on stdout — where a stray log line (e.g. the
    compilation-cache enable notice) would corrupt the artifact stream.
    """
    global _DEFAULT_STREAM
    proxy = _StderrProxy()
    _DEFAULT_STREAM = proxy
    for logger in _LOGGERS.values():
        for h in logger.handlers:
            # FileHandler subclasses StreamHandler; retargeting one would
            # silently divert a file log to stderr.
            if isinstance(h, logging.StreamHandler) and not isinstance(
                h, logging.FileHandler
            ):
                h.setStream(proxy)


def rank_zero_print(*args, all_ranks: bool = False, **kwargs) -> None:
    """``print`` that only fires on process 0 (the reference prints from every
    rank — e.g. the training prints inside ``train_func`` at
    ``distributed_cnn.py:188-191`` run once per executor)."""
    if all_ranks or process_rank() == 0:
        print(*args, **kwargs)


def process_rank() -> int:
    """This process's rank in a gang (``MLSPARK_PROCESS_ID``), 0 outside
    one. The port has no JAX process index to ask."""
    # mlspark-lint: ok env-direct-read -- the registry lives in utils.env,
    # which this module must not need just to name the rank
    v = os.environ.get("MLSPARK_PROCESS_ID")
    try:
        return int(v) if v is not None else 0
    except ValueError:
        return 0
