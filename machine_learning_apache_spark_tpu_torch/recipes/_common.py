"""Shared recipe plumbing — the port of
``machine_learning_apache_spark_tpu/recipes/_common.py`` for one process on
one device: no mesh and no distributed sampler.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from machine_learning_apache_spark_tpu_torch.data.loader import (
    ArrayDataset,
    DataLoader,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import MetricsLogger
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def default_compute_dtype(override: str | None = None) -> torch.dtype:
    """The compute dtype: float32, the only one the port's kernels take in
    this slice (the JAX package picks bfloat16 on a TPU; bf16 kernels are
    ROADMAP queue B work). An explicit ``"float32"`` is accepted."""
    if override in (None, "float32"):
        return torch.float32
    raise NotImplementedError(
        f"compute dtype {override!r} is not ported yet: the kernels take "
        "float32 only (bf16 inputs are ROADMAP queue B)"
    )


def with_overrides(recipe, overrides: dict):
    """``dataclasses.replace`` with the no-override fast path — the shared
    ``train_x(recipe, **overrides)`` config idiom."""
    return dataclasses.replace(recipe, **overrides) if overrides else recipe


def local_batch_scale(mesh=None) -> int:
    """Per-process multiplier turning a per-replica batch into this
    process's share of the global batch: 1 without a mesh, the only case
    this port runs (a mesh is ROADMAP A4)."""
    if mesh is not None:
        raise NotImplementedError(
            "recipes on a mesh are not ported yet (ROADMAP queue A4 (distributed))"
        )
    return 1


def make_bucketed_loader(
    loader_cls,
    *streams,
    batch_size: int,
    full_width: int,
    boundaries: tuple[int, ...] = (),
    seed: int = 0,
):
    """Shared bucketed-loader construction for recipes: default boundaries
    at (1/4, 1/2, full) of the fixed width, and a loud error when the
    batch leaves every bucket short of one full batch (``drop_last``
    inside each bucket would otherwise "train" on zero batches)."""
    boundaries = boundaries or tuple(
        sorted({max(full_width // 4, 8), max(full_width // 2, 8), full_width})
    )
    effective = batch_size * local_batch_scale()
    loader = loader_cls(
        *streams, batch_size=effective, boundaries=boundaries, seed=seed
    )
    if len(loader) == 0:
        raise ValueError(
            f"effective batch {effective} (batch_size={batch_size} × "
            f"{local_batch_scale()} local replicas) leaves every length "
            f"bucket ({boundaries}) short of one full batch; shrink the "
            "batch or provide more data"
        )
    return loader


def make_loaders(
    train_ds: ArrayDataset | None,
    test_ds: ArrayDataset | None,
    *,
    batch_size: int,
    seed: int = 0,
    collate: Callable[[tuple], Any] | None = None,
) -> tuple[DataLoader | None, DataLoader | None]:
    """The JAX package's loader rules for one process without a mesh: the
    batch is clamped to what the split can fill once; ``drop_last=True`` on
    the shuffled train loader (one static shape), ``drop_last=False`` on
    the test loader so eval scores every row (``train.loop.evaluate``)."""

    def _clamped(n_rows: int, want: int) -> int:
        return min(want, max(n_rows, 1))

    train_loader = None
    if train_ds is not None:
        train_loader = DataLoader(
            train_ds,
            _clamped(len(train_ds), batch_size),
            shuffle=True,
            drop_last=True,
            seed=seed,
            collate=collate,
            # Assemble ahead on a background thread while the card trains.
            prefetch=2,
        )
    test_loader = None
    if test_ds is not None:
        test_loader = DataLoader(
            test_ds,
            _clamped(len(test_ds), batch_size),
            drop_last=False,
            seed=seed,
            collate=collate,
        )
    return train_loader, test_loader


@contextlib.contextmanager
def checkpointing(
    checkpoint_dir: str | None,
    state,
    *,
    resume: bool = True,
    max_to_keep: int = 3,
):
    """Context-managed recipe checkpointing: yields
    ``(manager_or_None, state, resumed_step_or_None)`` and closes the
    manager on exit — the shared shape of every recipe's
    open → fit(checkpointer=...) → close sequence."""
    mgr, state, resumed = open_checkpointing(
        checkpoint_dir, state, resume=resume, max_to_keep=max_to_keep
    )
    try:
        yield mgr, state, resumed
    finally:
        if mgr is not None:
            mgr.close()


def open_checkpointing(
    checkpoint_dir: str | None,
    state,
    *,
    resume: bool = True,
    max_to_keep: int = 3,
):
    """Recipe-surface checkpoint/resume.

    Returns ``(manager_or_None, state, resumed_step_or_None)``: when
    ``checkpoint_dir`` holds prior checkpoints and ``resume`` is True, the
    freshly created ``state`` is the restore template (same model and
    optimizer code) and takes the newest valid step's values in place.
    Callers pass the manager to ``fit(checkpointer=...)`` and must
    ``close()`` it when done — or use ``checkpointing``, which does."""
    if not checkpoint_dir:
        return None, state, None
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
    resumed = None
    if resume:
        restored = mgr.restore_latest_valid(state)
        if restored is not None:
            state, resumed, _ = restored
            log.info("resuming from checkpoint step %d", resumed)
    return mgr, state, resumed


def fit_recipe(r, state, loss_fn, train_loader):
    """``fit`` under a recipe's training fields (``epochs``, ``seed``,
    ``log_every``, ``checkpoint_dir``/``checkpoint_every``/``resume``,
    ``metrics_path``, ``steps_per_call``, ``prefetch_to_device``).
    Returns ``(FitResult, resumed_step_or_None)``.

    With a checkpoint to resume from, the run trains ``r.epochs`` more
    epochs numbered on from the checkpoint's, with its loader order and
    dropout stream, so a run cut at an epoch boundary and resumed trains
    as the uninterrupted run would."""
    from machine_learning_apache_spark_tpu_torch.train.loop import fit

    with checkpointing(r.checkpoint_dir, state, resume=r.resume) as (ckpt, state, resumed):
        epochs = r.epochs
        if resumed is not None:
            epochs += int(ckpt.read_meta(resumed).get("epoch", -1)) + 1
        result = fit(
            state,
            loss_fn,
            train_loader,
            epochs=epochs,
            rng=torch.Generator().manual_seed(r.seed),
            log_every=r.log_every,
            checkpointer=ckpt,
            checkpoint_every=r.checkpoint_every,
            metrics_file=r.metrics_path,
            steps_per_call=r.steps_per_call,
            prefetch_to_device=r.prefetch_to_device,
            resume=resumed is not None,
        )
    return result, resumed


def summarize(
    fit_result, eval_metrics: dict | None, *, metrics_path: str | None = None,
    **extra,
) -> dict:
    """The printable/picklable end-of-run contract — the reference's metric
    vocabulary (train wall time, losses, eval metrics). ``metrics_path``
    appends one ``{"kind": "eval", ...}`` JSON line."""
    out = {
        "train_seconds": fit_result.train_seconds,
        "final_loss": fit_result.final_loss,
        "epochs": len(fit_result.history),
        "history": fit_result.history,
        "world_processes": 1,
        "devices": 1,
    }
    if eval_metrics:
        out.update(eval_metrics)
    out.update(extra)
    if metrics_path and eval_metrics:
        scalars = {
            k: v for k, v in extra.items() if isinstance(v, (int, float, str))
        }
        with MetricsLogger(metrics_path) as sink:
            sink.write({"kind": "eval", **eval_metrics, **scalars})
    return out
