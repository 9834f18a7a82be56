"""Shared recipe plumbing — the port of
``machine_learning_apache_spark_tpu/recipes/_common.py``.

A recipe is one reference entry-point script: data resolution, mesh and
world bring-up (``resolve_mesh``: a data-parallel mesh over the gang when
the recipe runs under ``launcher.Distributor``, none for one process),
the fit/evaluate calls and a picklable result dict (the launcher returns
rank 0's result across a process boundary — ``distributor.run``
contract, ``distributed_cnn.py:231``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch.data.loader import (
    ArrayDataset,
    DataLoader,
)
from machine_learning_apache_spark_tpu_torch.data.sampler import DistributedSampler
from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_parallel_mesh,
    process_count,
    process_index,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import MetricsLogger
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


#: The compute dtypes the port runs: its kernels are instantiated for both.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_compute_dtype(override: str | torch.dtype | None = None) -> torch.dtype:
    """Platform-default compute dtype, the JAX package's rule: bfloat16 on
    a TPU (full-rate MXU), float32 elsewhere — so float32 in the port,
    which runs on no TPU. An explicit ``"float32"`` or ``"bfloat16"`` (or
    the torch dtype) wins. A name of another dtype that JAX would take
    (``"float16"``, ``"float64"``, ...) raises ``NotImplementedError``: no
    kernel is built for it. A string that names no dtype raises
    ``TypeError``, as ``jnp.dtype`` does."""
    if override is None:
        return torch.float32
    if isinstance(override, torch.dtype) and override in COMPUTE_DTYPES.values():
        return override
    if isinstance(override, str) and override in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[override]
    try:
        name = np.dtype(override).name
    except TypeError:
        raise TypeError(f"data type {override!r} not understood") from None
    raise NotImplementedError(
        f"compute dtype {name!r} is not ported: the port's kernels take "
        f"{' and '.join(COMPUTE_DTYPES)}"
    )


def with_overrides(recipe, overrides: dict):
    """``dataclasses.replace`` with the no-override fast path — the shared
    ``train_x(recipe, **overrides)`` config idiom."""
    return dataclasses.replace(recipe, **overrides) if overrides else recipe


def resolve_mesh(
    use_mesh: bool = True,
    *,
    model_parallel: int = 1,
    sequence_parallel: int = 1,
    expert_parallel: int = 1,
    pipeline_parallel: int = 1,
):
    """The recipe's mesh, or None when a mesh buys nothing — the JAX
    package's rules, with one device per process: under a gang of several
    processes a data-parallel mesh over all of them; for one process none.

    ``use_mesh=False`` under a gang raises ``ValueError`` (each rank would
    train an unsynchronized replica, and rank 0's metrics would pass for a
    full-data run), as does any other parallelism without a mesh or with
    one device. ``model_parallel=M`` carves the inner ``"model"`` axis
    (tensor parallelism, ``{data: world/M, model: M}``) and
    ``pipeline_parallel=S`` the ``"pipeline"`` axis (``{data: world/S,
    pipeline: S}``), ``sequence_parallel=N`` the ``"seq"`` axis
    (``{data: world/N, seq: N}``) and ``expert_parallel=N`` the
    ``"expert"`` axis (``{data: world/N, expert: N}``, with
    ``model_parallel=M`` beside it ``{data: world/(N·M), expert: N,
    model: M}``); the seq axis composes with both (``{data, expert, seq,
    model}``, canonical order), and beside a pipeline axis ``make_mesh``
    raises the JAX recipe's ``ValueError``."""
    extra = {
        "model_parallel": model_parallel,
        "sequence_parallel": sequence_parallel,
        "expert_parallel": expert_parallel,
        "pipeline_parallel": pipeline_parallel,
    }
    any_extra = any(v > 1 for v in extra.values())
    world = process_count()
    if world > 1 and not use_mesh:
        raise ValueError(
            "use_mesh=False under a multi-process gang would train "
            "independent unsynchronized replicas; run single-process or "
            "keep use_mesh=True"
        )
    if not use_mesh and any_extra:
        raise ValueError(
            "model/sequence/expert parallelism requires use_mesh=True"
        )
    if world == 1 and any_extra:
        # Never silently drop a requested parallelism mode.
        raise ValueError(f"{extra} requested but only {world} device(s) are available")
    if use_mesh and world > 1:
        from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
            EXPERT_AXIS,
            MODEL_AXIS,
            PIPELINE_AXIS,
            SEQ_AXIS,
            make_mesh,
        )

        axes = {DATA_AXIS: -1}
        if pipeline_parallel > 1:
            axes[PIPELINE_AXIS] = pipeline_parallel
        if expert_parallel > 1:
            axes[EXPERT_AXIS] = expert_parallel
        if model_parallel > 1:
            axes[MODEL_AXIS] = model_parallel
        if sequence_parallel > 1:
            axes[SEQ_AXIS] = sequence_parallel
        if len(axes) > 1:
            return make_mesh(axes, world=world)
        return data_parallel_mesh()
    return None


def data_replicas(mesh=None) -> tuple[int, int]:
    """``(num_replicas, rank)`` for the samplers: the data axis's size and
    this process's index on it (the ranks of one model line, of one
    pipeline line, of one seq line or of one expert line read the same
    rows); without a mesh, the gang's processes."""
    if mesh is None:
        return process_count(), process_index()
    return mesh.shape.get(DATA_AXIS, 1), mesh.index(DATA_AXIS)


def make_bucketed_loader(
    loader_cls,
    *streams,
    batch_size: int,
    mesh=None,
    full_width: int,
    boundaries: tuple[int, ...] = (),
    seed: int = 0,
):
    """Shared bucketed-loader construction for recipes: default boundaries
    at (1/4, 1/2, full) of the fixed width, the per-replica batch on each
    data replica (each takes its slice of every bucket; one device per
    process, so a process's share is one replica's), and a loud error
    when the batch leaves every bucket short of one full batch
    (``drop_last`` inside each bucket would otherwise "train" on zero
    batches)."""
    boundaries = boundaries or tuple(
        sorted({max(full_width // 4, 8), max(full_width // 2, 8), full_width})
    )
    replicas, rank = data_replicas(mesh)
    loader = loader_cls(
        *streams, batch_size=batch_size, boundaries=boundaries, seed=seed,
        num_replicas=replicas, rank=rank,
    )
    if len(loader) == 0:
        raise ValueError(
            f"batch_size={batch_size} leaves every length bucket "
            f"({boundaries}) short of one full batch; shrink the batch or "
            "provide more data"
        )
    return loader


def make_loaders(
    train_ds: ArrayDataset | None,
    test_ds: ArrayDataset | None,
    *,
    batch_size: int,
    mesh=None,
    seed: int = 0,
    collate: Callable[[tuple], Any] | None = None,
) -> tuple[DataLoader | None, DataLoader | None]:
    """The JAX package's loader rules, mesh-aware.

    ``batch_size`` is **per replica**, as in the reference, which shards
    the dataset across ranks (``DistributedSampler`` + per-rank loaders,
    ``distributed_cnn.py:112-124``): under a gang each rank samples its
    shard at ``batch_size`` rows (one device per process), so the global
    batch is ``batch_size`` × the data axis's size. The batch is clamped to what the
    split can fill once; ``drop_last=True`` on the train loader (one
    static shape), ``drop_last=False`` on the test loader so eval scores
    every row (``train.loop.evaluate``)."""
    world = process_count()
    replicas, rank = data_replicas(mesh)

    def _clamped(n_rows: int, want: int, split: str) -> int:
        if mesh is None:
            return min(want, max(n_rows, 1))
        if n_rows == 0:
            raise ValueError(
                f"{split} split (0 rows on this process) cannot fill one "
                "row; provide more data or a smaller mesh"
            )
        if want > n_rows:
            log.warning(
                "%s batch %d exceeds the %d-row split; clamping to %d",
                split, want, n_rows, n_rows,
            )
        return min(want, n_rows)

    train_loader = None
    if train_ds is not None:  # None: the caller brings its own (bucketed)
        sampler = (
            DistributedSampler(len(train_ds), replicas, rank, seed=seed) if world > 1 else None
        )
        n_train = len(sampler) if sampler is not None else len(train_ds)
        train_loader = DataLoader(
            train_ds,
            _clamped(n_train, batch_size, "train"),
            shuffle=sampler is None,
            sampler=sampler,
            drop_last=True,
            seed=seed,
            collate=collate,
            # Assemble ahead on a background thread while the card trains.
            prefetch=2,
        )
    test_loader = None
    if test_ds is not None:
        test_sampler = (
            DistributedSampler(len(test_ds), replicas, rank, shuffle=False, seed=seed)
            if world > 1 else None
        )
        n_test = len(test_sampler) if test_sampler is not None else len(test_ds)
        test_loader = DataLoader(
            test_ds,
            _clamped(n_test, batch_size, "test"),
            sampler=test_sampler,
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
    ``close()`` it when done — or use ``checkpointing``, which does.

    In a gang of several processes each rank checkpoints to its own
    ``<checkpoint_dir>/ckpt_r<rank>`` (the checkpoint group convention),
    and the resume is the group-capped ``restore_latest_valid``: every
    rank restores the newest step complete on all of them, or none."""
    if not checkpoint_dir:
        return None, state, None
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    directory = checkpoint_dir
    if process_count() > 1:
        directory = os.path.join(checkpoint_dir, f"ckpt_r{process_index()}")
    mgr = CheckpointManager(
        directory, max_to_keep=max_to_keep, run=envcfg.get_str("MLSPARK_GANG_RUN")
    )
    resumed = None
    if resume:
        restored = mgr.restore_latest_valid(state)
        if restored is not None:
            state, resumed, _ = restored
            log.info("resuming from checkpoint step %d", resumed)
    return mgr, state, resumed


def resume_epochs(ckpt, resumed: int, epochs: int) -> int:
    """The epoch count ``fit`` runs to after resuming step ``resumed``.

    A retried attempt of the same gang run (the step's sidecar carries
    this run's ``MLSPARK_GANG_RUN`` id) finishes the interrupted run: to
    the epoch count that run was given. Otherwise ``epochs`` more,
    numbered on from the checkpoint's — a new run over an old checkpoint
    directory trains on."""
    meta = ckpt.read_meta(resumed)
    if ckpt.run is not None and meta.get("run") == ckpt.run and "epochs" in meta:
        return int(meta["epochs"])
    return epochs + int(meta.get("epoch", -1)) + 1


def data_parallel_state(state, mesh):
    """``state`` as ``fit(mesh=)`` trains it under the gang's data-parallel
    mode (``MLSPARK_DP_MODE``, which ``Distributor(dp_mode=)`` sets) and
    the mesh's model and expert axes: a ZeRO-1 gang's state is sharded
    here, and a tensor- or expert-parallel state takes this rank's model
    and expert shards, before the recipe's checkpoint restore, so that the
    restore finds the layout its checkpoints hold."""
    from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel, zero

    if mesh is None:
        return state
    if zero.resolve_dp_mode(None) == "zero1":
        return zero.shard_optimizer_state(state, mesh, zero.Zero1Config.from_env())
    return tensor_parallel.shard_state(state, mesh)


def fit_recipe(r, state, loss_fn, train_loader, mesh=None):
    """``fit`` under a recipe's training fields (``epochs``, ``seed``,
    ``log_every``, ``checkpoint_dir``/``checkpoint_every``/``resume``,
    ``metrics_path``, ``steps_per_call``, ``prefetch_to_device``).
    Returns ``(FitResult, resumed_step_or_None)``.

    With a checkpoint to resume from, the run trains ``r.epochs`` more
    epochs numbered on from the checkpoint's, with its loader order and
    dropout stream, so a run cut at an epoch boundary and resumed trains
    as the uninterrupted run would; a retried gang attempt finishes its
    own run instead (``resume_epochs``)."""
    from machine_learning_apache_spark_tpu_torch.train.loop import fit

    # The restore below checks the checkpoints' topology stamp, which
    # names the mesh the state trains on and its data-parallel layout.
    state = data_parallel_state(state, mesh)
    state.mesh = mesh
    with checkpointing(r.checkpoint_dir, state, resume=r.resume) as (ckpt, state, resumed):
        epochs = r.epochs
        if resumed is not None:
            epochs = resume_epochs(ckpt, resumed, r.epochs)
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
            mesh=mesh,
        )
    return result, resumed


def summarize(
    fit_result, eval_metrics: dict | None, *, metrics_path: str | None = None,
    **extra,
) -> dict:
    """The printable/picklable end-of-run contract — the reference's metric
    vocabulary (train wall time, losses, eval metrics, the gang's world).
    ``metrics_path`` appends one ``{"kind": "eval", ...}`` JSON line (rank
    0 only)."""
    out = {
        "train_seconds": fit_result.train_seconds,
        "final_loss": fit_result.final_loss,
        "epochs": len(fit_result.history),
        "history": fit_result.history,
        # One device per process: the world is both counts.
        "world_processes": process_count(),
        "devices": process_count(),
    }
    if eval_metrics:
        out.update(eval_metrics)
    out.update(extra)
    if metrics_path and eval_metrics and process_index() == 0:
        scalars = {
            k: v for k, v in extra.items() if isinstance(v, (int, float, str))
        }
        with MetricsLogger(metrics_path) as sink:
            sink.write({"kind": "eval", **eval_metrics, **scalars})
    return out
