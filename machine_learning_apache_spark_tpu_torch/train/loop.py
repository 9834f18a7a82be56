"""Training/eval loop machinery — the port of
``machine_learning_apache_spark_tpu/train/loop.py`` on one device.

Every reference script re-implements the same loop inline (SURVEY.md §1 L7):
epochs × batches of {forward → loss → zero_grad → backward → step}, then an
eval pass, with wall-clock prints. Here the loop body is ``make_train_step``
and the Python loop only feeds batches and accumulates metrics.

The loss contract is the JAX package's with the module in place of the
parameter tree: ``loss_fn(model, batch, rng) -> (scalar_loss, aux_dict)``,
where ``rng`` is the step's dropout ``torch.Generator`` (None in eval).
``fit`` owns a host generator seeded from its ``rng`` and draws one seed
from it per step for the step's device generator — the counterpart of
``rng, step_rng = split(rng)``. Losses stay on the device between log
points, as in the JAX loop: no per-step host sync.

Single device only: the mesh, ZeRO, multi-step dispatch, checkpointing,
the profiler window and the replica sync check raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.telemetry.events import beacon_update
from machine_learning_apache_spark_tpu_torch.train.metrics import (
    MetricBundle,
    MetricsLogger,
)
from machine_learning_apache_spark_tpu_torch.train.state import TrainState
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger
from machine_learning_apache_spark_tpu_torch.utils.timing import Timer

log = get_logger(__name__)

LossFn = Callable[[nn.Module, Any, "torch.Generator | None"], tuple[torch.Tensor, dict]]

_SEED_RANGE = 2**63 - 1


def make_train_step(loss_fn: LossFn):
    """One training step: forward → loss → backward → the optimizer's
    chain (accumulate, clip, step) → zero_grad. Returns ``(state, loss,
    aux)`` with the loss and aux values as detached device tensors — no
    host sync."""

    def step(state: TrainState, batch, rng: torch.Generator | None):
        loss, aux = loss_fn(state.model, batch, rng)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def make_eval_step(loss_fn: LossFn):
    @torch.no_grad()
    def step(state: TrainState, batch, rng: torch.Generator | None):
        return loss_fn(state.model, batch, rng)

    return step


@dataclass
class FitResult:
    state: TrainState
    train_seconds: float
    history: list[dict] = field(default_factory=list)
    # Step the run resumed from; always None here (resume is not ported).
    resumed_step: int | None = None

    @property
    def final_loss(self) -> float:
        return self.history[-1]["loss"] if self.history else float("nan")


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def to_device(batch, device: torch.device):
    """A host batch (tuple of numpy arrays) → tensors on ``device``; token
    ids become int64. For the card the host arrays are pinned first: a copy
    from pageable memory would wait for the stream, serialising the host
    with every step."""
    out = []
    for a in batch:
        t = torch.as_tensor(np.asarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
        out.append(t if torch.is_floating_point(t) else t.long())
    return tuple(out)


def _unported(**given) -> None:
    """Raise for the first argument set away from its default."""
    items = {
        "mesh": ("A4 (distributed)", given["mesh"] is not None),
        "zero1": ("A4 (distributed)", given["zero1"]),
        "dp_mode": ("A4 (distributed)", given["dp_mode"] is not None),
        "dp_bucket_bytes": ("A4 (distributed)", given["dp_bucket_bytes"] is not None),
        "dp_comms_dtype": ("A4 (distributed)", given["dp_comms_dtype"] is not None),
        "dp_overlap": ("A4 (distributed)", given["dp_overlap"] is not None),
        "sync_check_every": ("A4 (distributed)", given["sync_check_every"] != 0),
        "steps_per_call": ("A1 (make_multi_step)", given["steps_per_call"] != 1),
        "checkpointer": ("A1 (train/checkpoint.py)", given["checkpointer"] is not None),
        "resume": ("A1 (train/checkpoint.py)", given["resume"]),
        "elastic": ("A4 (train/reshard.py)", given["elastic"] is not None),
        "profile_dir": ("A1 (profiler window)", given["profile_dir"] is not None),
    }
    for name, (item, set_) in items.items():
        if set_:
            raise NotImplementedError(
                f"fit({name}=...) is not ported yet (ROADMAP queue {item})"
            )


def fit(
    state: TrainState,
    loss_fn: LossFn,
    train_loader: Iterable | None = None,
    *,
    data: Iterable | None = None,
    epochs: int,
    rng: torch.Generator | None = None,
    mesh=None,
    log_every: int = 100,
    emit: Callable[[str], None] | None = None,
    checkpointer=None,
    checkpoint_every: int = 1,
    profile_dir: str | None = None,
    profile_window: tuple[int, int] = (2, 5),
    metrics_file: str | None = None,
    sync_check_every: int = 0,
    zero1: bool = False,
    dp_mode: str | None = None,
    dp_bucket_bytes: int | None = None,
    dp_comms_dtype: str | None = None,
    dp_overlap: bool | None = None,
    steps_per_call: int = 1,
    prefetch_to_device: int = 0,
    resume: bool = False,
    elastic: bool | None = None,
) -> FitResult:
    """The canonical loop (``pytorch_cnn.py:125-146`` shape): epochs ×
    batches, per-``log_every``-batch loss/time prints
    (``pytorch_machine_translator.py:199-205``), total wall time at the end.

    ``train_loader`` (or ``data=``) yields host batches of numpy arrays; if
    it has ``set_epoch``, it is called per epoch. Batches go to the model's
    device. ``rng`` is a CPU ``torch.Generator`` (default: seeded 0); one
    seed is drawn from it per step for that step's dropout generator on
    the device. ``metrics_file`` appends one JSON line per epoch and a
    final run record. The wall time blocks on the device before it stops.

    ``prefetch_to_device`` is accepted and, as in the JAX package without a
    mesh, has nothing to do. The state is updated in place and returned in
    the result."""
    _unported(
        mesh=mesh, zero1=zero1, dp_mode=dp_mode, dp_bucket_bytes=dp_bucket_bytes,
        dp_comms_dtype=dp_comms_dtype, dp_overlap=dp_overlap,
        sync_check_every=sync_check_every, steps_per_call=steps_per_call,
        checkpointer=checkpointer, resume=resume, elastic=elastic,
        profile_dir=profile_dir,
    )
    if data is not None:
        if train_loader is not None:
            raise ValueError("pass either train_loader or data=, not both")
        train_loader = data
    if train_loader is None:
        raise ValueError("fit needs a train_loader (or data=...)")
    emit = emit or log.info
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    device = _device_of(state)
    step_fn = make_train_step(loss_fn)
    sink = MetricsLogger(metrics_file) if metrics_file else None
    total_timer = Timer("train").start()
    span_timer = Timer("span").start()
    try:
        with telemetry.span("train.fit", epochs=epochs, steps_per_call=1, resumed_step=None):
            history = _run_epochs(
                state, step_fn, train_loader, epochs, rng, device, log_every,
                emit, span_timer, sink,
            )
        # Block on the device so the wall time includes its work.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = total_timer.stop()
        if sink is not None:
            sink.write({
                "kind": "run",
                "train_seconds": seconds,
                "epochs": len(history),
                "final_loss": history[-1].get("loss") if history else None,
            })
    finally:
        if sink is not None:
            sink.close()
    emit(f"Training Time: {seconds:.3f} sec")
    return FitResult(state=state, train_seconds=seconds, history=history)


def _drain_into(metrics: MetricBundle, pending: list, loss_name: str) -> None:
    """Move pending ``(loss, aux, n)`` device values to the host in one
    copy per metric and fold them into ``metrics``."""
    if not pending:
        return
    losses = torch.stack([p[0] for p in pending]).tolist()
    aux = {
        k: torch.stack([p[1][k] for p in pending]).tolist() for k in pending[0][1]
    }
    for i, (_, _, n) in enumerate(pending):
        metrics.mean(loss_name).update(losses[i], n)
        for k, vals in aux.items():
            metrics.mean(k).update(vals[i], n)
    pending.clear()


def _run_epochs(
    state, step_fn, train_loader, epochs, rng, device, log_every, emit,
    span_timer, sink,
):
    history: list[dict] = []
    step_rng = torch.Generator(device=device)
    global_step = 0
    last_emit_step = 0
    for epoch in range(epochs):
        with telemetry.span("train.epoch", epoch=epoch):
            beacon_update(phase="train", epoch=epoch, step=global_step)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            epoch_metrics = MetricBundle()
            # Step outputs stay on the device until a log point: reading
            # them per step would sync the host into every step.
            pending: list[tuple] = []
            for batch in train_loader:
                batch = to_device(batch, device)
                step_rng.manual_seed(
                    int(torch.randint(_SEED_RANGE, (), generator=rng))
                )
                with telemetry.span("train.step", step=global_step):
                    state, loss, aux = step_fn(state, batch, step_rng)
                global_step += 1
                pending.append((loss, aux, 1))
                if log_every and global_step % log_every == 0:
                    covered = global_step - last_emit_step
                    last_emit_step = global_step
                    beacon_update(phase="train", step=global_step)
                    _drain_into(epoch_metrics, pending, "loss")
                    emit(
                        f"epoch {epoch} step {global_step} | "
                        f"{epoch_metrics.log_line()} | "
                        f"{span_timer.lap():.3f} sec/{covered} batches"
                    )
            _drain_into(epoch_metrics, pending, "loss")
            computed = epoch_metrics.compute()
            computed["epoch"] = epoch
            history.append(computed)
            if sink is not None:
                sink.write({"kind": "epoch", "step": state.step, **computed})
            if log_every:
                emit(f"epoch {epoch} done | {epoch_metrics.log_line()}")
    return history


def evaluate(
    state: TrainState,
    loss_fn: LossFn,
    eval_loader: Iterable,
    *,
    mesh=None,
    rng: torch.Generator | None = None,
    emit: Callable[[str], None] | None = None,
) -> dict:
    """Eval pass: accumulated loss + metrics under ``torch.no_grad`` — the
    reference's ``model.eval()`` + ``no_grad`` + accuracy block
    (``pytorch_cnn.py:154-176``). ``rng`` (default None: no dropout) goes
    to the loss as is.

    Consumes the WHOLE loader, ragged tail included. Per-batch metrics are
    weighted by the batch's row count (not its token count), and the total
    is returned as ``eval_samples`` so callers can assert full coverage."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluate(mesh=...) is not ported yet (ROADMAP queue A4 (distributed))"
        )
    emit = emit or log.info
    device = _device_of(state)
    step_fn = make_eval_step(loss_fn)
    metrics = MetricBundle()
    pending: list[tuple] = []
    total = 0
    for batch in eval_loader:
        n = len(batch[0])
        loss, aux = step_fn(state, to_device(batch, device), rng)
        total += n
        pending.append((loss, aux, n))
    _drain_into(metrics, pending, "test_loss")
    out = metrics.compute()
    emit(" | ".join(f"{k}: {v:.5f}" for k, v in out.items()))
    out["eval_samples"] = total
    return out
