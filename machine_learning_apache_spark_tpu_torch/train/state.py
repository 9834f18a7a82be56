"""Train state: the model and its optimizer — the port of
``machine_learning_apache_spark_tpu/train/state.py``.

``make_optimizer`` covers the reference's optimizer vocabulary: SGD
(``pytorch_cnn.py:119`` lr=0.01, ``pytorch_multilayer_perceptron.py:96``
lr=0.03) and Adam (``pytorch_lstm.py:127`` lr=1e-3,
``pytorch_machine_translator.py:129``), plus AdamW — and the training-scale
knobs of the JAX package: learning-rate schedules (warmup/cosine),
global-norm gradient clipping, and gradient accumulation.

The JAX package builds these from optax; here each is written out with
optax's own formulas, so the same gradients give the same updates:

- schedules are optax's ``linear_schedule``, ``cosine_decay_schedule``
  (with ``alpha``) and ``warmup_cosine_decay_schedule``, evaluated at the
  update count *before* its increment, as ``scale_by_learning_rate`` does;
- clipping is ``clip_by_global_norm``: scale by ``max_norm / ‖g‖`` only when
  ``‖g‖ >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would divide by
  ``‖g‖ + 1e-6`` and always scale);
- accumulation is ``optax.MultiSteps``: a running mean of K microbatch
  gradients (``acc += (g − acc) / (i + 1)``), one real update on every K-th
  call, none in between, the counter carried across epochs;
- the update itself is ``torch.optim.SGD``/``Adam``/``AdamW`` with optax's
  defaults (``adamw``'s ``weight_decay`` is optax's 1e-4, not torch's 0.01);
  on the card it is built ``capturable`` (SGD ``fused``) with its lr in a
  device tensor, so an update issues no host value and a CUDA graph of
  several steps (``train.loop.make_multi_step``) can hold it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


def linear_schedule(
    init_value: float, end_value: float, transition_steps: int,
    transition_begin: int = 0,
) -> Schedule:
    """optax's ``linear_schedule`` (``polynomial_schedule`` of power 1)."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(
    init_value: float, decay_steps: int, alpha: float = 0.0,
    exponent: float = 1.0,
) -> Schedule:
    """optax's ``cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(
            f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}"
        )

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear warmup, then cosine
    decay over ``decay_steps − warmup_steps`` (``join_schedules`` at
    ``warmup_steps``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(
        peak_value, decay_steps - warmup_steps, alpha, exponent
    )

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def make_schedule(
    learning_rate: float,
    schedule: str | None = None,
    *,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    end_value: float = 0.0,
) -> float | Schedule:
    """Learning-rate schedule: ``None``/``"constant"`` (the reference's fixed
    lr), ``"cosine"`` (cosine decay to ``end_value`` over ``total_steps``),
    or ``"warmup_cosine"`` (linear 0→lr over ``warmup_steps``, then cosine).
    A constant comes back as the float itself, as in the JAX package."""
    if schedule in (None, "constant"):
        if warmup_steps:
            return linear_schedule(0.0, learning_rate, warmup_steps)
        return learning_rate
    if schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        if warmup_steps:  # cosine-with-warmup IS warmup_cosine; honor it
            schedule = "warmup_cosine"
        else:
            return cosine_decay_schedule(
                learning_rate, total_steps, alpha=end_value / learning_rate
            )
    if schedule == "warmup_cosine":
        if total_steps is None:
            raise ValueError("warmup_cosine schedule requires total_steps")
        return warmup_cosine_decay_schedule(
            0.0,
            learning_rate,
            warmup_steps,
            max(total_steps, warmup_steps + 1),
            end_value=end_value,
        )
    raise ValueError(f"unknown schedule {schedule!r}")


#: optax's argument names → torch's, per optimizer.
_OPTAX_KWARGS = {
    "sgd": ("momentum", "nesterov"),
    "adam": ("b1", "b2", "eps"),
    "adamw": ("b1", "b2", "eps", "weight_decay"),
}


@dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` returns: the torch optimizer to build and
    the optax chain around it — schedule, clip norm, accumulation count.
    ``build(params)`` makes the ``torch.optim`` instance.

    On the card the optimizer takes its learning rate from a device
    tensor and keeps its state there (Adam/AdamW ``capturable=True``, SGD
    ``fused=True``), so an update issues no host value and a CUDA graph
    can hold it; every update on the card, eager or replayed, runs this
    one setup. On the CPU the lr is a Python float, as torch's defaults
    take it."""

    name: str
    schedule: Schedule
    grad_clip: float | None = None
    accumulate_steps: int = 1
    kwargs: dict = field(default_factory=dict)

    def build(self, params) -> torch.optim.Optimizer:
        params = list(params)
        kw = dict(self.kwargs)
        lr = self.schedule(0)
        on_card = bool(params) and params[0].device.type == "cuda"
        if on_card:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        if self.name == "sgd":
            return torch.optim.SGD(
                params, lr=lr, momentum=kw.get("momentum") or 0.0,
                nesterov=bool(kw.get("nesterov", False)),
                fused=True if on_card else None,
            )
        betas = (kw.get("b1", 0.9), kw.get("b2", 0.999))
        eps = kw.get("eps", 1e-8)
        if self.name == "adam":
            return torch.optim.Adam(
                params, lr=lr, betas=betas, eps=eps, capturable=on_card
            )
        return torch.optim.AdamW(
            params, lr=lr, betas=betas, eps=eps,
            weight_decay=kw.get("weight_decay", 1e-4), capturable=on_card,
        )


def make_optimizer(
    name: str = "adam",
    learning_rate: float | Schedule = 1e-3,
    *,
    schedule: str | None = None,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    grad_clip: float | None = None,
    accumulate_steps: int = 1,
    **kw,
) -> Optimizer:
    """Optimizer with optional schedule, clipping, and accumulation.

    ``accumulate_steps=K`` averages K calls' gradients and makes one real
    parameter update (none in between), so ``fit`` needs no special
    handling — the effective batch is K × the loader batch. Extra keyword
    arguments take optax's names: ``momentum``/``nesterov`` for ``sgd``;
    ``b1``, ``b2``, ``eps`` (and ``weight_decay`` for ``adamw``)."""
    if isinstance(learning_rate, (int, float)):
        lr = make_schedule(
            learning_rate, schedule, warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
    else:
        if schedule is not None or warmup_steps:
            raise ValueError(
                "learning_rate is already a schedule callable; "
                "schedule/warmup_steps would be silently ignored"
            )
        lr = learning_rate
    name = name.lower()
    if name not in _OPTAX_KWARGS:
        raise ValueError(f"unknown optimizer {name!r}")
    unknown = set(kw) - set(_OPTAX_KWARGS[name])
    if unknown:
        raise TypeError(f"{name}: unsupported arguments {sorted(unknown)}")
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    if isinstance(lr, (int, float)):
        value = float(lr)
        lr = lambda count: value  # noqa: E731
    return Optimizer(name, lr, grad_clip, accumulate_steps, dict(kw))


def clip_by_global_norm(grads: list, norm: torch.Tensor, max_norm: float) -> list:
    """optax's ``clip_by_global_norm`` given the global norm: each tensor
    scaled by ``max_norm / norm`` only when ``norm >= max_norm``."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


@dataclass
class TrainState:
    """The model (its parameters), the optimizer and its optax chain, and
    the counters: ``step`` counts ``apply_gradients`` calls (microbatches,
    as the JAX ``TrainState.step`` does), ``updates`` the real optimizer
    updates (the schedule's count), ``mini_step`` the accumulation phase;
    ``acc_grads`` is ``optax.MultiSteps``' running mean (one buffer per
    parameter, zeros between updates; None without accumulation);
    ``mesh`` is the mesh it trains on, for the checkpoint's stamp.

    ``apply_gradients`` is one update with its host bookkeeping. A
    program of several steps (``train.loop.make_multi_step``) runs
    ``update_on_device`` per step, which issues device work only, and
    the caller moves the counters with ``advance`` after it."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Optimizer
    step: int = 0
    updates: int = 0
    mini_step: int = 0
    acc_grads: list | None = None
    # The ``parallel.mesh.Mesh`` this state trains on (``fit(mesh=)`` sets
    # it), which a checkpoint's topology stamp records; None for one
    # process without a mesh.
    mesh: object | None = None

    @classmethod
    def create(cls, *, model: nn.Module, tx: Optimizer) -> "TrainState":
        state = cls(model=model, optimizer=tx.build(model.parameters()), tx=tx)
        if tx.accumulate_steps > 1:
            state.acc_grads = [torch.zeros_like(p) for p in state.params]
        return state

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def lr_tensor(self) -> torch.Tensor | None:
        """The card's lr tensor (every group shares it), None on the CPU."""
        lr = self.optimizer.param_groups[0]["lr"]
        return lr if isinstance(lr, torch.Tensor) else None

    def emits(self, mini_step: int) -> bool:
        """Whether the update at accumulation phase ``mini_step`` steps
        the optimizer (every ``accumulate_steps``-th call does)."""
        return (mini_step + 1) % self.tx.accumulate_steps == 0

    def scheduled_lrs(self, n: int) -> np.ndarray:
        """float64 ``[n]``: the lr each of the next ``n`` updates uses
        (the schedule at the update count each would step at; a call
        that only accumulates gets the next one's, unused)."""
        out = np.empty(n, np.float64)
        updates = self.updates
        for i in range(n):
            out[i] = self.tx.schedule(updates)
            updates += self.emits(self.mini_step + i)
        return out

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One optax-chain update from the gradients in ``p.grad`` (a
        missing grad counts as zeros): accumulate, then on an emitting
        call clip, set the scheduled lr, step the torch optimizer; always
        clear the grads. Runs on the parameters' device without a host
        sync."""
        self.update_on_device(self.mini_step, self.tx.schedule(self.updates))
        self.advance(1)

    def advance(self, n: int) -> None:
        """Move the host counters past ``n`` updates."""
        k = self.tx.accumulate_steps
        self.updates += sum(self.emits(self.mini_step + i) for i in range(n))
        self.step += n
        self.mini_step = (self.mini_step + n) % k

    @torch.no_grad()
    def update_on_device(self, mini_step: int, lr: float | torch.Tensor) -> None:
        """The device work of one update at accumulation phase
        ``mini_step``: accumulate, and if it emits, clip, set the lr
        (a float, or a 0-d device tensor a program takes as its input)
        and step the optimizer. Touches no host counter."""
        params = self.params
        grads = [
            p.grad if p.grad is not None else torch.zeros_like(p) for p in params
        ]
        if self.acc_grads is not None:
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (mini_step + 1))
            if not self.emits(mini_step):
                for p in params:
                    p.grad = None
                return
            grads = self.acc_grads
        if self.tx.grad_clip is not None:
            # (Imported here: the parallel package imports this module.)
            from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
                global_sq_norm,
            )

            grads = clip_by_global_norm(
                grads, torch.sqrt(global_sq_norm(params, grads)), self.tx.grad_clip
            )
        self.set_lr(lr)
        self._step_optimizer(params, grads)
        if self.acc_grads is not None:
            for acc in self.acc_grads:  # optax resets the accumulator to zeros
                acc.zero_()

    def set_lr(self, lr: float | torch.Tensor) -> None:
        """The lr of the next optimizer step: a float, or a 0-d device
        tensor a program takes as its input."""
        if isinstance(lr, torch.Tensor):
            self.lr_tensor.copy_(lr)
        elif self.lr_tensor is not None:
            # The float32 a program's lr input would hold.
            self.lr_tensor.fill_(float(np.float32(lr)))
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def _step_optimizer(self, params: list, grads: list) -> None:
        """One step of the torch optimizer on ``grads``, then the grads
        cleared."""
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- checkpoint payload ---------------------------------------------------

    def state_dict(self) -> dict:
        """What a checkpoint holds: the counters, the accumulator, the
        model's and the optimizer's state (device tensors; the caller
        copies them to the host)."""
        return {
            "step": self.step,
            "updates": self.updates,
            "mini_step": self.mini_step,
            "acc_grads": self.acc_grads,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict()["state"],
        }

    @torch.no_grad()
    def load_state_dict(self, payload: dict) -> None:
        """Restore ``payload`` (``state_dict``'s form, on any device) into
        this state: parameters and the accumulator are copied in place;
        the optimizer's per-parameter state is loaded under this state's
        own param groups (its lr tensor, ``capturable``/``fused`` flags
        and hyperparameters stay). The optimizer's state tensors are new
        ones afterwards: a program captured before holds the old ones."""
        acc = payload["acc_grads"]
        if (acc is None) != (self.acc_grads is None):
            raise ValueError(
                "checkpoint accumulator does not match accumulate_steps="
                f"{self.tx.accumulate_steps}"
            )
        self.model.load_state_dict(payload["model"])
        groups = self.optimizer.state_dict()["param_groups"]
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(
            {"state": payload["optimizer"], "param_groups": groups}
        )
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        if acc is not None:
            for buf, saved in zip(self.acc_grads, acc):
                buf.copy_(saved)
        self.step = int(payload["step"])
        self.updates = int(payload["updates"])
        self.mini_step = int(payload["mini_step"])
