"""MLlib-parity MLP classifier: full-batch L-BFGS training; the port of
``machine_learning_apache_spark_tpu/mllib/classifier.py``.

Reference C1 (``mllib_multilayer_perceptron_classifier.py:32-39``):
``MultilayerPerceptronClassifier(layers=[4,5,4,3], maxIter=100, blockSize=30,
seed=1234, solver='l-bfgs', stepSize=0.03)`` then ``trainer.fit(train)`` /
``model.transform(test)``. MLlib's engine is breeze L-BFGS over the full
dataset; its MLP topology is sigmoid hidden layers with a softmax output
trained on cross-entropy.

The JAX package runs optax's L-BFGS for ``maxIter`` iterations as one
compiled scan; here the same algorithm (``mllib.lbfgs``) runs eagerly,
one iteration after another, over the parameters as one flat float32
vector on the device (the full-batch loss and gradient through the
port's ``MLP``), with the JAX fit's ``tol`` rule: from the iteration
after the loss improvement first falls below ``tol``, the parameters and
the optimizer state stay as they are and every later iteration records
the same loss. ``fit`` runs on the card unless ``device="cpu"`` is
passed. ``fit(mesh=)`` over a gang is MLlib's treeAggregate: each rank
holds its block of the rows, and every loss-and-gradient evaluation sums
the ranks' parts with one all-reduce, so every rank walks the same
L-BFGS.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch.data.frame import ArrayFrame
from machine_learning_apache_spark_tpu_torch.mllib.lbfgs import LBFGS, F32
from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
from machine_learning_apache_spark_tpu_torch.train.losses import cross_entropy
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
)

log = get_logger(__name__)


@dataclass
class PredictionFrame:
    """``model.transform(df)`` output: the input columns plus a
    ``prediction`` column (the MLlib DataFrame contract,
    ``mllib_multilayer_perceptron_classifier.py:45``)."""

    features: np.ndarray
    labels: np.ndarray
    predictions: np.ndarray

    def select(self, *cols: str) -> tuple[np.ndarray, ...]:
        mapping = {
            "features": self.features,
            "label": self.labels,
            "prediction": self.predictions,
        }
        return tuple(mapping[c] for c in cols)


@dataclass
class MultilayerPerceptronClassificationModel:
    """Fitted model — the transformer half of the estimator/transformer
    pair. ``mlp`` holds the trained weights on the fit's device;
    ``loss_history`` is one loss per iteration (``maxIter`` of them),
    ``iterations`` the iterations that updated the parameters (the
    count the JAX fit logs), ``fit_seconds`` the fit's wall time,
    ``evaluations`` the loss-and-gradient evaluations (line-search trials
    included) and ``allreduces`` the gang all-reduces (one per
    evaluation over a mesh of several processes, else 0)."""

    mlp: MLP
    loss_history: np.ndarray = field(repr=False, default=None)
    iterations: int = 0
    fit_seconds: float = 0.0
    evaluations: int = 0
    allreduces: int = 0

    @property
    def params(self) -> dict:
        """The trained weights as a Flax tree (the JAX model's ``params``)."""
        return export_flax_params(self.mlp)

    @torch.no_grad()
    def transform(self, frame: ArrayFrame) -> PredictionFrame:
        features, labels = frame.arrays()
        device = next(self.mlp.parameters()).device
        logits = self.mlp(torch.as_tensor(features, device=device))
        preds = torch.argmax(logits, dim=-1).cpu().numpy()
        return PredictionFrame(features, labels, preds)


class _FlatParams:
    """The MLP's parameters as one flat vector in the Flax tree's order
    (per layer its bias, then its ``[in, out]`` kernel), and the loss as
    a function of that vector."""

    def __init__(self, mlp: MLP):
        self.mlp = mlp
        self.entries = []  # (torch name, Flax shape, transpose)
        for i in range(len(mlp.layers) - 1):
            dense = getattr(mlp, f"dense_{i}")
            self.entries.append((f"dense_{i}.bias", tuple(dense.bias.shape), False))
            self.entries.append((f"dense_{i}.weight", tuple(dense.weight.T.shape), True))

    def flatten(self) -> torch.Tensor:
        params = dict(self.mlp.named_parameters())
        return torch.cat([
            (params[name].T if t else params[name]).reshape(-1).detach()
            for name, _, t in self.entries
        ])

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        out, start = {}, 0
        for name, shape, t in self.entries:
            n = int(np.prod(shape))
            leaf = flat[start : start + n].view(shape)
            out[name] = leaf.T if t else leaf
            start += n
        return out

    @torch.no_grad()
    def assign(self, flat: torch.Tensor) -> None:
        params = dict(self.mlp.named_parameters())
        for name, value in self.unflatten(flat).items():
            params[name].copy_(value)


@dataclass
class MultilayerPerceptronClassifier:
    """Estimator with the MLlib constructor surface
    (``mllib_multilayer_perceptron_classifier.py:32-35``).

    ``blockSize`` is accepted for parity; it is a JVM data-stacking
    performance knob with no meaning here (the full batch is one
    forward). ``stepSize`` applies only to ``solver='gd'`` — MLlib's own
    documented semantics (l-bfgs uses its linesearch instead). ``tol`` is
    the convergence test on per-iteration loss improvement; once met, the
    remaining iterations leave the parameters as they are.
    """

    layers: Sequence[int] = (4, 5, 4, 3)
    maxIter: int = 100
    blockSize: int = 30
    seed: int = 1234
    solver: str = "l-bfgs"
    stepSize: float = 0.03
    tol: float = 1e-6

    def setParams(self, **kw) -> "MultilayerPerceptronClassifier":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown param {k!r}")
            setattr(self, k, v)
        return self

    def fit(
        self,
        frame: ArrayFrame,
        mesh=None,
        *,
        device: str | torch.device | None = None,
        initial_params: dict | None = None,
    ) -> MultilayerPerceptronClassificationModel:
        """Full-batch fit on ``device`` (the card unless ``"cpu"``; in a
        gang, the rank's own device).

        The MLP starts from Flax's initialisers drawn from ``seed`` with a
        ``torch.Generator``, or from ``initial_params`` (a Flax-layout tree,
        e.g. the JAX fit's initial parameters) when given — the same on
        every rank.

        ``mesh`` (a ``parallel.mesh.Mesh`` over the gang) shards the rows
        over ``"data"`` as the JAX fit does: padded with zero-weight rows
        to a multiple of the world, each rank takes its contiguous block
        (``batch_sharding``'s order). Every loss-and-gradient evaluation,
        line-search trials included, all-reduces ``[Σ w·loss, Σ w, Σ
        ∇(w·loss)]`` (one collective) and divides, so every rank takes the
        same steps; each returns the model. A mesh of one process is the
        single-device fit, bit for bit."""
        solver = self.solver.lower()
        if solver not in ("l-bfgs", "lbfgs", "gd"):
            raise ValueError(f"unsupported solver {self.solver!r}")
        world = mesh.size if mesh is not None else 1
        dev = mesh.device if world > 1 and device is None else resolve_device(device)
        features, labels = frame.arrays()
        x = torch.as_tensor(features, device=dev)
        y = torch.as_tensor(labels, device=dev)
        mlp = MLP(tuple(self.layers), generator=torch.Generator().manual_seed(self.seed))
        if initial_params is not None:
            load_flax_params(mlp, initial_params)
        mlp.to(dev)
        flat = _FlatParams(mlp)
        n = x.shape[0]
        counts = {"evaluations": 0, "allreduces": 0}

        if world == 1:
            def value_and_grad(w: torch.Tensor):
                counts["evaluations"] += 1
                w = w.detach().requires_grad_(True)
                with torch.enable_grad():
                    logits = torch.func.functional_call(mlp, flat.unflatten(w), (x,))
                    # The JAX fit's weighted mean, every row at weight one.
                    value = torch.sum(cross_entropy(logits, y, reduction="none")) / n
                    (grad,) = torch.autograd.grad(value, w)
                return value.detach(), grad
        else:
            x, y, weights = _row_block(x, y, world, mesh.rank)

            def value_and_grad(w: torch.Tensor):
                counts["evaluations"] += 1
                counts["allreduces"] += 1
                w = w.detach().requires_grad_(True)
                with torch.enable_grad():
                    logits = torch.func.functional_call(mlp, flat.unflatten(w), (x,))
                    part = torch.sum(cross_entropy(logits, y, reduction="none") * weights)
                    (grad,) = torch.autograd.grad(part, w)
                # MLlib's treeAggregate: the gang's sums, then the mean.
                sums = torch.cat([part.detach().reshape(1), weights.sum().reshape(1), grad])
                mesh.all_reduce_(sums)
                return sums[0] / sums[1], sums[2:] / sums[1]

        t0 = time.perf_counter()
        w = flat.flatten()
        if solver == "gd":
            state = None

            def step(w, state):  # optax.sgd(stepSize)
                v, g = value_and_grad(w)
                return F32(v.item()), w - self.stepSize * g, None
        else:
            opt = LBFGS()
            state = opt.init(w)

            def step(w, state):
                value, g = opt.value_and_grad(value_and_grad, w, state)
                updates, state = opt.update(
                    g, state, w, value=value, value_and_grad=value_and_grad
                )
                return value, w + updates, state

        history: list[np.float32] = []
        prev, done, frozen = F32(np.inf), False, None
        iterations = 0
        with np.errstate(invalid="ignore"):
            for _ in range(self.maxIter):
                if done:
                    # The frozen carry's loss, the same every iteration.
                    if frozen is None:
                        frozen = (
                            opt.value_and_grad(value_and_grad, w, state)[0]
                            if state is not None else F32(value_and_grad(w)[0].item())
                        )
                    history.append(frozen)
                    continue
                value, w, state = step(w, state)
                iterations += 1
                history.append(value)
                done = bool(abs(prev - value) < F32(self.tol))
                prev = value
        flat.assign(w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        history_arr = np.asarray(history, dtype=np.float32)
        if history_arr.size:
            log.info(
                "%s: loss %.6f -> %.6f, %s after %d/%d iterations",
                solver, history_arr[0], history_arr[-1],
                "converged" if iterations < self.maxIter else "stopped",
                iterations, self.maxIter,
            )
        return MultilayerPerceptronClassificationModel(
            mlp=mlp, loss_history=history_arr, iterations=iterations,
            fit_seconds=seconds, **counts,
        )


def _row_block(x: torch.Tensor, y: torch.Tensor, world: int, rank: int):
    """This rank's contiguous block of the full batch after padding with
    zero rows to a multiple of ``world``, and the block's row weights
    (1 for a real row, 0 for padding)."""
    n = x.shape[0]
    pad = (-n) % world
    weights = torch.ones(n, dtype=torch.float32, device=x.device)
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = torch.cat([y, y.new_zeros((pad,))])
        weights = torch.cat([weights, weights.new_zeros((pad,))])
    per = (n + pad) // world
    rows = slice(rank * per, (rank + 1) * per)
    return x[rows], y[rows], weights[rows]
