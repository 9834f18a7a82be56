"""MLP recipe — the reference's MLP entry points as one function (C3 + C4);
the port of ``machine_learning_apache_spark_tpu/recipes/mlp.py``.

Sequential form: ``pytorch_multilayer_perceptron.py:83-146`` — libsvm 4-class
data via Spark, 4-5-4-3 sigmoid MLP, CrossEntropy, SGD(lr=0.03), 100 epochs,
batch 30, 60/40 split, then an eval pass printing accuracy. The
distributed form (``distributed_multilayer_perceptron.py:96-181``) is the
same recipe under ``launcher.Distributor``: with ``use_mesh`` (the
default) each rank trains its ``DistributedSampler`` shard at
``batch_size`` rows and the gradients are all-reduced
(``recipes._common.resolve_mesh``, ``train.loop.fit(mesh=)``).

``train_mlp`` runs on the card unless ``device="cpu"`` is passed
(``utils.device.resolve_device``). ``steps_per_call=K`` runs K steps per
call (one CUDA graph on the card), ``checkpoint_dir`` saves and resumes
(``recipes._common.fit_recipe``), ``metrics_path`` appends JSON lines.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from machine_learning_apache_spark_tpu_torch.data.datasets import synthetic_multiclass
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
from machine_learning_apache_spark_tpu_torch.recipes._common import (
    fit_recipe,
    make_loaders,
    resolve_mesh,
    summarize,
    with_overrides,
)
from machine_learning_apache_spark_tpu_torch.train.loop import (
    classification_loss,
    evaluate,
)
from machine_learning_apache_spark_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
)
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device


@dataclass
class MLPRecipe:
    """Reference hypers (``pytorch_multilayer_perceptron.py:93-96``; split
    seed 1234 from ``mllib_multilayer_perceptron_classifier.py:27``). The
    fields and defaults are the JAX package's."""

    layers: tuple[int, ...] = (4, 5, 4, 3)
    epochs: int = 100
    learning_rate: float = 0.03
    batch_size: int = 30
    train_fraction: float = 0.6
    seed: int = 1234
    data_path: str | None = None  # libsvm file; None → synthetic blobs
    synthetic_n: int = 600
    use_mesh: bool = True
    log_every: int = 0  # the reference prints per-batch; default quiet
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    metrics_path: str | None = None
    steps_per_call: int = 1
    prefetch_to_device: int = 2


def train_mlp(
    recipe: MLPRecipe | None = None,
    *,
    device: str | torch.device | None = None,
    _return_classifier: bool = False,
    _return_state: bool = False,
    **overrides,
) -> dict:
    """Run the MLP workload end to end; returns the metric dict."""
    r = with_overrides(recipe or MLPRecipe(), overrides)
    dev = resolve_device(device)

    frame = (
        read_libsvm(r.data_path)
        if r.data_path
        else synthetic_multiclass(
            r.synthetic_n, num_features=r.layers[0], num_classes=r.layers[-1],
            seed=r.seed,
        )
    )
    mesh = resolve_mesh(r.use_mesh)
    train_frame, test_frame = frame.random_split(
        [r.train_fraction, 1 - r.train_fraction], seed=r.seed
    )
    train_loader, test_loader = make_loaders(
        ArrayDataset(*train_frame.arrays()), ArrayDataset(*test_frame.arrays()),
        batch_size=r.batch_size, mesh=mesh, seed=r.seed,
    )
    model = MLP(r.layers, generator=torch.Generator().manual_seed(r.seed)).to(dev)
    state = TrainState.create(model=model, tx=make_optimizer("sgd", r.learning_rate))
    result, resumed = fit_recipe(
        r, state, classification_loss(model), train_loader, mesh=mesh
    )
    metrics = evaluate(
        result.state, classification_loss(model, train=False), test_loader, mesh=mesh
    )
    extra = {"resumed_from_step": resumed} if resumed is not None else {}
    out = summarize(result, metrics, metrics_path=r.metrics_path, **extra)
    if _return_state:
        out["state"] = result.state
        out["fit_result"] = result
    if _return_classifier:
        from machine_learning_apache_spark_tpu_torch.inference import Classifier

        out["classifier"] = Classifier(model, device=dev)
    return out
