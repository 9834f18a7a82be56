"""CNN recipe — the FashionMNIST workload (C6 + C7); the port of
``machine_learning_apache_spark_tpu/recipes/cnn.py``.

Sequential form: ``pytorch_cnn.py:101-180`` — TinyVGG (1 input channel, 10
hidden units, 10 classes), CrossEntropy, SGD(lr=0.01), 3 epochs, batch 32,
then the eval pass. ``dataset="cifar10"`` trains on the CIFAR-10 binary
batches (32×32×3), the ``BASELINE.json`` distributed-CNN workload. The
training loop iterates the *train* loader (fixing quirk Q1) and the eval
pass actually runs (fixing Q7).

``train_cnn`` runs on the card unless ``device="cpu"`` is passed; there
the convolutions are cuDNN's with deterministic algorithms
(``utils.device.resolve_device``), so ``steps_per_call=K`` trains bit for
bit like K = 1. Checkpoint and resume as in ``recipes._common.fit_recipe``.
Under ``launcher.Distributor`` it is ``distributed_cnn.py``'s gang: each
rank trains its ``DistributedSampler`` shard and the gradients are
all-reduced (``use_mesh``, the default; ``train.loop.fit(mesh=)``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from machine_learning_apache_spark_tpu_torch.data.datasets import (
    load_cifar10,
    load_fashion_mnist,
    synthetic_image_classification,
)
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
from machine_learning_apache_spark_tpu_torch.models.cnn import TinyVGG
from machine_learning_apache_spark_tpu_torch.recipes._common import (
    default_compute_dtype,
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
class CNNRecipe:
    """Reference hypers: ``pytorch_cnn.py:72,94-96,119`` (BATCH_SIZE=32,
    hidden_units=10, SGD lr=0.01, 3 epochs). The fields and defaults are
    the JAX package's."""

    hidden_units: int = 10
    num_classes: int = 10
    epochs: int = 3
    learning_rate: float = 0.01
    batch_size: int = 32
    seed: int = 0
    data_root: str | None = None  # dataset files under here; None → synthetic
    # "fashion_mnist" (28×28×1 idx files) or "cifar10" (32×32×3 batches).
    dataset: str = "fashion_mnist"
    synthetic_n: int = 4096
    use_mesh: bool = True
    log_every: int = 0
    # None → platform default (bfloat16 on TPU's MXU, float32 elsewhere —
    # so float32 in the port); an explicit dtype string is honored on any
    # platform ("float32" or "bfloat16").
    dtype: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    metrics_path: str | None = None
    steps_per_call: int = 1
    prefetch_to_device: int = 2


def train_cnn(
    recipe: CNNRecipe | None = None,
    *,
    device: str | torch.device | None = None,
    _return_classifier: bool = False,
    _return_state: bool = False,
    **overrides,
) -> dict:
    r = with_overrides(recipe or CNNRecipe(), overrides)
    loaders = {"fashion_mnist": load_fashion_mnist, "cifar10": load_cifar10}
    if r.dataset not in loaders:
        raise ValueError(
            f"dataset must be one of {sorted(loaders)}, got {r.dataset!r}"
        )
    dtype = default_compute_dtype(r.dtype)
    dev = resolve_device(device)
    if r.data_root:
        train_frame = loaders[r.dataset](r.data_root, train=True)
        test_frame = loaders[r.dataset](r.data_root, train=False)
    else:
        shape = (
            dict(height=32, width=32, channels=3)
            if r.dataset == "cifar10"
            else dict(height=28, width=28, channels=1)
        )
        train_frame = synthetic_image_classification(
            r.synthetic_n, num_classes=r.num_classes, seed=r.seed, **shape
        )
        test_frame = synthetic_image_classification(
            max(r.synthetic_n // 4, 128), num_classes=r.num_classes,
            seed=r.seed + 1, **shape,
        )
    mesh = resolve_mesh(r.use_mesh)
    train_loader, test_loader = make_loaders(
        ArrayDataset(*train_frame.arrays()), ArrayDataset(*test_frame.arrays()),
        batch_size=r.batch_size, mesh=mesh, seed=r.seed,
    )
    model = TinyVGG(
        hidden_units=r.hidden_units,
        num_classes=r.num_classes,
        dtype=dtype,
        input_shape=train_frame.features.shape[1:],
        generator=torch.Generator().manual_seed(r.seed),
    ).to(dev)
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
