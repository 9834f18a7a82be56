"""LSTM recipe — the AG_NEWS text classification workload (C9); the port of
``machine_learning_apache_spark_tpu/recipes/lstm.py``.

Sequential form: ``pytorch_lstm.py:131-188`` — basic_english tokenizer, vocab
with pad/sos/eos/unk, truncate-128 transform chain, Embedding(32) → 2-layer
LSTM(32) → Linear head, loss on the last timestep's logits
(``pytorch_lstm.py:160``), Adam(lr=1e-3), 3 epochs, batch 32. The
tokenization is hoisted *out* of the training loop (the reference
tokenizes per batch inside it, ``pytorch_lstm.py:148``).

``train_lstm`` runs on the card unless ``device="cpu"`` is passed. At
``max_seq_len=128`` one step is 129 recurrence steps per layer, thousands
of small launches: ``steps_per_call=K`` runs K steps as one CUDA graph.
``bucket_by_length`` pads each training batch to the smallest of a few
boundaries (``data.bucketing``); it takes one step per call. Checkpoint
and resume as in ``recipes._common.fit_recipe``. Under
``launcher.Distributor`` each rank trains its shard and the gradients are
all-reduced (``use_mesh``, the default; ``train.loop.fit(mesh=)``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from machine_learning_apache_spark_tpu_torch.data.bucketing import BucketByLengthLoader
from machine_learning_apache_spark_tpu_torch.data.datasets import (
    load_ag_news,
    synthetic_text_classification,
)
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
from machine_learning_apache_spark_tpu_torch.data.text import (
    PAD_ID,
    classification_pipeline,
)
from machine_learning_apache_spark_tpu_torch.models.lstm import LSTMClassifier
from machine_learning_apache_spark_tpu_torch.recipes._common import (
    fit_recipe,
    make_bucketed_loader,
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
class LSTMRecipe:
    """Reference hypers: ``pytorch_lstm.py:28-43,124-128`` (embed 32, hidden
    32, 2 layers, dropout 0.5, max_seq_len 128, Adam 1e-3, 3 epochs). The
    fields and defaults are the JAX package's."""

    embed_dim: int = 32
    hidden_size: int = 32
    num_layers: int = 2
    num_classes: int = 4
    dropout: float = 0.5
    max_seq_len: int = 128
    epochs: int = 3
    learning_rate: float = 1e-3
    batch_size: int = 32
    seed: int = 0
    data_root: str | None = None  # AG_NEWS csv root; None → synthetic
    synthetic_n: int = 2048
    use_mesh: bool = True
    log_every: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    # Length-bucketed training batches; eval keeps the fixed width.
    bucket_by_length: bool = False
    bucket_boundaries: tuple[int, ...] = ()  # () → (1/4, 1/2, full) of max
    metrics_path: str | None = None
    steps_per_call: int = 1
    prefetch_to_device: int = 2
    # Which position feeds the classifier head: "last" is the reference's
    # read of the FINAL column (``pytorch_lstm.py:160`` — on end-padded
    # batches the state after the row's pad steps); "last_valid" reads
    # each row's last non-pad position.
    classify_from: str = "last"


def train_lstm(
    recipe: LSTMRecipe | None = None,
    *,
    device: str | torch.device | None = None,
    _return_classifier: bool = False,
    _return_state: bool = False,
    **overrides,
) -> dict:
    r = with_overrides(recipe or LSTMRecipe(), overrides)
    if r.bucket_by_length and r.steps_per_call > 1:
        # A K-step program stacks K batches into one static shape; buckets
        # emit per-bucket widths.
        raise ValueError(
            "steps_per_call > 1 is incompatible with bucket_by_length: "
            "scanned dispatch stacks K batches into one static shape, but "
            "buckets emit per-bucket widths"
        )
    if r.classify_from not in ("last", "last_valid"):
        raise ValueError(
            f"classify_from must be 'last' or 'last_valid', got "
            f"{r.classify_from!r}"
        )
    dev = resolve_device(device)
    if r.data_root:
        train_texts, train_labels = load_ag_news(r.data_root, train=True)
        test_texts, test_labels = load_ag_news(r.data_root, train=False)
    else:
        train_texts, train_labels = synthetic_text_classification(
            r.synthetic_n, num_classes=r.num_classes, seed=r.seed
        )
        test_texts, test_labels = synthetic_text_classification(
            max(r.synthetic_n // 4, 128), num_classes=r.num_classes,
            seed=r.seed + 1,
        )

    # Preprocessing hoisted out of the hot loop: tokenize+transform the whole
    # corpus once, pad to one fixed width.
    pipe = classification_pipeline(
        train_texts, max_seq_len=r.max_seq_len, fixed_len=r.max_seq_len + 1
    )
    train_ds = ArrayDataset(pipe(train_texts), train_labels)
    test_ds = ArrayDataset(pipe(test_texts), test_labels)
    # Under bucketing the fixed-width train loader is never used: build only
    # the test loader (eval keeps the fixed width for full coverage).
    mesh = resolve_mesh(r.use_mesh)
    train_loader, test_loader = make_loaders(
        None if r.bucket_by_length else train_ds, test_ds,
        batch_size=r.batch_size, mesh=mesh, seed=r.seed,
    )
    if r.bucket_by_length:
        train_loader = make_bucketed_loader(
            BucketByLengthLoader,
            pipe.ragged(train_texts),
            train_labels,
            batch_size=r.batch_size,
            mesh=mesh,
            full_width=r.max_seq_len + 1,  # the fixed width (incl. eos)
            boundaries=r.bucket_boundaries,
            seed=r.seed,
        )

    model = LSTMClassifier(
        vocab_size=len(pipe.vocab),
        embed_dim=r.embed_dim,
        hidden_size=r.hidden_size,
        num_layers=r.num_layers,
        num_classes=r.num_classes,
        dropout=r.dropout,
        generator=torch.Generator().manual_seed(r.seed),
    ).to(dev)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    # Loss on the final timestep's logits — pred[:, -1, :]
    # (``pytorch_lstm.py:160``) — or each row's last non-pad position under
    # classify_from="last_valid".
    head_pad = PAD_ID if r.classify_from == "last_valid" else None
    result, resumed = fit_recipe(
        r, state,
        classification_loss(model, last_timestep=True, pad_id=head_pad),
        train_loader,
        mesh=mesh,
    )
    metrics = evaluate(
        result.state,
        classification_loss(model, last_timestep=True, train=False, pad_id=head_pad),
        test_loader,
        mesh=mesh,
    )
    extra = {"resumed_from_step": resumed} if resumed is not None else {}
    if r.bucket_by_length:
        # real tokens / padded slots over the epoch (fixed-width padding
        # scores far lower).
        extra["padding_efficiency"] = train_loader.padding_efficiency
    out = summarize(
        result, metrics, metrics_path=r.metrics_path,
        vocab_size=len(pipe.vocab), **extra,
    )
    if _return_state:
        out["state"] = result.state
        out["fit_result"] = result
    if _return_classifier:
        from machine_learning_apache_spark_tpu_torch.inference import Classifier

        out["classifier"] = Classifier(
            model, pipeline=pipe, last_timestep=True, head_pad_id=head_pad,
            device=dev,
        )
    return out
