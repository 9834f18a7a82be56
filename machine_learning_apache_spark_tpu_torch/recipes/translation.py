"""Machine-translation recipe — the Multi30k Transformer workload (C24), the
port of ``machine_learning_apache_spark_tpu/recipes/translation.py`` on one
device.

Reference: ``pytorch_machine_translator.py:107-209`` — en→de pairs, dual
vocabs with fixed length-200 transform chains, encoder-decoder Transformer
(d_model=512, ffn=1024, heads=8, layers=1, dropout=0.1), per-token CE with
pad masking (``:182-188``), Adam(lr=1e-3), batch 32, 1 epoch, per-100-batch
loss+time prints. Deltas by design, as in the JAX package: masks are built
inside the model, teacher forcing shifts the target by one, and
tokenization happens once up front.

``train_translator`` runs on the card unless ``device="cpu"`` is passed
(``utils.device.resolve_device``: no card and no explicit CPU raises).
Attention goes through the Hopper kernels there — the flash forward with
its ``lse`` and the two flash-2 backward kernels — and through their plain
versions on the CPU. ``steps_per_call=K`` runs K training steps per call
(one CUDA graph on the card, ``train.loop.StepDispatch``). With
``checkpoint_dir`` every ``checkpoint_every`` epochs and the last are
saved; a later run over the same directory (``resume``, the default)
restores the newest valid step, trains ``epochs`` more numbered on from
the saved one, and reports ``resumed_from_step``. The recipe fields of
the JAX package that this slice does not port raise
``NotImplementedError`` when set away from their defaults; ``use_mesh``
is accepted (one card: nothing to shard).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from machine_learning_apache_spark_tpu_torch.data.datasets import (
    load_multi30k,
    synthetic_translation_pairs,
)
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    SOS_ID,
    translation_pipelines,
)
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    greedy_translate_cached,
)
from machine_learning_apache_spark_tpu_torch.recipes._common import (
    checkpointing,
    default_compute_dtype,
    make_loaders,
    summarize,
    with_overrides,
)
from machine_learning_apache_spark_tpu_torch.train.loop import (
    evaluate,
    fit,
    to_device,
)
from machine_learning_apache_spark_tpu_torch.train.losses import (
    masked_token_cross_entropy,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import (
    corpus_bleu,
    strip_special_ids,
)
from machine_learning_apache_spark_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
)
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger


@dataclass
class TranslationRecipe:
    """Reference hypers: ``pytorch_machine_translator.py:108-129``. The
    fields and defaults are the JAX package's (see its recipe for what
    each parallelism and data-layout field does)."""

    d_model: int = 512
    ffn_hidden: int = 1024
    num_heads: int = 8
    num_layers: int = 1
    dropout: float = 0.1
    max_len: int = 200
    epochs: int = 1
    learning_rate: float = 1e-3
    batch_size: int = 32
    seed: int = 0
    data_root: str | None = None  # multi30k files; None → synthetic pairs
    synthetic_n: int = 2048
    use_mesh: bool = True
    log_every: int = 100  # the reference's per-100-batch print cadence
    # None → float32 (the only dtype the port's kernels take so far).
    dtype: str | None = None
    model_parallel: int = 1
    sequence_parallel: int = 1
    sequence_parallel_method: str = "ring"
    pipeline_parallel: int = 1
    pipeline_microbatches: int | None = None
    moe_experts: int = 0
    expert_parallel: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    remat: bool = False
    zero1: bool = False
    # Optimizer-side training-scale knobs: lr schedule ("constant" |
    # "cosine" | "warmup_cosine" over the full run), linear warmup steps,
    # global-norm gradient clipping, gradient accumulation.
    schedule: str | None = None
    warmup_steps: int = 0
    grad_clip: float | None = None
    grad_accum: int = 1
    # Decode the validation set after training and report corpus BLEU.
    compute_bleu: bool = False
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    metrics_path: str | None = None
    bucket_by_length: bool = False
    bucket_boundaries: tuple[int, ...] = ()
    pack_sequences: bool = False
    steps_per_call: int = 1
    prefetch_to_device: int = 2


#: Recipe fields of the JAX package that this slice does not port, with
#: the ROADMAP item that will. Each raises when set away from its default.
UNPORTED = {
    "model_parallel": "A4 (distributed)",
    "sequence_parallel": "A4 (distributed)",
    "sequence_parallel_method": "A4 (distributed)",
    "pipeline_parallel": "A4 (distributed)",
    "pipeline_microbatches": "A4 (distributed)",
    "moe_experts": "A2 (MoE)",
    "expert_parallel": "A2 (MoE)",
    "moe_capacity_factor": "A2 (MoE)",
    "moe_aux_weight": "A2 (MoE)",
    "remat": "A2 (remat)",
    "zero1": "A4 (distributed)",
    "bucket_by_length": "A1.2 (translation wiring)",
    "bucket_boundaries": "A1.2 (translation wiring)",
    "pack_sequences": "A1 (packed loaders)",
}


def _reject_unported(r: TranslationRecipe) -> None:
    if r.bucket_by_length and r.steps_per_call > 1:
        raise ValueError(
            "steps_per_call > 1 is incompatible with bucket_by_length: a "
            "K-step program stacks K batches into one static shape, but "
            "buckets emit per-bucket widths"
        )
    defaults = TranslationRecipe()
    for f in fields(TranslationRecipe):
        if f.name in UNPORTED and getattr(r, f.name) != getattr(defaults, f.name):
            raise NotImplementedError(
                f"TranslationRecipe.{f.name}={getattr(r, f.name)!r} is not "
                f"ported yet (ROADMAP queue {UNPORTED[f.name]})"
            )


def make_translation_loss(pad_id: int, *, train: bool = True):
    """Teacher-forced pad-masked CE over ``(src, trg)`` batches — the manual
    mask-mean at ``pytorch_machine_translator.py:182-188``. The loss
    function is ``(model, batch, rng) -> (loss, {})``; ``train=True`` hands
    ``rng`` to the model's dropout, ``train=False`` runs it deterministic."""

    def loss_fn(model, batch, rng):
        src, trg = batch
        logits = model(src, trg[:, :-1], dropout_rng=rng if train else None)
        return masked_token_cross_entropy(logits, trg[:, 1:], pad_id), {}

    return loss_fn


def bleu_decode(
    model: Transformer, loader, max_new_tokens: int, programs: ProgramCache
) -> tuple[list[list[int]], float]:
    """The recipe's BLEU decode: the KV-cache greedy decoder over the
    eval loader's batches (its ragged tail included), one program of
    ``programs`` per batch shape — a CUDA graph on the card, its first
    call the real one. Returns the candidates' ids (specials stripped)
    and the corpus BLEU against the loader's targets."""
    def decode(src):
        return greedy_translate_cached(
            model, src, max_new_tokens=max_new_tokens, sos_id=SOS_ID, eos_id=EOS_ID
        )

    kw = dict(pad_id=model.cfg.pad_id, sos_id=SOS_ID, eos_id=EOS_ID)
    cands: list[list[int]] = []
    refs: list[list[int]] = []
    for src_b, trg_b in loader:
        (src,) = to_device((src_b,), torch.device("cpu"))
        # Read back before the next call overwrites the outputs.
        cands.extend(strip_special_ids(programs("bleu_decode", decode, src), **kw))
        refs.extend(strip_special_ids(trg_b, **kw))
    return cands, corpus_bleu(cands, refs)


def train_translator(
    recipe: TranslationRecipe | None = None,
    *,
    device: str | torch.device | None = None,
    _return_state: bool = False,
    _return_translator: bool = False,
    **overrides,
) -> dict:
    r = with_overrides(recipe or TranslationRecipe(), overrides)
    _reject_unported(r)
    dev = resolve_device(device)
    if r.data_root:
        pairs = load_multi30k(r.data_root, "train")
        val_pairs = load_multi30k(r.data_root, "valid")
    else:
        pairs = synthetic_translation_pairs(r.synthetic_n, seed=r.seed)
        val_pairs = synthetic_translation_pairs(
            max(r.synthetic_n // 8, 64), seed=r.seed + 1
        )
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=r.max_len)

    def to_ids(ps):
        return src_pipe([s for s, _ in ps]), trg_pipe([t for _, t in ps])

    train_ds = ArrayDataset(*to_ids(pairs))
    val_ds = ArrayDataset(*to_ids(val_pairs))
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab),
        trg_vocab_size=len(trg_pipe.vocab),
        d_model=r.d_model,
        ffn_hidden=r.ffn_hidden,
        num_heads=r.num_heads,
        num_layers=r.num_layers,
        dropout=r.dropout,
        max_len=r.max_len,
        dtype=default_compute_dtype(r.dtype),
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(r.seed)).to(dev)
    train_loader, val_loader = make_loaders(
        train_ds, val_ds, batch_size=r.batch_size, seed=r.seed
    )
    # total_steps counts OPTIMIZER updates: under accumulation only every
    # grad_accum-th microbatch updates, and the microbatch counter carries
    # across epoch boundaries — so divide the GLOBAL batch count.
    n_micro = len(train_loader) * r.epochs
    if r.grad_accum > max(n_micro, 1):
        raise ValueError(
            f"grad_accum={r.grad_accum} exceeds the run's {n_micro} "
            "microbatches; the optimizer would never update"
        )
    if r.grad_accum > 1 and n_micro % r.grad_accum:
        get_logger(__name__).warning(
            "grad_accum=%d does not divide the run's %d microbatches; the "
            "final %d gradient(s) stay in the accumulator and never update "
            "the params",
            r.grad_accum, n_micro, n_micro % r.grad_accum,
        )
    total_updates = max(n_micro // max(r.grad_accum, 1), 1)
    state = TrainState.create(
        model=model,
        tx=make_optimizer(
            "adam",
            r.learning_rate,
            schedule=r.schedule,
            warmup_steps=r.warmup_steps,
            total_steps=total_updates,
            grad_clip=r.grad_clip,
            accumulate_steps=r.grad_accum,
        ),
    )
    with checkpointing(
        r.checkpoint_dir, state, resume=r.resume
    ) as (ckpt, state, resumed):
        epochs = r.epochs
        if resumed is not None:
            if r.schedule in ("cosine", "warmup_cosine"):
                # The restored update count sits at the prior run's total;
                # a horizon sized for a fresh run would train the whole
                # resumed run at the decayed floor. Extend it by the
                # restored updates (the step counter counts microbatches),
                # as the JAX recipe does.
                prior_updates = resumed // max(r.grad_accum, 1)
                state.tx = make_optimizer(
                    "adam",
                    r.learning_rate,
                    schedule=r.schedule,
                    warmup_steps=r.warmup_steps,
                    total_steps=prior_updates + total_updates,
                    grad_clip=r.grad_clip,
                    accumulate_steps=r.grad_accum,
                )
            # r.epochs more epochs, numbered on from the checkpoint's: fit's
            # resume reads the same step's sidecar and continues its loader
            # order and dropout stream, so a run cut at an epoch boundary
            # and resumed trains as the uninterrupted run would.
            epochs += int(ckpt.read_meta(resumed).get("epoch", -1)) + 1
        result = fit(
            state,
            make_translation_loss(cfg.pad_id),
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
        metrics = evaluate(
            result.state, make_translation_loss(cfg.pad_id, train=False), val_loader
        )
    extra: dict = {}
    if resumed is not None:
        extra["resumed_from_step"] = resumed
    if r.compute_bleu:
        # The target width is the pipeline's fixed length, so every batch
        # decodes the same number of steps.
        gen = min(val_ds[:1][1].shape[1], r.max_len) - 1
        programs = ProgramCache(dev, eager_first_call=True)
        extra["bleu"] = bleu_decode(model, val_loader, gen, programs)[1]
    out = summarize(
        result,
        metrics,
        metrics_path=r.metrics_path,
        src_vocab=len(src_pipe.vocab),
        trg_vocab=len(trg_pipe.vocab),
        **extra,
    )
    if _return_state:
        # Test and inspection hooks: the state, the fit's record (step
        # losses, its programs) and the BLEU decode's programs.
        out["state"] = result.state
        out["fit_result"] = result
        if r.compute_bleu:
            out["bleu_programs"] = programs.stats()
    if _return_translator:
        out["translator"] = Translator(model, src_pipe, trg_pipe, device=dev)
    return out
