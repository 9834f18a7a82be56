"""Machine-translation recipe — the Multi30k Transformer workload (C24), the
port of ``machine_learning_apache_spark_tpu/recipes/translation.py``.

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
the saved one, and reports ``resumed_from_step``.

The single-device options run as in the JAX recipe: ``moe_experts``
(switch-routed expert FFNs; the load-balancing loss joins the task loss
at ``moe_aux_weight`` and is reported as ``moe_aux``), ``remat`` (each
layer recomputed in the backward), ``bucket_by_length`` /
``bucket_boundaries`` (paired length buckets for the training batches;
eval keeps the fixed width) and ``pack_sequences`` (several pairs per
row behind block-diagonal segment masks, ``data.packing``; its dense
masks take the plain attention path, as they take the fused-XLA path in
the JAX package, so the packed step launches no flash kernel). The
combinations the JAX recipe rejects raise the same ``ValueError``.

Under ``launcher.Distributor`` the recipe trains data-parallel
(``use_mesh``, the default): each rank takes its ``DistributedSampler``
shard at ``batch_size`` rows, and ``train.loop.fit(mesh=)`` weights each
rank's gradient by its share of the global batch's valid target tokens
(the losses' ``loss_weight``), so the gang trains on the global batch's
token mean as the JAX ``fit(mesh=)`` does. ``model_parallel=M`` trains
tensor-parallel on a ``{data: world/M, model: M}`` mesh
(``parallel.tensor_parallel``): the LM head is padded to a multiple of M
(``logit_pad``, as the JAX recipe pads it), each rank holds its slice of
every annotated weight and runs the flash kernels on its ``H/M`` heads,
and the loss is the vocab-parallel one. The BLEU decode and the returned
``Translator`` run on the parameters gathered to full on every rank.
With ``moe_experts`` the expert weights' hidden dim is sharded over the
model axis too (``w_up`` columns, ``w_down`` rows).
``expert_parallel=N`` (with ``moe_experts``, which it must divide)
trains on a ``{data: world/N, expert: N}`` mesh, or ``{data:
world/(N·M), expert: N, model: M}`` beside ``model_parallel=M``
(``parallel.expert_parallel``): each rank of an expert line reads the
same rows, routes them replicated and runs its ``E/N`` experts, their
outputs summed over the line; the BLEU decode and the returned
``Translator`` run on the whole experts, gathered on every rank.
``pipeline_parallel=S`` trains on a ``{data: world/S, pipeline: S}``
mesh (``parallel.pipeline_transformer``): the training loss runs the
encoder and decoder stacks as GPipe rings of ``pipeline_microbatches``
microbatches (default S), ``num_layers / S`` layers a stage; eval, the
BLEU decode and the returned ``Translator`` run the sequential model,
whose whole parameters every rank holds. The JAX recipe's
``ValueError``s refuse it with tensor, sequence or expert parallelism,
MoE, length buckets, packing and a layer count S does not divide.
``sequence_parallel=N`` trains on a ``{data: world/N, seq: N}`` mesh with
``fit`` and ``evaluate`` inside ``ops.attention.sequence_parallel(mesh,
method=sequence_parallel_method)``: targets are padded to ``max_len + 1``
so the decoder's input, like the source, has ``max_len`` positions and
every attention site (cross-attention too) splits over the seq line,
through ring attention (``"ring"``) or Ulysses all-to-alls
(``"ulysses"``, which needs ``num_heads % N == 0``: the JAX
``ValueError``); the BLEU decode and the returned ``Translator`` run the
whole model outside the context. Beside ``model_parallel=M`` (``{data:
world/(N·M), seq: N, model: M}``) each seq line attends on its model
rank's ``num_heads / M`` heads, and beside ``moe_experts=E,
expert_parallel=X`` (``{data, expert: X, seq: N[, model: M]}``) each
expert line holds every row, as the JAX recipe's meshes do.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields

import torch

from machine_learning_apache_spark_tpu_torch.data.bucketing import (
    BucketByLengthPairsLoader,
)
from machine_learning_apache_spark_tpu_torch.data.datasets import (
    load_multi30k,
    synthetic_translation_pairs,
)
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
from machine_learning_apache_spark_tpu_torch.data.packing import pack_translation_pairs
from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    PAD_ID,
    SOS_ID,
    translation_pipelines,
)
from machine_learning_apache_spark_tpu_torch.inference import Translator
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    greedy_translate_cached,
)
from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
from machine_learning_apache_spark_tpu_torch.ops.masks import (
    combine_masks,
    make_causal_mask,
    make_segment_mask,
)
from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
    gather_params,
    is_sharded,
)
from machine_learning_apache_spark_tpu_torch.recipes._common import (
    checkpointing,
    default_compute_dtype,
    make_bucketed_loader,
    make_loaders,
    data_parallel_state,
    resolve_mesh,
    resume_epochs,
    summarize,
    with_overrides,
)
from machine_learning_apache_spark_tpu_torch.train.loop import (
    evaluate,
    fit,
    to_device,
)
from machine_learning_apache_spark_tpu_torch.train.losses import (
    cross_entropy,
    masked_mean,
    vocab_parallel_token_cross_entropy,
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
    # None → platform default (bfloat16 on TPU's MXU, float32 elsewhere —
    # so float32 in the port); an explicit dtype string is honored on any
    # platform ("float32" or "bfloat16").
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
    # Paired length buckets for the training batches (eval keeps the fixed
    # width); () -> (1/4, 1/2, full) of max_len.
    bucket_by_length: bool = False
    bucket_boundaries: tuple[int, ...] = ()
    # Several pairs per fixed row behind segment masks (data.packing);
    # training only.
    pack_sequences: bool = False
    steps_per_call: int = 1
    prefetch_to_device: int = 2


#: Recipe fields of the JAX package that this port does not run yet, with
#: the ROADMAP item that will. Each raises when set away from its default.
UNPORTED: dict[str, str] = {}


def _validate(r: TranslationRecipe) -> None:
    """The JAX recipe's rejections (``ValueError``, the same
    combinations), then the fields this port does not run yet
    (``NotImplementedError``)."""
    if r.pack_sequences:
        blockers = {
            "bucket_by_length": r.bucket_by_length,
            "sequence_parallel": r.sequence_parallel > 1,
            "pipeline_parallel": r.pipeline_parallel > 1,
            "moe_experts": r.moe_experts > 0,
        }
        bad = [k for k, v in blockers.items() if v]
        if bad:
            raise ValueError(
                f"pack_sequences is incompatible with {bad}: bucketing is "
                "another answer to the same padding, the sequence ring and "
                "the pipeline split need the plain loss, and MoE capacity "
                "routing is unvalidated on mixed rows"
            )
    if r.moe_experts and r.moe_experts % max(r.expert_parallel, 1):
        raise ValueError(
            f"moe_experts={r.moe_experts} must divide evenly over "
            f"expert_parallel={r.expert_parallel}"
        )
    if r.expert_parallel > 1 and not r.moe_experts:
        raise ValueError(
            f"expert_parallel={r.expert_parallel} requires moe_experts > 0"
        )
    if r.bucket_by_length and r.sequence_parallel > 1:
        raise ValueError(
            "bucket_by_length is incompatible with sequence_parallel: the "
            "ring needs one fixed seq-axis-divisible length"
        )
    if r.bucket_by_length and r.steps_per_call > 1:
        raise ValueError(
            "steps_per_call > 1 is incompatible with bucket_by_length: a "
            "K-step program stacks K batches into one static shape, but "
            "buckets emit per-bucket widths"
        )
    if r.pipeline_parallel > 1:
        # The pipeline schedule runs on data x pipeline meshes only.
        incompatible = {
            "model_parallel": r.model_parallel,
            "sequence_parallel": r.sequence_parallel,
            "expert_parallel": r.expert_parallel,
        }
        bad = {k: v for k, v in incompatible.items() if v > 1}
        if bad or r.moe_experts:
            raise ValueError(
                f"pipeline_parallel={r.pipeline_parallel} composes with "
                f"data parallelism only; incompatible settings: "
                f"{bad or {'moe_experts': r.moe_experts}}"
            )
        if r.bucket_by_length:
            raise ValueError(
                "pipeline_parallel is incompatible with bucket_by_length "
                "(the microbatch split needs one fixed batch shape)"
            )
        if r.num_layers % r.pipeline_parallel:
            raise ValueError(
                f"num_layers={r.num_layers} must divide into "
                f"{r.pipeline_parallel} pipeline stages"
            )
    if (r.sequence_parallel > 1 and r.sequence_parallel_method == "ulysses"
            and r.num_heads % r.sequence_parallel):
        raise ValueError(
            f"sequence_parallel_method='ulysses' needs num_heads "
            f"({r.num_heads}) divisible by sequence_parallel "
            f"({r.sequence_parallel}); use 'ring'"
        )
    defaults = TranslationRecipe()
    for f in fields(TranslationRecipe):
        if f.name in UNPORTED and getattr(r, f.name) != getattr(defaults, f.name):
            raise NotImplementedError(
                f"TranslationRecipe.{f.name}={getattr(r, f.name)!r} is not "
                f"ported yet (ROADMAP queue {UNPORTED[f.name]})"
            )


def token_losses(model, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE of the model's logits: through the vocab-parallel loss
    when its LM head is sharded over the model axis (``logits`` are then
    this rank's columns), else the plain one."""
    shard = model.vocab_shard
    if shard is None:
        return cross_entropy(logits, labels, reduction="none")
    axis, start = shard
    return vocab_parallel_token_cross_entropy(logits, labels, axis, start, model.cfg.trg_vocab_size)


def make_translation_loss(pad_id: int, *, train: bool = True):
    """Teacher-forced pad-masked CE over ``(src, trg)`` batches — the manual
    mask-mean at ``pytorch_machine_translator.py:182-188``. The loss
    function is ``(model, batch, rng) -> (loss, aux)``; ``train=True``
    hands ``rng`` to the model's dropout, ``train=False`` runs it
    deterministic.

    An MoE model's load-balancing losses (one per MoE layer, device
    tensors) join the loss at ``cfg.moe_aux_weight`` times their mean,
    reported as ``aux["moe_aux"]``, in training and eval alike."""

    def loss_fn(model, batch, rng):
        src, trg = batch
        dropout_rng = rng if train else None
        if model.cfg.moe_experts > 0:
            aux_terms: list = []
            logits = model(src, trg[:, :-1], dropout_rng=dropout_rng, aux_losses=aux_terms)
            aux = sum(aux_terms) / max(len(aux_terms), 1)
            loss = masked_mean(token_losses(model, logits, trg[:, 1:]), trg[:, 1:], pad_id)
            return loss + model.cfg.moe_aux_weight * aux, {"moe_aux": aux}
        logits = model(src, trg[:, :-1], dropout_rng=dropout_rng)
        return masked_mean(token_losses(model, logits, trg[:, 1:]), trg[:, 1:], pad_id), {}

    # What the loss averages over — the batch's valid target tokens — so
    # a gang weights each rank's gradient by its share of the global count
    # (parallel.data_parallel).
    loss_fn.loss_weight = lambda batch: (batch[1][:, 1:] != pad_id).sum()
    return loss_fn


def make_pipeline_translation_loss(pad_id: int, mesh, *, n_micro: int | None = None,
                                   train: bool = True):
    """The training loss with the forward scheduled as two GPipe rings
    over the mesh's ``"pipeline"`` axis
    (``parallel.pipeline_transformer``): the pad-masked CE of
    ``make_translation_loss``, its ``loss_weight`` too."""
    from machine_learning_apache_spark_tpu_torch.parallel.pipeline_transformer import (
        pipeline_transformer_logits,
    )

    def loss_fn(model, batch, rng):
        src, trg = batch
        logits = pipeline_transformer_logits(
            model, src, trg[:, :-1], mesh, n_micro=n_micro,
            generator=rng if train else None, deterministic=not train,
        )
        return masked_mean(token_losses(model, logits, trg[:, 1:]), trg[:, 1:], pad_id), {}

    loss_fn.loss_weight = lambda batch: (batch[1][:, 1:] != pad_id).sum()
    return loss_fn


def make_packed_translation_loss(pad_id: int, *, train: bool = True):
    """Teacher-forced CE over PACKED batches (``src, src_seg, src_pos, trg,
    trg_seg, trg_pos`` — ``data.packing``): the same per-token CE as
    ``make_translation_loss`` on the equivalent unpacked rows, through
    block-diagonal segment masks at all three attention sites,
    per-segment positions, and a loss mask that also drops the boundary
    position where one segment's last token would be scored against the
    next segment's first. The masks are dense, so attention takes the
    plain path (no flash kernel), as the JAX recipe's takes fused XLA."""

    def loss_fn(model, batch, rng):
        src, src_seg, src_pos, trg, trg_seg, trg_pos = batch
        tin_seg = trg_seg[:, :-1]
        logits = model(
            src,
            trg[:, :-1],
            src_mask=make_segment_mask(src_seg, src_seg),
            trg_mask=combine_masks(
                make_segment_mask(tin_seg, tin_seg),
                make_causal_mask(tin_seg.shape[1], device=tin_seg.device),
            ),
            cross_mask=make_segment_mask(tin_seg, src_seg),
            src_positions=src_pos,
            trg_positions=trg_pos[:, :-1],
            dropout_rng=rng if train else None,
        )
        labels = trg[:, 1:]
        per_tok = token_losses(model, logits, labels)
        scored = _packed_scored(trg, trg_seg, pad_id)
        return (per_tok * scored).sum() / scored.sum().clamp_min(1), {}

    loss_fn.loss_weight = lambda batch: _packed_scored(batch[3], batch[4], pad_id).sum()
    return loss_fn


def _packed_scored(trg: torch.Tensor, trg_seg: torch.Tensor, pad_id: int) -> torch.Tensor:
    """The packed loss's scored positions: a label counts only when it
    belongs to the SAME segment as its input token — pad labels drop
    (segment 0) and so does each segment's boundary into the next."""
    tin_seg = trg_seg[:, :-1]
    return (trg_seg[:, 1:] == tin_seg) & (tin_seg > 0) & (trg[:, 1:] != pad_id)


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
    _validate(r)
    dev = resolve_device(device)
    if r.data_root:
        pairs = load_multi30k(r.data_root, "train")
        val_pairs = load_multi30k(r.data_root, "valid")
    else:
        pairs = synthetic_translation_pairs(r.synthetic_n, seed=r.seed)
        val_pairs = synthetic_translation_pairs(
            max(r.synthetic_n // 8, 64), seed=r.seed + 1
        )
    # Under SP the targets are one longer, so the teacher-forced decoder
    # input (trg[:, :-1]) has max_len positions and rides the seq line as
    # the encoder does (max_len - 1 would share no divisor with the axis).
    src_pipe, trg_pipe = translation_pipelines(
        pairs, max_len=r.max_len,
        trg_max_len=r.max_len + 1 if r.sequence_parallel > 1 else None,
    )

    def to_ids(ps):
        return src_pipe([s for s, _ in ps]), trg_pipe([t for _, t in ps])

    def ragged(ps):
        return src_pipe.ragged([s for s, _ in ps]), trg_pipe.ragged([t for _, t in ps])

    packed = None
    if r.pack_sequences:
        packed = pack_translation_pairs(
            *ragged(pairs), src_len=r.max_len, trg_len=r.max_len, pad_id=PAD_ID
        )
        train_ds = ArrayDataset(*packed.arrays())
    else:
        train_ds = ArrayDataset(*to_ids(pairs))
    val_ds = ArrayDataset(*to_ids(val_pairs))
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab),
        trg_vocab_size=len(trg_pipe.vocab),
        # Megatron-style vocab padding, the JAX recipe's: the LM head stays
        # shardable over the model axis whatever the vocab size.
        logit_pad=(-len(trg_pipe.vocab)) % r.model_parallel if r.model_parallel > 1 else 0,
        d_model=r.d_model,
        ffn_hidden=r.ffn_hidden,
        num_heads=r.num_heads,
        num_layers=r.num_layers,
        dropout=r.dropout,
        max_len=r.max_len,
        remat=r.remat,
        moe_experts=r.moe_experts,
        moe_capacity_factor=r.moe_capacity_factor,
        moe_aux_weight=r.moe_aux_weight,
        dtype=default_compute_dtype(r.dtype),
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(r.seed)).to(dev)
    # Under bucketing the fixed-width train loader is never used: eval
    # keeps the fixed width (full coverage).
    mesh = resolve_mesh(r.use_mesh, model_parallel=r.model_parallel,
                        pipeline_parallel=r.pipeline_parallel,
                        sequence_parallel=r.sequence_parallel,
                        expert_parallel=r.expert_parallel)
    train_loader, val_loader = make_loaders(
        None if r.bucket_by_length else train_ds, val_ds,
        batch_size=r.batch_size, mesh=mesh, seed=r.seed,
    )
    if r.bucket_by_length:
        train_loader = make_bucketed_loader(
            BucketByLengthPairsLoader,
            *ragged(pairs),
            batch_size=r.batch_size,
            mesh=mesh,
            full_width=r.max_len,
            boundaries=r.bucket_boundaries,
            seed=r.seed,
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
    # The restore checks the checkpoints' topology stamp, which names the
    # mesh the state trains on and its data-parallel layout.
    state = data_parallel_state(state, mesh)
    state.mesh = mesh
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
            # r.epochs more epochs, numbered on from the checkpoint's (a
            # retried gang attempt finishes its own run): fit's resume
            # reads the same step's sidecar and continues its loader order
            # and dropout stream, so a run cut at an epoch boundary and
            # resumed trains as the uninterrupted run would.
            epochs = resume_epochs(ckpt, resumed, r.epochs)
        if r.pipeline_parallel > 1:
            train_loss = make_pipeline_translation_loss(
                cfg.pad_id, mesh, n_micro=r.pipeline_microbatches
            )
        elif r.pack_sequences:
            train_loss = make_packed_translation_loss(cfg.pad_id)
        else:
            train_loss = make_translation_loss(cfg.pad_id)
        # Under SP the attention dispatch context wraps the training and
        # the evaluation, whose sites every rank of a seq line runs alike;
        # the BLEU decode below runs outside it.
        sp_ctx = (
            sequence_parallel(mesh, method=r.sequence_parallel_method)
            if mesh is not None and r.sequence_parallel > 1
            else contextlib.nullcontext()
        )
        with sp_ctx:
            result = fit(
                state,
                train_loss,
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
                zero1=r.zero1,
            )
            metrics = evaluate(
                result.state, make_translation_loss(cfg.pad_id, train=False), val_loader,
                mesh=mesh,
            )
    extra: dict = {}
    if resumed is not None:
        extra["resumed_from_step"] = resumed
    if r.bucket_by_length:
        extra["padding_efficiency"] = train_loader.padding_efficiency
    if packed is not None:
        # Non-pad share of the packed token grid, against what the same
        # corpus costs at one pair per row (the reference's layout).
        extra["packing_token_efficiency"] = round(packed.token_efficiency, 4)
        extra["unpacked_token_efficiency"] = round(packed.unpacked_efficiency, 4)
        extra["packed_rows"] = len(packed.src)
        extra["packed_pairs"] = packed.pair_count
    # A tensor- or expert-parallel model decodes on its parameters
    # gathered to full (every rank the same whole model, as the JAX
    # recipe's Translator holds the unboxed full tree).
    decoder_model = model
    if is_sharded(model) and (r.compute_bleu or _return_translator):
        decoder_model = _gathered(model, cfg, dev)
    if r.compute_bleu:
        # The target width is the pipeline's fixed length, so every batch
        # decodes the same number of steps.
        gen = min(val_ds[:1][1].shape[1], r.max_len) - 1
        programs = ProgramCache(dev, eager_first_call=True)
        extra["bleu"] = bleu_decode(decoder_model, val_loader, gen, programs)[1]
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
        out["translator"] = Translator(decoder_model, src_pipe, trg_pipe, device=dev)
    return out


def _gathered(model: Transformer, cfg: TransformerConfig, dev: torch.device) -> Transformer:
    """The unsharded Transformer holding ``model``'s shards gathered over
    the model and expert axes (``tensor_parallel.gather_params``)."""
    full = Transformer(cfg).to(dev)
    full.load_state_dict(gather_params(model))
    return full
