"""Training/eval loop machinery — the port of
``machine_learning_apache_spark_tpu/train/loop.py`` on one device.

Every reference script re-implements the same loop inline (SURVEY.md §1 L7):
epochs × batches of {forward → loss → zero_grad → backward → step}, then an
eval pass, with wall-clock prints. Here the loop body is ``make_train_step``
(or ``make_multi_step`` for K steps at once) and the Python loop only feeds
batches and accumulates metrics.

The loss contract is the JAX package's with the module in place of the
parameter tree: ``loss_fn(model, batch, rng) -> (scalar_loss, aux_dict)``,
where ``rng`` is the dropout ``torch.Generator`` on the model's device
(None in eval). ``fit`` seeds one such generator per run from its host
``rng`` and every step draws on from it, so a run's dropout bits depend
on the seed and the step, not on how the steps were dispatched; its state
rides the checkpoint sidecar. Losses stay on the device between log
points, as in the JAX loop: no per-step host sync.

``steps_per_call=K`` runs K steps as one program (``StepDispatch``): on
the card one CUDA graph per accumulation phase, captured at its first
group and replayed after, bit for bit the same training as K single
steps. Checkpointing (``train.checkpoint.CheckpointManager``) saves at
epoch ends and ``resume=True`` continues from the newest valid step.

``profile_dir`` traces a window of steps (``profile_window``, steps
``[start, stop)``) with ``torch.profiler`` into one Chrome trace
(``utils.profiling.StepWindowTracer``); the trace stops in ``fit``'s
``finally``, so an exception inside the window leaves no profiler
running.

``mesh=`` (``parallel.mesh``) trains data-parallel over the process group
of a gang: each rank steps on its own slice of the global batch through
``parallel.data_parallel.make_data_parallel_step`` (the global batch's
loss, gradients all-reduced once per optimizer step), rank 0's parameters
are broadcast at the start, each rank draws its dropout from its own
generator (seeded from the fit's seed and the rank) and
``sync_check_every=N`` compares the replicas' fingerprints every N
epochs. ``dp_mode="zero1"`` (or ``MLSPARK_DP_MODE``) trains through the
ZeRO-1 step of ``parallel.zero`` instead (the optimizer sharded over the
ranks, the gradient reduce-scattered, the parameters all-gathered), and
``zero1=True`` shards the moments on top of the replicated step. A mesh
with a ``"model"`` axis trains tensor-parallel: the model is sharded
over it first (``parallel.tensor_parallel.shard_state``), the
data-parallel sums run over the data axis, and the ranks of one model
line draw the same dropout bits (seeded by the data index, not the
rank), as they hold the same replicated activations. A mesh with a
``"pipeline"`` axis trains the pipelined loss
(``recipes.translation.make_pipeline_translation_loss``) with each
stage's gradients synced from the stage that computed them
(``parallel.pipeline_parallel.GradSync``) and dropout seeded by the data
index and the stage. A mesh with a ``"seq"`` axis trains as a data mesh
whose seq lines hold the same replicas: under
``ops.attention.sequence_parallel(mesh)`` each attention site splits its
sequence over the line (ring or Ulysses attention) and gathers it back,
and the ranks of a line draw the same dropout bits (seeded by the data
index, as the JAX loop's masks are the same over ``"seq"``). In a
gang, ``steps_per_call=K`` runs K eager data-parallel steps per call: a
gloo collective runs on the host and cannot sit inside a CUDA graph.
Each step passes the ``train_step`` fault-injection site
(``utils.faults.maybe_fault``) on the host before it runs, and an
exception out of the loop dumps the flight recorder. Not ported yet:
elastic resume (``NotImplementedError`` naming its ROADMAP item).
"""

from __future__ import annotations

import base64
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
from machine_learning_apache_spark_tpu_torch.utils.faults import maybe_fault
from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger
from machine_learning_apache_spark_tpu_torch.utils.profiling import StepWindowTracer
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


def make_multi_step(loss_fn: LossFn):
    """K train steps as one function of device tensors — what one CUDA
    graph holds (the JAX package scans them inside one XLA program).

    ``multi_step(state, batches, rng, lrs, phase)``: ``batches`` is a
    tuple of ``[K, ...]`` tensors (step ``i`` takes ``b[i]`` of each),
    ``lrs`` the K scheduled learning rates (``TrainState.scheduled_lrs``:
    a float32 device tensor on the card, float64 on the CPU) and
    ``phase`` the accumulation phase at the first step. Each step runs
    ``TrainState.update_on_device``, which touches no host counter: the
    caller advances them by K after the call. Returns ``(losses [K], aux
    {name: [K]})``. Every step draws its dropout from ``rng`` as a single
    step would, so K steps train bit for bit like K single steps."""

    def multi_step(state: TrainState, batches, rng, lrs: torch.Tensor, phase: int):
        on_card = state.lr_tensor is not None
        losses, auxes = [], []
        for i in range(batches[0].shape[0]):
            loss, aux = loss_fn(state.model, tuple(b[i] for b in batches), rng)
            loss.backward()
            state.update_on_device(
                (phase + i) % state.tx.accumulate_steps,
                lrs[i] if on_card else float(lrs[i]),
            )
            losses.append(loss.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        return torch.stack(losses), {
            k: torch.stack([a[k] for a in auxes]) for k in auxes[0]
        }

    return multi_step


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
    # Step the run auto-resumed from (fit(resume=True) found a valid
    # checkpoint); None for a fresh run.
    resumed_step: int | None = None
    # Every step's training loss, in order (read at the log points).
    step_losses: list[float] = field(default_factory=list)
    # The run's programs (``ProgramCache.stats()``): one per group size
    # and accumulation phase; empty when every step ran singly.
    programs: list[dict] = field(default_factory=list)
    # On a mesh of more than one process: the gradient collectives'
    # host-timed totals (``GradientComms.stats()``, ZeRO-1's
    # ``Zero1Comms.stats()`` or a pipeline mesh's ``GradSync.stats()``),
    # with the model axis's (``TPComms.stats()``) under tensor parallelism
    # and the pipeline line's hops (``PPComms.stats()``); empty otherwise.
    comms: dict = field(default_factory=dict)

    @property
    def final_loss(self) -> float:
        return self.history[-1]["loss"] if self.history else float("nan")


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def to_device(batch, device: torch.device):
    """A host batch (tuple of numpy arrays) → tensors on ``device``; token
    ids become int64. For the card the host arrays are pinned first: a copy
    from pageable memory would wait for the stream, serialising the host
    with every step. Tensors already on ``device`` pass through."""
    out = []
    for a in batch:
        if isinstance(a, torch.Tensor) and a.device == device:
            t = a
        else:
            t = torch.as_tensor(np.asarray(a))
            if device.type == "cuda":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out.append(t if torch.is_floating_point(t) else t.long())
    return tuple(out)


def stack_batches(batches, device: torch.device) -> tuple[torch.Tensor, ...]:
    """K batches → one ``[K, ...]`` tensor per field, token ids as int64:
    on the device if the batches already are, else on the host (pinned
    for the card, where a program copies them into its inputs)."""
    fields = []
    for j in range(len(batches[0])):
        column = [b[j] for b in batches]
        on_device = all(isinstance(c, torch.Tensor) and c.device == device for c in column)
        t = torch.stack(column) if on_device else torch.from_numpy(
            np.stack([np.asarray(c) for c in column])
        )
        if not torch.is_floating_point(t):
            t = t.long()
        if not on_device and device.type == "cuda":
            t = t.pin_memory()
        fields.append(t)
    return tuple(fields)


class StepDispatch:
    """How one ``fit`` runs its steps on ``state``: ``single(batch)`` one
    step eagerly (``make_train_step``); ``group(batches)`` K steps as one
    program of ``make_multi_step`` in ``programs``, a ``ProgramCache`` whose
    first call of each (K, accumulation phase) is the real call and whose
    later calls replay (CUDA graphs on the card, with ``rng`` registered;
    eager on the CPU). Both return ``(losses [n], aux {name: [n]})`` on
    the device, the caller's to keep, and advance the state's counters.
    A state whose tensors are replaced (``TrainState.load_state_dict``)
    needs a new dispatch: the programs hold the old ones."""

    def __init__(
        self, state: TrainState, loss_fn: LossFn, rng: torch.Generator,
        step_fn=None,
    ):
        self.state = state
        self.rng = rng
        self.device = _device_of(state)
        self.programs = ProgramCache(
            self.device, eager_first_call=True,
            generators=(rng,) if self.device.type == "cuda" else (),
        )
        # ``step_fn`` replaces the single step (the data-parallel one on a
        # mesh, which takes the host batch: it reads the loss weight there
        # and moves the batch itself); the K-step program is always the
        # one-process chain.
        self._step = step_fn or make_train_step(loss_fn)
        self._host_batch = step_fn is not None
        self._multi = make_multi_step(loss_fn)

    def _program(self, *args):
        *fields, lrs, phase = args
        return self._multi(self.state, tuple(fields), self.rng, lrs, phase)

    def single(self, batch):
        if not self._host_batch:
            batch = to_device(batch, self.device)
        _, loss, aux = self._step(self.state, batch, self.rng)
        return loss[None], {k: v[None] for k, v in aux.items()}

    def group(self, batches):
        k = len(batches)
        if self._host_batch:
            # A gang's K steps run eagerly, one data-parallel step each: a
            # gloo collective runs on the host and cannot sit inside a
            # CUDA graph. The same steps in the same order as K calls.
            outs = [self.single(b) for b in batches]
            return torch.cat([o[0] for o in outs]), {
                n: torch.cat([o[1][n] for o in outs]) for n in outs[0][1]
            }
        lrs = torch.from_numpy(self.state.scheduled_lrs(k))
        if self.device.type == "cuda":
            lrs = lrs.float().pin_memory()
        losses, aux = self.programs(
            "train_steps", self._program,
            *stack_batches(batches, self.device), lrs, self.state.mini_step,
        )
        self.state.advance(k)
        # A replay's outputs are overwritten by the next one.
        return losses.clone(), {n: v.clone() for n, v in aux.items()}


def _gen_to_meta(gen: torch.Generator) -> str:
    """A generator's state as text for the checkpoint sidecar."""
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode("ascii")


def _gen_from_meta(gen: torch.Generator, text: str) -> torch.Generator:
    state = np.frombuffer(base64.b64decode(text), dtype=np.uint8).copy()
    return gen.set_state(torch.from_numpy(state))


def _check_resume_agreed(mesh, step: int | None) -> None:
    """Raise unless every rank of ``mesh`` restored the same step (or
    none): ranks on different steps would train different states, or
    block in different collectives. The group-agreed cap makes them
    agree; a payload torn under its own pointer is what breaks it."""
    mine = -1 if step is None else int(step)
    both = mesh.all_reduce_(torch.tensor([mine, -mine], dtype=torch.int64), op="max")
    if int(both[0]) != -int(both[1]):
        raise RuntimeError(
            f"the gang's ranks resumed from different checkpoint steps "
            f"(this rank {step}, steps {-int(both[1])}..{int(both[0])} "
            "across the gang, -1 for none)"
        )


def _unported(elastic) -> None:
    """Raise for the argument this port does not run yet."""
    if elastic is not None:
        raise NotImplementedError(
            "fit(elastic=...) is not ported yet (ROADMAP queue A4: train/reshard.py)"
        )


def _with_comms_counters(zstep, state):
    """The ZeRO-1 step with the comms telemetry contract of the JAX loop:
    per-step wire-byte counters (the static amounts of
    ``comms_bytes_per_step``, no device sync), the
    ``comms.opt_state_bytes_per_chip`` gauge set once, the ``comms.zero1``
    annotation, and one ``counter`` event per kind per fit
    (``flush_comms``), which the gang report's comms section reads."""
    if not telemetry.enabled():
        return zstep
    from machine_learning_apache_spark_tpu_torch.parallel import zero as _zero

    stats = zstep.comms_stats
    reg = telemetry.get_registry()
    reg.gauge("comms", "opt_state_bytes_per_chip").set(_zero.opt_state_bytes_per_chip(state))
    telemetry.annotate("comms.zero1", **{k: v for k, v in stats.items() if k != "grad_bytes_fp32"})
    kinds = {
        "bytes_reduce_scattered": "reduce_scatter_bytes",
        "bytes_allgathered": "allgather_bytes",
        # The exposed/overlapped split of the same wire bytes: the static
        # pipeline model (overlap on: 1/nb of each collective exposed).
        "bytes_exposed": "bytes_exposed",
        "bytes_overlapped": "bytes_overlapped",
    }
    counters = {name: reg.counter("comms", name) for name in kinds}
    counted = [0]

    def step(st, batch, rng):
        out = zstep(st, batch, rng)
        for name, key in kinds.items():
            counters[name].inc(stats[key])
        counted[0] += 1
        return out

    def flush():
        if not counted[0]:
            return
        common = {"steps": counted[0], "comms_dtype": stats["comms_dtype"], "overlap": stats["overlap"]}
        for name, key in kinds.items():
            telemetry.get_log().emit(
                "counter", f"comms.{name}", value=counted[0] * stats[key], attrs=common
            )
        counted[0] = 0

    step.flush_comms = flush
    step.comms = zstep.comms
    step.comms_stats = stats
    return step


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
    seed drawn from it seeds the run's dropout generator on the device,
    from which every step draws on. ``metrics_file`` appends one JSON
    line per epoch and a final run record. The wall time blocks on the
    device before it stops.

    ``steps_per_call=K`` runs K batches per call as one program
    (``StepDispatch.group``; on the card a CUDA graph per accumulation
    phase, captured at its first group), the same steps in the same
    order with the same dropout bits and learning rates: the trained
    parameters and every step's loss equal ``steps_per_call=1``'s bit for
    bit. A ragged trailing group at an epoch's end runs as single steps,
    so any loader length works (K larger than an epoch: every batch
    does).

    ``checkpointer`` (a ``train.checkpoint.CheckpointManager``) saves the
    state every ``checkpoint_every`` epochs and after the last, without
    waiting for the write (``wait=False``); the sidecar holds the epoch,
    the run's epoch count, both generators' states, the epoch's metrics
    and the topology stamp.
    ``resume=True`` (with a ``checkpointer``) restores the newest valid
    checkpoint before training (its parameters copied into the state's
    own tensors) and continues from the epoch after the saved one with
    the saved generators, so a resumed run trains bit for bit like an
    uninterrupted one; no checkpoint on disk is a fresh run.
    ``FitResult.resumed_step`` records which happened. In a gang each
    rank saves through its own manager (``<root>/ckpt_r<rank>``) and
    resumes the group-agreed step with its own dropout generator; a
    checkpoint of another topology raises ``TopologyMismatch``, and with
    a mesh the ranks check that they all resumed the same step.

    ``profile_dir`` traces the steps ``[profile_window[0],
    profile_window[1])`` (a K-step call enters and leaves the window as
    its first step crosses a boundary) into one Chrome trace there.

    ``mesh`` (a ``parallel.mesh.Mesh`` over the gang's process group)
    trains data-parallel: every rank runs this call on its own loader
    shard, each step is ``make_data_parallel_step`` (the reported loss is
    the global batch's, the gradient the global loss's, all-reduced once
    per optimizer step), rank 0's parameters are broadcast first and each
    rank's dropout generator is seeded from the fit's seed and its rank.
    ``sync_check_every=N`` runs ``assert_replicas_in_sync`` after every
    N-th epoch (one process passes trivially). On a mesh of one process
    nothing changes, CUDA graphs included. ``FitResult.comms`` holds the
    gradient all-reduce's host-timed totals.

    ``dp_mode="zero1"`` (or env ``MLSPARK_DP_MODE=zero1``, which
    ``Distributor(dp_mode="zero1")`` sets) with a mesh trains through the
    ZeRO-1 step (``parallel.zero.make_zero1_step``): the optimizer's
    moments built 1/N per rank, the gradient reduce-scattered per bucket,
    this rank's shard updated, the parameters all-gathered; float32
    trains the replicated step's bits. ``dp_bucket_bytes`` /
    ``dp_comms_dtype`` / ``dp_overlap`` (env ``MLSPARK_ZERO1_BUCKET_BYTES``
    / ``MLSPARK_COMMS_DTYPE`` / ``MLSPARK_ZERO1_OVERLAP``) set the bucket
    size, the gradient's wire dtype and the schedule. ``zero1=True`` is
    the implicit form: the replicated step with each moment sharded over
    its leading dimension (``parallel.zero.shard_moments``). The JAX
    loop's ``ValueError``s refuse the combinations it refuses. In a gang,
    ``steps_per_call=K`` runs K eager steps per call, the bits of K
    single steps. ``FitResult.comms`` holds the ZeRO-1 collectives'
    host-timed totals (``parallel.zero.Zero1Comms``).

    A mesh with a ``"model"`` axis larger than 1 trains tensor-parallel:
    an unsharded model is sharded over it here (``tensor_parallel.
    shard_state``: this rank's slice of every annotated weight, and of its
    optimizer moments), the data-parallel step runs over the data axis,
    dropout is seeded by the data index, and ``grad_clip`` clips by the
    norm of the whole model. ``dp_mode="zero1"`` and ``zero1=True``
    compose with it (the hybrid ZeRO-1 step of ``parallel.zero``).

    A mesh with a ``"pipeline"`` axis larger than 1 keeps the whole state
    on every rank (the JAX memory note) and syncs each parameter's
    gradient from the ranks of the stage that owns it: after every update
    all ranks of the mesh hold the same parameters and moments. Dropout is
    seeded by the data index and the stage. ``FitResult.comms`` adds the
    line's hops (``PPComms.stats()``: ``pp_send``, ``pp_recv``,
    ``pp_bcast``, ``pp_allreduce``). ``dp_mode="zero1"`` there raises the
    JAX ``ValueError``; ``zero1=True`` is not ported there.

    A mesh with a ``"seq"`` axis larger than 1 keeps the whole state and
    the whole activations on every rank of a seq line; run ``fit`` (and
    ``evaluate``) inside ``ops.attention.sequence_parallel(mesh,
    method=...)`` and each attention site splits its sequence over the
    line. The line's ranks see the same rows (the samplers key on the data
    index), draw the same dropout bits (seeded by the data index) and
    compute the same gradients; DDP and the sums are the data line's.
    ``FitResult.comms`` adds the line's collectives (``SPComms.stats()``:
    ``sp_ring``, ``sp_a2a``, ``sp_gather``).

    ``prefetch_to_device`` is accepted and has nothing to do: the loader
    already assembles ahead on a thread and the copy to the device is
    pinned and non-blocking. The state is updated in place and returned
    in the result."""
    from machine_learning_apache_spark_tpu_torch.parallel import zero as _zero

    _unported(elastic)
    if data is not None:
        if train_loader is not None:
            raise ValueError("pass either train_loader or data=, not both")
        train_loader = data
    if train_loader is None:
        raise ValueError("fit needs a train_loader (or data=...)")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    mode = _zero.resolve_dp_mode(dp_mode)
    if mode == "zero1":
        if mesh is None:
            raise ValueError("dp_mode='zero1' requires a mesh (use_mesh=True)")
        if zero1:
            raise ValueError(
                "pass either dp_mode='zero1' (fused reduce-scatter step) or "
                "zero1=True (implicit opt-state sharding), not both"
            )
        if steps_per_call > 1:
            raise ValueError(
                "dp_mode='zero1' runs its own fused step; steps_per_call "
                "fusion is not supported with it"
            )
    elif dp_bucket_bytes is not None or dp_comms_dtype is not None or dp_overlap is not None:
        raise ValueError(
            "dp_bucket_bytes/dp_comms_dtype/dp_overlap only apply to dp_mode='zero1'"
        )
    elif zero1 and mesh is None:
        # Never a silent no-op: without a mesh there is nothing to shard
        # the optimizer moments over.
        raise ValueError("zero1=True requires a mesh (use_mesh=True)")
    world = mesh.size if mesh is not None else 1
    pp_line = None
    if mesh is not None and mesh.axis_size("pipeline") > 1:
        if zero1:
            raise NotImplementedError(
                "fit(zero1=True) on a mesh with a pipeline axis is not ported yet "
                "(ROADMAP queue A, speed work: stage-local parameters and moments)"
            )
        from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import (
            pipeline_line,
        )

        pp_line = pipeline_line(mesh)
        # This fit's hop totals, as step_fn.comms holds its own.
        pp_line.restart_comms()
    sp_line = None
    if mesh is not None and mesh.axis_size("seq") > 1 and world > 1:
        from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_line

        sp_line = sequence_line(mesh)
        sp_line.restart_comms()
    emit = emit or log.info
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    device = _device_of(state)
    step_rng = torch.Generator(device=device)
    if mesh is not None and mesh.axis_size("model") > 1 and mode != "zero1":
        # Tensor parallelism: this rank's shard of the model (ZeRO-1's
        # init_sharded below shards it itself).
        from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as _tp

        state = _tp.shard_state(state, mesh)
    if mode == "zero1":
        # The sharded state before the resume: the restore template
        # carries the run's real layout, and its stamp names it.
        state = _zero.shard_optimizer_state(state, mesh, _zero.Zero1Config.from_env(
            bucket_bytes=dp_bucket_bytes, comms_dtype=dp_comms_dtype, overlap=dp_overlap,
        ))
    elif zero1:
        state = _zero.shard_moments(state, mesh)
    if mesh is not None:
        # The checkpoint's topology stamp names the mesh it trained on.
        state.mesh = mesh
    tp_axis = getattr(state.model, "tp_axis", None)
    if tp_axis is not None:
        # This fit's model-axis totals, as step_fn.comms holds its own.
        tp_axis.restart_comms()

    resumed_step: int | None = None
    resume_meta: dict = {}
    start_epoch = 0
    if resume and checkpointer is not None:
        from machine_learning_apache_spark_tpu_torch.train import checkpoint as _ckpt

        if world > 1:
            # A barrier: every rank's earlier saves (an earlier fit of
            # this gang's processes) are on disk before any rank reads
            # the group's pointers.
            mesh.all_reduce_(torch.zeros(1))
        # Topology is checked BEFORE any restore: every rank resolves the
        # same old stamp from its group, so every rank takes the same
        # route.
        current = _ckpt.topology_stamp(state)
        old = checkpointer.newest_topology_stamp()
        if old is not None and not _ckpt.same_topology(old, current):
            raise _ckpt.TopologyMismatch(
                f"checkpoints under {checkpointer.directory} were "
                f"written by a different topology — checkpoint "
                f"topology {old} vs this run's {current}. Pass "
                "elastic=True (or set MLSPARK_ELASTIC=1, which "
                "Distributor(elastic=True) does) to reshard, or "
                "point the run at a fresh checkpoint directory. "
                "(Resharding, to another world or model-axis size, is "
                "train/reshard.py: ROADMAP queue A4, not ported yet.)"
            )
        restored = checkpointer.restore_latest_valid(state)
        if world > 1:
            _check_resume_agreed(mesh, restored[1] if restored is not None else None)
        if restored is not None:
            state, resumed_step, resume_meta = restored
            if "rng" in resume_meta:
                rng = _gen_from_meta(torch.Generator(), resume_meta["rng"])
            start_epoch = int(resume_meta.get("epoch", -1)) + 1
            emit(
                f"resuming from checkpoint step {resumed_step} "
                f"(starting epoch {start_epoch})"
            )
    if "dropout_rng" in resume_meta:
        _gen_from_meta(step_rng, resume_meta["dropout_rng"])
    else:
        seed = int(torch.randint(_SEED_RANGE, (), generator=rng))
        if world > 1:
            # Each replica its own dropout masks (DDP's replicas draw
            # their own): the fit's seed mixed with the data index (the
            # rank on a pure data mesh). The ranks of one model line, and
            # of one seq line, share it: they drop the same elements of
            # their replicated activations. Each pipeline stage draws for
            # its own layers.
            # Data index 0, stage 0 keeps the one-process seed.
            seed = (seed + mesh.index("data") * 0x9E3779B97F4A7C15
                    + mesh.index("pipeline") * 0xC2B2AE3D27D4EB4F) % _SEED_RANGE
        step_rng.manual_seed(seed)

    step_fn = None
    if mode == "zero1":
        # Every replica starts from rank 0's parameters (the shard from
        # them), as DDP's constructor broadcast makes it below.
        from machine_learning_apache_spark_tpu_torch.parallel.mesh import replicate

        replicate(mesh, state.params)
        state.refresh_shard()
        step_fn = _with_comms_counters(_zero.make_zero1_step(loss_fn, mesh, state), state)
    elif world > 1:
        from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import (
            make_data_parallel_step,
        )
        step_fn = make_data_parallel_step(loss_fn, mesh)
        # DDP's constructor broadcast: every replica starts from rank 0's
        # parameters.
        step_fn.replica(state.model)
        if zero1:
            state.refresh_owned()
    dispatch = StepDispatch(state, loss_fn, step_rng, step_fn=step_fn)
    tracer = StepWindowTracer(
        profile_dir, start=profile_window[0], stop=profile_window[1]
    )
    # Rank-0 gated like the JAX loop: a gang writing one shared file would
    # duplicate every record.
    is_rank0 = mesh is None or mesh.rank == 0
    sink = MetricsLogger(metrics_file) if metrics_file and is_rank0 else None
    total_timer = Timer("train").start()
    span_timer = Timer("span").start()
    step_losses: list[float] = []
    try:
        with telemetry.span(
            "train.fit", epochs=epochs, steps_per_call=steps_per_call,
            resumed_step=resumed_step, device=str(device), world=world,
        ):
            try:
                history = _run_epochs(
                    dispatch, train_loader, epochs, rng, log_every, emit,
                    span_timer, sink, checkpointer, checkpoint_every,
                    steps_per_call, start_epoch, resumed_step or 0,
                    step_losses, tracer, mesh, sync_check_every,
                )
            except BaseException as e:
                # Flight recorder: an unhandled exception out of the
                # training loop ships with its last events (the failing
                # step's spans are the newest entries).
                telemetry.dump_flight(
                    f"train.fit:{type(e).__name__}", extra={"error": str(e)[:500]}
                )
                raise
            finally:
                # Stops a window the run ended or raised inside: the
                # profiler is process-wide, and a running one would make
                # every later trace in the process fail to start.
                tracer.close()
                # Comms byte totals land on the event log even for a run
                # that died mid-epoch.
                if hasattr(step_fn, "flush_comms"):
                    step_fn.flush_comms()
                for line in (pp_line, sp_line):
                    if line is not None:
                        line.comms.emit_counters()
        if not history and resume_meta.get("metrics"):
            # An already-complete resume: report the last epoch's metrics
            # from its sidecar.
            history = [dict(resume_meta["metrics"])]
        # Block on the device so the wall time includes its work.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = total_timer.stop()
        if checkpointer is not None:
            checkpointer.wait()  # durability barrier, outside the timed span
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
    comms = step_fn.comms.stats() if step_fn is not None else {}
    tp_axis = getattr(state.model, "tp_axis", None)
    if tp_axis is not None:
        comms |= tp_axis.comms.stats()
    for line in (pp_line, sp_line):
        if line is not None:
            comms |= line.comms.stats()
    return FitResult(
        state=state, train_seconds=seconds, history=history,
        resumed_step=resumed_step, step_losses=step_losses,
        programs=dispatch.programs.stats(), comms=comms,
    )


def _drain_into(metrics: MetricBundle, pending: list, loss_name: str,
                step_losses: list | None = None) -> None:
    """Move pending ``(values [m], aux {name: [m]}, n)`` device values to
    the host in one copy per metric and fold each value into ``metrics``
    on its own, with weight ``n``: a training entry holds one loss per
    step (``n`` 1), so the epoch's mean is the same bits whether its
    steps ran one at a time or K per program; an eval entry holds one
    batch's mean over its ``n`` rows. ``step_losses`` collects the
    values."""
    if not pending:
        return
    losses = torch.cat([p[0].reshape(-1) for p in pending]).tolist()
    aux = {
        k: torch.cat([p[1][k].reshape(-1) for p in pending]).tolist()
        for k in pending[0][1]
    }
    weights = [p[2] for p in pending for _ in range(p[0].numel())]
    for i, n in enumerate(weights):
        metrics.mean(loss_name).update(losses[i], n)
        for k, vals in aux.items():
            metrics.mean(k).update(vals[i], n)
    if step_losses is not None:
        step_losses.extend(losses)
    pending.clear()


def _run_epochs(
    dispatch, train_loader, epochs, rng, log_every, emit, span_timer, sink,
    checkpointer, checkpoint_every, steps_per_call, start_epoch, start_step,
    step_losses, tracer, mesh=None, sync_check_every=0,
):
    state = dispatch.state
    history: list[dict] = []
    # On resume the step counter continues from the restored checkpoint, so
    # log lines mean the same thing in a resumed run as in an uninterrupted
    # one.
    global_step = start_step
    last_emit_step = global_step
    for epoch in range(start_epoch, epochs):
        with telemetry.span("train.epoch", epoch=epoch):
            beacon_update(phase="train", epoch=epoch, step=global_step)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            epoch_metrics = MetricBundle()
            # Step outputs stay on the device until a log point: reading
            # them per step would sync the host into every step.
            pending: list[tuple] = []

            def run(call, arg, count):
                nonlocal global_step, last_emit_step
                prev = global_step
                tracer.on_step(prev)
                with telemetry.span("train.step", step=prev, count=count):
                    # On the host, before the step's work: a K-step call
                    # checks every step it covers, so a step-pinned fault
                    # fires whatever steps_per_call is.
                    for s in range(prev, prev + count):
                        maybe_fault("train_step", step=s)
                    losses, aux = call(arg)
                global_step += count
                pending.append((losses, aux, 1))
                # Stride-aware: a K-step call can jump past the multiple.
                if log_every and global_step // log_every > prev // log_every:
                    covered = global_step - last_emit_step
                    last_emit_step = global_step
                    beacon_update(phase="train", step=global_step)
                    _drain_into(epoch_metrics, pending, "loss", step_losses)
                    emit(
                        f"epoch {epoch} step {global_step} | "
                        f"{epoch_metrics.log_line()} | "
                        f"{span_timer.lap():.3f} sec/{covered} batches"
                    )

            group: list = []
            for batch in train_loader:
                if steps_per_call == 1:
                    run(dispatch.single, batch, 1)
                    continue
                group.append(batch)
                if len(group) == steps_per_call:
                    run(dispatch.group, group, len(group))
                    group = []
            # A ragged trailing group runs as single steps: a program per
            # remainder length would be one more capture each.
            for batch in group:
                run(dispatch.single, batch, 1)
            _drain_into(epoch_metrics, pending, "loss", step_losses)
            computed = epoch_metrics.compute()
            computed["epoch"] = epoch
            history.append(computed)
            if sink is not None:
                sink.write({"kind": "epoch", "step": state.step, **computed})
            if log_every:
                emit(f"epoch {epoch} done | {epoch_metrics.log_line()}")
            if sync_check_every and (epoch + 1) % sync_check_every == 0:
                # Before the checkpoint save: a diverged state must raise
                # here, not be persisted as the newest resumable step.
                from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import (
                    assert_replicas_in_sync,
                )

                div = assert_replicas_in_sync(state, mesh=mesh)
                emit(f"epoch {epoch} replica divergence: {div:.3g}")
            if checkpointer is not None and (
                (epoch + 1) % max(checkpoint_every, 1) == 0 or epoch == epochs - 1
            ):
                # The save snapshots the state to the host before it
                # returns (after the device work that writes it) and
                # writes the files on a thread. The sidecar carries what
                # resume needs to continue the exact trajectory.
                checkpointer.save(state, wait=False, meta={
                    "epoch": epoch,
                    "epochs": epochs,
                    "rng": _gen_to_meta(rng),
                    "dropout_rng": _gen_to_meta(dispatch.rng),
                    "metrics": {
                        k: (v if isinstance(v, int) else float(v))
                        for k, v in computed.items()
                    },
                })
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
    is returned as ``eval_samples`` so callers can assert full coverage.

    With a ``mesh`` over several processes each batch's loss and metrics
    are the global batch's (``make_data_parallel_eval_step``: every rank
    passes its own shard), weighted, as in the JAX loop, by this rank's
    rows, which ``eval_samples`` counts. A local batch whose rows do not
    divide this rank's share of the data axis is skipped with a warning,
    the JAX loop's treatment of a ragged local tail under a gang (with one
    device per rank the share is 1, so none is)."""
    from machine_learning_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS

    emit = emit or log.info
    device = _device_of(state)
    world = mesh.size if mesh is not None else 1
    if world > 1:
        from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import (
            make_data_parallel_eval_step,
        )

        step_fn = make_data_parallel_eval_step(loss_fn, mesh)
    else:
        eval_step = make_eval_step(loss_fn)

        def step_fn(state, batch, rng):
            return eval_step(state, to_device(batch, device), rng)
    # One device per process: each rank's share of the data axis is 1.
    local_size = max(mesh.shape.get(DATA_AXIS, 1) // world, 1) if mesh is not None else 1
    metrics = MetricBundle()
    pending: list[tuple] = []
    total = 0
    for batch in eval_loader:
        n = len(batch[0])
        if world > 1 and n % local_size:
            log.warning(
                "skipping %d-row ragged eval tail: a process-local tail "
                "cannot join the sharded step (%d local devices)",
                n, local_size,
            )
            continue
        loss, aux = step_fn(state, batch, rng)
        total += n
        pending.append((loss, aux, n))
    _drain_into(metrics, pending, "test_loss")
    tp_axis = getattr(state.model, "tp_axis", None)
    if tp_axis is not None:
        # The evaluation's all-reduces are no training step's.
        tp_axis.restart_comms()
    out = metrics.compute()
    emit(" | ".join(f"{k}: {v:.5f}" for k, v in out.items()))
    out["eval_samples"] = total
    return out


def select_last_valid(
    logits: torch.Tensor, tokens: torch.Tensor, pad_id: int
) -> torch.Tensor:
    """``[B, T, C]`` logits → ``[B, C]`` at each row's last non-pad
    position (all-pad rows fall back to position 0). Training loss and
    serving (``inference.Classifier``) MUST select through this one helper
    — scoring a different timestep than the loss trained silently degrades
    every deployed last-valid classifier."""
    idx = ((tokens != pad_id).sum(dim=-1) - 1).clamp(min=0)
    return torch.gather(
        logits, 1, idx[:, None, None].expand(-1, 1, logits.shape[-1])
    )[:, 0, :]


def classification_loss(
    model: nn.Module | None = None, *, last_timestep: bool = False,
    train: bool = True, pad_id: int | None = None,
) -> LossFn:
    """Standard CE classification loss over ``(features, labels)`` batches.

    ``model`` stands where the JAX function takes the model's ``apply_fn``
    and may be left out: under the port's loss contract the loss calls the
    module it is handed (``loss_fn(module, batch, rng)``, the state's model
    in ``fit``).

    ``last_timestep=True`` selects ``logits[:, -1, :]`` — the LSTM recipe's
    last-position head (``pytorch_lstm.py:160``). With ``pad_id`` set, the
    selection becomes each row's last NON-PAD position instead of the fixed
    final column (``select_last_valid``). ``train=True`` hands ``rng`` to
    the model's dropout (``model.train()``); ``train=False`` runs it
    deterministic (the eval pass, ``pytorch_cnn.py:154-176``). The aux
    output is ``{"accuracy": ...}``."""
    from machine_learning_apache_spark_tpu_torch.train.losses import cross_entropy
    from machine_learning_apache_spark_tpu_torch.train.metrics import logits_accuracy

    del model

    def loss_fn(module, batch, rng):
        features, labels = batch
        logits = module(features, dropout_rng=rng if train else None)
        if last_timestep:
            if pad_id is not None:
                logits = select_last_valid(logits, features, pad_id)
            else:
                logits = logits[:, -1, :]
        loss = cross_entropy(logits, labels)
        return loss, {"accuracy": logits_accuracy(logits, labels)}

    return loss_fn
