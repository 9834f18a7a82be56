"""Data parallelism — the reference's DDP layer over the process group;
the port of ``machine_learning_apache_spark_tpu/parallel/data_parallel.py``.

The reference wraps each model in ``DDP(model)`` over a gloo process group
and lets backward hooks all-reduce the gradients (C11,
``distributed_cnn.py:152-156``); so does the port. The JAX package's
``fit(mesh=)`` compiles one step over the *global* batch, so its loss and
gradient are the global batch's. Here each rank holds its own slice and:

1. sums its loss weight — the count the loss averages over
   (``loss_weight(batch)``: the rows for the zoo's per-row mean, the valid
   target tokens for the translation loss) — over the ranks, read from the
   host batch before it moves to the device;
2. back-propagates its loss through ``DistributedDataParallel`` scaled by
   ``world × weight / total weight``: DDP's mean over the ranks of the
   scaled gradients is then the gradient of the global loss (with equal
   weights the scale is exactly 1: plain DDP). The gradients are reduced
   once per optimizer step: a step that only accumulates runs under
   ``no_sync``;
3. after the update, sums ``[loss × weight, aux × weight]`` over the ranks
   for the global batch's reported loss and aux.

Averaging the ranks' own means instead would weight a rank with few valid
tokens as much as one with many: a different gradient for the MT loss.

A DDP comm hook times each bucket's all-reduce on the host, from its
launch to its completion (``comms.grad_allreduce`` spans), and the step
counts the bytes reduced (``comms.bytes_allreduced``).

All of this runs over this rank's line of the **data** axis: DDP's
group, the weights, the loss sums, the replica check. On a ``data ×
model`` mesh (tensor parallelism, ``parallel.tensor_parallel``) the ranks
of one model line see the same rows and hold different shards; summing
over the whole gang would count the rows M times and mix the shards. A
mesh without a data axis has one replica and no data-parallel sums. The
model's own collectives run inside its forward and backward.

On a mesh with a ``"seq"`` axis (``parallel.sequence``) the ranks of
one seq line see the same rows and hold the same whole model; under
``sequence_parallel`` each attention site splits its sequence over them
and gathers the output back, so their gradients are the same bits: DDP
and the sums stay the data line's, and ``assert_replicas_in_sync`` also
holds each seq line to the same bits. The line's collectives are closed
once per step (``SeqLine.comms``).

On a mesh with a ``"pipeline"`` axis (``parallel.pipeline_parallel``)
the ranks of one pipeline line see the same rows and hold the whole
model, but each computes the gradients of its own stage's layers only
(and stage 0 the embeddings'). There is no DDP: after the backward of
an update's last microbatch one all-reduce over the whole mesh
(``pipeline_parallel.GradSync``) sums, for each parameter, the
gradients of the ranks of the stage that owns it — the others put
zeros — divided by the data axis's size, so every rank applies the same
update to the same parameters. The loss weights and sums stay the data
line's. ``assert_replicas_in_sync`` compares the whole mesh there.

``params_fingerprint`` is the JAX package's weighted sum of |p| per leaf,
in the Flax tree's leaf order; ``assert_replicas_in_sync`` compares it
across the ranks. The loss-weight helpers here (``loss_weight_of``,
``_total_weight``, ``_global_means``) serve the ZeRO-1 step
(``parallel.zero``) too.
"""

from __future__ import annotations

import inspect
import threading
import time
from contextlib import nullcontext
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQ_AXIS,
    Mesh,
)

_TINY = float(np.finfo(np.float32).tiny)

# DDP's switch for the buffer broadcast before each forward, under the
# name this torch gives it.
_NO_FORWARD_BUFFER_SYNC = (
    {"forward_sync_buffers": False}
    if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
    else {"broadcast_buffers": False}
)


def loss_weight_of(loss_fn: Callable) -> Callable:
    """The count ``loss_fn`` averages over, as a function of its batch:
    the loss's own ``loss_weight`` attribute when it has one, else the
    batch's rows."""
    weight = getattr(loss_fn, "loss_weight", None)
    return weight if weight is not None else (lambda batch: batch[0].shape[0])


class _Replica(DistributedDataParallel):
    """``DDP(model)`` through which a loss still reads the model's own
    attributes (the translation loss reads ``model.cfg``)."""

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


class GradientComms:
    """The gradient all-reduce, as DDP's comm hook: each bucket is divided
    by the world and summed over the ranks (DDP's own default), and timed
    on the host from its launch to its completion — a
    ``comms.grad_allreduce`` span per bucket. ``stats()`` gives the
    totals: buckets reduced, synchronised steps, the buckets' seconds
    summed, each step's window from its first bucket's launch to its last
    one's completion summed, and bytes."""

    def __init__(self, world: int):
        self.world = world
        self.calls = 0
        self.steps = 0
        self.seconds = 0.0
        self.window = 0.0
        self.bytes = 0
        self._first: float | None = None
        self._last = 0.0
        self._lock = threading.Lock()

    def hook(self, group, bucket):
        buf = bucket.buffer()
        buf.div_(self.world)
        nbytes = buf.numel() * buf.element_size()
        t0 = time.perf_counter()
        with self._lock:
            if self._first is None:
                self._first = t0
        fut = dist.all_reduce(buf, group=group, async_op=True).get_future()

        def done(f):
            t1 = time.perf_counter()
            dur = t1 - t0
            with self._lock:
                self.calls += 1
                self.seconds += dur
                self.bytes += nbytes
                self._last = max(self._last, t1)
            telemetry.get_log().emit(
                "span_end", "comms.grad_allreduce", value=dur, attrs={"bytes": nbytes}
            )
            return f.value()[0]

        return fut.then(done)

    def end_step(self) -> None:
        """Close a synchronised step (after its backward, which waits for
        every bucket)."""
        with self._lock:
            self.steps += 1
            if self._first is not None:
                self.window += self._last - self._first
            self._first = None

    def stats(self) -> dict:
        return {
            "allreduce_calls": self.calls,
            "allreduce_steps": self.steps,
            "allreduce_seconds": self.seconds,
            "allreduce_bytes": self.bytes,
            "allreduce_window_seconds": self.window,
            "allreduce_ms_per_step": 1e3 * self.window / max(self.steps, 1),
        }


def _total_weight(mesh: Mesh, weight: float) -> float:
    """The loss weight summed over the data replicas (a host collective)."""
    t = torch.tensor([weight], dtype=torch.float64)
    with telemetry.span("comms.weight_allreduce"):
        mesh.all_reduce_(t, axis=DATA_AXIS)
    return float(t[0])


def _global_means(mesh: Mesh, weight: float, loss: torch.Tensor, aux: dict,
                  total: float | None = None):
    """``(loss, aux)`` of the global batch — the weight-averaged means over
    every rank's rows — from one all-reduce of ``[loss × weight, aux ×
    weight]`` (and the weight itself when ``total`` is not known yet)."""
    keys = list(aux)
    parts = [loss.detach().float() * weight, *(aux[k].detach().float() * weight for k in keys)]
    if total is None:
        parts.append(torch.full((), weight, dtype=torch.float32, device=loss.device))
    stats = torch.stack(parts)
    with telemetry.span("comms.loss_allreduce"):
        mesh.all_reduce_(stats, axis=DATA_AXIS)
    denom = stats[-1].clamp_min(_TINY) if total is None else max(total, _TINY)
    stats = stats / denom
    return stats[0], {k: stats[1 + i] for i, k in enumerate(keys)}


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_data_parallel_step(loss_fn: Callable, mesh: Mesh, *, axis: str = DATA_AXIS):
    """One data-parallel training step: ``step(state, batch, rng) ->
    (state, loss, aux)`` like ``train.loop.make_train_step``, with the
    loss and aux of the global batch. ``batch`` is this rank's slice, on
    the host (its loss weight is read there) or already on the device;
    ``loss_fn(model, batch, rng)`` runs through ``DDP(state.model)``,
    built at the first step over the data axis's group (its constructor
    broadcasts the first data rank's parameters). ``step.comms`` is the
    ``GradientComms``; on a mesh with a model axis the model's
    ``TPComms`` is closed once per step. On a mesh with a pipeline axis
    the gradients are synced by ``pipeline_parallel.GradSync`` instead
    of DDP (``step.comms``), the first step's ``replica`` broadcasts
    rank 0's parameters and buffers over the whole mesh, and the line's
    ``PPComms`` is closed once per step; on a mesh with a seq axis the
    seq line's ``SPComms`` is.

    Accumulation (``accumulate_steps=K``) reduces once per update: the
    first K - 1 microbatches back-propagate under ``no_sync`` into the
    state's running mean; the K-th back-propagates onto their sum, so DDP
    reduces the sum of all K, and the mean is that over K."""
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    del axis  # the data axis: the whole group, or its line on a hybrid mesh
    weight_of = loss_weight_of(loss_fn)
    dp_world = mesh.axis_size(DATA_AXIS)
    pipelined = mesh.axis_size(PIPELINE_AXIS) > 1
    line = None
    if pipelined:
        from machine_learning_apache_spark_tpu_torch.parallel import pipeline_parallel as _pp

        comms = _pp.GradSync(mesh)
        line = _pp.pipeline_line(mesh)
    else:
        comms = GradientComms(dp_world)
    sp_line = None
    if mesh.axis_size(SEQ_AXIS) > 1:
        from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_line

        sp_line = sequence_line(mesh)
    counter = telemetry.get_registry().counter("comms", "bytes_allreduced")
    held: dict = {}

    def replica(model: nn.Module) -> nn.Module:
        if pipelined:
            if held.get("model") is not model:
                # DDP's constructor broadcast, over every rank of the mesh.
                with torch.no_grad():
                    for t in [*model.parameters(), *model.buffers()]:
                        mesh.broadcast_(t.data, src=0)
                held.update(model=model)
            return model
        if dp_world == 1:
            return model
        if held.get("model") is not model:
            # Buffers are tables every rank builds alike (positional
            # encodings): no broadcast before every forward.
            group = mesh.group(DATA_AXIS)
            ddp = _Replica(model, process_group=group, **_NO_FORWARD_BUFFER_SYNC)
            # The hook's state is the group its all-reduce runs over.
            ddp.register_comm_hook(group, comms.hook)
            held.update(model=model, ddp=ddp)
        return held["ddp"]

    def step(state, batch, rng):
        world = dp_world
        weight = float(weight_of(batch))
        total = _total_weight(mesh, weight)
        model = replica(state.model)
        batch = to_device(batch, _device_of(state.model))
        emits = state.emits(state.mini_step)
        k = state.tx.accumulate_steps
        onto_sum = (world > 1 or pipelined) and k > 1 and emits
        if onto_sum:
            with torch.no_grad():
                for p, acc in zip(state.params, state.acc_grads):
                    p.grad = acc * state.mini_step
        with nullcontext() if emits or world == 1 or pipelined else model.no_sync():
            loss, aux = loss_fn(model, batch, rng)
            (loss * (weight * world / max(total, _TINY))).backward()
        if pipelined and emits:
            comms.sync_(state.params)
        if onto_sum:
            with torch.no_grad():
                # The running mean becomes the reduced mean, so the
                # state's accumulate step leaves it as it is.
                for p, acc in zip(state.params, state.acc_grads):
                    acc.copy_(p.grad.div_(k))
        if (world > 1 or pipelined) and emits:
            nbytes = sum(p.numel() * p.element_size() for p in state.params)
            comms.end_step()
            counter.inc(nbytes)
            telemetry.get_log().emit(
                "counter", "comms.bytes_allreduced", value=nbytes, attrs={"steps": 1}
            )
        state.apply_gradients()
        g_loss, g_aux = _global_means(mesh, weight, loss, aux, total)
        tp_axis = getattr(state.model, "tp_axis", None)
        if tp_axis is not None:
            tp_axis.comms.end_step()
        for open_line in (line, sp_line):
            if open_line is not None:
                open_line.comms.end_step()
        return state, g_loss, g_aux

    step.comms = comms
    step.replica = replica
    return step



def make_data_parallel_eval_step(loss_fn: Callable, mesh: Mesh, *, axis: str = DATA_AXIS):
    """Eval counterpart: ``step(state, batch, rng) -> (loss, aux)`` of the
    global batch, under ``torch.no_grad``; ``batch`` on the host or the
    device."""
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    del axis
    weight_of = loss_weight_of(loss_fn)

    @torch.no_grad()
    def step(state, batch, rng):
        weight = float(weight_of(batch))
        loss, aux = loss_fn(state.model, to_device(batch, _device_of(state.model)), rng)
        return _global_means(mesh, weight, loss, aux)

    return step


def pad_batch_to_multiple(batch, multiple: int):
    """Pad the leading dim so it divides ``multiple``: ``(padded_batch,
    real_count)``, padded rows repeating row 0 (the JAX function's
    contract). ``batch`` is a tuple/list of arrays or tensors."""
    n = batch[0].shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return batch, n
    pad = target - n

    def _pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[:1].repeat_interleave(pad, dim=0)], dim=0)
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)

    return type(batch)(_pad(x) for x in batch), n


def _leaves(params) -> list[torch.Tensor]:
    """The tensors to fingerprint, in the JAX package's leaf order: a
    ``TrainState`` or ``nn.Module`` by its Flax tree paths (sorted level
    by level, as ``jax.tree.leaves`` orders a dict tree), a dict tree
    (an optimizer state) by its sorted keys, a sequence of tensors as
    given."""
    model = getattr(params, "model", params)
    if isinstance(model, nn.Module):
        from machine_learning_apache_spark_tpu_torch.weights import flax_named_parameters

        return [p for _, p in sorted(
            flax_named_parameters(model), key=lambda kv: tuple(kv[0].split("/"))
        )]
    if isinstance(params, dict):
        return [t for k in sorted(params, key=str) for t in _leaves(params[k])]
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for p in params for t in _leaves(p)]


@torch.no_grad()
def params_fingerprint(params) -> float:
    """Order-stable scalar fingerprint: ``Σ (i + 1) · Σ|p_i|`` over the
    leaves (each sum in float32, the total in float64) — the JAX
    package's, on the same weights within float32 summation order.
    Accepts a ``TrainState``, an ``nn.Module`` or a sequence of tensors."""
    leaves = _leaves(params)
    if not leaves:
        return 0.0
    sums = torch.stack([p.detach().float().abs().sum() for p in leaves]).tolist()
    total = 0.0
    for i, v in enumerate(sums):
        total += (i + 1) * v
    return total


@torch.no_grad()
def bits_checksum(params) -> int:
    """An exact checksum of the parameters' bits: each leaf's elements as
    integers of their width, summed, weighted by the leaf's place (the
    fingerprint's leaf order), modulo a 61-bit prime. Equal bits give
    equal checksums on any device."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    total = 0
    for i, p in enumerate(_leaves(params)):
        t = p.detach().contiguous()
        s = t.view(ints[t.element_size()]).to(torch.int64).sum()
        total = (total + (i + 1) * int(s)) % (2**61 - 1)
    return total


def assert_replicas_in_sync(params, *, atol: float = 1e-6, mesh: Mesh | None = None) -> float:
    """Race-detector analogue (SURVEY.md §5): gather every rank's
    parameter fingerprint and assert they agree within ``atol`` relative —
    the check for the reference's Q2-class replica drift
    (``distributed_cnn.py:175``). One process passes trivially. Returns
    the largest divergence from rank 0's. On a mesh with a model axis the
    replicas are the ranks of one data line (each model rank holds its
    own shards), compared line by line; on a pipeline mesh every rank
    holds the whole model, so the whole mesh is compared. On a mesh with
    a seq axis each seq line must hold the same bits besides (a checksum
    of the parameters' bits, equal on every rank of the line). A state is
    checked by its parameters (a ZeRO-1 state's are replicated); an
    optimizer state sharded over the ranks
    (``parallel.zero.ShardedOptState``) raises ``ValueError``: its ranks
    hold different data by design."""
    from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
        data_parallel_mesh,
        process_count,
    )
    from machine_learning_apache_spark_tpu_torch.parallel.zero import ShardedOptState

    if isinstance(params, ShardedOptState):
        raise ValueError(
            "assert_replicas_in_sync needs a replicated tree; this optimizer "
            "state is sharded over the data axis (each rank holds its own "
            "shard), so its fingerprints differ by design"
        )

    fp = params_fingerprint(params)
    if mesh is None:
        if process_count() == 1:
            return 0.0
        mesh = data_parallel_mesh()
    if mesh.axis_size(SEQ_AXIS) > 1 and process_count() > 1:
        n = mesh.axis_size(SEQ_AXIS)
        sums = torch.zeros(n, dtype=torch.int64)
        sums[mesh.index(SEQ_AXIS)] = bits_checksum(params)
        mesh.all_reduce_(sums, axis=SEQ_AXIS)
        if bool((sums != sums[0]).any()):
            raise AssertionError(
                f"the {n} ranks of a seq line hold different parameter bits "
                f"(checksums {sums.tolist()})"
            )
    axis = DATA_AXIS if mesh.axis_size(MODEL_AXIS) > 1 else None
    world = mesh.axis_size(DATA_AXIS) if axis else mesh.size
    if world == 1:
        return 0.0
    slots = torch.zeros(world, dtype=torch.float64)
    slots[mesh.index(DATA_AXIS) if axis else mesh.rank] = fp
    mesh.all_reduce_(slots, axis=axis)
    div = float((slots - slots[0]).abs().max())
    if div > atol * max(abs(fp), 1.0):
        raise AssertionError(f"replica divergence {div} across {world} processes")
    return div
