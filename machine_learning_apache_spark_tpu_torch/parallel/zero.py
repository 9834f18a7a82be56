"""ZeRO-1 sharded weight update for the data-parallel path — the port of
``machine_learning_apache_spark_tpu/parallel/zero.py``.

``make_data_parallel_step`` replicates everything: every rank holds the
full parameters *and* the full optimizer moments and pays a full-gradient
all-reduce per step. The all-reduce is a reduce-scatter and an
all-gather, and the weight update between the two halves only needs 1/N
of the gradient (arxiv 2004.13336), so each rank owns 1/N of the
parameters for the update and the moments shrink by N:

    reduce_scatter(grads) -> update on this rank's shard -> all_gather(params)

with the collectives of ``torch.distributed`` over the gang's group:

- the parameters' ``.grad`` are views into one flat float32 buffer,
  padded to a multiple of the world, so flattening the gradient costs no
  copy; the parameters keep their own tensors (the GEMMs read them
  aligned), and each bucket's all-gather lands in one of two
  bucket-sized buffers, copied into the parameters it spans. The flat
  vector is cut into **buckets**
  (``bucket_bytes``, each a multiple of the world long, the zero pad in
  the last); each bucket is divided by the world and reduce-scattered
  (``reduce_scatter_tensor``, SUM), DDP's own arithmetic, so the float32
  wire gives the replicated step's bits;
- each bucket may travel in a compressed ``comms_dtype``: ``bfloat16``
  (cast, reduce, cast back) or ``int8`` with the per-bucket scale
  ``max(max_ranks |seg| · N / 127, 1e-30)``, so the N-way int8 sum cannot
  overflow (EQuARX, arxiv 2506.17615); parameters and moments stay
  float32;
- the optimizer (``make_optimizer``'s chain) is built over this rank's
  shard only, one tensor per bucket piece: the replicated moments never
  exist, so the optimizer's memory is ~1/N from the first step;
- ``grad_clip`` clips by the *global* norm: each rank's sum of squares
  over its shard, all-reduced (a scalar), never the shard's own norm;
- with ``overlap=True`` (the default; ``MLSPARK_ZERO1_OVERLAP``) each
  bucket's reduce-scatter is issued from backward as soon as all of its
  gradients are accumulated (post-accumulate-grad hooks), in reverse
  bucket order — the order backward produces them — and on the tail each
  bucket is updated and its all-gather issued at once, so the gather of
  bucket k runs while bucket k+1 updates. ``overlap=False`` is the serial
  schedule: reduce-scatter every bucket after backward, one update, then
  all-gather every bucket. Both are elementwise the same, so float32
  training is bit for bit the same either way.

Shard layout: rank ``i`` owns the ``i``-th 1/N slice of *every bucket*,
concatenated bucket-major — what ``reduce_scatter_tensor`` hands it, and
the JAX layout, so ``plan_layout`` and the checkpoint stamp are the JAX
package's on the same parameters. The flat vector holds the parameters
in the model's registration order (first layer first, as backward
reaches it last).

The JAX package runs the ranks' step as one ``shard_map`` program; here
each rank is a process and the collectives run over gloo, which takes
host and CUDA tensors alike. The implicit form, ``fit(zero1=True)``,
shards each optimizer moment over its leading dimension on top of the
replicated step (``shard_moments``).

On a hybrid ``data × model`` mesh (tensor parallelism over ``"model"``,
``parallel.tensor_parallel``) each rank's flat vector holds its own TP
shards first, then the replicated leaves (``make_hybrid_plan``): two
segments, each cut into buckets. Every bucket is reduce-scattered over
this rank's **data line** (the ranks of one model index hold the same
shards). A bucket of shards is updated whole by its data piece's owner;
a bucket of replicated leaves holds the same values on every model rank,
so each model rank updates 1/M of its data piece and the pieces are
all-gathered over the whole gang (rank ``d·M + m`` owns the ``(d·M +
m)``-th 1/(D·M) of the bucket, in rank order). The moments then cost
1/(D·M) of the model's, as the JAX package's flat ``(data, model)``
sharding does. The float32 wire gives the replicated hybrid step's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import (
    _TINY,
    _global_means,
    _total_weight,
    loss_weight_of,
)
from machine_learning_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TimedCollectives,
)
from machine_learning_apache_spark_tpu_torch.train.state import (
    TrainState,
    clip_by_global_norm,
)
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg

# Environment contract (the launcher's gang plumbing: Distributor sets
# these in every worker, fit() picks them up).
ENV_DP_MODE = "MLSPARK_DP_MODE"
ENV_BUCKET_BYTES = "MLSPARK_ZERO1_BUCKET_BYTES"
ENV_COMMS_DTYPE = "MLSPARK_COMMS_DTYPE"
ENV_OVERLAP = "MLSPARK_ZERO1_OVERLAP"

DP_MODES = ("replicated", "zero1")
COMMS_DTYPES = ("float32", "bfloat16", "int8")

#: DDP's default bucket is 25 MB; the models here are far smaller, and a
#: 4 MiB bucket already gives the reduce-scatter several pipeline stages.
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024

_WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def resolve_dp_mode(dp_mode: str | None) -> str:
    """Explicit argument > ``MLSPARK_DP_MODE`` env > ``"replicated"``."""
    # raw() rather than get_str(): the registry's choices check would raise
    # before this guard, and callers rely on the dp_mode-named message below.
    mode = dp_mode or envcfg.raw(ENV_DP_MODE) or "replicated"
    if mode not in DP_MODES:
        raise ValueError(f"unknown dp_mode {mode!r} (expected one of {DP_MODES})")
    return mode


def _parse_bool(raw: str, *, env: str) -> bool:
    lowered = raw.strip().lower()
    if lowered in ("1", "true", "on", "yes"):
        return True
    if lowered in ("0", "false", "off", "no"):
        return False
    raise ValueError(f"{env}={raw!r} is not a boolean (use 1/0/true/false/on/off)")


@dataclasses.dataclass(frozen=True)
class Zero1Config:
    """Comms knobs of the ZeRO-1 step: the bucket size, the gradient wire
    dtype and the schedule (``overlap``: per-bucket reduce-scatter issued
    from backward and per-bucket update + all-gather, instead of the
    serial barrier; elementwise the same)."""

    axis: str = DATA_AXIS
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    comms_dtype: str = "float32"
    overlap: bool = True

    def __post_init__(self) -> None:
        if self.comms_dtype not in COMMS_DTYPES:
            raise ValueError(
                f"unknown comms_dtype {self.comms_dtype!r} "
                f"(expected one of {COMMS_DTYPES})"
            )
        if self.bucket_bytes < 4:
            raise ValueError(
                f"bucket_bytes must hold at least one fp32 element, "
                f"got {self.bucket_bytes}"
            )

    @classmethod
    def from_env(
        cls,
        *,
        axis: str = DATA_AXIS,
        bucket_bytes: int | None = None,
        comms_dtype: str | None = None,
        overlap: bool | None = None,
    ) -> "Zero1Config":
        """Explicit arguments win; unset ones fall back to the launcher
        env contract, then to defaults."""
        if bucket_bytes is None:
            bucket_bytes = envcfg.get_int(ENV_BUCKET_BYTES, DEFAULT_BUCKET_BYTES)
        if comms_dtype is None:
            comms_dtype = envcfg.get_str(ENV_COMMS_DTYPE)
        if overlap is None:
            raw = envcfg.raw(ENV_OVERLAP)
            overlap = True if raw is None else _parse_bool(raw, env=ENV_OVERLAP)
        return cls(axis=axis, bucket_bytes=bucket_bytes, comms_dtype=comms_dtype, overlap=overlap)


@dataclasses.dataclass(frozen=True)
class _FlatPlan:
    """The parameters ↔ flat float32 vector mapping. The leaves lie in
    one segment or, on a ``data × model`` mesh, two
    (``make_hybrid_plan``); each segment is padded to a multiple of its
    ranks and cut into buckets of multiples of them, so each bucket
    reduce-scatters evenly over the ``world`` data ranks and a segment's
    zero pad lies in its last bucket. ``offsets`` are the leaves' places
    in the vector; ``subs`` per bucket how many model ranks split each
    data piece (1 for a pure data mesh and for TP shards, M for the
    replicated leaves of a hybrid plan)."""

    shapes: tuple
    dtypes: tuple
    sizes: tuple
    total: int
    padded: int
    shard_len: int
    buckets: tuple  # ((start, stop), ...) in flat padded coordinates
    subs: tuple
    offsets: tuple
    world: int

    def piece(self, k: int) -> int:
        """Bucket ``k``'s data piece: what each data rank reduces of it."""
        s, e = self.buckets[k]
        return (e - s) // self.world

    def owned(self, k: int) -> int:
        """What this rank updates of bucket ``k``."""
        return self.piece(k) // self.subs[k]


def _leaves_of(params) -> list:
    """The leaves a plan covers: a dict tree in ``jax.tree.leaves`` order
    (sorted keys, level by level), a sequence as given."""
    if isinstance(params, dict):
        return [leaf for k in sorted(params) for leaf in _leaves_of(params[k])]
    if isinstance(params, (list, tuple)):
        return list(params)
    return [params]


def _dtype_name(leaf) -> str:
    dt = leaf.dtype
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def make_flat_plan(params, axis_size: int, bucket_bytes: int) -> _FlatPlan:
    """The flat plan of ``params`` (a dict tree or a sequence of tensors
    or arrays) over ``axis_size`` ranks — the JAX function's."""
    return make_hybrid_plan(_leaves_of(params), [], axis_size, 1, bucket_bytes)


def make_hybrid_plan(sharded, replicated, data_ways: int, model_ways: int,
                     bucket_bytes: int) -> _FlatPlan:
    """The flat plan of one rank on a ``data × model`` mesh: its TP shards
    (``sharded``), padded to a multiple of ``data_ways`` and bucketed in
    multiples of it, then the ``replicated`` leaves, padded and bucketed
    in multiples of ``data_ways · model_ways``. With no replicated leaves
    it is the flat plan of ``sharded`` over ``data_ways`` ranks."""
    # Bucket element counts are fp32-denominated (the master accumulation
    # dtype) and rounded up to a multiple of the segment's ranks so every
    # bucket reduce-scatters evenly.
    elems = max(bucket_bytes // 4, 1)
    shapes, dtypes, sizes, offsets, buckets, subs = [], [], [], [], [], []
    start = 0
    for leaves, ways, sub in ((sharded, data_ways, 1), (replicated, data_ways * model_ways, model_ways)):
        if not leaves:
            continue
        o = start
        for leaf in leaves:
            shapes.append(tuple(leaf.shape))
            dtypes.append(_dtype_name(leaf))
            sizes.append(int(np.prod(leaf.shape, dtype=np.int64)))
            offsets.append(o)
            o += sizes[-1]
        seg = -(-(o - start) // ways) * ways
        step = -(-elems // ways) * ways
        for b in range(start, start + seg, step):
            buckets.append((b, min(b + step, start + seg)))
            subs.append(sub)
        start += seg
    if not sizes:
        raise ValueError("cannot build a ZeRO-1 plan for an empty params tree")
    shard_len = sum((e - s) // data_ways // sub for (s, e), sub in zip(buckets, subs))
    return _FlatPlan(
        shapes=tuple(shapes), dtypes=tuple(dtypes), sizes=tuple(sizes), total=sum(sizes),
        padded=start, shard_len=shard_len, buckets=tuple(buckets), subs=tuple(subs),
        offsets=tuple(offsets), world=data_ways,
    )


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _flatten(tree, plan: _FlatPlan) -> torch.Tensor:
    """Leaves → one float32 vector of length ``plan.padded``."""
    flat = torch.cat([_as_tensor(l).reshape(-1).float() for l in _leaves_of(tree)])
    return torch.nn.functional.pad(flat, (0, plan.padded - plan.total))


def _bucket_segment(leaves, plan: _FlatPlan, k: int) -> torch.Tensor:
    """Bucket ``k``'s float32 segment assembled from the leaves it spans
    (the zero pad appended in the last bucket)."""
    s, e = plan.buckets[k]
    parts = []
    offset = 0
    for leaf, size in zip(_leaves_of(leaves), plan.sizes):
        lo, hi = max(s, offset), min(e, offset + size)
        if lo < hi:
            parts.append(_as_tensor(leaf).reshape(-1)[lo - offset:hi - offset].float())
        offset += size
    if e > plan.total:
        parts.append(torch.zeros(e - max(s, plan.total)))
    return torch.cat(parts)


def _unflatten(flat: torch.Tensor, plan: _FlatPlan) -> list[torch.Tensor]:
    """Inverse of ``_flatten``: the leaves, reshaped, in their dtypes."""
    return [
        flat[o:o + n].reshape(shape).to(getattr(torch, dt))
        for o, n, shape, dt in zip(plan.offsets, plan.sizes, plan.shapes, plan.dtypes)
    ]


# -- the wire ------------------------------------------------------------------


def int8_scale(absmax: torch.Tensor, world: int) -> torch.Tensor:
    """The int8 wire's per-bucket scale from the bucket's absolute maximum
    over every rank: each rank's values map into ``[-127/N, 127/N]``."""
    return torch.clamp_min(absmax * world / 127.0, 1e-30)


def encode_bucket(seg: torch.Tensor, comms_dtype: str, scale: torch.Tensor | None = None):
    """A float32 bucket segment in its wire dtype (int8 needs the bucket's
    ``int8_scale``)."""
    if comms_dtype == "float32":
        return seg
    if comms_dtype == "bfloat16":
        return seg.to(torch.bfloat16)
    return torch.clamp(torch.round(seg / scale), -127, 127).to(torch.int8)


def decode_piece(piece: torch.Tensor, comms_dtype: str, scale: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """A reduced wire piece back in float32 (into ``out`` when given)."""
    if comms_dtype == "int8":
        return torch.mul(piece.float(), scale, out=out)
    if out is None:
        return piece.float()
    return out.copy_(piece)


def _reduce_scatter_bucket(seg: torch.Tensor, out: torch.Tensor, world: int, comms_dtype: str,
                           group=None):
    """Issue one bucket's gradient reduce-scatter (SUM over the group) of
    ``seg`` in the wire dtype; ``out`` (float32, ``len(seg) / world``)
    receives this rank's piece. Returns ``(work, finish)``: ``finish()``
    waits for the collective and decodes into ``out``. fp32 is exact;
    bf16 is cast, reduced and cast back; int8 takes the bucket's absolute
    maximum over the ranks first (a scalar all-reduce) for its scale."""
    if comms_dtype == "float32":
        work = dist.reduce_scatter_tensor(out, seg, group=group, async_op=True)
        return work, work.wait
    scale = None
    if comms_dtype == "int8":
        absmax = seg.abs().max().reshape(1)
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = int8_scale(absmax, world)
    wire = encode_bucket(seg, comms_dtype, scale)
    piece = torch.empty(out.shape, dtype=wire.dtype, device=out.device)
    work = dist.reduce_scatter_tensor(piece, wire, group=group, async_op=True)
    held = [wire]  # the wire tensor lives until the collective is done

    def finish():
        if held:
            work.wait()
            decode_piece(piece, comms_dtype, scale, out=out)
            held.clear()

    return work, finish


def comms_bytes_per_step(plan: _FlatPlan, config: Zero1Config) -> dict:
    """Static wire accounting for one step (what the telemetry counters
    report): reduce-scatter payload in the wire dtype (+4 bytes per int8
    bucket for the scale), all-gather of the updated float32 parameters.
    The exposed/overlapped split is the JAX package's static pipeline
    model: with ``overlap`` and ``nb`` buckets, ``(nb - 1) / nb`` of each
    collective's bytes count as overlapped; without, all are exposed."""
    wire = _WIRE_ITEMSIZE[config.comms_dtype]
    rs = plan.padded * wire
    if config.comms_dtype == "int8":
        rs += 4 * len(plan.buckets)
    ag = plan.padded * 4
    nb = len(plan.buckets)
    hidden_frac = (nb - 1) / nb if config.overlap else 0.0
    rs_hidden = int(rs * hidden_frac)
    ag_hidden = int(ag * hidden_frac)
    return {
        "reduce_scatter_bytes": rs,
        "allgather_bytes": ag,
        "grad_bytes_fp32": plan.padded * 4,
        "n_buckets": nb,
        "bucket_bytes": config.bucket_bytes,
        "comms_dtype": config.comms_dtype,
        "padded_elems": plan.padded,
        "pad_elems": plan.padded - plan.total,
        "overlap": config.overlap,
        "hidden_fraction": hidden_frac,
        "bytes_overlapped": rs_hidden + ag_hidden,
        "bytes_exposed": (rs - rs_hidden) + (ag - ag_hidden),
    }


def plan_layout(plan: _FlatPlan) -> dict:
    """JSON-safe bucket layout of a plan — the ``layout`` record of the
    checkpoint topology stamp (the JAX function's)."""
    layout = {
        "total": int(plan.total),
        "world": int(plan.world),
        "padded": int(plan.padded),
        "shard_len": int(plan.shard_len),
        "buckets": [[int(s), int(e)] for s, e in plan.buckets],
    }
    if any(sub > 1 for sub in plan.subs):  # the model splits of a hybrid plan
        layout["subs"] = [int(x) for x in plan.subs]
        # The model shards' length before their segment's pad: where the
        # replicated leaves' coordinates start once the pad is taken out
        # (train.reshard re-pads them for another data-axis size).
        seg = min(s for (s, _), sub in zip(plan.buckets, plan.subs) if sub > 1)
        layout["sharded"] = int(sum(n for o, n in zip(plan.offsets, plan.sizes) if o < seg))
    return layout


class ShardedOptState(dict):
    """An optimizer state of which this rank holds only its shard (flat
    moments of the bucket-major layout, or leading-dimension slices):
    not replicated, so ``assert_replicas_in_sync`` refuses it."""


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def opt_state_bytes(opt_state) -> int:
    """Byte size of an optimizer state held here: a torch optimizer, its
    state or a tree of tensors (for a replicated state, the per-rank
    footprint)."""
    if isinstance(opt_state, torch.optim.Optimizer):
        opt_state = list(opt_state.state.values())
    return _tensor_bytes(opt_state)


def opt_state_bytes_per_chip(state) -> int:
    """This rank's optimizer-state bytes: ``opt_state_bytes`` of a
    replicated state, ~1/N of it for a sharded one."""
    opt = getattr(state, "opt_state", None)
    return opt_state_bytes(opt if opt is not None else state.optimizer)


# -- the state -----------------------------------------------------------------


@dataclasses.dataclass
class Zero1State(TrainState):
    """``TrainState`` of the ZeRO-1 step: the model's parameters,
    replicated, their grads views into ``flat_grad``; the optimizer runs
    over ``pieces``, this rank's slice of every bucket (views into
    ``shard``, its master copy), with ``shard_grad`` the reduce-scattered
    gradient. ``params`` are the model's; ``opt_state`` the rank's
    moments as flat vectors (bucket-major, ``shard_len`` long) and the
    step count once."""

    plan: _FlatPlan | None = None
    config: Zero1Config | None = None
    world: int = 1
    rank: int = 0
    flat_grad: torch.Tensor | None = None
    shard: torch.Tensor | None = None
    shard_grad: torch.Tensor | None = None
    pieces: list = dataclasses.field(default_factory=list)
    # Hybrid mesh: this rank's model index, the data line's group (None:
    # the whole gang) and the parameters' order in the flat vector.
    model_rank: int = 0
    group: object | None = None
    order: tuple = ()

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def flat_params(self) -> list[torch.Tensor]:
        """The parameters in the flat vector's order."""
        params = self.params
        return [params[i] for i in self.order] if self.order else params

    def bucket_span(self, k: int) -> tuple[slice, slice]:
        """Bucket ``k``'s part this rank updates: its slice of the flat
        vector and of the shard."""
        s, _ = self.plan.buckets[k]
        n, own = self.plan.piece(k), self.plan.owned(k)
        lo = s + self.rank * n + (self.model_rank * own if self.plan.subs[k] > 1 else 0)
        o = sum(self.plan.owned(j) for j in range(k))
        return slice(lo, lo + own), slice(o, o + own)

    def param_views(self, lo: int, hi: int) -> list[tuple[torch.Tensor, slice]]:
        """The flat range ``[lo, hi)`` as ``(view of a parameter, slice of
        the range)`` pairs, in order (the zero pad has none)."""
        out = []
        for p, o, n in zip(self.flat_params, self.plan.offsets, self.plan.sizes):
            a, b = max(lo, o), min(hi, o + n)
            if a < b:
                out.append((p.detach().view(-1)[a - o:b - o], slice(a - lo, b - lo)))
        return out

    @torch.no_grad()
    def refresh_shard(self) -> None:
        """The shard (this rank's pieces) from the replicated parameters."""
        self.shard.zero_()
        for k in range(len(self.plan.buckets)):
            in_flat, in_shard = self.bucket_span(k)
            piece = self.shard[in_shard]
            for view, sl in self.param_views(in_flat.start, in_flat.stop):
                piece[sl].copy_(view)

    @property
    def opt_state(self) -> ShardedOptState:
        per_piece = [self.optimizer.state.get(p, {}) for p in self.pieces]
        out = ShardedOptState()
        for key, value in per_piece[0].items():
            if isinstance(value, torch.Tensor) and value.ndim >= 1:
                out[key] = torch.cat([st[key].reshape(-1) for st in per_piece])
            else:  # the step count: the same in every piece, kept once
                out[key] = value
        return out

    def apply_gradients(self) -> None:
        raise TypeError(
            "a Zero1State updates through make_zero1_step (reduce-scatter, "
            "the shard's update, all-gather), not apply_gradients"
        )

    def state_dict(self) -> dict:
        """The checkpoint payload: the counters, the accumulator (this
        rank's shard of it), the model's (replicated) parameters and this
        rank's flat moment shard — the JAX ``_detach_local`` of a 1-D
        sharded leaf."""
        return {
            "step": self.step,
            "updates": self.updates,
            "mini_step": self.mini_step,
            "acc_grads": self.acc_grads,
            "model": self.model.state_dict(),
            "optimizer": dict(self.opt_state),
        }

    def load_state_dict(self, payload: dict) -> None:
        """Restore ``payload`` as ``TrainState`` does, its flat moments
        (and accumulator) split over the pieces — a whole vector or this
        rank's run, told apart by length (``train.checkpoint.attach_local``)
        — then the shard from the restored parameters."""
        from machine_learning_apache_spark_tpu_torch.train.checkpoint import attach_local

        lens = [self.plan.owned(k) for k in range(len(self.plan.buckets))]
        per_piece: dict = {i: {} for i in range(len(self.pieces))}
        for key, value in payload["optimizer"].items():
            if isinstance(value, torch.Tensor) and value.ndim >= 1:
                parts = torch.split(attach_local(value, self.plan, self.rank), lens)
            else:  # the step count, the same in every piece
                parts = [value] * len(lens)
            for i, part in enumerate(parts):
                per_piece[i][key] = part.clone() if isinstance(part, torch.Tensor) else part
        acc = payload["acc_grads"]
        super().load_state_dict({
            **payload, "optimizer": per_piece,
            "acc_grads": None if acc is None else [attach_local(a, self.plan, self.rank) for a in acc],
        })
        self.refresh_shard()


def _require_zero1_mesh(mesh, axis: str) -> tuple[int, int]:
    """Validate the mesh for ``dp_mode='zero1'``: ``(axis_size,
    model_ways)``. Any other axis larger than 1 (pipeline, seq, expert)
    raises; a ``model`` axis is the hybrid layout."""
    if axis not in mesh.axis_names:
        raise ValueError(f"zero1 needs a mesh with a {axis!r} axis; got {mesh.axis_names}")
    axis_size = mesh.shape[axis]
    if axis_size <= 1:
        raise ValueError(
            f"zero1 needs a >1 {axis!r} axis to shard over; got {axis_size} "
            f"(mesh {dict(mesh.shape)})"
        )
    model_ways = mesh.shape.get(MODEL_AXIS, 1)
    other = {a: s for a, s in mesh.shape.items() if a not in (axis, MODEL_AXIS) and s > 1}
    if other:
        raise ValueError(
            "dp_mode='zero1' shards the weight update over the data axis "
            "and composes only with tensor parallelism on the 'model' "
            f"axis; mesh has extra >1 axes {other}. Pipeline/sequence/"
            "expert axes restructure the step itself — use the dedicated "
            "paths (parallel.pipeline_parallel, ring/ulysses attention, "
            "moe) on meshes without a zero1 data axis."
        )
    return axis_size, model_ways


@torch.no_grad()
def init_sharded(*, model: nn.Module, tx, mesh, config: Zero1Config | None = None) -> Zero1State:
    """A ``Zero1State`` over ``model`` whose optimizer is built over this
    rank's shard from the start: the replicated moments never exist. The
    parameters' grads become views into one flat float32 buffer.

    On a ``data × model`` mesh the model is first sharded over the model
    axis (``tensor_parallel.shard_params``, unless it is already) and
    the plan is ``make_hybrid_plan``'s: the moments cost 1/(D·M)."""
    config = config or Zero1Config()
    axis_size, model_ways = _require_zero1_mesh(mesh, config.axis)
    params = list(model.parameters())
    odd = sorted({str(p.dtype) for p in params if p.dtype != torch.float32})
    if odd:
        raise ValueError(f"the ZeRO-1 flat vector holds float32 parameters; got {odd}")
    order: tuple = ()
    group = None
    if model_ways > 1:
        from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as _tp

        _tp.shard_params(model, mesh)
        # Beside the data axis only the model axis may shard a leaf
        # (_require_zero1_mesh), so a marked leaf is a model shard.
        order = tuple(
            [i for i, p in enumerate(params) if getattr(p, "shards", ())]
            + [i for i, p in enumerate(params) if not getattr(p, "shards", ())]
        )
        n_sharded = sum(bool(getattr(p, "shards", ())) for p in params)
        ordered = [params[i] for i in order]
        plan = make_hybrid_plan(
            ordered[:n_sharded], ordered[n_sharded:], axis_size, model_ways, config.bucket_bytes
        )
        params = ordered
        group = mesh.group(config.axis)
    else:
        plan = make_flat_plan(params, axis_size, config.bucket_bytes)
    dev = params[0].device
    flat_grad = torch.zeros(plan.padded, device=dev)
    for p, o, n in zip(params, plan.offsets, plan.sizes):
        p.grad = flat_grad[o:o + n].view_as(p)
    shard = torch.zeros(plan.shard_len, device=dev)
    lens = [plan.owned(k) for k in range(len(plan.buckets))]
    pieces = list(torch.split(shard, lens))
    state = Zero1State(
        model=model, optimizer=tx.build(pieces), tx=tx, mesh=mesh,
        acc_grads=[torch.zeros_like(shard)] if tx.accumulate_steps > 1 else None,
        plan=plan, config=config, world=axis_size, rank=mesh.index(config.axis),
        flat_grad=flat_grad, shard=shard, shard_grad=torch.zeros_like(shard), pieces=pieces,
        model_rank=mesh.index(MODEL_AXIS), group=group, order=order,
    )
    state.refresh_shard()
    return state


def shard_optimizer_state(state: TrainState, mesh, config: Zero1Config | None = None) -> Zero1State:
    """``TrainState → Zero1State``, the entry point of
    ``fit(dp_mode="zero1")``. The optimizer state is built sharded, not
    migrated: a fresh state's moments are zeros in both layouts, and
    converting a mid-run state would drop them, so that raises."""
    if isinstance(state, Zero1State):
        return state
    if int(state.step) != 0:
        raise ValueError(
            "shard_optimizer_state re-initializes the optimizer moments "
            f"(sharded from the start); converting a mid-run state at step "
            f"{int(state.step)} would silently discard them. "
            "Start zero1 runs from a fresh state (resume restores into the "
            "sharded layout afterwards)."
        )
    return init_sharded(model=state.model, tx=state.tx, mesh=mesh, config=config)


class Zero1Comms(TimedCollectives):
    """Host-timed collectives of the ZeRO-1 step: each bucket's
    reduce-scatter and all-gather from its issue to the return of the
    step's wait for it (``comms.reduce_scatter`` / ``comms.allgather``
    spans), each step's window per kind, and the bytes on the wire."""

    KINDS = ("reduce_scatter", "allgather")
    STEPS = "zero1_steps"


class _Schedule:
    """One step's bucket reduce-scatters: issued in reverse bucket order,
    each as soon as it and every later bucket are ready (all their
    gradients accumulated), the rest by ``issue_all``."""

    def __init__(self, state: Zero1State, comms: Zero1Comms, leaf_buckets: list):
        self.state = state
        self.comms = comms
        self.leaf_buckets = leaf_buckets
        nb = len(state.plan.buckets)
        self.pending = [0] * nb
        for buckets in leaf_buckets:
            for k in buckets:
                self.pending[k] += 1
        self.next = nb - 1
        self.finish: list = [None] * nb

    def leaf_ready(self, i: int) -> None:
        for k in self.leaf_buckets[i]:
            self.pending[k] -= 1
        while self.next >= 0 and self.pending[self.next] == 0:
            self.issue(self.next)

    def issue(self, k: int) -> None:
        st = self.state
        s, e = st.plan.buckets[k]
        seg = st.flat_grad[s:e]
        # DDP's arithmetic: each rank's share divided by the world, summed.
        seg.div_(st.world)
        _, in_shard = st.bucket_span(k)
        sub = st.plan.subs[k]
        out = st.shard_grad[in_shard] if sub == 1 else torch.empty(
            st.plan.piece(k), device=seg.device
        )
        _, finish = _reduce_scatter_bucket(
            seg, out, st.world, st.config.comms_dtype, group=st.group
        )
        if sub > 1:
            # A replicated bucket: this model rank keeps its 1/M of the
            # data piece.
            own = st.plan.owned(k)
            lo = st.model_rank * own
            reduce = finish

            def finish():
                reduce()
                st.shard_grad[in_shard].copy_(out[lo:lo + own])

        wire = (e - s) * _WIRE_ITEMSIZE[st.config.comms_dtype]
        self.finish[k] = self.comms.timed("reduce_scatter", finish, wire)
        self.next = min(self.next, k - 1)

    def issue_all(self, order) -> None:
        for k in order:
            if self.finish[k] is None:
                self.issue(k)


def make_zero1_step(loss_fn: Callable, mesh, state: Zero1State, *, grad_clip: float | None = None):
    """The ZeRO-1 train step: ``step(state, batch, rng) -> (state, loss,
    aux)`` like ``make_data_parallel_step``'s, with the loss and aux of the
    global batch. ``batch`` is this rank's slice (its loss weight read on
    the host, as the replicated step reads it): the rank's loss is scaled
    by ``world × weight / total weight``, back-propagated into the flat
    gradient, reduce-scattered per bucket, the rank's shard updated
    (accumulate, clip by the global norm, the scheduled lr, the torch
    optimizer), and the updated pieces all-gathered into the
    parameters. ``grad_clip`` defaults to the optimizer's. The step
    carries ``comms`` (``Zero1Comms``) and ``comms_stats`` (the static
    wire bytes per step). On a ``data × model`` mesh the collectives of
    the gradient run over the data line and a replicated bucket's
    all-gather over the gang (the module docstring's hybrid layout)."""
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    if not isinstance(state, Zero1State):
        raise TypeError(
            "make_zero1_step needs a Zero1State (init_sharded / "
            f"shard_optimizer_state), got {type(state).__name__}"
        )
    config, plan = state.config, state.plan
    axis_size, model_ways = _require_zero1_mesh(mesh, config.axis)
    tp_axis = getattr(state.model, "tp_axis", None)
    if plan.world != axis_size or (tp_axis.size if tp_axis else 1) != model_ways or any(
        sub not in (1, model_ways) for sub in plan.subs
    ):
        raise ValueError(
            f"state plan (padded={plan.padded}) does not divide the mesh's "
            f"{config.axis!r} x model layout ({axis_size} x {model_ways}); the "
            "state was built for a different mesh"
        )
    clip = grad_clip if grad_clip is not None else state.tx.grad_clip
    weight_of = loss_weight_of(loss_fn)
    comms = Zero1Comms()
    nb = len(plan.buckets)
    leaf_buckets = []
    for o, n in zip(plan.offsets, plan.sizes):
        leaf_buckets.append([k for k, (s, e) in enumerate(plan.buckets) if s < o + n and o < e])
    live: dict = {}
    if config.overlap:
        # Each leaf's hook tells the running step's schedule its gradient
        # is accumulated (backward runs them on its own thread).
        for i, p in enumerate(state.flat_params):
            p.register_post_accumulate_grad_hook(
                lambda _p, i=i: live["schedule"].leaf_ready(i) if "schedule" in live else None
            )

    def update_piece(k: int, g: torch.Tensor) -> None:
        piece = state.pieces[k]
        piece.grad = g
        state.optimizer.step()
        piece.grad = None

    # Two bucket-sized landing buffers: bucket k's all-gather lands in one
    # while bucket k - 1's is copied out of the other into the parameters.
    longest = max(e - s for s, e in plan.buckets)
    landing = [torch.empty(longest, device=state.shard.device) for _ in range(min(2, nb))]
    bucket_views = [state.param_views(s, e) for s, e in plan.buckets]
    in_flight: list = []

    def land(k: int, wait, buf: torch.Tensor) -> None:
        wait()
        views = bucket_views[k]
        torch._foreach_copy_([v for v, _ in views], [buf[sl] for _, sl in views])

    def gather(k: int) -> None:
        if len(in_flight) == len(landing):
            land(*in_flight.pop(0))
        s, e = plan.buckets[k]
        buf = landing[k % len(landing)]
        # A bucket of shards gathers over the data line; a replicated one,
        # split over the model ranks too, over the gang (rank order is
        # the bucket's order).
        group = state.group if plan.subs[k] == 1 else None
        work = dist.all_gather_into_tensor(buf[:e - s], state.pieces[k], group=group, async_op=True)
        in_flight.append((k, comms.timed("allgather", work.wait, (e - s) * 4), buf))

    @torch.no_grad()
    def update_and_gather(schedule: _Schedule) -> None:
        mini = state.mini_step
        emits = state.emits(mini)
        spans = [state.bucket_span(k)[1] for k in range(nb)]
        needs_all = clip is not None or not config.overlap or not emits
        if needs_all:
            for k in range(nb):
                schedule.finish[k]()
        grads = [state.shard_grad[sl] for sl in spans]
        if state.acc_grads is not None:
            accs = [state.acc_grads[0][sl] for sl in spans]
            for k in range(nb):
                if not needs_all:
                    schedule.finish[k]()
                accs[k].add_((grads[k] - accs[k]) / (mini + 1))
            if not emits:
                return
            grads = accs
            needs_all = True
        if clip is not None:
            # The shard pieces tile the padded vector once over the ranks
            # (on a hybrid mesh: every shard and replicated leaf once over
            # the gang), so the sum of the ranks' sums of squares is the
            # global one.
            sq = sum(torch.sum(torch.square(g)) for g in grads).reshape(1)
            dist.all_reduce(sq)
            grads = clip_by_global_norm(grads, torch.sqrt(sq[0]), clip)
        state.set_lr(state.tx.schedule(state.updates))
        if config.overlap:
            for k in range(nb):
                if not needs_all:
                    schedule.finish[k]()
                update_piece(k, grads[k])
                gather(k)
        else:
            for piece, g in zip(state.pieces, grads):
                piece.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            for k in range(nb):
                gather(k)
        while in_flight:
            land(*in_flight.pop(0))
        if state.acc_grads is not None:
            state.acc_grads[0].zero_()

    def step(state_: Zero1State, batch, rng):
        if state_ is not state:
            raise ValueError("this ZeRO-1 step was built for another state")
        world = state.world
        weight = float(weight_of(batch))
        total = _total_weight(mesh, weight)
        batch = to_device(batch, state.shard.device)
        state.flat_grad.zero_()
        # The grads stay views into the flat gradient (a caller that set
        # them to None would break the buckets).
        for p, o, n in zip(state.flat_params, plan.offsets, plan.sizes):
            p.grad = state.flat_grad[o:o + n].view_as(p)
        schedule = _Schedule(state, comms, leaf_buckets)
        if config.overlap:
            live["schedule"] = schedule
        try:
            loss, aux = loss_fn(state.model, batch, rng)
            (loss * (weight * world / max(total, _TINY))).backward()
        finally:
            live.pop("schedule", None)
        # Buckets whose leaves got no gradient this step (and every bucket
        # of the serial schedule), in the schedule's order.
        schedule.issue_all(range(nb - 1, -1, -1) if config.overlap else range(nb))
        update_and_gather(schedule)
        comms.end_step()
        state.advance(1)
        g_loss, g_aux = _global_means(mesh, weight, loss, aux, total)
        if tp_axis is not None:
            tp_axis.comms.end_step()
        return state, g_loss, g_aux

    step.comms = comms
    step.comms_stats = comms_bytes_per_step(plan, config)
    return step


# -- the implicit form: fit(zero1=True) ----------------------------------------


@dataclasses.dataclass
class LeadingShardState(TrainState):
    """``fit(zero1=True)``'s state, the JAX ``shard_state(zero1=True)``:
    the replicated step (DDP's all-reduce) with each optimizer moment
    sharded over the data axis on its leading dimension — a parameter
    whose leading dimension the world divides is updated by its owner
    rank on its rows and all-gathered; any other parameter is updated
    whole on every rank (its moments replicated). ``owned`` holds what
    the optimizer steps: the rank's rows (a copy) or the parameter."""

    world: int = 1
    rank: int = 0
    owned: list = dataclasses.field(default_factory=list)

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def _sharded(self, p: torch.Tensor, owned: torch.Tensor) -> bool:
        return owned is not p

    def _step_optimizer(self, params: list, grads: list) -> None:
        for p, o, g in zip(params, self.owned, grads):
            if self._sharded(p, o):
                rows = p.shape[0] // self.world
                o.grad = g[self.rank * rows:(self.rank + 1) * rows]
            else:
                o.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        group = self.mesh.group(DATA_AXIS)
        for p, o in zip(params, self.owned):
            p.grad = None
            if self._sharded(p, o):
                dist.all_gather_into_tensor(p.data, o, group=group)

    @torch.no_grad()
    def refresh_owned(self) -> None:
        """The owned rows from the (replicated) parameters."""
        for p, o in zip(self.params, self.owned):
            if self._sharded(p, o):
                rows = p.shape[0] // self.world
                o.copy_(p[self.rank * rows:(self.rank + 1) * rows])

    def load_state_dict(self, payload: dict) -> None:
        super().load_state_dict(payload)
        self.refresh_owned()

    @property
    def opt_state(self) -> ShardedOptState:
        return ShardedOptState(
            (i, self.optimizer.state.get(o, {})) for i, o in enumerate(self.owned)
        )

    def state_dict(self) -> dict:
        """A rank's checkpoint holds its own part of every leaf; a
        multi-dimensional leaf sharded across the gang has no rank-local
        form, as in the JAX package's ``_detach_local``."""
        for p, o in zip(self.params, self.owned):
            if self._sharded(p, o) and p.ndim > 1 and self.optimizer.state.get(o):
                raise ValueError(
                    "per-rank checkpointing of a multi-dimensional cross-process "
                    f"sharded array (shape {tuple(p.shape)}) is not supported — "
                    "ZeRO-1 keeps params replicated and moments as flat 1-D vectors"
                )
        return super().state_dict()


@torch.no_grad()
def shard_moments(state: TrainState, mesh) -> LeadingShardState:
    """``TrainState → LeadingShardState`` for ``fit(zero1=True)``: the
    optimizer rebuilt over the rank's rows of every parameter whose
    leading dimension the data axis divides (the others whole). A fresh
    state only, as ``shard_optimizer_state``."""
    if isinstance(state, LeadingShardState):
        return state
    world = mesh.shape.get(DATA_AXIS, 1)
    if world <= 1:
        raise ValueError(
            f"zero1=True requires a mesh with a >1 {DATA_AXIS!r} axis; got "
            f"mesh shape {dict(mesh.shape)}"
        )
    if int(state.step) != 0:
        raise ValueError(
            f"zero1=True builds the optimizer moments sharded; a state at step "
            f"{int(state.step)} would lose its moments"
        )
    rank = mesh.index(DATA_AXIS)
    owned = []
    for p in state.model.parameters():
        if p.ndim >= 1 and p.shape[0] % world == 0:
            rows = p.shape[0] // world
            owned.append(p.detach()[rank * rows:(rank + 1) * rows].clone())
        else:
            owned.append(p)
    return LeadingShardState(
        model=state.model, optimizer=state.tx.build(owned), tx=state.tx,
        acc_grads=state.acc_grads, mesh=mesh, world=world, rank=rank, owned=owned,
    )


__all__ = [
    "COMMS_DTYPES",
    "DEFAULT_BUCKET_BYTES",
    "DP_MODES",
    "ENV_BUCKET_BYTES",
    "ENV_COMMS_DTYPE",
    "ENV_DP_MODE",
    "ENV_OVERLAP",
    "LeadingShardState",
    "ShardedOptState",
    "Zero1Comms",
    "Zero1Config",
    "Zero1State",
    "comms_bytes_per_step",
    "decode_piece",
    "encode_bucket",
    "init_sharded",
    "int8_scale",
    "make_flat_plan",
    "make_hybrid_plan",
    "make_zero1_step",
    "opt_state_bytes",
    "opt_state_bytes_per_chip",
    "plan_layout",
    "resolve_dp_mode",
    "shard_moments",
    "shard_optimizer_state",
]
