"""Cross-topology checkpoint resharding — elastic resume; the port of
``machine_learning_apache_spark_tpu/train/reshard.py``.

Fault tolerance restarts a failed gang whole, at the same world size; a
preempted 4-rank job could never come back as 3 ranks. This module maps
a checkpoint group written by a gang of N ranks (per-rank payloads:
parameters, the optimizer state — ZeRO-1's flat bucket-major moment
shards — the counters, and the sidecar's generators and ingest stream
state) onto a gang whose data axis has another size, as the JAX module
does. What it refuses, it refuses as the JAX module does: a change of the
data-parallel mode, of any axis but ``data`` (model, expert, pipeline,
seq) or of the flat vector's ``total`` raises ``TopologyMismatch``
naming both stamps.

Why it is tractable: the ZeRO-1 moments are flat 1-D float32 vectors in
**bucket-major shard order** (``parallel.zero``: data rank ``i`` owns the
``i``-th 1/N slice of every bucket, concatenated), so re-mapping between
world sizes is pure byte-range redistribution — the portable-collective
formulation of "Memory-efficient array redistribution" (arxiv
2112.01075). The stored vector is a *permutation* of the logical flat
vector that depends on ``(world, buckets)``; the remap un-permutes
through the source :class:`BucketLayout` and re-permutes through the
destination one:

    stored[i * shard_len + base_k + t]  <->  logical[s_k + i * piece_k + t]

where bucket ``k`` spans ``[s_k, e_k)``, ``piece_k = (e_k - s_k) /
world`` and ``base_k`` is the cumulative piece length of earlier
buckets. :func:`gather_spec` intersects the two piecewise-linear maps
into contiguous ``(src_shard, src_off, dst_off, length)`` copies;
:func:`reshard_flat` applies them, and :func:`reshard_flat_oracle` is
the bit-exact single-host reference that reconstructs the logical
vector explicitly. These four are the JAX functions, on numpy.

Where the port differs: its tensor- and expert-parallel leaves are
per-rank slices (``p.shards``), not global arrays. So a rank of the new
gang takes its parameters (and any replicated optimizer state) from the
old rank with data index 0 and the same model, expert, pipeline and seq
coordinates, and on a ``{data × model}`` mesh (``make_hybrid_plan``) its
flat vector is two layouts (:func:`flat_layouts`): the model shards over
the data ranks of its own model index, then the replicated leaves over
every rank of ``data × model``.

The run-level entry point is :func:`elastic_restore`: given a
``train.checkpoint.CheckpointManager`` whose directory follows the
gang's ``ckpt_r<rank>`` group convention and the old run's topology
stamp, it agrees on one complete step across every old rank directory
(:func:`_agreed_step_and_stamp`, which after repeated shrinks reshards
from the agreed step's own stamp), reads the old ranks' payloads,
reshards the flat vectors onto this rank's layout and loads the result
into the new run's template state.

Env contract: ``MLSPARK_ELASTIC=1`` — set by ``Distributor(elastic=True)``
in every worker — lets ``fit(resume=True)`` route a topology-mismatched
resume through this module instead of raising :class:`TopologyMismatch`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Sequence

import numpy as np

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.parallel.mesh import _coords
from machine_learning_apache_spark_tpu_torch.train.checkpoint import TopologyMismatch
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_ELASTIC = "MLSPARK_ELASTIC"


def resolve_elastic(elastic: bool | None) -> bool:
    """Explicit argument > ``MLSPARK_ELASTIC`` env > False (the launcher
    gang plumbing: ``Distributor(elastic=True)`` sets the env var in
    every worker)."""
    if elastic is not None:
        return bool(elastic)
    return envcfg.get_bool(ENV_ELASTIC)


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static description of how one flat fp32 vector is cut into
    bucket-major shards — the checkpoint-portable core of ``zero.py``'s
    ``_FlatPlan`` (no leaf shapes: resharding never needs them).

    ``world`` is the number of FLAT SHARDS: the data ranks of a plain
    plan; on a hybrid plan see :func:`flat_layouts`.
    """

    total: int
    world: int
    padded: int
    shard_len: int
    buckets: tuple  # ((start, stop), ...) in flat padded coordinates

    def __post_init__(self) -> None:
        if self.padded != self.shard_len * self.world:
            raise ValueError(
                f"inconsistent layout: padded={self.padded} != "
                f"shard_len={self.shard_len} * world={self.world}"
            )
        stops = [0] + [e for _, e in self.buckets]
        starts = [s for s, _ in self.buckets] + [self.padded]
        if stops[:-1] != starts[: len(stops) - 1] or stops[-1] != self.padded:
            raise ValueError(
                f"buckets {self.buckets} do not partition [0, {self.padded})"
            )
        for s, e in self.buckets:
            if (e - s) % self.world:
                raise ValueError(
                    f"bucket ({s}, {e}) does not tile world={self.world}"
                )

    @classmethod
    def create(cls, total: int, world: int, bucket_bytes: int) -> "BucketLayout":
        """Mirror of ``zero.make_flat_plan``'s arithmetic (the tests pin
        the two equal): fp32-denominated bucket element counts rounded
        up to a multiple of the world, padding in the last bucket."""
        elems = max(bucket_bytes // 4, 1)
        elems = -(-elems // world) * world
        padded = -(-total // world) * world
        buckets = tuple(
            (start, min(start + elems, padded))
            for start in range(0, padded, elems)
        )
        return cls(
            total=total, world=world, padded=padded,
            shard_len=padded // world, buckets=buckets,
        )

    @classmethod
    def from_json(cls, data: dict) -> "BucketLayout":
        """Inverse of ``zero.plan_layout`` for a plain plan (the topology
        stamp's ``layout`` record)."""
        return cls(
            total=int(data["total"]),
            world=int(data["world"]),
            padded=int(data["padded"]),
            shard_len=int(data["shard_len"]),
            buckets=tuple((int(s), int(e)) for s, e in data["buckets"]),
        )

    def to_json(self) -> dict:
        return {
            "total": self.total, "world": self.world, "padded": self.padded,
            "shard_len": self.shard_len,
            "buckets": [[s, e] for s, e in self.buckets],
        }

    def segments(self) -> Iterable[tuple[int, int, int, int]]:
        """Yield ``(logical_lo, logical_hi, shard, stored_off)``: shard
        ``shard`` stores logical ``[lo, hi)`` at ``stored_off`` within
        its ``shard_len`` vector. Together the segments cover
        ``[0, padded)`` exactly once."""
        base = 0  # cumulative piece length of earlier buckets
        for s, e in self.buckets:
            piece = (e - s) // self.world
            for i in range(self.world):
                yield (s + i * piece, s + (i + 1) * piece, i, base)
            base += piece


def gather_spec(
    src: BucketLayout, dst: BucketLayout
) -> tuple[tuple[tuple[int, int, int, int], ...], ...]:
    """The resharded gather, as data: for every destination shard, the
    contiguous copies ``(src_shard, src_off, dst_off, length)`` (element
    units; multiply by the itemsize for byte ranges) that assemble it
    from the source shards.

    Only logical positions ``< total`` are copied: source padding is
    dropped and destination padding stays zero (the caller zero-fills),
    so layouts with different ``padded`` compose. Copies are produced by
    intersecting the two layouts' piecewise-linear stored<->logical maps
    — each overlap of a src segment with a dst segment is one contiguous
    run in both stored vectors.
    """
    if src.total != dst.total:
        raise ValueError(
            f"layouts describe different vectors: src total {src.total} "
            f"!= dst total {dst.total}"
        )
    src_segs = sorted(src.segments())  # sorted by logical_lo
    out: list[tuple] = []
    for j in range(dst.world):
        copies: list[tuple[int, int, int, int]] = []
        for dlo, dhi, shard, dbase in dst.segments():
            if shard != j:
                continue
            dhi = min(dhi, dst.total)
            for slo, shi, i, sbase in src_segs:
                lo, hi = max(dlo, slo), min(dhi, shi)
                if lo < hi:
                    copies.append(
                        (i, sbase + (lo - slo), dbase + (lo - dlo), hi - lo)
                    )
        copies.sort(key=lambda c: c[2])
        out.append(tuple(copies))
    return tuple(out)


def spec_byte_ranges(
    spec: Sequence[Sequence[tuple[int, int, int, int]]], itemsize: int = 4
) -> tuple[tuple[tuple[int, int, int, int], ...], ...]:
    """The same gather expressed over bucket BYTE ranges (what a remote
    blob-range reader would fetch): every offset/length scaled by the
    element ``itemsize`` (fp32 master vectors: 4)."""
    return tuple(
        tuple((i, so * itemsize, do * itemsize, ln * itemsize)
              for i, so, do, ln in copies)
        for copies in spec
    )


def reshard_flat(
    shards: Sequence[np.ndarray],
    src: BucketLayout,
    dst: BucketLayout,
    spec=None,
) -> list[np.ndarray]:
    """Redistribute a stored flat vector from ``src``'s N shards to
    ``dst``'s M shards by applying :func:`gather_spec`'s byte-range
    copies. Destination padding is zero (matching what ``zero.py``'s
    step maintains: the pad never accumulates nonzero state under an
    elementwise optimizer fed zero pad gradients)."""
    if len(shards) != src.world:
        raise ValueError(f"expected {src.world} shards, got {len(shards)}")
    arrs = [np.asarray(s) for s in shards]
    for i, a in enumerate(arrs):
        if a.shape != (src.shard_len,):
            raise ValueError(
                f"shard {i} has shape {a.shape}, expected ({src.shard_len},)"
            )
    dtype = arrs[0].dtype
    spec = gather_spec(src, dst) if spec is None else spec
    out = [np.zeros(dst.shard_len, dtype=dtype) for _ in range(dst.world)]
    for j, copies in enumerate(spec):
        for i, so, do, ln in copies:
            out[j][do:do + ln] = arrs[i][so:so + ln]
    return out


def reshard_flat_oracle(
    shards: Sequence[np.ndarray], src: BucketLayout, dst: BucketLayout
) -> list[np.ndarray]:
    """Bit-exact single-host reference: reconstruct the LOGICAL vector
    explicitly through ``src``'s coordinate map, then scatter it through
    ``dst``'s. ``reshard_flat`` must agree to the bit (tests pin it);
    this form is O(padded) memory, the gather form streams ranges."""
    arrs = [np.asarray(s) for s in shards]
    logical = np.zeros(src.padded, dtype=arrs[0].dtype)
    for lo, hi, i, base in src.segments():
        logical[lo:hi] = arrs[i][base:base + (hi - lo)]
    logical = logical[:src.total]
    out = [np.zeros(dst.shard_len, dtype=logical.dtype) for _ in range(dst.world)]
    for lo, hi, j, base in dst.segments():
        hi = min(hi, dst.total)
        if lo < hi:
            out[j][base:base + (hi - lo)] = logical[lo:hi]
    return out


# -- a rank's flat vector on a hybrid mesh --------------------------------------

def flat_layouts(layout: dict, model_ways: int = 1) -> list[tuple[BucketLayout, bool]]:
    """A rank's stored flat vector (``zero.plan_layout``'s record) as
    consecutive ``(BucketLayout, shared)`` parts. A plain plan is one
    part over the data ranks. A hybrid plan (``subs``) is two: the model
    shards (``sharded`` elements, padded to a multiple of the data
    ranks), one layout over the data ranks of each model index
    (``shared`` False: each model index has its own vector); then the
    replicated leaves, whose bucket ``k`` gives rank ``(d, m)`` the piece
    at ``d · M + m`` of ``data × model`` — one layout over every rank
    (``shared`` True)."""
    subs = layout.get("subs")
    if not subs:
        return [(BucketLayout.from_json(layout), False)]
    world = int(layout["world"])
    buckets = [(int(s), int(e)) for s, e in layout["buckets"]]
    own = [b for b, k in zip(buckets, subs) if k == 1]
    rep = [b for b, k in zip(buckets, subs) if k > 1]
    seg = own[-1][1] if own else 0
    padded, sharded = int(layout["padded"]), int(layout["sharded"])
    parts = []
    if own:
        parts.append((BucketLayout(total=sharded, world=world, padded=seg,
                                   shard_len=seg // world, buckets=tuple(own)), False))
    ways = world * model_ways
    parts.append((BucketLayout(
        total=int(layout["total"]) - sharded, world=ways, padded=padded - seg,
        shard_len=(padded - seg) // ways, buckets=tuple((s - seg, e - seg) for s, e in rep)), True))
    return parts


def reshard_rank_vector(
    stored: dict, old_layout: dict, new_layout: dict, data_index: int,
    model_index: int = 0, model_ways: int = 1,
) -> np.ndarray:
    """The new rank ``(data_index, model_index)``'s stored flat vector,
    from ``stored``: ``{(old data index, model index): vector}`` of every
    old rank (of a plain plan, model index 0), each ``old_layout``'s
    ``shard_len`` long. Each part of :func:`flat_layouts` is resharded by
    :func:`gather_spec`'s copies; the destination's pads are zero."""
    old_d = int(old_layout["world"])
    out = []
    offsets = [0, 0]  # where the current part starts in the old and new vectors
    for (src, shared), (dst, _) in zip(flat_layouts(old_layout, model_ways),
                                       flat_layouts(new_layout, model_ways)):
        if shared:
            keys = [(d, m) for d in range(old_d) for m in range(model_ways)]
            j = data_index * model_ways + model_index
        else:
            keys = [(d, model_index) for d in range(old_d)]
            j = data_index
        o = offsets[0]
        shards = [np.asarray(stored[k])[o:o + src.shard_len] for k in keys]
        piece = np.zeros(dst.shard_len, dtype=shards[0].dtype)
        for i, so, do, ln in gather_spec(src, dst)[j]:
            piece[do:do + ln] = shards[i][so:so + ln]
        out.append(piece)
        offsets[0] += src.shard_len
        offsets[1] += dst.shard_len
    return np.concatenate(out)


# -- run-level elastic restore ------------------------------------------------

def _mesh_of(stamp: dict) -> dict:
    return dict(stamp.get("mesh") or {"data": int(stamp.get("world_size", 1))})


def _others(shape: dict) -> dict:
    """The axes but ``data`` larger than 1."""
    return {a: int(s) for a, s in shape.items() if a != "data" and int(s) > 1}


def check_reshardable(old_stamp: dict, new_stamp: dict) -> None:
    """Raise ``TopologyMismatch`` naming both stamps unless the two
    differ only where the JAX package reshards: the data axis's size
    (and with it the world and the ZeRO-1 layout's data split)."""
    def refuse(why: str):
        raise TopologyMismatch(
            f"cannot reshard this checkpoint: {why} — checkpoint topology "
            f"{old_stamp} vs this run's {new_stamp}"
        )

    old_mode = old_stamp.get("dp_mode", "replicated")
    if old_mode != new_stamp.get("dp_mode", "replicated"):
        refuse(f"it was written under dp_mode {old_mode!r}, this run is "
               f"{new_stamp.get('dp_mode')!r}")
    old_axes, new_axes = _others(_mesh_of(old_stamp)), _others(_mesh_of(new_stamp))
    if old_axes != new_axes:
        refuse(f"only the data axis reshards; the other axes change from {old_axes} "
               f"to {new_axes}")
    old, new = old_stamp.get("layout"), new_stamp.get("layout")
    old_flat = bool(old) and "total" in old
    new_flat = bool(new) and "total" in new
    if old_flat != new_flat or (not old_flat and old != new):
        refuse(f"its layout {old} is incompatible with this run's {new}")
    if old_flat:
        if int(old["total"]) != int(new["total"]):
            refuse(f"its flat vector has {old['total']} elements, this run's "
                   f"{new['total']} — a different model/optimizer, not a topology change")
        if bool(old.get("subs")) != bool(new.get("subs")) or old.get("sharded") != new.get("sharded"):
            refuse("the model-axis split of its flat vector differs from this run's")


def _source_ranks(old_stamp: dict, coords: dict) -> tuple[dict, int]:
    """The old ranks a new rank at ``coords`` reads: ``{(data index, model
    index): old rank}`` over its other coordinates (on a hybrid ZeRO-1
    plan every model index: the replicated leaves' pieces lie on all of
    them), and the one it adopts parameters, counters and sidecar from
    (data index 0, its own coordinates)."""
    old_shape = _mesh_of(old_stamp)
    mine = {a: int(coords.get(a, 0)) for a in _others(old_shape)}
    layout = old_stamp.get("layout") or {}
    every_model = bool(layout.get("subs"))
    ranks = {}
    for r in range(int(old_stamp.get("world_size", 1))):
        c = _coords(r, old_shape)
        if all(c.get(a, 0) == i for a, i in mine.items() if not (every_model and a == "model")):
            ranks[(c.get("data", 0), c.get("model", 0))] = r
    return ranks, ranks[(0, mine.get("model", 0))]


def restore_payload(old_dirs: dict, step: int, old_stamp: dict, new_stamp: dict,
                    coords: dict) -> tuple[dict, int]:
    """The checkpoint payload of the new rank at ``coords`` (its mesh
    coordinates) from the old group's step ``step``: the counters,
    parameters and replicated optimizer state of the old rank with data
    index 0 and the same other coordinates; every flat ZeRO-1 vector (the
    moments, the accumulator) resharded onto the new layout by
    :func:`reshard_rank_vector`. Returns ``(payload, bytes read)``."""
    import torch

    from machine_learning_apache_spark_tpu_torch.train import checkpoint as _ckpt

    check_reshardable(old_stamp, new_stamp)
    layout = old_stamp.get("layout")
    flat = bool(layout) and "total" in layout
    ranks, base_rank = _source_ranks(old_stamp, coords)
    need = sorted(ranks.values()) if flat else [base_rank]
    payloads, read = {}, 0
    for r in need:
        path = os.path.join(old_dirs[r], str(int(step)), _ckpt.PAYLOAD)
        read += os.path.getsize(path)
        payloads[r] = _ckpt.read_raw_payload(old_dirs[r], step)
    base = payloads[base_rank]
    if not flat:
        return base, read
    new_layout = new_stamp["layout"]
    model_ways = int(_mesh_of(new_stamp).get("model", 1))
    old_len = int(layout["shard_len"])
    by_index = {key: payloads[r] for key, r in ranks.items()}

    def resharded(pick) -> torch.Tensor:
        stored = {key: pick(p).numpy() for key, p in by_index.items()}
        return torch.from_numpy(reshard_rank_vector(
            stored, layout, new_layout, int(coords.get("data", 0)),
            int(coords.get("model", 0)), model_ways))

    def is_flat(v) -> bool:
        return isinstance(v, torch.Tensor) and v.ndim == 1 and v.numel() == old_len

    out = dict(base)
    out["optimizer"] = {
        k: resharded(lambda p, k=k: p["optimizer"][k]) if is_flat(v) else v
        for k, v in base["optimizer"].items()
    }
    if base["acc_grads"] is not None:
        out["acc_grads"] = [
            resharded(lambda p, i=i: p["acc_grads"][i]) if is_flat(a) else a
            for i, a in enumerate(base["acc_grads"])
        ]
    return out, read


def elastic_restore(checkpointer, template, *, old_stamp: dict, step: int | None = None):
    """Restore an old-topology checkpoint group into ``template`` (the
    NEW topology's state, loaded in place). Returns ``(state, step,
    meta)`` like ``CheckpointManager.restore_latest_valid``, or None when
    the group has no complete step to agree on.

    - the step is the group-durable one: the newest step whose payload is
      finalized in every OLD rank's directory (a step directory is
      renamed into place whole, so it is complete even when the dead
      rank's ``latest`` pointer never moved), preferring a step whose
      sidecar (generators / epoch / topology) survives;
    - flat ZeRO-1 vectors are reassembled from every old rank's shard and
      resharded through ``gather_spec``; everything else adopts from the
      old rank with data index 0 and this rank's other coordinates;
    - the returned ``meta`` is that rank's sidecar of the agreed step (the
      host generator, epoch and ingest state are the same on every rank
      of a data line — the caller reuses its normal resume path on it).

    A ``train.elastic_restore`` annotation records the step, the seconds
    and the payload bytes read."""
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as _ckpt

    t0 = time.perf_counter()
    old_world = int(old_stamp.get("world_size", 1))
    dirs = checkpointer.group_rank_dirs()
    if dirs is None:
        if old_world != 1:
            raise TopologyMismatch(
                f"checkpoint stamp names a {old_world}-rank gang but "
                f"{checkpointer.directory!r} does not follow the "
                "ckpt_r<rank> group convention — the peer rank "
                "directories cannot be located for resharding"
            )
        dirs = {0: checkpointer.directory}
    missing = [r for r in range(old_world) if r not in dirs]
    if missing:
        raise TopologyMismatch(
            f"elastic resume needs every old rank's checkpoint directory; "
            f"missing ckpt_r<k> for ranks {missing} of the old "
            f"{old_world}-rank gang"
        )
    if step is None:
        chosen = _agreed_step_and_stamp(dirs, old_stamp)
        if chosen is None:
            log.warning(
                "elastic resume found no step durable on every rank of the "
                "old %d-rank group; starting fresh", old_world,
            )
            return None
        step, stamp = chosen
        stamp_world = int(stamp.get("world_size", old_world))
        if stamp_world != old_world:
            # Repeated shrinks can leave the newest sidecar naming a gang
            # whose own checkpoint never became group-durable; the agreed
            # step's OWN stamp is the layout its payload was written under.
            log.info(
                "elastic resume: newest stamp names a %d-rank gang but the "
                "agreed step %d was written by a %d-rank gang; resharding "
                "from the step's own topology", old_world, step, stamp_world,
            )
            old_stamp, old_world = stamp, stamp_world
    old_dirs = {r: dirs[r] for r in range(old_world)}
    new_stamp = _ckpt.topology_stamp(template)
    mesh = getattr(template, "mesh", None)
    coords = mesh.coords if mesh is not None else {}
    payload, read = restore_payload(old_dirs, step, old_stamp, new_stamp, coords)
    template.load_state_dict(payload)
    _, meta_rank = _source_ranks(old_stamp, coords)
    meta = _ckpt.read_meta_at(old_dirs[meta_rank], step)
    seconds = time.perf_counter() - t0
    telemetry.annotate(
        "train.elastic_restore", step=int(step), old_world=old_world,
        new_world=int(new_stamp.get("world_size", 1)), seconds=seconds, bytes_read=read,
    )
    log.info(
        "elastic restore: step %d resharded from %d-rank layout onto %s "
        "(%.3f s, %d payload bytes read)",
        step, old_world, new_stamp.get("world_size"), seconds, read,
    )
    return template, int(step), meta


def _agreed_step_and_stamp(dirs, fallback_stamp):
    """Pick the restore step and the topology it was actually written
    under, TOGETHER. Scans the authority (lowest-rank) directory's
    sidecars newest-first and accepts the first step that is durable in
    every directory of the gang named by that step's own stamp — after
    repeated shrinks the newest sidecar and the newest group-durable step
    can name different world sizes, and resharding a payload with the
    wrong layout would interleave shards from the wrong ranks. Falls
    back to the plain durable-data intersection under ``fallback_stamp``
    when no stamped step qualifies (e.g. every sidecar was lost with the
    crashed ranks)."""
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as _ckpt

    auth = dirs[min(dirs)]
    durable = {r: _ckpt.durable_steps_of(d) for r, d in dirs.items()}
    for s in _ckpt.sidecar_steps_of(auth):
        meta = _ckpt.read_meta_at(auth, s) or {}
        stamp = meta.get("topology")
        if not stamp:
            continue
        w = int(stamp.get("world_size", 1))
        if any(r not in dirs for r in range(w)):
            continue
        if all(s in durable[r] for r in range(w)):
            return s, stamp
    w = int(fallback_stamp.get("world_size", 1))
    if any(r not in dirs for r in range(w)):
        return None
    s = _ckpt.group_durable_step({r: dirs[r] for r in range(w)})
    return (s, fallback_stamp) if s is not None else None


__all__ = [
    "ENV_ELASTIC",
    "BucketLayout",
    "TopologyMismatch",
    "check_reshardable",
    "elastic_restore",
    "flat_layouts",
    "gather_spec",
    "reshard_flat",
    "reshard_flat_oracle",
    "reshard_rank_vector",
    "resolve_elastic",
    "restore_payload",
    "spec_byte_ranges",
]
