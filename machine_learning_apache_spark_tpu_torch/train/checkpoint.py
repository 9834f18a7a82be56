"""Checkpoint / resume for one process — the port of
``machine_learning_apache_spark_tpu/train/checkpoint.py``
(``CheckpointManager`` and the single-process helpers) with ``torch.save``
in place of orbax.

On disk, under one directory:

- ``<step>/payload.pt`` — the train state (``TrainState.state_dict``: the
  counters, the accumulator, the model's and the optimizer's state, all
  on the host). It is written into ``<step>.tmp-<pid>/`` and renamed into
  place, as orbax finalizes a step, so an integer-named directory is a
  complete payload;
- ``meta_<step>.json`` — the sidecar (epoch, the host and device
  generator states, the epoch's metrics, the topology stamp), written
  atomically;
- ``latest`` — ``{"step": N}``, replaced atomically, naming the newest
  step whose payload and sidecar are both durable.

In a gang each rank checkpoints to its own sibling directory
``<root>/ckpt_r<rank>`` (``GROUP_DIR_RE``), the JAX package's group
convention: a manager there finds its peers (``group_rank_dirs``), and a
resume restores the newest step complete on every rank
(``group_agreed_step``), so the ranks never restore different steps. The
group functions read only pointers, sidecars and the integer step
directories, so they read the JAX package's trees as well as the port's.
A ZeRO-1 rank's payload holds its own run of the flat moments
(``parallel.zero.Zero1State.state_dict``); ``attach_local`` takes it, or
the whole vector, back.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import torch

from machine_learning_apache_spark_tpu_torch.train.state import TrainState
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

LATEST_POINTER = "latest"  # <dir>/latest — JSON {"step": N}
PAYLOAD = "payload.pt"
PARAMS = "params.pt"

# Gang group convention: rank k of a gang checkpoints to a sibling
# directory `<root>/ckpt_r<k>`. Managers whose directory matches can
# locate their peers — the basis for group-agreed fallback.
GROUP_DIR_RE = re.compile(r"^ckpt_r(\d+)$")


class TopologyMismatch(RuntimeError):
    """A resume found checkpoints written under a different topology and
    elastic resume is disabled (the port's copy of the JAX
    ``train.reshard.TopologyMismatch``). The message names BOTH
    topologies — a wrong-world resume must never silently misload
    per-rank state."""


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_copy(tree):
    """``tree`` with every tensor copied to the host (a blocking copy: it
    waits for the device work that writes it), so later in-place updates
    on the device cannot reach what is written to disk."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def attach_local(value: torch.Tensor, plan, rank: int) -> torch.Tensor:
    """This rank's run of a 1-D ZeRO-1 leaf (a flat moment, the
    accumulator): ``value`` is either the whole vector (every rank's run,
    in rank order, as a reshard hands it) or this rank's run already —
    told apart by its length, as the JAX ``attach_local`` does."""
    n = int(value.shape[0])
    if n == plan.shard_len:
        return value
    if n == plan.padded:
        return value[rank * plan.shard_len:(rank + 1) * plan.shard_len]
    raise ValueError(
        f"a flat ZeRO-1 leaf of {n} elements fits neither this rank's run "
        f"({plan.shard_len}) nor the whole vector ({plan.padded})"
    )


def detached_payload(state: TrainState) -> dict:
    """The host checkpoint payload of ``state`` (``TrainState.state_dict``
    with every tensor copied to the host): what this rank's manager
    writes, taken before the call returns."""
    return host_copy(state.state_dict())


def topology_stamp(state: TrainState | None = None) -> dict:
    """The topology under which ``state`` checkpoints, in the JAX stamp's
    keys: the gang's world size (the process group's), the mesh's axis
    sizes when the state trains on one (``state.mesh``, which
    ``fit(mesh=)`` sets; ``{"data": world}`` in a gang, ``{"data": D,
    "model": M}`` under tensor parallelism), the data-parallel mode, and
    for a ZeRO-1 state (``parallel.zero``) ``"zero1"`` with its bucket
    layout (``plan_layout``), for a tensor- or expert-parallel one its
    shard layout (the model and expert axes' sizes). A seq axis lies in
    the mesh's sizes (``{data, expert, seq, model}``): each rank of a seq
    line holds its model coordinate's shards whole. Stamped into
    every sidecar; a resume whose own stamp differs raises
    ``TopologyMismatch`` rather than misload."""
    mesh = getattr(state, "mesh", None)
    stamp = {
        "world_size": _world_size(),
        "dp_mode": "replicated",
        "mesh": {str(k): int(v) for k, v in mesh.shape.items()} if mesh is not None else None,
        "layout": None,
    }
    plan = getattr(state, "plan", None)
    if plan is not None:
        from machine_learning_apache_spark_tpu_torch.parallel.zero import plan_layout

        stamp["dp_mode"] = "zero1"
        stamp["layout"] = plan_layout(plan)
    else:
        # Each rank's payload holds its model-axis shard, fused q/k/v
        # split by heads (parallel.tensor_parallel), and its expert-axis
        # shard, whole experts (parallel.expert_parallel).
        model = getattr(state, "model", None)
        tp_axis = getattr(model, "tp_axis", None)
        ep_axis = getattr(model, "ep_axis", None)
        if tp_axis is not None:
            stamp["layout"] = {"tensor_parallel": "heads", "model": tp_axis.size}
        if ep_axis is not None:
            stamp["layout"] = {**(stamp["layout"] or {}), "expert_parallel": "experts",
                               "expert": ep_axis.size}
    return stamp


def same_topology(a: dict | None, b: dict | None) -> bool:
    """Whether two topology stamps describe the same checkpoint layout."""

    def _norm(stamp: dict | None) -> str:
        stamp = stamp or {}
        return json.dumps(
            {
                "world_size": int(stamp.get("world_size", 1)),
                "dp_mode": stamp.get("dp_mode", "replicated"),
                "mesh": stamp.get("mesh"),
                "layout": stamp.get("layout"),
            },
            sort_keys=True,
        )

    return _norm(a) == _norm(b)


def pointed_step_of(directory: str) -> int | None:
    """``latest`` pointer target of a checkpoint directory (None when
    absent or torn)."""
    try:
        with open(os.path.join(directory, LATEST_POINTER)) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def read_meta_at(directory: str, step: int) -> dict:
    try:
        with open(os.path.join(directory, f"meta_{int(step)}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def group_agreed_step(dirs: dict[int, str | None]) -> int | None:
    """The newest step COMPLETE on every rank of a checkpoint group: the
    min over rank directories of each ``latest`` pointer (a pointer only
    advances past durability, so its step is whole on that rank; the min
    is therefore whole on all). None when any rank has no pointer — the
    group then has no step it can agree on and every rank must conclude
    the same (a fresh run), which is the agreement property itself."""
    steps = []
    for _, d in sorted(dirs.items()):
        s = pointed_step_of(d) if d else None
        if s is None:
            return None
        steps.append(s)
    return min(steps) if steps else None


_META_RE = re.compile(r"^meta_(\d+)\.json$")


def sidecar_steps_of(directory: str) -> list[int]:
    """Steps with a ``meta_<step>.json`` sidecar in ``directory``, newest
    first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        (int(m.group(1)) for m in map(_META_RE.match, names) if m),
        reverse=True,
    )


def durable_steps_of(directory: str) -> set[int]:
    """Steps with a finalized payload in ``directory``: a step directory
    is renamed into place only once its payload is written, so a plain
    integer-named directory is complete even when the ``latest`` pointer
    never caught up."""
    try:
        names = os.listdir(directory)
    except OSError:
        return set()
    return {
        int(n) for n in names
        if n.isdigit() and os.path.isdir(os.path.join(directory, n))
    }


def group_durable_step(
    dirs: dict[int, str | None], *, meta_dir: str | None = None
) -> int | None:
    """The newest step whose payload is finalized on EVERY rank of a
    group, preferring (when ``meta_dir`` is given) steps whose sidecar
    exists there — the authority directory the caller reads the
    generators, epoch and topology from. Looser than
    ``group_agreed_step``: it needs no ``latest`` pointer, so a rank that
    died before its pointer moved still leaves the last step durable
    everywhere recoverable."""
    common: set[int] | None = None
    for _, d in sorted(dirs.items()):
        steps = durable_steps_of(d) if d else set()
        if not steps:
            return None
        common = steps if common is None else (common & steps)
    if not common:
        return None
    ordered = sorted(common, reverse=True)
    if meta_dir is not None:
        for s in ordered:
            if os.path.exists(os.path.join(meta_dir, f"meta_{s}.json")):
                return s
    return ordered[0]


def read_raw_payload(directory: str, step: int) -> dict:
    """One-shot read of ``directory``'s step ``step`` payload onto the
    host, without opening a manager on it — how a rank reads a peer's
    checkpoint. (The JAX function takes a shaped target for orbax;
    ``torch.load`` needs none.)"""
    return _load(os.path.join(os.path.abspath(directory), str(int(step)), PAYLOAD))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_json(path: str, payload: dict) -> None:
    """Write-then-rename: readers see the old file or the new file, never
    a torn one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_dir_atomically(final: str, filename: str, obj) -> None:
    """``torch.save(obj)`` as ``final/filename``: written and synced in a
    temporary sibling directory, then renamed to ``final``."""
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, filename)
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    os.rename(tmp, final)
    _fsync_dir(os.path.dirname(final))


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Step-numbered checkpoints under one directory.

    >>> ckpt = CheckpointManager(dir, max_to_keep=3)
    >>> ckpt.save(state)                       # step taken from state.step
    >>> state, step = ckpt.restore(template)   # latest by default

    ``save`` writes the payload, then the ``meta_<step>.json`` sidecar, then
    moves the ``latest`` pointer: the pointer only ever names a step whose
    payload and sidecar are durable, so a process killed mid-save leaves
    it on the previous step. ``wait=False`` takes the host snapshot at
    once (after the device work that writes the state) and writes it on
    a background thread. ``restore_latest_valid`` tries the pointed step
    first, then every other step newest-first, past any that fails to
    load: corrupt or partial data costs one checkpoint interval, never
    the run. ``max_to_keep`` prunes the oldest steps (never the pointed
    one). ``run`` (an id) is stamped into every sidecar as ``"run"``."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, run: str | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # Stamped into every sidecar this manager writes (the gang run id
        # a recipe passes), so a retried attempt knows its own steps.
        self.run = run
        self._last_saved: int | None = None
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(self.directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(
        self,
        state: TrainState,
        *,
        step: int | None = None,
        wait: bool = True,
        meta: dict | None = None,
    ) -> int:
        step = int(state.step if step is None else step)
        # Saving the same step twice WITHIN this run (a zero-batch epoch
        # leaves state.step unchanged) is a no-op. A step left on disk by a
        # PRIOR run is overwritten: after a restore-and-retrain the new
        # trajectory wins.
        if step == self._last_saved:
            log.info("checkpoint step %d already saved this run; skipping", step)
            return step
        self._join_writer()
        if step in durable_steps_of(self.directory):
            log.info("overwriting stale checkpoint step %d from a prior run", step)
            shutil.rmtree(os.path.join(self.directory, str(step)))
        self._last_saved = step
        meta = dict(meta or {})
        meta.setdefault("topology", topology_stamp(state))
        if self.run is not None:
            meta.setdefault("run", self.run)
        payload = detached_payload(state)
        if wait:
            self._write(step, payload, meta)
        else:
            self._writer = threading.Thread(
                target=self._write_in_background, args=(step, payload, meta),
                name="mlspark-ckpt-writer", daemon=True,
            )
            self._writer.start()
        log.info("checkpoint step %d -> %s", step, self.directory)
        return step

    def _write(self, step: int, payload: dict, meta: dict) -> None:
        """Payload, then sidecar, then pointer — the ordering is the
        correctness; then retention."""
        _write_dir_atomically(os.path.join(self.directory, str(step)), PAYLOAD, payload)
        _atomic_write_json(self._meta_path(step), meta)
        _atomic_write_json(os.path.join(self.directory, LATEST_POINTER), {"step": step})
        self._prune(keep=step)

    def _write_in_background(self, step: int, payload: dict, meta: dict) -> None:
        try:
            self._write(step, payload, meta)
        except Exception as e:  # re-raised by the next wait()/save()/close()
            log.exception("background checkpoint write of step %d failed", step)
            self._error = e

    def _join_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"background checkpoint write failed: {error!r}") from error

    def _prune(self, keep: int) -> None:
        """Drop the oldest steps beyond ``max_to_keep`` (never ``keep``,
        the pointed one) and every sidecar whose step is gone."""
        steps = sorted(durable_steps_of(self.directory), reverse=True)
        for s in steps[self.max_to_keep:]:
            if s != keep:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
        live = durable_steps_of(self.directory)
        for s in sidecar_steps_of(self.directory):
            if s not in live:
                try:
                    os.unlink(self._meta_path(s))
                except OSError:
                    pass

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"meta_{step}.json")

    def read_meta(self, step: int) -> dict:
        """The sidecar saved with ``step`` ({} if absent/unreadable)."""
        return read_meta_at(self.directory, step)

    def pointed_step(self) -> int | None:
        """The ``latest`` pointer's target, or None (no pointer / torn)."""
        return pointed_step_of(self.directory)

    # -- read ----------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = durable_steps_of(self.directory)
        return max(steps) if steps else None

    def all_steps(self) -> list[int]:
        return sorted(durable_steps_of(self.directory))

    def restore(
        self, template: TrainState, *, step: int | None = None
    ) -> tuple[TrainState, int]:
        """Restore into ``template`` (a state built by ``TrainState.create``
        with the same model and optimizer): parameters are copied in
        place, so the template's tensors stay the ones its owner holds.
        The payload is read whole before the template is touched."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        payload = _load(os.path.join(self.directory, str(step), PAYLOAD))
        template.load_state_dict(payload)
        log.info("restored checkpoint step %d from %s", step, self.directory)
        return template, step

    def group_rank_dirs(self) -> dict[int, str] | None:
        """Sibling rank directories of this checkpoint's gang group
        (``<root>/ckpt_r<k>``), keyed by rank and including self — or
        None when the directory does not follow the group convention."""
        m = GROUP_DIR_RE.match(os.path.basename(self.directory))
        if not m:
            return None
        parent = os.path.dirname(self.directory)
        try:
            names = os.listdir(parent)
        except OSError:
            return None
        out = {}
        for name in names:
            mm = GROUP_DIR_RE.match(name)
            if mm and os.path.isdir(os.path.join(parent, name)):
                out[int(mm.group(1))] = os.path.join(parent, name)
        return out or None

    def _group_scope(self) -> dict[int, str | None] | None:
        """Rank directories participating in fallback agreement. Inside a
        gang, exactly the CURRENT world's ranks — stale higher-rank
        directories left by a bigger run must not drag the agreed step
        down. Offline (one process), every sibling present. None when
        agreement does not apply (no group / no peers)."""
        dirs = self.group_rank_dirs()
        if dirs is None:
            return None
        world = _world_size()
        if world > 1:
            return {r: dirs.get(r) for r in range(world)}
        return dirs if len(dirs) > 1 else None

    def newest_topology_stamp(self) -> dict | None:
        """The topology stamp a resume validates against, BEFORE any
        restore is attempted. Authority order: the lowest-ranked group
        sibling with a stamped step, then self — so every rank of a gang
        resolves the SAME old topology even when its own directory is
        stale or empty."""
        dirs = self.group_rank_dirs()
        candidates = (
            [self.directory] if dirs is None
            else [dirs[r] for r in sorted(dirs)]
        )
        for d in candidates:
            # Pointer target first, then every finalized step newest-first
            # — a rank torn down before its pointer moved still has
            # stamped sidecars for earlier steps.
            steps = [pointed_step_of(d)] + sorted(durable_steps_of(d), reverse=True)
            seen: set[int] = set()
            for step in steps:
                if step is None or step in seen:
                    continue
                seen.add(step)
                stamp = read_meta_at(d, step).get("topology")
                if stamp:
                    return stamp
        return None

    def restore_latest_valid(
        self, template: TrainState
    ) -> tuple[TrainState, int, dict] | None:
        """Restore the newest checkpoint that actually loads: the pointed
        step first (the newest known complete), then every other step
        newest-first. A step without a sidecar while others have one (a
        torn sidecar write) or stamped with another topology is skipped,
        as is one whose payload fails to load. Returns ``(state, step,
        meta)``, or None when nothing on disk restores.

        When the directory belongs to a ``ckpt_r<k>`` gang group, the
        candidates are first capped at the GROUP-AGREED step (min over
        every rank's pointer): rank k may hold a durable step S while
        another rank's S is torn, and without the cap the ranks would
        restore different steps and deadlock the next collective. No
        agreed step is a fresh start on every rank."""
        steps = sorted(durable_steps_of(self.directory), reverse=True)
        scope = self._group_scope()
        if scope is not None:
            agreed = group_agreed_step(scope)
            if agreed is None:
                if steps:
                    log.warning(
                        "checkpoint group %s has no step complete on "
                        "every rank; starting fresh",
                        os.path.dirname(self.directory),
                    )
                return None
            steps = [s for s in steps if s <= agreed]
        pointed = self.pointed_step()
        if pointed in steps:
            steps.remove(pointed)
            steps.insert(0, pointed)
        stamp = topology_stamp(template)
        any_meta = any(os.path.exists(self._meta_path(s)) for s in steps)
        for step in steps:
            if any_meta and not os.path.exists(self._meta_path(step)):
                log.warning(
                    "checkpoint step %d has no meta sidecar while other "
                    "steps do (torn sidecar write); skipping", step,
                )
                continue
            meta = self.read_meta(step)
            old = meta.get("topology")
            if old and not same_topology(old, stamp):
                log.warning(
                    "checkpoint step %d was written under topology %s, "
                    "this run is %s; skipping", step, old, stamp,
                )
                continue
            try:
                state, _ = self.restore(template, step=step)
            except Exception as e:  # noqa: BLE001 - any load failure → fall back
                log.warning(
                    "checkpoint step %d failed to restore (%r); falling "
                    "back to the previous one", step, e,
                )
                continue
            return state, step, meta
        return None

    def wait(self) -> None:
        """Block until an in-flight ``wait=False`` save is durable (and the
        ``latest`` pointer names it); raise if it failed."""
        self._join_writer()

    def close(self) -> None:
        self._join_writer()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def save_params(path: str, params) -> None:
    """One-shot param-only save (the eval-after-train handoff): a module's
    or a ``state_dict``'s tensors, to the directory ``path``, written
    atomically."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write_dir_atomically(path, PARAMS, host_copy(dict(params)))


def load_params(path: str, template=None):
    """The ``state_dict`` saved by ``save_params``, on the host; with a
    module as ``template``, loaded into it (in place) and the module
    returned."""
    params = _load(os.path.join(os.path.abspath(path), PARAMS))
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(params)
        return template
    return params
