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

What is gang-only in the JAX module (per-rank directories, group
agreement, ``attach_local``, cross-topology reads) comes with the
distributed layers (ROADMAP A4).
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


def topology_stamp(state: TrainState | None = None) -> dict:
    """The topology a checkpoint was written under: one process, no mesh,
    replicated (the JAX stamp's keys; the port runs world size 1)."""
    return {"world_size": 1, "dp_mode": "replicated", "mesh": None, "layout": None}


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
    one)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
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
        payload = host_copy(state.state_dict())
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

    def restore_latest_valid(
        self, template: TrainState
    ) -> tuple[TrainState, int, dict] | None:
        """Restore the newest checkpoint that actually loads: the pointed
        step first (the newest known complete), then every other step
        newest-first. A step without a sidecar while others have one (a
        torn sidecar write) or stamped with another topology is skipped,
        as is one whose payload fails to load. Returns ``(state, step,
        meta)``, or None when nothing on disk restores."""
        steps = sorted(durable_steps_of(self.directory), reverse=True)
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
