"""StreamingPipeline — records to device-resident batches, off the hot
path; the port of ``machine_learning_apache_spark_tpu/ingest/pipeline.py``.

The stage chain (each optional stage collapses to a pass-through):

    source -> [transform] -> [online pack] -> shard -> batch/tail-policy
           -> [bounded host prefetch thread] -> [pin + device copy stage]

Everything left of the prefetch queue runs on a background producer
thread; the consumer (the training loop) pulls host batches from a
bounded queue and copies them to the device ``device_prefetch`` batches
ahead, so batch k+1 is on the device before step k's work is done. The
queue bound caps host memory; shutdown is clean — ``shutdown()`` (called
by ``fit``'s finally) releases the producer and joins it, leaving no
threads behind.

**The device stage on the card.** The JAX stage enqueues
``jax.device_put`` ahead of consumption. Here, for a CUDA target, the
consumer's thread pins each host batch and issues each field's copy
with ``non_blocking=True`` on a side ``torch.cuda.Stream``, and records
an event after it. The producer thread touches no CUDA state, so no
CUDA call of the pipeline runs during a CUDA-graph capture of the
training thread's. A batch is handed over only when it is
consumed: the stream the consumer is on waits on the batch's event (so
no kernel, stack or graph input copy can read a half-copied batch), and
each tensor is ``record_stream``-ed onto that stream, so the caching
allocator does not hand its memory to a later copy while the consumer's
work may still read it. Token ids travel as int64, so ``fit``'s
``to_device`` and ``stack_batches`` take the batch as it is: no second
copy. For a CPU target the stage wraps the host arrays as tensors
without a copy.

**Batch-count equalization** (the gang-deadlock fix): every rank MUST
yield the same number of batches per epoch or the epoch-tail collective
hangs. Two shard modes, two guarantees:

- ``shard="records"`` (default): every rank enumerates the same global
  unit stream (records, or packed rows when packing is on) and keeps
  units ``i % world == rank``. Per-rank counts differ by at most one and
  every rank knows the global count N at end of stream, so the tail
  policy is computed from N identically everywhere: ``tail="pad"`` wraps
  each rank's own recent units to ``ceil(ceil(N/world)/B)`` batches
  (the ``DistributedSampler`` convention); ``tail="drop"`` truncates every
  rank to ``(N // world) // B`` (a one-batch holdback keeps a rank with a
  surplus unit from over-yielding before N is known).
- ``shard="files"``: rank r reads only ``paths[r::world]`` (a true I/O
  split; per-rank record counts are ragged and no rank knows N), so a
  fixed ``steps_per_epoch`` is REQUIRED for world > 1: every rank yields
  exactly that many batches, wrapping its local stream when short.

In a gang, ``rank`` and ``world`` are the data axis's: ``fit(mesh=)``
binds the pipeline to this rank's data index and the data axis's size,
so the ranks of one model, expert, pipeline or seq line read the same
rows. A pipeline built with an explicit ``rank`` or ``world`` that
disagrees with the mesh raises.

Telemetry: every stage reports into the ``data.*`` family —
``data.read`` / ``data.pack`` / ``data.h2d`` phase durations (per batch;
``data.h2d`` is the copies' enqueue time, as in the JAX stage),
``data.wait`` (consumer time blocked on the host buffer — the direct
input-bound signal), a ``data.buffer_occupancy`` gauge sampled at every
producer put, and per-epoch ``data.records`` / ``data.batches`` /
``data.bytes_h2d`` counters. ``telemetry.aggregate.ingest_report`` folds
these into the gang report's input-bound/compute-bound verdict.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.ingest.config import IngestConfig
from machine_learning_apache_spark_tpu_torch.ingest.packing import OnlinePacker
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Thread-name prefix for every pipeline worker — the leak check in
#: tests (and operators' py-spy dumps) find them by this.
WORKER_PREFIX = "mlspark-ingest"

_END, _ERR = object(), object()

SHARD_MODES = ("records", "files")

_PACK_KEYS = {"src_len", "trg_len", "pad_id", "max_segments"}


def _default_collate(units: list) -> Any:
    """Stack per-field: a list of B record tuples becomes a tuple of
    ``[B, ...]`` arrays (scalar fields stack to ``[B]`` vectors)."""
    first = units[0]
    if isinstance(first, tuple):
        return tuple(
            np.stack([u[i] for u in units]) for i in range(len(first))
        )
    return np.stack(units)


def _emit_phase(name: str, seconds: float, **attrs) -> None:
    """Record a phase duration as a ``span_end`` event so the aggregate
    phase table picks it up. Producer-side phases are accumulated per
    batch (per-record spans would flood the bounded event ring)."""
    telemetry.get_log().emit(
        "span_end", name, value=seconds, attrs=attrs or None
    )


def _map_fields(batch, fn):
    """``fn`` over a batch's fields (a tuple of arrays, or one array)."""
    return tuple(fn(x) for x in batch) if isinstance(batch, tuple) else fn(batch)


def _fields(batch) -> tuple:
    return batch if isinstance(batch, tuple) else (batch,)


def _host_tensor(a):
    """A host field as a tensor the step takes as it is: numpy wrapped
    without a copy, integer ids widened to int64 (the loop's id dtype)."""
    import torch

    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if arr.dtype.kind in "iub" and arr.dtype != np.int64:
            arr = arr.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if torch.is_floating_point(t) else t.long()


class _UnitStream:
    """One pass over the pipeline's global unit stream: applies transform
    and online packing, filters to this rank's units (records mode), and
    accumulates read/pack time for the per-batch phase events. After
    exhaustion, ``global_units`` holds the pass's total unit count (global
    in records mode, local in files mode) and ``records_read`` the number
    of records pulled from the source."""

    def __init__(self, pipeline: "StreamingPipeline") -> None:
        self.pl = pipeline
        self.read_seconds = 0.0
        self.pack_seconds = 0.0
        self.records_read = 0
        self.global_units = 0

    def __iter__(self) -> Iterator:
        pl = self.pl
        perf = time.perf_counter
        filt = pl.shard == "records" and pl.world > 1
        rank, world = pl.rank, pl.world
        packer = OnlinePacker(**pl.pack) if pl.pack is not None else None
        transform = pl.transform
        idx = 0  # unit index within the (global) stream
        it = iter(pl._source)
        while True:
            t0 = perf()
            try:
                rec = next(it)
            except StopIteration:
                self.read_seconds += perf() - t0
                break
            if transform is not None:
                rec = transform(rec)
            self.read_seconds += perf() - t0
            self.records_read += 1
            if packer is None:
                if not filt or idx % world == rank:
                    yield rec
                idx += 1
            else:
                t1 = perf()
                row = packer.add(rec[0], rec[1])
                self.pack_seconds += perf() - t1
                if row is not None:
                    if not filt or idx % world == rank:
                        yield row
                    idx += 1
        if packer is not None:
            t1 = perf()
            row = packer.flush()
            self.pack_seconds += perf() - t1
            if row is not None:
                if not filt or idx % world == rank:
                    yield row
                idx += 1
        self.global_units = idx


def _hand_over(batch, event, dev):
    """A copied batch, made safe for the stream that consumes it: that
    stream waits on the copies' event, and every tensor is recorded as in
    use on it (``record_stream``), so its memory is not reused while work
    queued there may still read it."""
    if event is not None:
        import torch

        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in _fields(batch):
            t.record_stream(consumer)
    return batch


class StreamingPipeline:
    """Async streaming input pipeline; the ``data=`` argument of
    ``train.loop.fit``.

    - ``source``: any ``ingest.readers`` source, a ``MixtureSampler``, or
      a plain restartable iterable of records.
    - ``batch_size``: records (or packed rows) per batch — the static
      leading dimension.
    - ``rank``/``world``: data-axis coordinates; default from the launcher
      env contract (``MLSPARK_PROCESS_ID`` / ``MLSPARK_NUM_PROCESSES``),
      and ``fit(mesh=)`` binds the mesh's data index and size.
    - ``shard``/``tail``/``steps_per_epoch``: see the module docstring's
      equalization contract.
    - ``transform``: per-record callable applied in the producer thread
      (tokenize-outside-the-step seam).
    - ``pack``: ``dict(src_len=, trg_len=, pad_id=, max_segments=)``
      enables online packing; records must then be (src_ids, trg_ids)
      pairs and batches are stacked 6-tuples of packed rows.
    - ``buffer``/``device_prefetch``: queue depths, resolved through
      ``MLSPARK_INGEST_*`` when not given (``IngestConfig.from_env``).
    - ``mesh``/``device``: placement. ``device=True`` (the default) copies
      batches to the device ``fit`` binds (its model's), or to the card
      when nothing is bound (raising when there is none); a device
      (``"cpu"``, ``"cuda"``) names the target; ``device=False`` yields
      host batches.
    """

    #: duck-typing marker for fit() — avoids an import cycle.
    is_streaming_pipeline = True

    def __init__(
        self,
        source,
        batch_size: int,
        *,
        rank: int | None = None,
        world: int | None = None,
        shard: str = "records",
        tail: str | None = None,
        steps_per_epoch: int | None = None,
        transform: Callable | None = None,
        collate: Callable[[list], Any] | None = None,
        pack: dict | None = None,
        buffer: int | None = None,
        device_prefetch: int | None = None,
        mesh=None,
        device=True,
        name: str = "train",
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if shard not in SHARD_MODES:
            raise ValueError(
                f"unknown shard mode {shard!r} (expected one of {SHARD_MODES})"
            )
        if steps_per_epoch is not None and steps_per_epoch < 1:
            raise ValueError(
                f"steps_per_epoch must be >= 1, got {steps_per_epoch}"
            )
        self.config = IngestConfig.from_env(
            buffer=buffer, device_prefetch=device_prefetch, tail=tail
        )
        self.batch_size = batch_size
        # Which coordinates the caller fixed: a mesh bound later must
        # agree with them (never train on another rank's rows).
        self._explicit = {"rank": rank, "world": world}
        self.rank = rank if rank is not None else envcfg.get_int("MLSPARK_PROCESS_ID")
        self.world = world if world is not None else envcfg.get_int("MLSPARK_NUM_PROCESSES")
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} outside world of {self.world}"
            )
        self.shard = shard
        self.steps_per_epoch = steps_per_epoch
        self.transform = transform
        self.collate = collate or _default_collate
        if pack is not None:
            unknown = set(pack) - _PACK_KEYS
            if unknown:
                raise ValueError(
                    f"unknown pack option(s) {sorted(unknown)} "
                    f"(expected a subset of {sorted(_PACK_KEYS)})"
                )
            OnlinePacker(**pack)  # validate budgets now, not mid-epoch
        self.pack = dict(pack) if pack is not None else None
        self.mesh = None
        self.device = device
        self.name = name
        if shard == "files" and not hasattr(source, "shard_files"):
            raise ValueError(
                f"shard='files' needs a file-backed source with "
                f"shard_files(); {type(source).__name__} has none — "
                "use shard='records'"
            )
        self._full_source = source
        self._source = self._sharded_source()
        self._epoch = 0
        self._workers: list[tuple[threading.Event, threading.Thread, Any]] = []
        #: batches yielded in the most recently completed epoch.
        self.last_epoch_batches: int | None = None
        #: host-to-device tensor copies issued by the device stage (the
        #: only copies a batch takes on its way to the step).
        self.h2d_copies = 0
        if mesh is not None:
            self.bind(mesh=mesh)

    def _sharded_source(self):
        """The source this rank reads: the whole stream (records mode) or
        its files (files mode)."""
        if self.shard != "files" or self.world == 1:
            return self._full_source
        if self.steps_per_epoch is None:
            raise ValueError(
                "shard='files' with world > 1 requires "
                "steps_per_epoch: ranks read disjoint files, so no "
                "rank knows the global record count and only a "
                "fixed per-epoch step budget keeps batch counts "
                "equal across the gang (gang collectives deadlock "
                "otherwise)"
            )
        return self._full_source.shard_files(self.rank, self.world)

    # -- epoch / fit integration --------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if hasattr(self._source, "set_epoch"):
            self._source.set_epoch(epoch)

    def bind(self, *, mesh=None, device=None) -> None:
        """Late-bind placement: ``fit`` passes its mesh (this rank reads
        as the mesh's data index of the data axis's size) and its model's
        device here."""
        if mesh is not None:
            from machine_learning_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS

            coords = {"rank": mesh.index(DATA_AXIS), "world": mesh.axis_size(DATA_AXIS)}
            for key, given in self._explicit.items():
                if given is not None and given != coords[key]:
                    raise ValueError(
                        f"StreamingPipeline was built with {key}={given}, but the "
                        f"mesh {dict(mesh.shape)} gives this process data index "
                        f"{coords['rank']} of {coords['world']}: it would read "
                        "another rank's rows"
                    )
            if (self.rank, self.world) != (coords["rank"], coords["world"]):
                self.rank, self.world = coords["rank"], coords["world"]
                self._source = self._sharded_source()
            self.mesh = mesh
        if device is not None:
            self.device = device

    @property
    def yields_device_batches(self) -> bool:
        return self.device is not False and self.config.device_prefetch > 0

    def target_device(self):
        """The device batches are copied to (None: host batches)."""
        if not self.yields_device_batches:
            return None
        import torch

        from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

        return resolve_device(None if self.device is True else torch.device(self.device))

    # -- resume state --------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe pipeline position for the checkpoint meta sidecar:
        the epoch counter plus the source's stream state (mixture RNG and
        cursors) when the source is stateful."""
        sd: dict = {"version": 1, "epoch": self._epoch}
        if hasattr(self._source, "state_dict"):
            sd["source"] = self._source.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self._epoch = int(sd.get("epoch", 0))
        src_state = sd.get("source")
        if src_state is not None:
            if not hasattr(self._source, "load_state_dict"):
                raise ValueError(
                    "checkpoint carries ingest source state but "
                    f"{type(self._source).__name__} cannot restore it — "
                    "resuming would silently replay a different stream"
                )
            self._source.load_state_dict(src_state)

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator:
        dev = self.target_device()
        it = self._host_batches()
        if self.config.buffer > 0:
            it = self._prefetched(it)
        if dev is not None:
            it = self._device_stage(it, dev)
        return it

    def _host_batches(self) -> Iterator:
        B = self.batch_size
        target = self.steps_per_epoch
        tail = self.config.tail
        epoch = self._epoch
        eq_world = self.world if self.shard == "records" else 1
        yielded = 0
        pending = None  # drop-policy holdback (see module docstring)
        buf: list = []
        # Wrap-pad material: a rank's most recent units, enough to fill
        # one batch — bounded, unlike retaining the shard.
        recent: collections.deque = collections.deque(maxlen=B)
        records_acc = 0
        stream: _UnitStream | None = None

        def _batch_of(units: list):
            t0 = time.perf_counter()
            out = self.collate(units)
            if telemetry.enabled() and stream is not None:
                _emit_phase(
                    "data.read",
                    stream.read_seconds + (time.perf_counter() - t0),
                    epoch=epoch,
                )
                stream.read_seconds = 0.0
                if self.pack is not None:
                    _emit_phase("data.pack", stream.pack_seconds, epoch=epoch)
                    stream.pack_seconds = 0.0
            return out

        try:
            while True:  # >1 pass only when steps_per_epoch wraps the stream
                stream = _UnitStream(self)
                pass_units = 0
                for unit in stream:
                    pass_units += 1
                    buf.append(unit)
                    recent.append(unit)
                    if len(buf) == B:
                        batch = _batch_of(buf)
                        buf = []
                        if target is None and tail == "drop":
                            if pending is not None:
                                yield pending
                                yielded += 1
                            pending = batch
                        else:
                            yield batch
                            yielded += 1
                            if target is not None and yielded >= target:
                                return
                records_acc += stream.records_read
                stream.records_read = 0  # folded; finally must not re-add
                if target is None:
                    break
                if pass_units == 0:
                    raise ValueError(
                        f"ingest source yielded no units on a full pass; "
                        f"cannot reach steps_per_epoch={target}"
                    )
                stream = None  # records already folded into records_acc
            # Natural end of the stream: equalize the epoch tail from the
            # unit count every rank observed identically.
            n = stream.global_units
            if tail == "drop":
                allowed = (n // eq_world) // B
                if pending is not None and yielded < allowed:
                    yield pending
                    yielded += 1
                pending = None
            else:  # pad
                per_rank = -(-n // eq_world)  # ceil
                target_pad = -(-per_rank // B)
                fill = list(buf)
                buf = []
                ring = list(recent)
                if yielded < target_pad and not ring:
                    raise ValueError(
                        f"rank {self.rank} saw no units this epoch but the "
                        f"gang-wide batch target is {target_pad}; the "
                        f"dataset ({n} unit(s)) is smaller than the world "
                        f"size {eq_world}"
                    )
                i = 0
                while yielded < target_pad:
                    while len(fill) < B:
                        fill.append(ring[i % len(ring)])
                        i += 1
                    yield _batch_of(fill[:B])
                    fill = fill[B:]
                    yielded += 1
        finally:
            if stream is not None:
                records_acc += stream.records_read
            self.last_epoch_batches = yielded
            reg = telemetry.get_registry()
            reg.counter("data", "records").inc(records_acc)
            reg.counter("data", "batches").inc(yielded)
            if telemetry.enabled():
                log_ = telemetry.get_log()
                log_.emit(
                    "counter", "data.records", value=float(records_acc),
                    attrs={"epoch": epoch},
                )
                log_.emit(
                    "counter", "data.batches", value=float(yielded),
                    attrs={"epoch": epoch},
                )

    def _prefetched(self, it: Iterator) -> Iterator:
        """Bounded producer/consumer stage: batch assembly moves to a
        background thread; the queue bound caps host memory. Same
        stop-event/sentinel shutdown discipline as ``data.loader``'s
        prefetcher, plus occupancy telemetry and a join on teardown (no
        leaked threads — pinned by tests/test_torch_ingest.py). The
        producer touches no CUDA state: its batches are numpy arrays."""
        q: _queue.Queue = _queue.Queue(maxsize=self.config.buffer)
        stop = threading.Event()
        gauge = telemetry.get_registry().gauge("data", "buffer_occupancy")

        def _put(item) -> bool:
            # Bounded-wait put: an abandoned consumer releases the worker
            # within 100ms of shutdown() setting the stop event.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not _put(item):
                        return
                    occ = q.qsize()
                    gauge.set(occ)
                    if telemetry.enabled():
                        telemetry.get_log().emit(
                            "gauge", "data.buffer_occupancy", value=float(occ)
                        )
            except BaseException as e:  # re-raised at the consumer
                _put((_ERR, e))
            else:
                _put(_END)

        thread = threading.Thread(
            target=worker,
            daemon=True,
            name=f"{WORKER_PREFIX}-{self.name}-e{self._epoch}",
        )
        handle = (stop, thread, q)
        self._workers.append(handle)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                while True:
                    try:
                        item = q.get(timeout=1.0)
                        break
                    except _queue.Empty:
                        if not thread.is_alive():
                            raise RuntimeError(
                                "ingest producer thread died without a "
                                "sentinel (killed?)"
                            ) from None
                wait = time.perf_counter() - t0
                if item is _END:
                    return
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and item[0] is _ERR
                ):
                    raise item[1]
                if telemetry.enabled():
                    _emit_phase("data.wait", wait, epoch=self._epoch)
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            thread.join(timeout=5.0)
            if handle in self._workers:
                self._workers.remove(handle)

    def _device_stage(self, it: Iterator, dev) -> Iterator:
        """Copies each batch to ``dev`` ``device_prefetch`` batches ahead
        of consumption: on the card, each field pinned, copied with
        ``non_blocking=True`` on a side stream, an event recorded after
        them, and the batch handed over (``_hand_over``) when consumed;
        on the host, the arrays wrapped as tensors. The ``data.h2d`` span
        measures the pinning and the copies' enqueue."""
        import torch

        cuda = dev.type == "cuda"
        stream = torch.cuda.Stream(device=dev) if cuda else None
        depth = max(self.config.device_prefetch, 1)
        pending: collections.deque = collections.deque()
        h2d_counter = telemetry.get_registry().counter("data", "bytes_h2d")
        bytes_total = 0
        try:
            for batch in it:
                t0 = time.perf_counter()
                event = None
                if cuda:
                    pinned = _map_fields(batch, lambda a: _host_tensor(a).pin_memory())
                    with torch.cuda.stream(stream):
                        moved = _map_fields(pinned, lambda t: t.to(dev, non_blocking=True))
                    event = torch.cuda.Event()
                    event.record(stream)
                    self.h2d_copies += len(_fields(moved))
                else:
                    moved = _map_fields(batch, _host_tensor)
                if telemetry.enabled():
                    _emit_phase(
                        "data.h2d", time.perf_counter() - t0,
                        epoch=self._epoch,
                    )
                nbytes = sum(t.numel() * t.element_size() for t in _fields(moved))
                h2d_counter.inc(nbytes)
                bytes_total += nbytes
                pending.append((moved, event))
                if len(pending) >= depth:
                    yield _hand_over(*pending.popleft(), dev)
            while pending:
                yield _hand_over(*pending.popleft(), dev)
        finally:
            if telemetry.enabled() and bytes_total:
                telemetry.get_log().emit(
                    "counter", "data.bytes_h2d", value=float(bytes_total),
                    attrs={"epoch": self._epoch},
                )

    # -- teardown ------------------------------------------------------------
    def shutdown(self) -> None:
        """Release and join every live producer thread (idempotent; safe
        mid-epoch). ``fit`` calls this in its finally, so a training run
        leaves no pipeline threads behind whether it returned or raised."""
        handles, self._workers = self._workers, []
        for stop, _, _ in handles:
            stop.set()
        for _, thread, q in handles:
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            thread.join(timeout=5.0)
            if thread.is_alive():
                log.warning(
                    "ingest worker %s did not exit within 5s", thread.name
                )

    def __enter__(self) -> "StreamingPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()



def rescatter_stream_state(
    sd: dict, *, old_world: int, new_world: int, shard: str = "records"
) -> dict:
    """Validate and adapt a pipeline ``state_dict`` across a world-size
    change (elastic resume, ``train/reshard.py``).

    In ``shard="records"`` mode the sidecar state is rank-agnostic by
    construction — every rank strides the same stream by its own
    ``(rank, world)`` read from the env at pipeline construction, and
    batch-count equalization is recomputed per-iteration from the
    CURRENT world — so the rescatter is adopt-as-is; this function's job
    is pinning that contract (and failing the one case that breaks it).
    ``shard="files"`` partitions FILES per rank at construction, so a
    saved cursor indexes into one old rank's file subset and cannot be
    re-scattered without re-reading the old partition; elastic resume
    refuses it loudly rather than silently replaying the wrong files.
    """
    if int(new_world) < 1 or int(old_world) < 1:
        raise ValueError(
            f"world sizes must be >= 1, got {old_world} -> {new_world}"
        )
    if shard == "files":
        raise ValueError(
            "ingest stream state from shard='files' is rank-local (each "
            f"rank cursors its own file subset) and cannot be re-scattered "
            f"from world {old_world} to world {new_world}; use "
            "shard='records' for elastic runs or drop the ingest state"
        )
    out = dict(sd)
    out["rescattered"] = {"old_world": int(old_world), "new_world": int(new_world)}
    return out
