"""Serving engine — the decode loop behind ``Translator.serve()``.

The port of ``machine_learning_apache_spark_tpu/serving/engine.py``.
Caller threads tokenize and ``submit()`` into the admission queue; one
background worker decodes in one of two KV disciplines (``kv_mode``):

- **paged** (default, greedy): the worker admits FIFO requests into free
  cache rows (chunk-budgeted prefill, prefix-cache hits for repeated
  prompts), runs ``steps_per_launch`` ragged decode steps over every
  occupied row, and retires rows as they finish;
- **padded** (and every ``method="beam"`` engine): the worker takes
  shape-bucketed batches, pads each to the bucket's ``[max_batch,
  boundary]`` (filler rows replicate row 0), takes a KV slot per member
  and runs the KV-cache decoder (``greedy_translate_cached`` or
  ``beam_translate``) over the rectangle.

A raised launch, admission or batch quarantines its own requests only;
everything still queued keeps flowing.

Compile at warmup, as the JAX engine does: ``warmup()`` (run by
``start()``) builds every program a live request can need — paged: one
prefill per chunk width and the K-step launch (the runtime's
``programs()``); padded and beam: one program per bucket, the whole
``greedy_translate_cached`` or ``beam_translate`` over ``[max_batch,
boundary]`` (encoder, priming call, every step and every beam reorder).
On the card each program is a CUDA graph captured then and replayed
after (``utils/graph_cache.py``); on the CPU it runs eagerly and is
counted alike. ``compile_count()`` is the number of programs (paged:
``max_chunks + 1``; padded and beam: ``len(boundaries)``, the JAX
engine's figures) and ``recompiles_after_warmup`` how many were added
after warmup — 0 in a healthy steady state.

Each batch (padded) or launch (paged) passes the ``decode_batch``
fault-injection site (``utils.faults.maybe_fault``) on the host before
its program runs, and a quarantine dumps the flight recorder.

The live plane, as in the JAX engine: ``start()`` registers the
``serving`` status and health providers (``/statusz``, ``/healthz``),
the paged runtime's ``prefix_cache`` section and the live gauges
``queue_depth_live``, ``kv_page_occupancy``, ``kv_mem_bytes_in_use`` and
``active_rows`` (``/metrics``), and starts the HTTP server when
``MLSPARK_TELEMETRY_HTTP`` asks for one. ``/healthz`` turns 503 on a
quarantine and back at the next batch or launch that completes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Sequence

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
from machine_learning_apache_spark_tpu_torch.models import (
    beam_translate,
    greedy_translate_cached,
)
from machine_learning_apache_spark_tpu_torch.serving.batcher import (
    Batch,
    Batcher,
    TokenBudgetBatcher,
)
from machine_learning_apache_spark_tpu_torch.serving.kv_slots import KVSlotPool
from machine_learning_apache_spark_tpu_torch.serving.metrics import (
    ServingMetrics,
)
from machine_learning_apache_spark_tpu_torch.serving.paged_runtime import (
    PagedDecodeRuntime,
)
from machine_learning_apache_spark_tpu_torch.serving.queue import (
    DeadlineExceeded,
    RequestQueue,
    ServeRequest,
)
from machine_learning_apache_spark_tpu_torch.telemetry import (
    tracectx as _tracectx,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import strip_special_ids
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.faults import maybe_fault
from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class EngineStopped(RuntimeError):
    """The engine shut down before this request completed."""


class InternalError(RuntimeError):
    """The engine failed this request internally (its launch raised).

    The failure is *contained*: only the quarantined launch's requests see
    this and the decode loop keeps serving. The original exception rides
    along as ``__cause__``.
    """


class _HealthWindow:
    """The /healthz quarantine-recovery window, shared between the decode
    worker (writes) and HTTP scrape threads (reads). Both timestamps move
    under one lock so a reader always sees a (quarantine, ok-batch) pair
    that actually coexisted: two bare loads could pair a fresh ok-batch
    time with a stale quarantine time and report "recovered" inside the
    degraded window."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_quarantine_t: float | None = None  # guarded-by: self._lock
        self._last_ok_batch_t: float | None = None  # guarded-by: self._lock

    def note_quarantine(self, t: float) -> None:
        with self._lock:
            self._last_quarantine_t = t

    def note_ok_batch(self, t: float) -> None:
        with self._lock:
            self._last_ok_batch_t = t

    def snapshot(self) -> tuple[float | None, float | None]:
        """A consistent (last_quarantine_t, last_ok_batch_t) pair."""
        with self._lock:
            return self._last_quarantine_t, self._last_ok_batch_t

    def recovered(self) -> bool:
        """False while the most recent quarantine has not yet been
        followed by a successful batch."""
        lq, lok = self.snapshot()
        return lq is None or (lok is not None and lok > lq)


class ServingEngine:
    """Continuous-batching server over a ``Translator``-shaped bundle
    (``model``, ``src_pipe``, ``trg_pipe``, ``device``).

    >>> with translator.serve(max_active=32, boundaries=(32, 64)) as eng:
    ...     futs = [eng.submit(s) for s in texts]
    ...     outs = [f.result(timeout=30) for f in futs]

    ``kv_mode`` (default ``"paged"``, env ``MLSPARK_SERVE_KV_MODE``) picks
    the KV discipline; ``method="beam"`` (``beam_size``,
    ``length_penalty``) always runs padded. Knobs: ``boundaries`` bound
    prompt length (the largest sizes the memory pages; padded: one bucket
    each), ``max_queue_depth`` the backpressure point, ``max_batch`` the
    padded batch shape, ``max_wait_s`` the padded co-batching patience,
    ``num_slots`` the padded KV slots (default ``2 * max_batch``). Paged:
    ``max_active`` the concurrent rows (default ``max_batch``),
    ``page_size``/``num_pages`` the KV granularity/budget,
    ``prefill_chunk``+``prefill_budget`` the chunked-prefill pacing,
    ``steps_per_launch`` decode steps per launch, ``prefix_cache_size``
    the shared-prefix entries, and ``kv_dtype`` (``"float32"`` /
    ``"int8"`` pages with per-page scales, env ``MLSPARK_SERVE_KV_DTYPE``;
    padded and beam engines reject int8).
    """

    def __init__(
        self,
        translator,
        *,
        boundaries: Sequence[int] = (16, 32, 64),
        max_batch: int = 8,
        max_wait_s: float = 0.02,
        max_queue_depth: int = 64,
        num_slots: int | None = None,
        max_new_tokens: int | None = None,
        default_deadline_s: float | None = None,
        method: str = "greedy",
        beam_size: int = 4,
        length_penalty: float = 0.6,
        kv_mode: str | None = None,
        kv_dtype: str | None = None,
        quantize_self: bool = False,
        page_size: int = 8,
        prefill_chunk: int | None = None,
        steps_per_launch: int = 4,
        max_active: int | None = None,
        num_pages: int | None = None,
        prefix_cache_size: int = 32,
        prefill_budget: int | None = None,
        clock=time.monotonic,
    ):
        cfg = translator.model.cfg
        boundaries = tuple(sorted(boundaries))
        if boundaries[-1] > cfg.max_len:
            raise ValueError(
                f"largest boundary {boundaries[-1]} exceeds the model's "
                f"max_len {cfg.max_len}; positions past max_len have no "
                "encoding"
            )
        if method not in ("greedy", "beam"):
            raise ValueError(f"method must be 'greedy' or 'beam', got {method!r}")
        if kv_mode is None:
            kv_mode = envcfg.get_str("MLSPARK_SERVE_KV_MODE")
        if kv_mode not in ("padded", "paged"):
            raise ValueError(
                f"kv_mode must be 'padded' or 'paged', got {kv_mode!r} "
                "(check MLSPARK_SERVE_KV_MODE)"
            )
        if method == "beam" and kv_mode == "paged":
            # Beam hypotheses share and reorder their rows' KV; the paged
            # store has no story for that, so beam engines run padded.
            log.info("beam method: routing kv_mode paged -> padded")
            kv_mode = "padded"
        if kv_dtype is None:
            kv_dtype = envcfg.get_str("MLSPARK_SERVE_KV_DTYPE")
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'float32' or 'int8', got {kv_dtype!r} "
                "(check MLSPARK_SERVE_KV_DTYPE)"
            )
        if kv_dtype == "int8" and kv_mode != "paged":
            # The decode cache of the padded path has no scale plane.
            raise ValueError(
                "kv_dtype='int8' requires the paged KV store; this engine "
                f"resolved kv_mode={kv_mode!r}"
                + (" via method='beam'" if method == "beam" else "")
                + " — use kv_mode='paged' with greedy decoding, or drop "
                "the int8 request (check MLSPARK_SERVE_KV_DTYPE)"
            )
        self.kv_dtype = kv_dtype
        self.quantize_self = bool(quantize_self)
        self.translator = translator
        self.device = translator.device
        self.boundaries = boundaries
        self.max_batch = max_batch
        self.max_new_tokens = (
            cfg.max_len - 1 if max_new_tokens is None else max_new_tokens
        )
        self.method = method
        self.beam_size = beam_size
        self.length_penalty = length_penalty
        self.kv_mode = kv_mode
        self.clock = clock
        self.metrics = ServingMetrics(clock=clock)
        self.queue = RequestQueue(
            max_queue_depth, default_deadline_s=default_deadline_s,
            clock=clock, on_expire=self.metrics.on_expire,
            on_slo=self.metrics.on_slo,
        )
        self._stop = threading.Event()
        # Monotonic sequence over dispatched batches/launches — the
        # ``decode_batch`` fault-injection coordinate (worker thread
        # only; no lock needed).
        self._batch_seq = 0
        self._worker: threading.Thread | None = None
        self._compiles_at_warmup: int | None = None
        self._health = _HealthWindow()
        if kv_mode == "padded":
            self.max_active = max_batch
            self.runtime = None
            # One program per bucket: the whole decode over the rectangle.
            self._programs = ProgramCache(self.device)
            self.batcher = Batcher(
                self.queue, boundaries=boundaries, max_batch=max_batch,
                max_wait_s=max_wait_s,
            )
            # 2x max_batch by default: one batch decoding plus one forming.
            self.pool = KVSlotPool(num_slots or 2 * max_batch)
            return
        self.max_active = max_active or max_batch
        if prefill_chunk is None:
            prefill_chunk = max(page_size, boundaries[0] // page_size * page_size)
        self.prefill_chunk = prefill_chunk
        # Chunked-prefill pacing: at most this many chunk-padded prompt
        # tokens prefill between consecutive decode launches, so admission
        # bursts can't stall in-flight rows' next token.
        self.prefill_budget = (
            prefill_budget
            if prefill_budget is not None
            else 2 * -(-boundaries[-1] // prefill_chunk) * prefill_chunk
        )
        self.runtime = PagedDecodeRuntime(
            translator.model,
            max_active=self.max_active,
            max_src=boundaries[-1],
            max_new_tokens=self.max_new_tokens,
            page_size=page_size,
            prefill_chunk=prefill_chunk,
            steps_per_launch=steps_per_launch,
            num_pages=num_pages,
            prefix_cache_size=prefix_cache_size,
            kv_dtype=kv_dtype,
            quantize_self=quantize_self,
            sos_id=SOS_ID, eos_id=EOS_ID, pad_id=cfg.pad_id,
            device=self.device,
        )
        # The row pool: one slot = one cache row of the launch.
        self.pool = KVSlotPool(self.max_active)
        self.paged_batcher = TokenBudgetBatcher(self.queue, chunk=prefill_chunk)
        self._programs = self.runtime.programs()

    def _decode(self, src: torch.Tensor) -> torch.Tensor:
        """The padded path's program for one ``[max_batch, boundary]``
        rectangle of int64 ids (on the host): the bucket's decoder
        output, ``[max_batch, max_new_tokens + 1]`` on the device, valid
        until the next call."""
        return self._programs("decode", self._decode_body, src)

    def _decode_body(self, src: torch.Tensor) -> torch.Tensor:
        """``beam_translate`` or ``greedy_translate_cached`` over the
        rectangle ``src``, on the device."""
        kw = dict(max_new_tokens=self.max_new_tokens, sos_id=SOS_ID, eos_id=EOS_ID)
        if self.method == "beam":
            return beam_translate(
                self.translator.model, src, beam_size=self.beam_size,
                length_penalty=self.length_penalty, **kw,
            )
        return greedy_translate_cached(self.translator.model, src, **kw)

    @contextlib.contextmanager
    def _on_device(self):
        """Decoding context: the engine's card current (if any), no
        autograd."""
        with (
            torch.cuda.device(self.device)
            if self.device.type == "cuda" else contextlib.nullcontext()
        ), torch.no_grad():
            yield

    # -- lifecycle -----------------------------------------------------------
    def start(self, *, warmup: bool = True) -> "ServingEngine":
        if self._worker is not None:
            raise RuntimeError("engine already started")
        if warmup:
            self.warmup()
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._serve_loop, name="serving-engine", daemon=True
        )
        self._worker.start()
        # The live plane: contribute this engine's state to /statusz,
        # /healthz and /metrics, and (idempotently) start the HTTP server
        # — a no-op with zero threads unless MLSPARK_TELEMETRY_HTTP is set
        # and telemetry is on.
        telemetry.register_status_provider("serving", self._status_snapshot)
        telemetry.register_health_provider("serving", self._health_snapshot)
        telemetry.register_live_gauge(
            "serving", "queue_depth_live", lambda: self.queue.depth
        )
        if self.runtime is not None:
            # The residency section a prefix-affinity router reads off
            # /statusz. Looked up per scrape: a quarantine replaces the
            # runtime's prefix cache.
            telemetry.register_status_provider(
                "prefix_cache", lambda: self.runtime.prefix_cache.stats()
            )
            telemetry.register_live_gauge(
                "serving", "kv_page_occupancy",
                lambda: self.runtime.mem_pool.occupancy,
            )
            telemetry.register_live_gauge(
                "serving", "kv_mem_bytes_in_use",
                lambda: self.runtime.mem_pool.bytes_in_use,
            )
            telemetry.register_live_gauge(
                "serving", "active_rows", self.runtime.active_count,
            )
        telemetry.start_http_server()
        telemetry.beacon_update(phase="serving")
        return self

    def stop(self, *, timeout: float = 30.0) -> None:
        if self._worker is None:
            return
        telemetry.unregister_provider("serving")
        telemetry.unregister_provider("prefix_cache")
        self._stop.set()
        with self.queue.cond:
            self.queue.cond.notify_all()
        self._worker.join(timeout)
        self._worker = None
        n = self.queue.fail_all(EngineStopped("serving engine stopped"))
        if n:
            # Counted into ``failed`` so the conservation law balances
            # across shutdown: stop-drained requests are terminal too.
            self.metrics.on_failure(n)
            log.info("engine stop failed %d queued requests", n)

    def __enter__(self) -> "ServingEngine":
        if self._worker is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> int:
        """Build every program a live request could need — padded: one
        decoder per bucket; paged: every prefill width and the launch —
        so no request pays a capture, a kernel build or a library's
        start-up. Returns the program count."""
        if self.kv_mode == "paged":
            with self._on_device(), torch.profiler.record_function("serve_warmup_paged"):
                n = self.runtime.warmup()
            self._compiles_at_warmup = self.compile_count()
            log.info(
                "warmup built %d paged programs (%d prefill widths + 1 launch; "
                "max_active=%d, page_size=%d, device=%s)",
                n, n - 1, self.max_active, self.runtime.page_size, self.device,
            )
            return n
        row = [SOS_ID, EOS_ID]
        with self._on_device():
            for b in self.boundaries:
                src = np.full((self.max_batch, b), self._pad_id, np.int64)
                src[:, : len(row)] = row
                with torch.profiler.record_function(f"serve_warmup_b{b}"):
                    self._decode(torch.from_numpy(src)).cpu()
        self._compiles_at_warmup = self.compile_count()
        log.info(
            "warmup built %d bucket programs (max_batch=%d, buckets=%s, "
            "method=%s, device=%s)",
            len(self.boundaries), self.max_batch, list(self.boundaries),
            self.method, self.device,
        )
        return len(self.boundaries)

    def programs(self) -> ProgramCache:
        """The engine's programs: the paged runtime's prefill widths and
        launch, or the padded engine's bucket decoders."""
        return self._programs

    def compile_count(self) -> int:
        """How many programs the engine holds (``programs().size()``)."""
        return self._programs.size()

    @property
    def recompiles_after_warmup(self) -> int | None:
        """Programs built since ``warmup()`` — 0 in a healthy steady
        state; None before warmup."""
        if self._compiles_at_warmup is None:
            return None
        return self.compile_count() - self._compiles_at_warmup

    # -- live plane providers (called from HTTP scrape threads) --------------
    def _health_snapshot(self) -> dict:
        """/healthz check: worker thread alive, and not in the degraded
        window between a quarantine and the next successful batch."""
        worker = self._worker
        worker_alive = worker is not None and worker.is_alive()
        recovered = self._health.recovered()
        return {
            "healthy": worker_alive and recovered,
            "worker_alive": worker_alive,
            "quarantine_recovered": recovered,
            "kv_mode": self.kv_mode,
            "kv_dtype": self.kv_dtype,
            "queue_depth": self.queue.depth,
            "loop_restarts": self.metrics.loop_restarts,
            "quarantined": self.metrics.quarantined,
        }

    def _status_snapshot(self) -> dict:
        """/statusz section: the engine's live state — config,
        conservation ledger, latency summary, page-pool stats,
        slowest-request exemplars."""
        out = {
            "kv_mode": self.kv_mode,
            "kv_dtype": self.kv_dtype,
            "method": self.method,
            "boundaries": list(self.boundaries),
            "max_batch": self.max_batch,
            "max_active": self.max_active,
            "max_new_tokens": self.max_new_tokens,
            "queue_depth": self.queue.depth,
            "recompiles_after_warmup": self.recompiles_after_warmup,
            "ledger": self.metrics.ledger(),
            "metrics": self.metrics.summary(),
            "slowest_requests": self.metrics.request_exemplars(),
        }
        if self.runtime is not None:
            out["page_pool"] = self.runtime.stats()
        return out

    # -- request path --------------------------------------------------------
    @property
    def _pad_id(self) -> int:
        return self.translator.model.cfg.pad_id

    def submit(
        self,
        text: str,
        *,
        deadline_s: float | None = None,
        tier: str | None = None,
    ) -> ServeRequest:
        """Tokenize and admit one request; returns its ``ServeRequest``
        (``.result(timeout)`` blocks for the translation). Raises
        ``Backpressure`` at capacity and ``ValueError`` for inputs no
        boundary can hold — both *before* the request costs decode work."""
        if self._worker is None:
            raise RuntimeError("engine not started (use start() or `with`) ")
        ids = self.translator.src_pipe.ragged([text])[0]
        if len(ids) > self.boundaries[-1]:
            raise ValueError(
                f"input tokenizes to {len(ids)} ids, beyond the largest "
                f"bucket boundary {self.boundaries[-1]}; raise boundaries "
                "or shorten the input"
            )
        # Count the attempt BEFORE the queue decides: the conservation law
        # needs every admission attempt in ``submitted``.
        self.metrics.on_submit()
        ctx = _tracectx.current() or _tracectx.mint()
        with _tracectx.use(ctx), telemetry.span("serving.submit"):
            try:
                req = self.queue.submit(
                    text, ids, deadline_s=deadline_s, tier=tier
                )
            except Exception:
                self.metrics.on_reject()
                raise
        return req

    # -- the decode loop -----------------------------------------------------
    def _serve_loop(self) -> None:
        """Supervisor: keep the decode loop alive until ``stop()``. A
        launch that raises is quarantined inside the loop; if the loop
        itself dies it is restarted here (``loop_restarts`` counts it).
        The worker runs on the engine's device, and without autograd."""
        with self._on_device():
            while not self._stop.is_set():
                try:
                    self._decode_loop()
                except Exception:  # noqa: BLE001 — a dead loop, not a dead engine
                    if self._stop.is_set():
                        break
                    log.exception("decode loop died; restarting")
                    self.metrics.on_loop_restart()

    def _decode_loop(self) -> None:
        if self.kv_mode == "paged":
            self._paged_loop()
            return
        while not self._stop.is_set():
            batch = self.batcher.next_batch(timeout=0.05)
            if batch is None:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — a batch must never kill the loop
                self._quarantine(batch, e)

    # -- the paged decode loop ----------------------------------------------
    def _paged_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.queue.expire_overdue()
                idle = not self.runtime.any_active()
                self._paged_admit(timeout=0.05 if idle else 0.0)
                if self._stop.is_set():
                    break
                if not self.runtime.any_active():
                    continue
                self._paged_step()
            except Exception as e:  # noqa: BLE001 — contain, keep serving
                self._paged_quarantine(e)
        self._paged_fail_active(EngineStopped("serving engine stopped"))

    def _admission_cost(self, req) -> int:
        """Prefill tokens admitting ``req`` will compute: zero for a
        prefix-cache hit, the chunk-padded prompt width otherwise."""
        if self.runtime.prefix_cache.contains(tuple(req.ids)):
            return 0
        return self.paged_batcher.cost(req.ids)

    def _paged_admit(self, timeout: float = 0.0) -> None:
        """Move pending requests onto free rows, bounded by the prefill
        token budget. On page-pool pressure the untaken tail goes back to
        the queue head — transient, not an error."""
        taken = self.paged_batcher.take(
            max_requests=self.pool.free,
            token_budget=self.prefill_budget,
            timeout=timeout,
            cost_fn=self._admission_cost,
        )
        if not taken:
            self.queue.expire_now()
            return
        for i, req in enumerate(taken):
            if self._stop.is_set():
                self.queue.requeue_front(taken[i:])
                return
            row = self.pool.try_acquire(req.id)
            if row is None:  # unreachable: take() is bounded by free rows
                self.queue.requeue_front(taken[i:])
                return
            res = self.runtime.admit(req, row)
            if res is None:
                self.pool.release_owner(req.id)
                self.queue.requeue_front(taken[i:])
                return
            kind, computed, real = res
            req.admit_time = self.clock()
            req.trace.mark(
                "admit", req.admit_time,
                kind=kind, prefill_tokens=computed, row=row,
            )
            self.metrics.on_token_slots(
                real=0 if kind == "hit" else real, padded=computed
            )

    def _paged_step(self) -> None:
        """One fault-injection point, one page-growth pass, the deadline
        sweep, one launch, then host-side retirement of every finished
        row. The fault point is on the host, before the launch's graph
        replays."""
        seq = self._batch_seq
        self._batch_seq += 1
        maybe_fault("decode_batch", batch=seq)
        for row in self.runtime.grow():
            req = self.runtime.retire(row)
            self.pool.release_owner(req.id)
            if not req.future.done():
                req.trace.mark("failed", self.clock(), reason="pages_exhausted")
                req.future.set_exception(InternalError(
                    "kv page pool exhausted mid-decode; size num_pages "
                    "for the worst case (the default does)"
                ))
                self.metrics.on_failure(1)
                self.metrics.on_trace(req)
        # Deadline sweep between launches: a row whose deadline passed
        # retires now, freeing its pages and row.
        now = self.clock()
        n_reaped = 0
        for row, req in self.runtime.active_rows():
            if not req.expired(now):
                continue
            self.runtime.retire(row)
            self.pool.release_owner(req.id)
            n_reaped += 1
            if not req.future.done():
                req.trace.mark("expire", now, reason="in_flight")
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired mid-decode after "
                    f"{now - req.submit_time:.3f}s"
                ))
                self.metrics.on_expire(1, in_flight=True)
                self.metrics.on_slo(req.tier, True)
                self.metrics.on_trace(req)
        if n_reaped:
            telemetry.annotate(
                "serving.expire_in_flight", mode="paged", count=n_reaped
            )
        active = self.runtime.active_requests()
        n_active = len(active)
        if n_active == 0:
            return
        t0 = self.clock()
        with telemetry.span(
            "serving.batch", mode="paged", rows=n_active,
            steps=self.runtime.steps_per_launch,
            requests=[r.trace.trace_id for r in active],
        ), torch.profiler.record_function("serve_decode_paged"):
            result = self.runtime.launch()
        decode_done = self.clock()
        decode_s = decode_done - t0
        for req in active:
            req.trace.note_launch()
        for req in result.first_emits:
            req.decode_done_time = decode_done
            req.trace.mark("first_token", decode_done)
        vocab = self.translator.trg_pipe.vocab
        n_completed = 0
        for req, ids, row, saw_eos in result.completed:
            self.runtime.retire(row)
            self.pool.release_owner(req.id)
            req.trace.mark("complete", decode_done, tokens=len(ids))
            req.future.set_result(" ".join(vocab.lookup_tokens(ids)))
            n_completed += 1
            now = self.clock()
            self.metrics.on_complete(
                queue_wait=(req.admit_time or req.submit_time) - req.submit_time,
                ttft=(req.decode_done_time or now) - req.submit_time,
                total=now - req.submit_time,
            )
            self.metrics.on_trace(req)
            self.metrics.on_slo(
                req.tier, req.deadline is not None and now > req.deadline
            )
        # Token ledger: real emits count EOS when emitted; a
        # budget-exhausted row gets its implicit stop token here.
        new_tokens = result.real_tokens + sum(
            1 for *_, saw_eos in result.completed if not saw_eos
        )
        self.metrics.on_token_slots(
            real=result.real_tokens, padded=result.computed_slots
        )
        if n_completed:
            self.queue.note_serviced(n_completed, decode_s)
        self.metrics.on_batch(
            n_requests=n_active,
            max_batch=self.max_active,
            decode_s=decode_s,
            new_tokens=new_tokens,
            queue_depth=self.queue.depth,
            slot_occupancy=self.runtime.mem_pool.occupancy,
        )
        # A launch completed without raising: the degraded window (if
        # any) is over — /healthz flips back to ok.
        self._health.note_ok_batch(decode_done)

    def _paged_quarantine(self, exc: Exception) -> None:
        """Contain a failed launch/admission: the page store's contents
        are suspect, so every active request fails with ``InternalError``
        and the store resets; everything still queued keeps flowing."""
        if self._stop.is_set():
            return
        self._health.note_quarantine(self.clock())
        active = self.runtime.reset()
        log.info("quarantining paged launch of %d: %r", len(active), exc)
        traces: list[dict] = []
        telemetry.annotate(
            "serving.quarantine", mode="paged", requests=len(active),
            error=type(exc).__name__,
        )
        n = 0
        for req in active:
            self.pool.release_owner(req.id)
            if not req.future.done():
                req.trace.mark(
                    "failed", self.clock(), reason="quarantine",
                    error=type(exc).__name__,
                )
                err = InternalError(
                    f"decode launch failed internally ({type(exc).__name__});"
                    " only the active paged rows are affected"
                )
                err.__cause__ = exc
                req.future.set_exception(err)
                n += 1
                traces.append(req.trace.to_dict())
                self.metrics.on_trace(req)
        self.metrics.on_quarantine(n)
        self.metrics.on_failure(n)
        # The flight dump carries each quarantined request's full trace
        # timeline — postmortems see where every victim's time went.
        telemetry.dump_flight(
            f"serving.quarantine:{type(exc).__name__}",
            extra={
                "mode": "paged", "requests_failed": n,
                "request_traces": traces,
            },
        )

    def _paged_fail_active(self, exc: Exception) -> None:
        """Engine stopping with rows mid-decode: fail them terminally so
        the admission ledger still balances."""
        n = 0
        for req in self.runtime.reset():
            self.pool.release_owner(req.id)
            if not req.future.done():
                req.trace.mark("failed", self.clock(), reason="engine_stop")
                req.future.set_exception(exc)
                n += 1
        if n:
            self.metrics.on_failure(n)
            log.info("engine stop failed %d in-flight paged rows", n)

    # -- the padded decode path ------------------------------------------------
    def _quarantine(self, batch: Batch, exc: Exception) -> None:
        """Contain one failed batch: free its KV slots, fail its (and only
        its) requests with ``InternalError``, and count it."""
        self._health.note_quarantine(self.clock())
        log.info("quarantining batch of %d: %r", len(batch.requests), exc)
        traces: list[dict] = []
        telemetry.annotate(
            "serving.quarantine", mode="padded", boundary=batch.boundary,
            requests=len(batch.requests), error=type(exc).__name__,
        )
        n = 0
        for r in batch.requests:
            self.pool.release_owner(r.id)
            if not r.future.done():
                r.trace.mark(
                    "failed", self.clock(), reason="quarantine",
                    error=type(exc).__name__,
                )
                err = InternalError(
                    f"decode batch failed internally ({type(exc).__name__}); "
                    "only this batch's requests are affected"
                )
                err.__cause__ = exc
                r.future.set_exception(err)
                n += 1
                traces.append(r.trace.to_dict())
                self.metrics.on_trace(r)
        self.metrics.on_quarantine(n)
        self.metrics.on_failure(n)
        # Flight recorder: the quarantined batch's decode span (errored),
        # the annotation above, and every victim's trace timeline.
        telemetry.dump_flight(
            f"serving.quarantine:{type(exc).__name__}",
            extra={
                "boundary": batch.boundary, "requests_failed": n,
                "request_traces": traces,
            },
        )

    def _take_slots(self, batch: Batch) -> list[ServeRequest]:
        """All-or-nothing slot acquisition for the batch's live members,
        shedding any member whose deadline passes while waiting."""
        members = list(batch.requests)
        while members and not self._stop.is_set():
            now = self.clock()
            live = [r for r in members if not r.expired(now)]
            for r in members:
                if r not in live:
                    self.metrics.on_expire()
                    self.metrics.on_slo(r.tier, True)
                    r.trace.mark("expire", now, where="slot_wait")
                    r.future.set_exception(
                        DeadlineExceeded(f"request {r.id} expired awaiting a KV slot")
                    )
            members = live
            if not members:
                break
            if self.pool.acquire_many([r.id for r in members], timeout=0.05):
                return members
        n_failed = 0
        for r in members:  # engine stopping
            if not r.future.done():
                r.trace.mark("failed", self.clock(), reason="engine_stop")
                r.future.set_exception(EngineStopped("engine stopping"))
                n_failed += 1
        if n_failed:
            self.metrics.on_failure(n_failed)  # terminal — conservation
        return []

    def _run_batch(self, batch: Batch) -> None:
        with telemetry.span(
            "serving.batch", mode="padded", boundary=batch.boundary,
            size=len(batch.requests),
            requests=[r.trace.trace_id for r in batch.requests],
        ):
            self._run_batch_inner(batch)

    def _run_batch_inner(self, batch: Batch) -> None:
        members = self._take_slots(batch)
        if not members:
            return
        # After slot acquisition, before decode: an injected failure here
        # exercises the full quarantine path, slot release included.
        seq = self._batch_seq
        self._batch_seq += 1
        maybe_fault("decode_batch", batch=seq)
        batch_start = self.clock()
        for r in members:
            r.trace.mark(
                "admit", batch_start, kind="padded", prefill_tokens=batch.boundary,
            )
        src = np.full((self.max_batch, batch.boundary), self._pad_id, np.int64)
        for i, r in enumerate(members):
            row = r.ids[: batch.boundary]
            src[i, : len(row)] = row
        # Filler rows replicate row 0: real tokens keep every attention row
        # well-formed, and rows past len(members) are discarded.
        src[len(members):] = src[0]
        with torch.profiler.record_function(f"serve_decode_b{batch.boundary}"):
            out = self._decode(torch.from_numpy(src)).cpu()
        decode_done = self.clock()
        rows = strip_special_ids(
            out[: len(members)], pad_id=self._pad_id, sos_id=SOS_ID, eos_id=EOS_ID,
        )
        vocab = self.translator.trg_pipe.vocab
        new_tokens = 0
        real_decode = 0
        for r, row in zip(members, rows):
            r.decode_done_time = decode_done
            r.trace.note_launch()
            r.trace.mark("first_token", decode_done)
            new_tokens += len(row) + 1  # emitted ids + the eos/stop token
            real_decode += min(len(row) + 1, self.max_new_tokens)
            # The slot frees at EOS: the row is done either way (eos
            # emitted, or the max_new_tokens budget exhausted).
            self.pool.release_owner(r.id)
            r.trace.mark("complete", decode_done, tokens=len(row))
            r.future.set_result(" ".join(vocab.lookup_tokens(row)))
            done = self.clock()
            self.metrics.on_complete(
                queue_wait=batch_start - r.submit_time,
                ttft=decode_done - r.submit_time,
                total=done - r.submit_time,
            )
            self.metrics.on_trace(r)
            self.metrics.on_slo(r.tier, r.deadline is not None and done > r.deadline)
        # Padding-waste ledger: the rectangle this batch computed (every
        # row, filler included, at the full boundary and budget) against
        # the tokens that were real.
        self.metrics.on_token_slots(
            real=sum(min(len(r.ids), batch.boundary) for r in members) + real_decode,
            padded=self.max_batch * (batch.boundary + self.max_new_tokens),
        )
        decode_s = decode_done - batch_start
        self.queue.note_serviced(len(members), decode_s)
        self.metrics.on_batch(
            n_requests=len(members),
            max_batch=self.max_batch,
            decode_s=decode_s,
            new_tokens=new_tokens,
            queue_depth=self.queue.depth,
            slot_occupancy=self.pool.occupancy,
        )
        # Batch retired cleanly: end of any post-quarantine degraded window.
        self._health.note_ok_batch(decode_done)
