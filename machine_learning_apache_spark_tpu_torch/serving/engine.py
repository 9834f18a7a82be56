"""Serving engine — the decode loop behind ``Translator.serve()``.

The port of ``machine_learning_apache_spark_tpu/serving/engine.py``, paged
greedy path: caller threads tokenize and ``submit()`` into the admission
queue; one background worker admits FIFO requests into free cache rows
(chunk-budgeted prefill, prefix-cache hits for repeated prompts), runs
``steps_per_launch`` ragged decode steps over every occupied row, and
retires rows as they finish. A raised launch or admission quarantines the
active set only; everything still queued keeps flowing.

Not ported yet (ROADMAP): ``kv_mode="padded"`` and ``method="beam"`` raise
``NotImplementedError``; the telemetry HTTP server, status and health
providers, flight-recorder dumps and fault-injection sites are absent.
Eager PyTorch keeps no program cache, so ``compile_count()`` and
``recompiles_after_warmup`` report ``None`` — the JAX contract's "probe
not exposed" case.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Sequence

import torch

from machine_learning_apache_spark_tpu_torch import telemetry
from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
from machine_learning_apache_spark_tpu_torch.serving.batcher import (
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
from machine_learning_apache_spark_tpu_torch.utils import env as envcfg
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: The ROADMAP item that ports what this engine does not run yet.
_LEFT_OUT = "ROADMAP.md, queue A: 'Serving, rest of the engine'"


class EngineStopped(RuntimeError):
    """The engine shut down before this request completed."""


class InternalError(RuntimeError):
    """The engine failed this request internally (its launch raised).

    The failure is *contained*: only the quarantined launch's requests see
    this and the decode loop keeps serving. The original exception rides
    along as ``__cause__``.
    """


class ServingEngine:
    """Continuous-batching paged server over a ``Translator``-shaped bundle
    (``model``, ``src_pipe``, ``trg_pipe``, ``device``).

    >>> with translator.serve(max_active=32, boundaries=(32, 64)) as eng:
    ...     futs = [eng.submit(s) for s in texts]
    ...     outs = [f.result(timeout=30) for f in futs]

    Knobs: ``boundaries`` bound prompt length (the largest sizes the
    memory pages), ``max_queue_depth`` the backpressure point,
    ``max_active`` the concurrent rows (default ``max_batch``),
    ``page_size``/``num_pages`` the KV granularity/budget,
    ``prefill_chunk``+``prefill_budget`` the chunked-prefill pacing,
    ``steps_per_launch`` decode steps per launch, ``prefix_cache_size``
    the shared-prefix entries, and ``kv_dtype`` (``"float32"`` /
    ``"int8"`` pages with per-page scales, env ``MLSPARK_SERVE_KV_DTYPE``).
    """

    def __init__(
        self,
        translator,
        *,
        boundaries: Sequence[int] = (16, 32, 64),
        max_batch: int = 8,
        max_queue_depth: int = 64,
        max_new_tokens: int | None = None,
        default_deadline_s: float | None = None,
        method: str = "greedy",
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
        if method == "beam":
            raise NotImplementedError(
                f"method='beam' is not ported yet ({_LEFT_OUT})"
            )
        if method != "greedy":
            raise ValueError(f"method must be 'greedy' or 'beam', got {method!r}")
        if kv_mode is None:
            kv_mode = envcfg.get_str("MLSPARK_SERVE_KV_MODE")
        if kv_mode == "padded":
            raise NotImplementedError(
                f"kv_mode='padded' is not ported yet ({_LEFT_OUT})"
            )
        if kv_mode != "paged":
            raise ValueError(
                f"kv_mode must be 'padded' or 'paged', got {kv_mode!r} "
                "(check MLSPARK_SERVE_KV_MODE)"
            )
        if kv_dtype is None:
            kv_dtype = envcfg.get_str("MLSPARK_SERVE_KV_DTYPE")
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'float32' or 'int8', got {kv_dtype!r} "
                "(check MLSPARK_SERVE_KV_DTYPE)"
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
        self.kv_mode = kv_mode
        self.clock = clock
        self.metrics = ServingMetrics(clock=clock)
        self.queue = RequestQueue(
            max_queue_depth, default_deadline_s=default_deadline_s,
            clock=clock, on_expire=self.metrics.on_expire,
            on_slo=self.metrics.on_slo,
        )
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
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None

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
        return self

    def stop(self, *, timeout: float = 30.0) -> None:
        if self._worker is None:
            return
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
        """Run every prefill width and one launch once, so no request pays
        a kernel build or a library's start-up. Returns how many distinct
        shapes ran."""
        with torch.profiler.record_function("serve_warmup_paged"):
            n = self.runtime.warmup()
        log.info(
            "warmup ran %d paged shapes (%d prefill widths + 1 launch; "
            "max_active=%d, page_size=%d, device=%s)",
            n, n - 1, self.max_active, self.runtime.page_size, self.device,
        )
        return n

    def compile_count(self) -> int | None:
        """``None``: eager PyTorch keeps no program cache to count."""
        return None

    @property
    def recompiles_after_warmup(self) -> int | None:
        """``None``, for the same reason as ``compile_count``."""
        return None

    # -- request path --------------------------------------------------------
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
        dev_ctx = (
            torch.cuda.device(self.device)
            if self.device.type == "cuda" else contextlib.nullcontext()
        )
        with dev_ctx, torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._paged_loop()
                except Exception:  # noqa: BLE001 — a dead loop, not a dead engine
                    if self._stop.is_set():
                        break
                    log.exception("decode loop died; restarting")
                    self.metrics.on_loop_restart()

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
        """One page-growth pass, the deadline sweep, one launch, then
        host-side retirement of every finished row."""
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

    def _paged_quarantine(self, exc: Exception) -> None:
        """Contain a failed launch/admission: the page store's contents
        are suspect, so every active request fails with ``InternalError``
        and the store resets; everything still queued keeps flowing."""
        if self._stop.is_set():
            return
        active = self.runtime.reset()
        log.info("quarantining paged launch of %d: %r", len(active), exc)
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
                self.metrics.on_trace(req)
        self.metrics.on_quarantine(n)
        self.metrics.on_failure(n)

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
