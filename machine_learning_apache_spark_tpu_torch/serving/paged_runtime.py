"""Paged decode runtime — the device half of the ragged serving engine.

The port of ``machine_learning_apache_spark_tpu/serving/paged_runtime.py``.
The runtime keeps **two page stores** on its device, each ``[layers, 2,
num_pages, page_size, d_model]``:

- the **self store** holds generated-token K/V, sized at worst case
  (``max_active x ceil(max_new_tokens/page_size)`` pages, plus the null
  page) so a decoding row can never starve;
- the **mem store** holds prompt cross-attention K/V and the prefix
  cache; prefill writes it and decode only reads it.

With ``kv_dtype="int8"`` the mem store's payload is int8 with per-page
absmax scales kept in a ``[layers, 2, num_pages, page_size]`` fp32 plane
addressed by the same block tables; ``quantize_self=True`` quantizes the
self store too, with per-slot scales written by the decode scatter. The
attention kernel dequantizes slot by slot before its dots.

Two kinds of work run over the stores:

- **prefill**: encode one prompt padded to the next ``prefill_chunk``
  multiple, project every decoder layer's cross-attention K/V
  (``Transformer.prefill_paged``), and write them into the request's
  memory pages. A ``PrefixCache`` hit skips it entirely.
- **launch**: ``steps_per_launch`` greedy decode steps, a Python loop over
  ``Transformer.decode_step_paged``, serving every occupied row whatever
  its prompt length or generation depth: block tables and per-row lengths
  make raggedness a property of the data.

Where JAX threads the stores through donated jitted programs, the port
updates ``kv_self``/``kv_mem`` and their scale planes **in place**
(``index_put_``), so no store is ever copied. Host state (block tables,
cursors, row↔request maps) is plain numpy, mutated only by the engine's
decode thread; a launch copies it to the device once and synchronises
once, when the emitted tokens come back.

Decode discipline (kept token-identical with the JAX runtime): each step
scatters the new K/V at the row's *old* cursor (finished rows write the
null page), emits ``argmax`` (pad forced for finished rows; like
``jnp.argmax``, ``torch.argmax`` returns the first maximum), then advances
the cursor of unfinished rows only. A row finishes on emitting EOS or pad,
or on exhausting ``max_new_tokens``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    KVPagePool,
    PrefixCache,
)
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
from machine_learning_apache_spark_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _quantize(x: torch.Tensor, absmax: torch.Tensor):
    """Absmax int8: ``(q, scale)`` with ``x ≈ q * scale``; the scale has
    ``absmax``'s shape and a 1e-30 floor, ``q`` is clipped to ±127 and
    rounded half to even (as ``jnp.round``)."""
    s = torch.clamp_min(absmax / 127.0, 1e-30)
    shape = s.shape + (1,) * (x.dim() - s.dim())
    q = torch.clamp(torch.round(x / s.reshape(shape)), -127, 127)
    return q.to(torch.int8), s


@dataclasses.dataclass
class LaunchResult:
    """What one launch produced, for the engine's bookkeeping."""

    #: rows that finished this launch: (request, content token ids —
    #: sos/eos/pad excluded, row index, whether EOS was actually emitted)
    completed: list
    #: requests whose FIRST token arrived this launch (TTFT stamp)
    first_emits: list
    #: real tokens emitted this launch (EOS included; pads excluded)
    real_tokens: int
    #: decode-step slots computed (max_active x steps)
    computed_slots: int
    steps: int
    n_active: int


class PagedDecodeRuntime:
    """Page stores + prefill/launch + per-row host state.

    Single-threaded by contract: every method is called from the engine's
    decode thread (the pools it owns are internally locked, so
    introspection from other threads stays safe). ``model`` is the port's
    ``Transformer``; it is moved to ``device`` (the card unless
    ``device="cpu"``) and put in eval mode.
    """

    def __init__(
        self,
        model,
        *,
        max_active: int,
        max_src: int,
        max_new_tokens: int,
        page_size: int = 8,
        prefill_chunk: int = 8,
        steps_per_launch: int = 4,
        num_pages: int | None = None,
        prefix_cache_size: int = 32,
        kv_dtype: str = "float32",
        quantize_self: bool = False,
        sos_id: int,
        eos_id: int,
        pad_id: int,
        device=None,
    ):
        cfg = model.cfg
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk % page_size != 0:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a multiple of "
                f"page_size ({page_size}) so memory pages fill exactly"
            )
        if max_new_tokens > cfg.max_len:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds max_len "
                f"{cfg.max_len}: decode positions would have no encoding"
            )
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r} (expected 'float32' or "
                "'int8')"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_active = max_active
        self.max_new_tokens = max_new_tokens
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.steps_per_launch = steps_per_launch
        self.sos_id, self.eos_id, self.pad_id = sos_id, eos_id, pad_id
        self.kv_dtype = kv_dtype
        self.quantize_self = bool(quantize_self)
        self._mem_quant = kv_dtype == "int8"
        self._self_quant = self._mem_quant and self.quantize_self

        # Geometry: self pages cover the max_new_tokens budget; memory
        # pages cover the largest chunk-padded prompt; ``num_pages``
        # bounds the MEM store (prompts + prefix cache).
        self.self_pages = -(-max_new_tokens // page_size)
        self.max_chunks = -(-max_src // prefill_chunk)
        self.mem_pages = self.max_chunks * prefill_chunk // page_size
        self.num_self_pages = 1 + max_active * self.self_pages
        if num_pages is None:
            num_pages = (
                1 + (max_active + prefix_cache_size) * self.mem_pages
            )
        elif num_pages < 1 + self.mem_pages:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one full prompt "
                f"({self.mem_pages} pages + the reserved null page)"
            )
        self.num_pages = num_pages

        self._self_shape = (
            cfg.num_layers, 2, self.num_self_pages, page_size, cfg.d_model
        )
        self._mem_shape = (cfg.num_layers, 2, num_pages, page_size, cfg.d_model)
        self._self_store_dtype = torch.int8 if self._self_quant else cfg.dtype
        self._mem_store_dtype = torch.int8 if self._mem_quant else cfg.dtype
        # Per-slot dequantization scales, same block-table addressing as
        # the payload: slot (p, s) dequantizes as pages[p, s] * scale[p, s].
        self._self_scale_shape = (cfg.num_layers, 2, self.num_self_pages, page_size)
        self._mem_scale_shape = (cfg.num_layers, 2, num_pages, page_size)
        self._zero_stores()

        d = cfg.d_model
        self.mem_page_bytes = cfg.num_layers * 2 * page_size * (
            d * self._mem_store_dtype.itemsize + (4 if self._mem_quant else 0)
        )
        self.self_page_bytes = cfg.num_layers * 2 * page_size * (
            d * self._self_store_dtype.itemsize + (4 if self._self_quant else 0)
        )
        self.self_pool = KVPagePool(
            self.num_self_pages, page_bytes=self.self_page_bytes
        )
        self.mem_pool = KVPagePool(num_pages, page_bytes=self.mem_page_bytes)
        self.prefix_cache = PrefixCache(self.mem_pool, prefix_cache_size)
        self.prefix_cache_size = prefix_cache_size
        self._reset_host_state()

    def _zero_stores(self) -> None:
        dev = self.device
        self.kv_self = torch.zeros(self._self_shape, dtype=self._self_store_dtype, device=dev)
        self.kv_mem = torch.zeros(self._mem_shape, dtype=self._mem_store_dtype, device=dev)
        self.self_scale = (
            torch.zeros(self._self_scale_shape, dtype=torch.float32, device=dev)
            if self._self_quant else None
        )
        self.mem_scale = (
            torch.zeros(self._mem_scale_shape, dtype=torch.float32, device=dev)
            if self._mem_quant else None
        )

    def _reset_host_state(self) -> None:
        R, Ps, Pm = self.max_active, self.self_pages, self.mem_pages
        self._self_tbl = np.full((R, Ps), NULL_PAGE, np.int32)
        self._mem_tbl = np.full((R, Pm), NULL_PAGE, np.int32)
        self._mem_len = np.zeros(R, np.int32)
        self._cursor = np.zeros(R, np.int32)
        self._token = np.full(R, self.pad_id, np.int32)
        self._finished = np.ones(R, bool)
        self._self_alloc = np.zeros(R, np.int32)  # self pages held per row
        self._req_of_row = [None] * R
        self._emitted: list[list[int]] = [[] for _ in range(R)]
        self._awaiting_first = np.zeros(R, bool)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- device work ---------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, src: np.ndarray, pages: np.ndarray) -> None:
        """Project one chunk-padded prompt ``src`` ``[1, width]`` and write
        its memory K/V into ``pages`` of the mem store, in place."""
        cfg = self.model.cfg
        width = src.shape[1]
        n_pages = width // self.page_size
        _, k, v = self.model.prefill_paged(self._to_device(src).long())
        kv = torch.stack([k[:, 0], v[:, 0]], dim=1)  # [L, 2, width, d]
        kv = kv.reshape(cfg.num_layers, 2, n_pages, self.page_size, cfg.d_model)
        tbl = self._to_device(pages).long()
        if not self._mem_quant:
            self.kv_mem[:, :, tbl] = kv.to(self.kv_mem.dtype)
            return
        # Per-page absmax: one scale per (layer, k/v, page), broadcast to
        # the page's slots so dequantization addressing is per slot for
        # both stores.
        q, s = _quantize(kv, kv.abs().amax(dim=(3, 4)))  # s: [L, 2, n_pages]
        self.kv_mem[:, :, tbl] = q
        self.mem_scale[:, :, tbl] = s[..., None].expand(-1, -1, -1, self.page_size)

    @torch.no_grad()
    def _decode(self, token, cursor, finished, self_tbl, mem_tbl, mem_len):
        """``steps_per_launch`` greedy steps over every row; updates the
        self store in place and returns ``(token, cursor, finished,
        emits [T, R])`` as device tensors."""
        page, Ps = self.page_size, self.self_pages
        eos, pad, mnt = self.eos_id, self.pad_id, self.max_new_tokens
        emits = []
        for _ in range(self.steps_per_launch):
            logits, k_new, v_new = self.model.decode_step_paged(
                token[:, None].long(), self.kv_self, self.kv_mem,
                self_tbl, cursor, mem_tbl, mem_len, cursor[:, None].long(),
                self.self_scale, self.mem_scale,
            )
            knv = torch.stack([k_new, v_new], dim=1)  # [L, 2, R, d]
            # Scatter at the old cursor; finished rows write the null page
            # (harmless by reservation).
            pidx = torch.clamp(cursor // page, max=Ps - 1).long()
            pids = self_tbl.long().gather(1, pidx[:, None])[:, 0]
            pids = torch.where(finished, NULL_PAGE, pids)
            offs = (cursor % page).long()
            if self._self_quant:
                # Per-slot scales: each step writes one slot per row, so
                # the int8 already on the page keeps its own scales.
                q, s = _quantize(knv, knv.abs().amax(dim=-1))  # s: [L, 2, R]
                self.kv_self[:, :, pids, offs, :] = q
                self.self_scale[:, :, pids, offs] = s
            else:
                self.kv_self[:, :, pids, offs, :] = knv.to(self.kv_self.dtype)
            emit = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
            emit = torch.where(finished, pad, emit)
            cursor = cursor + (~finished).to(torch.int32)
            finished = finished | (emit == eos) | (emit == pad) | (cursor >= mnt)
            token = emit
            emits.append(emit)
        return token, cursor, finished, torch.stack(emits)

    def warmup(self) -> int:
        """Run every prefill width and one launch against the null page
        (no rows active), so the first request pays no kernel build or
        library start-up; then zero the stores. Returns how many distinct
        shapes were run (prefill widths + the launch)."""
        seed = np.array([self.sos_id, self.eos_id], np.int32)
        for c in range(1, self.max_chunks + 1):
            width = c * self.prefill_chunk
            src = np.full((1, width), self.pad_id, np.int32)
            src[0, : len(seed)] = seed
            self._prefill(src, np.full(width // self.page_size, NULL_PAGE, np.int32))
        self._launch_device()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._zero_stores()
        return self.max_chunks + 1

    # -- admission -----------------------------------------------------------
    def _acquire_mem_pages(self, n: int, owner) -> list[int] | None:
        pages = self.mem_pool.try_acquire(n, owner)
        if pages is None:
            # Pressure valve: cached prefixes are a luxury, live requests
            # are not.
            self.prefix_cache.evict_until_free(n)
            pages = self.mem_pool.try_acquire(n, owner)
        return pages

    def admit(self, req, row: int):
        """Place ``req`` on ``row``: attach (cache hit) or prefill (miss)
        its memory pages, allocate its first self page, and arm the row
        for decode. Returns ``(kind, padded_width, real_len)`` with kind
        in {"hit", "miss"} — a hit computes nothing, so its width is 0 —
        or None if the page pool cannot hold the request right now (the
        caller requeues; no references are leaked, and a miss's finished
        prefill survives in the cache for the retry)."""
        ids = list(req.ids)
        key = tuple(ids)
        width = _round_up(max(len(ids), 1), self.prefill_chunk)
        n_mem = width // self.page_size
        entry = self.prefix_cache.get(key, owner=req.id)
        if entry is None:
            pages = self._acquire_mem_pages(n_mem, req.id)
            if pages is None:
                return None
            src = np.full((1, width), self.pad_id, np.int32)
            src[0, : len(ids)] = ids
            self._prefill(src, np.asarray(pages, np.int32))
            self.prefix_cache.put(key, pages, n_pages=n_mem, src_len=len(ids))
            kind, computed = "miss", width
        else:
            pages = entry["pages"]
            kind, computed = "hit", 0
        first = self.self_pool.try_acquire(1, req.id)
        if first is None:
            # Drop this request's references; a miss's pages stay alive
            # under the cache's own reference — the work is not lost.
            self.mem_pool.release_owner(req.id)
            return None
        self._req_of_row[row] = req
        self._emitted[row] = []
        self._awaiting_first[row] = True
        self._self_tbl[row, :] = NULL_PAGE
        self._self_tbl[row, 0] = first[0]
        self._self_alloc[row] = 1
        self._mem_tbl[row, :] = NULL_PAGE
        self._mem_tbl[row, : len(pages)] = pages
        self._mem_len[row] = len(ids)
        self._cursor[row] = 0
        self._token[row] = self.sos_id
        self._finished[row] = False
        return kind, computed, len(ids)

    def grow(self) -> list[int]:
        """Lazy self-page growth: before a launch, extend every active
        row's block table to cover the cursors the next
        ``steps_per_launch`` steps can reach. The self pool is sized at
        worst case, so starvation is impossible by construction; the
        starved-row return stays as the engine's defensive contract (it
        must fail such rows before launching, or their writes would land
        on the null page and corrupt reads of it)."""
        starved = []
        for r in range(self.max_active):
            req = self._req_of_row[r]
            if req is None or self._finished[r]:
                continue
            last = min(
                int(self._cursor[r]) + self.steps_per_launch - 1,
                self.max_new_tokens - 1,
            )
            need = last // self.page_size + 1
            have = int(self._self_alloc[r])
            if need <= have:
                continue
            got = self.self_pool.try_acquire(need - have, req.id)
            if got is None:
                starved.append(r)
                continue
            self._self_tbl[r, have:need] = got
            self._self_alloc[r] = need
        return starved

    # -- decode --------------------------------------------------------------
    def any_active(self) -> bool:
        return any(r is not None for r in self._req_of_row)

    def active_count(self) -> int:
        return sum(r is not None for r in self._req_of_row)

    def _launch_device(self) -> np.ndarray:
        """One launch over the current host state: tables to the device
        once, the decode loop, then one synchronising copy back."""
        token, cursor, finished, emits = self._decode(
            self._to_device(self._token), self._to_device(self._cursor),
            self._to_device(self._finished), self._to_device(self._self_tbl),
            self._to_device(self._mem_tbl), self._to_device(self._mem_len),
        )
        out = torch.cat([emits, token[None], cursor[None], finished[None].int()]).cpu().numpy()
        T = self.steps_per_launch
        self._token = out[T].astype(np.int32)
        self._cursor = out[T + 1].astype(np.int32)
        self._finished = out[T + 2].astype(bool)
        return out[:T]

    def launch(self) -> LaunchResult:
        """Run one multi-step decode over every row and fold the emitted
        tokens into per-row transcripts."""
        emits = self._launch_device()
        completed, first_emits, real = [], [], 0
        for r in range(self.max_active):
            req = self._req_of_row[r]
            if req is None:
                continue
            saw_eos = False
            for e in emits[:, r]:
                e = int(e)
                if e == self.pad_id:
                    break
                if self._awaiting_first[r]:
                    self._awaiting_first[r] = False
                    first_emits.append(req)
                real += 1
                if e == self.eos_id:
                    saw_eos = True
                    break
                self._emitted[r].append(e)
            if self._finished[r]:
                completed.append((req, self._emitted[r], r, saw_eos))
        return LaunchResult(
            completed=completed,
            first_emits=first_emits,
            real_tokens=real,
            computed_slots=self.max_active * self.steps_per_launch,
            steps=self.steps_per_launch,
            n_active=self.active_count(),
        )

    # -- retirement / containment -------------------------------------------
    def retire(self, row: int):
        """Free a finished (or failed) row: drop every page reference the
        request holds — its self pages free now, shared prefix pages only
        once the cache and other holders let go. Returns the request."""
        req = self._req_of_row[row]
        if req is None:
            return None
        self._req_of_row[row] = None
        self._emitted[row] = []
        self._awaiting_first[row] = False
        self._finished[row] = True
        self._token[row] = self.pad_id
        self._cursor[row] = 0
        self._self_tbl[row, :] = NULL_PAGE
        self._mem_tbl[row, :] = NULL_PAGE
        self._mem_len[row] = 0
        self._self_alloc[row] = 0
        self.self_pool.release_owner(req.id)
        self.mem_pool.release_owner(req.id)
        return req

    def active_requests(self) -> list:
        return [r for r in self._req_of_row if r is not None]

    def active_rows(self) -> list:
        """``(row, request)`` pairs for every occupied row — the engine's
        between-launch deadline sweep walks this to :meth:`retire` expired
        rows without reaching into private row state."""
        return [
            (row, req)
            for row, req in enumerate(self._req_of_row)
            if req is not None
        ]

    def reset(self) -> list:
        """Quarantine path: the store's contents are suspect, so drop
        everything — returns the requests that were active (the caller
        fails them)."""
        active = self.active_requests()
        self.self_pool = KVPagePool(
            self.num_self_pages, page_bytes=self.self_page_bytes
        )
        self.mem_pool = KVPagePool(
            self.num_pages, page_bytes=self.mem_page_bytes
        )
        self.prefix_cache = PrefixCache(self.mem_pool, self.prefix_cache_size)
        self._reset_host_state()
        self._zero_stores()
        return active

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "num_self_pages": self.num_self_pages,
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "quantize_self": self.quantize_self,
            "mem_page_bytes": self.mem_page_bytes,
            "self_page_bytes": self.self_page_bytes,
            "mem_pages_in_use": self.mem_pool.in_use,
            "self_pages_in_use": self.self_pool.in_use,
            "mem_occupancy": round(self.mem_pool.occupancy, 4),
            "self_occupancy": round(self.self_pool.occupancy, 4),
            "mem_high_water": self.mem_pool.high_water,
            "self_high_water": self.self_pool.high_water,
            "mem_bytes_in_use": self.mem_pool.bytes_in_use,
            "self_bytes_in_use": self.self_pool.bytes_in_use,
            "mem_bytes_high_water": self.mem_pool.bytes_high_water,
            "self_bytes_high_water": self.self_pool.bytes_high_water,
            "mem_bytes_capacity": self.mem_pool.bytes_capacity,
            "self_bytes_capacity": self.self_pool.bytes_capacity,
            "prefix_cache": self.prefix_cache.stats(),
            "active_rows": self.active_count(),
        }
