#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — a CUDA card must be present; prints its name, the device
   count and ``nvidia-smi``'s name and power limit;
2. build — builds every kernel of the path from ``csrc/`` (``nvcc``, in
   parallel) and prints the build time and ``ptxas`` report;
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card, at the serving slice's shapes and at edge cases (max abs
   error against the fp32 tolerance, 1e-4: the summation order differs);
4. serving — the reference MT model at full width (d_model 512, ffn 1024,
   8 heads of 64, 1 layer, max_len 200, ~8,000-word vocabularies, random
   weights from a seed in the JAX package's Flax layout, through the
   weight bridge) served by ``Translator.serve`` (paged, greedy): 64
   concurrent requests, some repeated, once with fp32 pages and once with
   int8 pages. Checks that every request completes, that the pools drain,
   that both kernels ran on this path, and the token agreement of the fp32
   engine with the one-shot greedy decoder on the CPU (plain versions)
   and of the int8 engine with the fp32 engine (each >= 0.99);
5. times — requests/s, generated tokens/s, peak device memory, and each
   kernel's time (CUDA events) beside its bound, its plain version's time
   and one library call's.

The line before the last is ``nvidia-smi``'s name and power limit; before
it, one JSON line with every kernel's numbers. The last line is
``{"ok": true, "device": {...}}``. Without a card it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4  # fp32, kernel vs plain: the two sum in different orders
AGREEMENT_MIN = 0.99
SEED = 0

# The reference MT model (models/transformer.py defaults; the MT driver's
# d_model 512, ffn 1024, 8 heads, 1 layer, max_len 200), dropout off.
MODEL = dict(
    d_model=512, ffn_hidden=1024, num_heads=8, num_layers=1, max_len=200,
    dropout=0.0,
)
VOCAB_WORDS = 8000
SERVE = dict(
    kv_mode="paged", max_active=32, page_size=16, boundaries=(32, 64),
    max_new_tokens=64,
)
N_REQUESTS = 64
N_UNIQUE = 48  # the rest repeat earlier prompts, so the prefix cache hits

REPLACES = {
    "flash_attention_fwd": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:40",
    "ragged_paged_attention": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:638",
}
SOURCES = {
    "flash_attention_fwd": "machine_learning_apache_spark_tpu_torch/csrc/flash_attention_fwd.cu",
    "ragged_paged_attention": "machine_learning_apache_spark_tpu_torch/csrc/ragged_paged_attention.cu",
}

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM rate, and the
# fp32 rate outside the tensor cores, which is what both kernels use.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- phase 1: device ------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernels vs plain -------------------------------------------------


def _flash_case(torch, rng, b, h, sq, sk, d, *, causal, valid_frac, dev,
                strided=False, empty_batch=None):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    if strided:
        # Head-split views of a fused [B, S, H*d] projection, as the
        # model passes them: non-contiguous, head dim stride 1.
        q = t(b, sq, 3 * h * d)[..., : h * d].view(b, sq, h, d).transpose(1, 2)
        kv = t(b, sk, 2 * h * d)
        k = kv[..., : h * d].view(b, sk, h, d).transpose(1, 2)
        v = kv[..., h * d:].view(b, sk, h, d).transpose(1, 2)
    else:
        q, k, v = t(b, h, sq, d), t(b, h, sk, d), t(b, h, sk, d)
    kv_valid = None
    if valid_frac is not None:
        valid = rng.random((b, sk)) < valid_frac
        valid[:, 0] = True
        if empty_batch is not None:
            valid[empty_batch] = False  # rows of this batch see no key
        kv_valid = torch.from_numpy(valid).to(dev)
    return q, k, v, kv_valid


def check_kernels(torch, hop, dev) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest error per kernel."""
    rng = np.random.default_rng(SEED)
    errs = {}
    flash_cases = [
        ("prefill encoder 1x8x64x64, kv_valid", dict(b=1, h=8, sq=64, sk=64, d=64, causal=False, valid_frac=0.6)),
        ("prefill cross 1x64, kv_valid", dict(b=1, h=8, sq=1, sk=64, d=64, causal=False, valid_frac=0.6)),
        ("causal Sq!=Sk 24x70, kv_valid, strided", dict(b=2, h=8, sq=24, sk=70, d=64, causal=True, valid_frac=0.8, strided=True)),
        ("causal Sq>Sk 40x30 (rows see nothing)", dict(b=2, h=4, sq=40, sk=30, d=64, causal=True, valid_frac=None)),
        ("fully masked batch, Sk=45 not a tile multiple", dict(b=3, h=2, sq=17, sk=45, d=128, causal=False, valid_frac=0.5, empty_batch=1)),
        ("d=40, no mask", dict(b=2, h=3, sq=33, sk=65, d=40, causal=False, valid_frac=None)),
        ("greedy decode 64x65x8, causal+kv_valid", dict(b=64, h=8, sq=65, sk=65, d=64, causal=True, valid_frac=0.9, strided=True)),
    ]
    worst = 0.0
    for label, kw in flash_cases:
        causal = kw.pop("causal")
        q, k, v, kv_valid = _flash_case(torch, rng, causal=causal, dev=dev, **kw)
        got = hop.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        want = hop.flash_attention_plain(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        nan = bool(torch.isnan(got).any().item())
        log(f"  flash_attention_fwd  {label:48s} max_abs_err {err:.3e} (tol {TOL:.0e})")
        if nan or not err <= TOL:
            fail(f"flash_attention_fwd disagrees with its plain version on {label}")
        if kw.get("empty_batch") is not None:
            if got[kw["empty_batch"]].abs().max().item() != 0.0:
                fail("flash_attention_fwd: rows that see no key must be zeros")
        worst = max(worst, err)
    errs["flash_attention_fwd"] = worst

    worst = 0.0
    R, H, dh, page, P = 32, 8, 64, 16, 4
    D = H * dh
    num_pages = 1 + R * P
    lengths = rng.integers(1, P * page + 1, R).astype(np.int32)
    lengths[:6] = [0, 1, 15, 16, 17, P * page]
    table = np.zeros((R, P), np.int32)
    nxt = 1
    for r in range(R - 1):
        used = -(-int(lengths[r]) // page)
        table[r, :used] = np.arange(nxt, nxt + used)
        nxt += used
    # The last row shares the previous row's pages (a prefix-cache hit):
    # same pages, same length, same query → identical output.
    table[R - 1], lengths[R - 1] = table[R - 2], lengths[R - 2]
    query = rng.standard_normal((R, H, dh)).astype(np.float32)
    query[R - 1] = query[R - 2]

    def to(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    pages_f32 = [to(rng.standard_normal((num_pages, page, D)).astype(np.float32)) for _ in range(2)]
    pages_i8 = [to(rng.integers(-127, 128, (num_pages, page, D)).astype(np.int8)) for _ in range(2)]
    scales = [to((rng.random((num_pages, page)) * 0.02 + 1e-3).astype(np.float32)) for _ in range(2)]
    qkv = to(rng.standard_normal((R, 3 * D)).astype(np.float32))
    q_rows = qkv[:, :D].reshape(R, H, dh)  # strided rows, as the model passes them
    cur_k, cur_v = qkv[:, D:2 * D], qkv[:, 2 * D:]
    tbl, lens = to(table), to(lengths)
    for store in ("float32", "int8"):
        kp, vp = pages_f32 if store == "float32" else pages_i8
        ks, vs = (None, None) if store == "float32" else scales
        for with_cur in (False, True):
            for qname, qq in (("contiguous q", to(query)), ("strided q", q_rows)):
                ck, cv = (cur_k, cur_v) if with_cur else (None, None)
                kw = dict(k_scale=ks, v_scale=vs, cur_k=ck, cur_v=cv)
                got = hop.ragged_paged_attention(qq, kp, vp, tbl, lens, **kw)
                want = hop.ragged_paged_attention_plain(qq, kp, vp, tbl, lens, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                label = f"{store} pages, cur={with_cur}, {qname}"
                log(f"  ragged_paged_attention {label:46s} max_abs_err {err:.3e} (tol {TOL:.0e})")
                if not err <= TOL:
                    fail(f"ragged_paged_attention disagrees with its plain version ({label})")
                if not with_cur and got[0].abs().max().item() != 0.0:
                    fail("ragged_paged_attention: a length-0 row without cur must be zeros")
                # (with cur the two rows' own K/V differ, so only without)
                if not with_cur and qname == "contiguous q" and not torch.equal(got[R - 1], got[R - 2]):
                    fail("ragged_paged_attention: rows sharing prefix pages differ")
                worst = max(worst, err)
    errs["ragged_paged_attention"] = worst
    return errs


# -- phase 4: serving -----------------------------------------------------------


def make_vocab_texts(prefix: str) -> tuple[list[str], list[str]]:
    words = [f"{prefix}{i:04d}" for i in range(VOCAB_WORDS)]
    corpus = [" ".join(words[i:i + 50]) for i in range(0, VOCAB_WORDS, 50)]
    return words, corpus


def make_prompts(words: list[str]) -> list[str]:
    rng = np.random.default_rng(SEED + 1)
    unique = [
        " ".join(rng.choice(words, size=int(n)))
        for n in rng.integers(3, 61, N_UNIQUE)
    ]
    repeats = [unique[int(i)] for i in rng.integers(0, N_UNIQUE, N_REQUESTS - N_UNIQUE)]
    prompts = unique + repeats
    order = rng.permutation(len(prompts))
    return [prompts[int(i)] for i in order]


def build_translator(device, params, src_pipe, trg_pipe):
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos),
        trg_vocab_size=len(trg_pipe.vocab.itos),
        **MODEL,
    )
    model = load_flax_params(Transformer(cfg), params)
    return Translator(model, src_pipe, trg_pipe, device=device)


def model_params(src_pipe, trg_pipe):
    """Random weights from the seed, in the Flax tree layout."""
    from machine_learning_apache_spark_tpu_torch.data.text import PAD_ID
    from machine_learning_apache_spark_tpu_torch.models import TransformerConfig
    from machine_learning_apache_spark_tpu_torch.weights import random_flax_params

    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos),
        trg_vocab_size=len(trg_pipe.vocab.itos),
        **MODEL,
    )
    params = random_flax_params(cfg, SEED)
    # A trained model never emits <pad>; an untrained one would, at random,
    # and the paged engine ends a row on an emitted pad where the one-shot
    # decoder carries on. Pushing the pad logit down keeps the comparison
    # about the kernels, not about that rule.
    params["lm_head"]["bias"][PAD_ID] = -30.0
    return params


def agreement(a: list[str], b: list[str]) -> tuple[float, list[str]]:
    """Share of generated token positions that agree, and the mismatches."""
    same = total = 0
    notes = []
    for i, (x, y) in enumerate(zip(a, b)):
        xs, ys = x.split(), y.split()
        n = max(len(xs), len(ys))
        s = sum(1 for p, q in zip(xs, ys) if p == q)
        same += s
        total += n
        if s != n:
            first = next((j for j, (p, q) in enumerate(zip(xs, ys)) if p != q), min(len(xs), len(ys)))
            notes.append(f"request {i}: {n - s} of {n} positions differ, first at {first}")
    return (same / total if total else 1.0), notes


def serve_once(torch, hop, translator, prompts, kv_dtype: str) -> dict:
    """One engine over all prompts; returns outputs, counts and times."""
    eng = translator.serve(kv_dtype=kv_dtype, **SERVE)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hop.reset_launches()
        t0 = time.perf_counter()
        futs = [eng.submit(p) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hop.LAUNCHES)
        stats = eng.runtime.stats()
        metrics = eng.metrics.summary()
        eng.metrics.check_conservation(in_flight=0)
        peak = torch.cuda.max_memory_allocated()
    finally:
        eng.stop()
    if metrics["completed"] != len(prompts):
        fail(f"{kv_dtype} engine completed {metrics['completed']} of {len(prompts)}")
    if stats["active_rows"] != 0 or stats["self_pages_in_use"] != 0:
        fail(f"{kv_dtype} engine pools not back at baseline: {stats}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{kv_dtype} engine never launched {name}")
    return dict(
        outs=outs, wall=wall, launches=launches, stats=stats,
        tokens=metrics["tokens_out"], peak=peak,
        hits=stats["prefix_cache"]["hits"],
    )


# -- phase 5: times ---------------------------------------------------------------


def cuda_time_ms(torch, fn, n: int = 200, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_us(evt) -> float:
    """Self device time of one profiler row, in microseconds."""
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0.0))


def profile_device(torch, fn) -> list:
    """``fn()`` under ``torch.profiler`` with device activity only (no
    host-op recording, so little added host cost); returns ``(name,
    calls, device_us)`` rows, busiest first. Empty when the profiler saw
    no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    return sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])


def device_ms_per_call(torch, fn, n: int = 50) -> float | None:
    """Device time of one call (all its kernels), from the profiler; None
    when the profiler saw no device work."""
    fn()

    def many():
        for _ in range(n):
            fn()

    rows = profile_device(torch, many)
    return sum(r[2] for r in rows) / 1e3 / n if rows else None


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, hop, dev, prompt_lens: list[int]) -> dict:
    """Each kernel at the serving slice's shape: kernel, plain version,
    one library call, and the bound."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 2)
    out = {}
    # Flash: the prefill encoder self-attention of one 64-token prompt
    # (the largest chunk width), 8 heads of 64, with its kv_valid. q, k, v
    # are head-split views of one fused qkv projection, as the model
    # passes them (stride 3*h*d between positions).
    b, h, s, d = 1, 8, 64, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).to(dev)
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    valid = torch.from_numpy(np.arange(s)[None, :] < 45).to(dev)
    mask = valid[:, None, None, :]
    n_valid = int(valid.sum().item())
    t_kernel = cuda_time_ms(torch, lambda: hop.flash_attention(q, k, v, kv_valid=valid))
    t_plain = cuda_time_ms(torch, lambda: hop.flash_attention_plain(q, k, v, kv_valid=valid))
    t_lib = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    dev_ms = {
        "kernel": device_ms_per_call(torch, lambda: hop.flash_attention(q, k, v, kv_valid=valid)),
        "plain": device_ms_per_call(torch, lambda: hop.flash_attention_plain(q, k, v, kv_valid=valid)),
        "library": device_ms_per_call(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
    }
    # q read and out written for every row; K and V only for the valid
    # keys (masked keys do not touch the output); kv_valid read once.
    nbytes = 4 * b * h * d * (2 * s + 2 * n_valid) + b * s
    flops = 4.0 * b * h * s * n_valid * d  # QK^T and PV over the valid keys
    bnd, by = bound_ms(nbytes, flops)
    out["flash_attention_fwd"] = dict(
        ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bnd, bound_by=by,
        device_ms=dev_ms,
        shape=f"q,k,v [{b},{h},{s},{d}] fp32 views of a fused qkv, kv_valid {n_valid}/{s}",
    )

    # Ragged: the decode cross-attention of a full batch: 32 rows over the
    # fp32 memory store, lengths = the prompts' token counts, page 16.
    R, H, dh, page = SERVE["max_active"], 8, 64, SERVE["page_size"]
    P = SERVE["boundaries"][-1] // page
    D = H * dh
    lens_np = np.asarray(prompt_lens[:R], np.int32)
    num_pages = 1 + 2 * R * P
    table_np = np.zeros((R, P), np.int32)
    pid = 1
    for r in range(R):
        used = -(-int(lens_np[r]) // page)
        table_np[r, :used] = np.arange(pid, pid + used)
        pid += used
    kp, vp = (torch.from_numpy(rng.standard_normal((num_pages, page, D)).astype(np.float32)).to(dev) for _ in range(2))
    query = torch.from_numpy(rng.standard_normal((R, H, dh)).astype(np.float32)).to(dev)
    tbl, lens = torch.from_numpy(table_np).to(dev), torch.from_numpy(lens_np).to(dev)
    t_kernel = cuda_time_ms(torch, lambda: hop.ragged_paged_attention(query, kp, vp, tbl, lens))
    t_plain = cuda_time_ms(torch, lambda: hop.ragged_paged_attention_plain(query, kp, vp, tbl, lens))
    tbl_long = tbl.long()
    key_mask = (torch.arange(P * page, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def library():
        kk = kp[tbl_long].reshape(R, P * page, H, dh).transpose(1, 2)
        vv = vp[tbl_long].reshape(R, P * page, H, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(query[:, :, None, :], kk, vv, attn_mask=key_mask)

    t_lib = cuda_time_ms(torch, library)
    dev_ms = {
        "kernel": device_ms_per_call(torch, lambda: hop.ragged_paged_attention(query, kp, vp, tbl, lens)),
        "plain": device_ms_per_call(torch, lambda: hop.ragged_paged_attention_plain(query, kp, vp, tbl, lens)),
        "library": device_ms_per_call(torch, library),
    }
    n_pos = int(lens_np.sum())
    n_pages_read = int(sum(-(-int(x) // page) for x in lens_np))
    nbytes = (4 * R * D * 2  # query read, out written
              + 2 * 4 * n_pos * D  # K and V of every cached position
              + 4 * n_pages_read + 4 * R)  # table entries walked, lengths
    flops = 4.0 * n_pos * D
    bnd, by = bound_ms(nbytes, flops)
    out["ragged_paged_attention"] = dict(
        ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bnd, bound_by=by,
        device_ms=dev_ms,
        shape=f"{R} rows x {H} heads x {dh}, fp32 pages of {page}, {n_pos} cached positions",
    )
    return out


# -- main -----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    log("== phase 1: device")
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; device {kind}; count {count}")
    log(f"  nvidia-smi: {card}")
    log(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    log("== phase 2: build")
    t0 = time.perf_counter()
    built = LIBRARY.kernels()
    log(f"  built {len(built)} kernels in {time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for name, kb in built.items():
        log(f"  {name}: nvcc {kb.seconds:.2f} s -> {kb.library}")
        for line in kb.compiler_output.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")

    log("== phase 3: kernels vs plain (on the card)")
    errs = check_kernels(torch, hop, dev)

    log("== phase 4: serving slice at full width")
    src_words, src_corpus = make_vocab_texts("s")
    trg_words, trg_corpus = make_vocab_texts("t")
    src_pipe = TextPipeline.fit(src_corpus, max_seq_len=SERVE["boundaries"][-1] - 1)
    trg_pipe = TextPipeline.fit(trg_corpus, max_seq_len=SERVE["boundaries"][-1] - 1)
    prompts = make_prompts(src_words)
    prompt_lens = [len(src_pipe.ragged([p])[0]) for p in prompts]
    log(f"  vocab {len(src_pipe.vocab.itos)} / {len(trg_pipe.vocab.itos)}; "
        f"{len(prompts)} prompts ({len(set(prompts))} distinct), "
        f"{min(prompt_lens)}-{max(prompt_lens)} ids; model {MODEL}")
    params = model_params(src_pipe, trg_pipe)
    translator = build_translator(None, params, src_pipe, trg_pipe)
    runs = {kv: serve_once(torch, hop, translator, prompts, kv) for kv in ("float32", "int8")}
    for kv, run in runs.items():
        log(f"  {kv:7s} engine: {len(prompts)} completed in {run['wall']:.3f} s, "
            f"prefix-cache hits {run['hits']}, launches {run['launches']}, "
            f"pools {{active_rows: {run['stats']['active_rows']}, "
            f"self_pages_in_use: {run['stats']['self_pages_in_use']}}}")

    t0 = time.perf_counter()
    oracle = build_translator("cpu", params, src_pipe, trg_pipe)(
        prompts, max_new_tokens=SERVE["max_new_tokens"]
    )
    log(f"  one-shot greedy on the CPU (plain versions): {time.perf_counter() - t0:.1f} s")
    checks = [
        ("fp32 engine vs one-shot greedy on the CPU", runs["float32"]["outs"], oracle),
        ("int8 engine vs fp32 engine", runs["int8"]["outs"], runs["float32"]["outs"]),
    ]
    for label, got, want in checks:
        share, notes = agreement(got, want)
        log(f"  token agreement, {label}: {share:.6f} (gate >= {AGREEMENT_MIN})")
        for n in notes:
            log(f"    mismatch: {n}")
        if share < AGREEMENT_MIN:
            fail(f"token agreement {share:.4f} < {AGREEMENT_MIN} ({label})")
    n_tokens = sum(len(o.split()) for o in runs["float32"]["outs"])
    if n_tokens == 0:
        fail("the engine generated no tokens")

    log("== phase 5: times")
    for kv, run in runs.items():
        log(f"  {kv:7s} engine: {len(prompts) / run['wall']:.2f} requests/s, "
            f"{run['tokens'] / run['wall']:.1f} generated tokens/s "
            f"({run['tokens']} tokens), peak max_memory_allocated "
            f"{run['peak'] / 2**20:.1f} MiB [{card}]")
    # Where a serving run's time goes: the fp32 engine once more, with the
    # profiler recording device activity. Busy time and wall time come
    # from one window, submit to drain, timed inside the profiler so that
    # its start and stop stay outside.
    eng = translator.serve(kv_dtype="float32", **SERVE)
    window = {}

    def serve_all():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in [eng.submit(p) for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        window["wall"] = time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        rows = profile_device(torch, serve_all)
        outer = time.perf_counter() - t0
    finally:
        eng.stop()
    if rows:
        busy, wall = sum(r[2] for r in rows) / 1e6, window["wall"]
        log(f"  profiled fp32 serving run: submit-to-drain wall {wall:.4f} s, device busy "
            f"{busy:.4f} s, device idle share {1 - busy / wall:.4f} (one window; "
            f"profiler start and stop outside it, {outer - wall:.4f} s) [{card}]")
        for name, calls, us in rows[:10]:
            log(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {name[:90]}")
    else:
        log("  profiled fp32 serving run: device time not measured (the profiler saw no device work)")
    times = time_kernels(torch, hop, dev, prompt_lens)
    kernels = []
    for name, t in times.items():
        log(f"  {name}: {t['shape']}: kernel {t['ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} ms [{card}]")
        dm = {k: ("not measured" if v is None else f"{v:.5f} ms") for k, v in t["device_ms"].items()}
        log(f"    device time per call (profiler): kernel {dm['kernel']}, plain {dm['plain']}, "
            f"library {dm['library']}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(run["launches"][name] for run in runs.values()),
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
