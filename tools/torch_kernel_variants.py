#!/usr/bin/env python3
"""Where an attention kernel's time goes, on one CUDA card.

    python3 tools/torch_kernel_variants.py

Builds patched copies of the port's kernel sources
(``machine_learning_apache_spark_tpu_torch/csrc``) into
``build/kernel_variants/<variant>/`` and times each, through the port's own
launch parameters, with the profiler's device time per call: the forward
at the serving prefill (``[1, 8, 64, 64]`` views of a fused qkv, 45/64
keys valid) and at the MT encoder training site (``[32, 8, 200, 64]``,
fixture batch 0, with ``lse``), dK/dV and dQ at that site, and the ragged
decode at its cross-attention site (fp32 pages) and its self-attention
site (int8 pages, with cur). The variants take one piece of work out at a
time:

- ``base``: the sources as they are;
- ``1pass``: one TF32 product instead of three (wrong digits: timing only);
- ``chain``: every pass accumulated into one fragment (no fresh fragment);
- ``fastexp``: ``__expf`` for ``expf``;
- ``noS``: no S (S^T, dP^T) products in the forward and dK/dV;
- ``noPV``: no P·V (dV, dK) products in the forward and dK/dV;
- ``noloop``: no tile math in the forward and dK/dV (the start, loads and
  writes only);
- ``dq_noloop``: no key-tile math in dQ; ``dq_nodP``: no dP product in dQ;
- ``rg_noPV``: no P·V walk in the ragged kernel;
- ``rg_nostage``: the ragged kernel's ``cp.async`` copies made plain
  loads and stores (nothing in flight while the warp waits);
- ``rg_1warp``: the ragged kernel as built, launched with one warp per
  (row, head), no splits (its first design's grid).

A variant's results are wrong by design; only its time is read. Each
variant's entry points are called directly, with the arguments the
wrappers in ``ops/hopper_attention.py`` pass. A patch that no longer
matches its source stops the run and names it. Needs a card and ``nvcc``,
like ``chip_smoke.py``, whose helpers it uses.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

THREE = "  mma_tf32(p, a.lo, b.hi);\n  mma_tf32(p, a.hi, b.lo);\n  mma_tf32(p, a.hi, b.hi);\n"
FRESH = ("  float p[4] = {0.f, 0.f, 0.f, 0.f};\n" + THREE
         + "#pragma unroll\n  for (int i = 0; i < 4; ++i) c[i] += p[i];\n")
# The ragged kernel's cp.async copies as plain loads and stores.
PLAIN_COPIES = (
    "__device__ __forceinline__ void plain_copy16(void* dst, const void* src, bool in) {\n"
    "  *static_cast<int4*>(dst) = in ? *static_cast<const int4*>(src) : make_int4(0, 0, 0, 0);\n}\n"
    "__device__ __forceinline__ void plain_copy4(void* dst, const void* src, bool in) {\n"
    "  *static_cast<int*>(dst) = in ? *static_cast<const int*>(src) : 0;\n}\n"
)
# variant -> {source file: [(old, new), ...]} (every occurrence of old)
VARIANTS = {
    "base": {},
    "1pass": {"hopper_mma.cuh": [(THREE, "  mma_tf32(p, a.hi, b.hi);\n")]},
    "chain": {"hopper_mma.cuh": [(FRESH, THREE.replace("(p,", "(c,"))]},
    "fastexp": {"flash_attention_fwd.cu": [("expf(", "__expf(")],
                "flash_attention_bwd.cu": [("expf(st", "__expf(st")]},
    "noS": {"flash_attention_fwd.cu": [("hopper::mma_3xtf32(s_acc[n], qf[s]",
                                        "if (kd < 0) hopper::mma_3xtf32(s_acc[n], qf[s]")],
            "flash_attention_bwd.cu": [("hopper::mma_3xtf32(st[n], ka", "if (kd < 0) hopper::mma_3xtf32(st[n], ka"),
                                       ("hopper::mma_3xtf32(dpt[n], va", "if (kd < 0) hopper::mma_3xtf32(dpt[n], va")]},
    "noPV": {"flash_attention_fwd.cu": [("hopper::mma_3xtf32(o[n], pa,", "if (kd < 0) hopper::mma_3xtf32(o[n], pa,")],
             "flash_attention_bwd.cu": [("hopper::mma_3xtf32(dv_acc[n], pa,", "if (kd < 0) hopper::mma_3xtf32(dv_acc[n], pa,"),
                                        ("hopper::mma_3xtf32(dk_acc[n], sa,", "if (kd < 0) hopper::mma_3xtf32(dk_acc[n], sa,")]},
    "noloop": {"flash_attention_fwd.cu": [("step < n_steps; ++step) {", "step < n_steps && kd < 0; ++step) {")],
               "flash_attention_bwd.cu": [("    if (work) {", "    if (work && kd < 0) {")]},
    "dq_noloop": {"flash_attention_bwd.cu": [("    if (dq_work) {", "    if (dq_work && kd < 0) {")]},
    "dq_nodP": {"flash_attention_bwd.cu": [("hopper::mma_3xtf32(dp_acc[n], da,",
                                            "if (kd < 0) hopper::mma_3xtf32(dp_acc[n], da,")]},
    "rg_noPV": {"ragged_paged_attention.cu": [("for (int j = 0; j < n; j += 2) {", "for (int j = 0; j < 0; j += 2) {")]},
    "rg_nostage": {"ragged_paged_attention.cu": [
        ("__device__ __forceinline__ void cp_async8(", PLAIN_COPIES + "__device__ __forceinline__ void cp_async8("),
        ('asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\\n" ::"r"(d), "l"(src), "r"(in ? 8 : 0) : "memory");',
         "(void)d; *static_cast<int2*>(dst) = in ? *static_cast<const int2*>(src) : make_int2(0, 0);"),
        ("hopper::cp_async16(", "plain_copy16("),
        ("hopper::cp_async4(", "plain_copy4("),
    ]},
    "rg_1warp": {},
}
# Launch overrides: variant -> entry point -> wrapper keyword arguments.
LAUNCH = {"rg_1warp": {"ragged_paged_attention": dict(splits=1)}}
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "ragged_paged_attention")


def build(out_dir: Path) -> dict:
    """Each variant's patched sources (only the ones it patches; the rest
    come from ``base``), built in parallel; returns its loaded entry
    points per variant."""
    from machine_learning_apache_spark_tpu_torch.ops import cuda_build as cb

    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, patches in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True)
        for src in cb.CSRC_DIR.iterdir():
            if src.suffix not in (".cu", ".cuh"):
                continue
            text = src.read_text()
            for old, new in patches.get(src.name, []):
                if old not in text:
                    raise SystemExit(f"{name}: {src.name} no longer holds {old!r}")
                text = text.replace(old, new)
            (d / src.name).write_text(text)
        for stem in _stems(name):
            cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, "-o", str(d / f"{stem}.so"), str(d / f"{stem}.cu")]
            procs[name, stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{key}: {out}")
    if failed:
        raise SystemExit("nvcc failed:\n" + "\n".join(failed))
    libs = {}
    for name in VARIANTS:
        fns = {}
        for entry, (stem, fn_name, argtypes) in cb.ENTRY_POINTS.items():
            built = name if stem in _stems(name) else "base"
            fn = getattr(ctypes.CDLL(str(out_dir / built / f"{stem}.so")), fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[entry] = fn
        libs[name] = fns
    return libs


def _stems(variant: str) -> list[str]:
    """The sources a variant builds: all for ``base`` and for a patch of
    the shared header, else the ones it patches."""
    patched = VARIANTS[variant]
    if variant == "base" or any(f.endswith(".cuh") for f in patched):
        return list(SOURCES)
    return [f[:-3] for f in patched]


def _strides(*tensors) -> list[int]:
    return [st for t in tensors for st in t.stride()[:3]]


def prompt_lengths(cs) -> list[int]:
    """The token counts of the smoke's serving prompts (its vocabulary and
    prompt generator, from its seed)."""
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline

    words, corpus = cs.make_vocab_texts("s")
    pipe = TextPipeline.fit(corpus, max_seq_len=cs.SERVE["boundaries"][-1] - 1)
    return [len(pipe.ragged([p])[0]) for p in cs.make_prompts(words)]


def launch_fwd(torch, hop, fn, q, k, v, valid, with_lse: bool):
    """The flash forward wrapper's launch (non-causal), on ``fn``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    warps, splits, d_pad = hop.flash_fwd_launch_params(b, h, sq, sk, d, hop.device_sm_count(q.device))
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, h, sq, sk, d, 0, 1.0 / math.sqrt(d),
             warps, splits, d_pad, *_strides(q, k, v), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash forward variant failed with CUDA error {err}")


def launch_dkv(torch, hop, fn, q, k, v, g, lse, delta, valid):
    """The dK/dV wrapper's launch (non-causal), on ``fn``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    warps, splits, d_pad = hop.dkv_launch_params(b, h, sq, sk, d)
    dk = torch.empty((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             valid.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, 0, 1.0 / math.sqrt(d),
             warps, splits, d_pad, *_strides(q, k, v, g), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dK/dV variant failed with CUDA error {err}")


def launch_dq(torch, hop, fn, q, k, v, g, lse, delta, valid):
    """The dQ wrapper's launch (non-causal), on ``fn``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    warps, splits, d_pad = hop.dq_launch_params(b, h, sq, sk, d, hop.device_sm_count(q.device))
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             valid.data_ptr(), dq.data_ptr(), b, h, sq, sk, d, 0, 1.0 / math.sqrt(d),
             warps, splits, d_pad, *_strides(q, k, v, g), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dQ variant failed with CUDA error {err}")


def launch_ragged(torch, hop, fn, args, kw, splits=None):
    """The ragged wrapper's launch on ``fn``, at its launch choice unless
    ``splits`` is given."""
    query, kp, vp, tbl, lens = args
    rows, heads, dh = query.shape
    quant = kp.dtype == torch.int8
    page = kp.shape[1]
    n_splits, stages = hop.ragged_launch_params(dh, tbl.shape[1] * page, quant, splits)
    ck, cv = kw.get("cur_k"), kw.get("cur_v")
    out = torch.empty((rows, heads, dh), dtype=torch.float32, device=query.device)
    err = fn(query.data_ptr(), query.stride(0), kp.data_ptr(), vp.data_ptr(),
             kw["k_scale"].data_ptr() if quant else None, kw["v_scale"].data_ptr() if quant else None,
             int(quant), tbl.data_ptr(), tbl.shape[1], lens.data_ptr(),
             None if ck is None else ck.data_ptr(), None if cv is None else cv.data_ptr(),
             0 if ck is None else ck.stride(0), out.data_ptr(), rows, heads, dh, page,
             1.0 / math.sqrt(dh), n_splits, stages, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ragged variant failed with CUDA error {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "kernel_variants")
    rng = np.random.default_rng(cs.SEED + 2)
    b, h, s, d = 1, 8, 64, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).to(dev)
    pq, pk, pv = (t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    pvalid = torch.from_numpy(np.arange(s)[None, :] < 45).to(dev)
    _, _, train_ds = cs.fixture_data()
    src0, trg0 = cs.train_batches(train_ds, 1)[0]
    site = cs.training_sites(torch, np.random.default_rng(cs.SEED + 4), dev, src0, trg0[:, :-1])["encoder self"]
    q, k, v, g, valid = site["q"], site["k"], site["v"], site["g"], site["kv_valid"].contiguous()
    out, lse = hop.flash_attention_fwd(q, k, v, kv_valid=valid, return_lse=True)
    delta = (g * out).sum(-1)
    sms = hop.device_sm_count(dev)
    prompt_lens = prompt_lengths(cs)
    ragged = cs.ragged_sites(torch, np.random.default_rng(cs.SEED + 2), dev, prompt_lens)
    cross, self_i8 = ragged["cross, fp32 pages"], ragged["self + cur, int8 pages"]
    print(f"device us per call [{cs.card_line()}]; launch (warps, splits): prefill "
          f"{hop.flash_fwd_launch_params(b, h, s, s, d, sms)[:2]}, encoder forward "
          f"{hop.flash_fwd_launch_params(*q.shape[:3], k.shape[2], d, sms)[:2]}, dK/dV "
          f"{hop.dkv_launch_params(*q.shape[:3], k.shape[2], d)[:2]}, dQ "
          f"{hop.dq_launch_params(*q.shape[:3], k.shape[2], d, sms)[:2]}; ragged (splits, stages) "
          f"{hop.ragged_launch_params(64, 64, False)}")
    labels = ("prefill forward", "encoder forward+lse", "encoder dK/dV", "encoder dQ",
              "ragged cross fp32", "ragged self int8+cur")
    print(f"{'variant':10s} " + " | ".join(f"{label:>20s}" for label in labels))
    for name, fns in libs.items():
        fwd, dkv, dq, rg = (fns[e] for e in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                             "flash_attention_bwd_dq", "ragged_paged_attention"))
        choice = LAUNCH.get(name, {}).get("ragged_paged_attention", {})
        calls = (
            lambda: launch_fwd(torch, hop, fwd, pq, pk, pv, pvalid, False),
            lambda: launch_fwd(torch, hop, fwd, q, k, v, valid, True),
            lambda: launch_dkv(torch, hop, dkv, q, k, v, g, lse, delta, valid),
            lambda: launch_dq(torch, hop, dq, q, k, v, g, lse, delta, valid),
            lambda: launch_ragged(torch, hop, rg, *cross, **choice),
            lambda: launch_ragged(torch, hop, rg, *self_i8, **choice),
        )
        times = [cs.device_ms_per_call(torch, fn, n=30) for fn in calls]
        print(f"{name:10s} " + " | ".join(
            f"{'not measured' if t is None else f'{t * 1e3:.2f}':>20s}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
