"""Long-context training on one card: the MT train step at 2048, 4096 and
8192 positions, bf16, through the flash kernels and through the dense path
they replace — the port's twin of ``tools/longctx_bench.py``.

    python3 tools/torch_longctx_bench.py [--out build/longctx.json] [--steps 5]

The reference MT model (d_model 512, ffn 1024, 8 heads, 1 layer) with
``max_len`` set to the length and the published 8004-word vocabularies,
random weights and ids from ``--seed``; batches halve as the length
doubles (16, 8, 4: one token budget a step). For each length and each
``ops.attention.attention_impl`` (``"flash"``: the Hopper kernels, no
``[S, S]`` scores; ``"dense"``: the plain path's materialised scores,
the reference's core) one Adam step is warmed and ``--steps`` are timed
with CUDA events: ms per step, non-pad target tokens/s, and the peak
device memory of the config (``max_memory_allocated`` after a reset). A
config that runs out of device memory is recorded as ``"oom": true`` with
the peak at the failure, not as a broken run: for the dense path it is
the evidence of the ``[B, H, S, S]`` scores outgrowing the card. One JSON
line per config, then a summary line; the card's name and power limit
beside them. Needs a CUDA card (exits 2 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = ((2048, 16), (4096, 8), (8192, 4))
VOCAB = 8004


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_config(torch, seq: int, batch: int, impl: str, steps: int, seed: int) -> dict:
    import numpy as np

    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops.attention import attention_impl
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    dev = torch.device("cuda")
    out = {"seq": seq, "batch": batch, "impl": impl, "dtype": "bfloat16"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        cfg = TransformerConfig(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, d_model=512,
                                ffn_hidden=1024, num_heads=8, num_layers=1, dropout=0.1,
                                max_len=seq, dtype=torch.bfloat16)
        model = Transformer(cfg, generator=torch.Generator().manual_seed(seed)).to(dev)
        state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
        rng = np.random.default_rng(seed)
        src = rng.integers(4, VOCAB, (batch, seq))
        trg = rng.integers(4, VOCAB, (batch, seq + 1))
        for i, n in enumerate(rng.integers(seq // 2, seq + 1, batch)):
            src[i, n:] = 0
            trg[i, n:] = 0
        batch_t = to_device((src, trg), dev)
        tokens = int((trg[:, 1:] != 0).sum())
        step = make_train_step(make_translation_loss(cfg.pad_id))
        gen = torch.Generator(device=dev).manual_seed(seed)
        with attention_impl(impl):
            step(state, batch_t, gen)  # warm
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                _, loss, _ = step(state, batch_t, gen)
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
        out.update(ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3), loss=float(loss),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).splitlines()[0][:200],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        state = model = batch_t = None  # noqa: F841 - free before the next config
        torch.cuda.empty_cache()
    return out


def summarize(results: list) -> list:
    """Per length: flash against dense — the speedup where both ran, what
    the dense failure shows where it did not."""
    rows = []
    for seq, _ in CONFIGS:
        pair = {r["impl"]: r for r in results if r["seq"] == seq}
        fl, de = pair.get("flash", {}), pair.get("dense", {})
        row = {"seq": seq, "flash_tokens_per_s": fl.get("tokens_per_s"),
               "dense_tokens_per_s": de.get("tokens_per_s"),
               "flash_peak_gib": fl.get("peak_gib"), "dense_peak_gib": de.get("peak_gib")}
        if fl.get("tokens_per_s") and de.get("tokens_per_s"):
            row["flash_speedup"] = fl["tokens_per_s"] / de["tokens_per_s"]
        elif de.get("oom"):
            row["dense"] = "OOM (the materialised [B, H, S, S] scores outgrew the card)"
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_longctx_bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    lines, results = [], []
    for seq, batch in CONFIGS:
        for impl in ("flash", "dense"):
            r = run_config(torch, seq, batch, impl, args.steps, args.seed)
            r["card"] = card
            results.append(r)
            lines.append(json.dumps(r))
            print(lines[-1], flush=True)
    lines.append(json.dumps({"summary": summarize(results), "card": card}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
