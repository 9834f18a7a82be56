#!/usr/bin/env python3
"""The port's kernels of two or more trees, timed in turns on one card.

    python3 tools/torch_kernel_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repo (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and ``.``). For each argument, in the order given, a fresh process
imports that tree's package, builds its kernels from its own ``csrc/``
into its own ``build/``, and times every kernel through its public
wrapper at the sites ``chip_smoke.py`` times, with the profiler's device
time per call: the forward at the serving prefill; the ragged decode at
its cross-attention and self-attention sites over fp32 and int8 pages;
the forward with ``lse``, dQ and dK/dV at the three MT training sites
and at one sequence of the encoder site (fixture keys, all keys valid);
and the forward at the KV-cache decoders' one-query-row sites (with each
tree's own launch choice) beside ``F.scaled_dot_product_attention`` with
a bool mask on the same inputs (the ``SDPA ...`` rows); a tree with bf16
instantiations (the ``*_bf16`` entry points) also times them at the
same sites on bf16 inputs (the ``bf16 ...`` rows; an older tree reads
``n/m`` there). The inputs are made by
this tree's ``chip_smoke.py`` helpers from the same seeds for every run,
and the wrappers are called only with arguments that trees since the
first port slice take, so an older tree runs as it is. Prints each run's
results as a JSON line, then a table of device µs per call, one column
per run, with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MARK = "AB_RESULT "


def _chip_smoke():
    """This tree's ``chip_smoke.py``, under its own name, so that a tree
    on ``sys.path`` cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path) -> dict:
    """Times one tree's kernels; the tree's package comes first on the path."""
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    if not Path(hop.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {hop.__file__}, not the package of {tree}")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    hop.LIBRARY.kernels()  # build first: not part of any timing
    times = {}

    def record(label, fn):
        times[label] = cs.device_ms_per_call(torch, fn, n=30)

    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline

    words, corpus = cs.make_vocab_texts("s")
    pipe = TextPipeline.fit(corpus, max_seq_len=cs.SERVE["boundaries"][-1] - 1)
    prompt_lens = [len(pipe.ragged([p])[0]) for p in cs.make_prompts(words)]
    _, _, train_ds = cs.fixture_data()
    src0, trg0 = cs.train_batches(train_ds, 1)[0]
    # Trees since the bf16 slice time their bf16 instantiations too, at
    # the same sites on bf16 inputs ("bf16 ..." rows).
    dtypes = [None] + ([torch.bfloat16] if hasattr(hop, "kernel_name") else [])
    for dtype in dtypes:
        tag = "" if dtype is None else "bf16 "
        kw_dt = {} if dtype is None else dict(dtype=dtype)
        rng = np.random.default_rng(cs.SEED + 2)
        b, h, s, d = 1, 8, 64, 64
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).to(dev)
        if dtype is not None:
            qkv = qkv.to(dtype)
        pq, pk, pv = (t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        pvalid = torch.from_numpy(np.arange(s)[None, :] < 45).to(dev)
        record(f"{tag}forward @ serving prefill",
               lambda pq=pq, pk=pk, pv=pv, pvalid=pvalid: hop.flash_attention(pq, pk, pv, kv_valid=pvalid))
        for site, (args, kw) in cs.ragged_sites(torch, rng, dev, prompt_lens, **kw_dt).items():
            kw = {k: v for k, v in kw.items() if v is not None}
            record(f"{tag}ragged @ {site}", lambda args=args, kw=kw: hop.ragged_paged_attention(*args, **kw))
        sites = cs.training_sites(torch, np.random.default_rng(cs.SEED + 4), dev, src0, trg0[:, :-1], **kw_dt)
        sites |= cs.one_sequence_sites(torch, sites["encoder self"])
        for site, c in sites.items():
            q, k, v, g = c["q"], c["k"], c["v"], c["g"]
            kw = dict(causal=c["causal"], kv_valid=c["kv_valid"])
            out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            delta = (g.float() * out.float()).sum(-1)
            record(f"{tag}forward+lse @ {site}",
                   lambda q=q, k=k, v=v, kw=kw: hop.flash_attention_fwd(q, k, v, return_lse=True, **kw))
            record(f"{tag}dQ @ {site}",
                   lambda q=q, k=k, v=v, g=g, lse=lse, delta=delta, kw=kw:
                   hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw))
            record(f"{tag}dK/dV @ {site}",
                   lambda q=q, k=k, v=v, g=g, lse=lse, delta=delta, kw=kw:
                   hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw))
        for site, c in cs.decode_sites(torch, dev, cs.bleu_val_valid(), **kw_dt).items():
            record(f"{tag}forward @ decode {site}",
                   lambda c=c: hop.flash_attention_fwd(c["q"], c["k"], c["v"], kv_valid=c["kv_valid"]))
            # The library call the kernel table sets beside it, read by
            # the same profiler in the same process.
            mask = None if c["kv_valid"] is None else c["kv_valid"][:, None, None, :]
            record(f"{tag}SDPA @ decode {site}",
                   lambda c=c, mask=mask: F.scaled_dot_product_attention(
                       c["q"], c["k"], c["v"], attn_mask=mask))
    return dict(tree=str(tree), card=cs.card_line(), device_ms=times)


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        print(MARK + json.dumps(worker(Path(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--worker", tree], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"torch_kernel_ab: the run of {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        result = json.loads(lines[-1][len(MARK):])
        print(json.dumps(result), flush=True)
        runs.append(result)
    print(f"device us per call [{runs[0]['card']}]; runs: "
          + ", ".join(f"{i} = {r['tree']}" for i, r in enumerate(runs)))
    print(f"{'site':58s} " + " ".join(f"{f'run {i}':>12s}" for i in range(len(runs))))
    sites = list(dict.fromkeys(site for r in runs for site in r["device_ms"]))
    for site in sites:
        cells = []
        for r in runs:
            t = r["device_ms"].get(site)
            cells.append(f"{'n/m' if t is None else f'{t * 1e3:.2f}':>12s}")
        print(f"{site:58s} " + " ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
