#!/usr/bin/env python3
"""The port's training step, BLEU decode and one-shot ``Translator`` of two
or more trees, timed in turns on one card.

    python3 tools/torch_train_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repo (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and ``.``). For each argument, in the order given, a fresh process
imports that tree's package, builds its kernels into its own ``build/``,
and measures, with inputs made by this tree's ``chip_smoke.py`` helpers
from the same seeds for every run:

- the reference recipe's train step (full width, dropout 0.1, Adam 1e-3,
  fixture batches of 32 resident on the card): one step per call, and K
  steps per call where the tree has ``train.loop.StepDispatch``; ms per
  step from CUDA events over 20 steps, steps/s, non-pad target tokens/s,
  the peak memory allocated above the trained state and the peak
  reserved, the memory the K-step program holds, and over one profiled
  window of 12 steps the device idle share, the device ms per step and
  the ten busiest kernels' ms per step;
- the recipe's BLEU decode of one epoch (the 80 validation pairs in
  batches of 32, 32 and 16; 199 steps): eager, and through the recipe's
  programs where the tree has them (a capturing epoch, then a replaying
  one); wall and device busy time per epoch;
- the one-shot ``Translator`` at the smoke's serving width (~8,000-word
  vocabularies, 64 new tokens), greedy and beam 4 at 32 and 16 rows:
  median latency of 5 calls after one call of the shape.

Prints each run's results as a JSON line, then a table with one column
per run, with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MARK = "AB_RESULT "
K = 4
TIMED_STEPS = 20


def _chip_smoke():
    """This tree's ``chip_smoke.py``, under its own name, so that a tree
    on ``sys.path`` cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_train_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled(torch, cs, fn, rows_out=None) -> tuple[float, float | None]:
    """``fn()`` under the profiler: wall seconds (synchronised, inside the
    profiler) and device busy seconds (None when it saw no device work);
    the profiler's rows go into ``rows_out`` when given."""
    out = {}

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    rows = cs.profile_device(torch, run)
    if rows_out is not None:
        rows_out.extend(rows)
    return out["wall"], (sum(r[2] for r in rows) / 1e6 if rows else None)


def _train(torch, cs, train_ds, src_pipe, trg_pipe) -> dict:
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train import loop
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    dev = torch.device("cuda")
    cfg = TransformerConfig(src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab))
    model = Transformer(cfg, generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
    batches = [loop.to_device(b, dev) for b in cs.train_batches(train_ds, 12)]
    tokens = [int((b[1][:, 1:] != cfg.pad_id).sum().item()) for b in batches]
    loss_fn = make_translation_loss(cfg.pad_id)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    dispatch = loop.StepDispatch(state, loss_fn, gen) if hasattr(loop, "StepDispatch") else None
    step = loop.make_train_step(loss_fn)
    out, kernels = {}, {}
    for k in (1, K) if dispatch is not None else (1,):
        def run(n, offset=0, k=k):
            for i in range(0, n, k):
                group = [batches[(offset + i + j) % len(batches)] for j in range(k)]
                if dispatch is None:  # a tree before StepDispatch: its fit's step
                    gen.manual_seed(offset + i)
                    step(state, group[0], gen)
                elif k == 1:
                    dispatch.single(group[0])
                else:
                    dispatch.group(group)

        _, _, held = cs.held_memory(torch, lambda: run(2 * k))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(TIMED_STEPS, 3)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED_STEPS
        n_tok = sum(tokens[(3 + i) % len(batches)] for i in range(TIMED_STEPS)) / TIMED_STEPS
        rows = []
        wall, busy = _profiled(torch, cs, lambda: run(12, 100), rows)
        kernels[f"{k} per call"] = [[name[:70], calls, us / 12 / 1e3] for name, calls, us in rows[:10]]
        out[f"train device ms per step, {k} per call"] = None if busy is None else busy / 12 * 1e3
        out[f"train step ms, {k} per call"] = ms
        out[f"train steps/s, {k} per call"] = 1e3 / ms
        out[f"train tokens/s, {k} per call"] = n_tok * 1e3 / ms
        out[f"train peak MiB above state, {k} per call"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[f"train peak reserved MiB, {k} per call"] = torch.cuda.max_memory_reserved() / 2**20
        if k > 1:
            out[f"train program MiB reserved, {k} per call"] = held / 2**20
        out[f"train idle share, {k} per call"] = None if busy is None else 1 - busy / wall
    return dict(times=out, model=model, kernels=kernels)


def _bleu(torch, cs, model) -> dict:
    from machine_learning_apache_spark_tpu_torch.recipes import translation

    val_loader, gen = cs.eval_loader()
    out = {}
    runs = [("eager", lambda: cs.bleu_decode(model, val_loader, gen))]
    if hasattr(translation, "bleu_decode"):
        from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache

        programs = ProgramCache(next(model.parameters()).device, eager_first_call=True)
        graphed = lambda: translation.bleu_decode(model, val_loader, gen, programs)  # noqa: E731
        runs += [("graphs, capturing", graphed), ("graphs, replaying", graphed)]
    for label, fn in runs:
        wall, busy = _profiled(torch, cs, fn)
        out[f"BLEU decode wall ms, {label}"] = wall * 1e3
        out[f"BLEU decode device ms, {label}"] = None if busy is None else busy * 1e3
    return out


def _translator(torch, cs) -> dict:
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline

    src_words, src_corpus = cs.make_vocab_texts("s")
    trg_words, trg_corpus = cs.make_vocab_texts("t")
    width = cs.SERVE["boundaries"][-1] - 1
    src_pipe = TextPipeline.fit(src_corpus, max_seq_len=width)
    trg_pipe = TextPipeline.fit(trg_corpus, max_seq_len=width)
    prompts = cs.make_prompts(src_words)
    translator = cs.build_translator(None, cs.model_params(src_pipe, trg_pipe), src_pipe, trg_pipe)
    out = {}
    for method in ("greedy", "beam"):
        for rows in (32, 16):
            kw = dict(method=method, max_new_tokens=cs.SERVE["max_new_tokens"],
                      beam_size=cs.SERVE_BEAM["beam_size"])
            translator(prompts[:rows], **kw)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                translator(prompts[:rows], **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"Translator {method} ms, {rows} rows"] = statistics.median(times)
    return out


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    if not Path(hop.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {hop.__file__}, not the package of {tree}")
    cs = _chip_smoke()
    hop.LIBRARY.kernels()  # build first: not part of any timing
    src_pipe, trg_pipe, train_ds = cs.fixture_data()
    train = _train(torch, cs, train_ds, src_pipe, trg_pipe)
    times = train["times"] | _bleu(torch, cs, train["model"])
    kernels = train["kernels"]
    del train
    torch.cuda.empty_cache()
    times |= _translator(torch, cs)
    return dict(tree=str(tree), card=cs.card_line(), times=times, train_kernels_ms_per_step=kernels)


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
            print(f"torch_train_ab: the run of {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        result = json.loads(lines[-1][len(MARK):])
        print(json.dumps(result), flush=True)
        runs.append(result)
    labels = list(dict.fromkeys(k for r in runs for k in r["times"]))
    print(f"{'':44s}" + "".join(f"{r['tree'][-14:]:>16s}" for r in runs))
    for label in labels:
        cells = []
        for r in runs:
            v = r["times"].get(label)
            cells.append(f"{'—' if v is None else f'{v:.4f}':>16s}")
        print(f"{label:44s}" + "".join(cells))
    print(f"cards: {sorted({r['card'] for r in runs})}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
