#!/usr/bin/env python3
"""The port's ingest bench: the synchronous loader against the streaming
pipeline, training on the card.

    python3 tools/torch_ingest_bench.py --smoke [--out P]   # the CPU: one tiny entry, the gates
    python3 tools/torch_ingest_bench.py [--out P]           # the card: the full sweep
    (--cpu runs the full sweep on the host instead)

The twin of ``tools/ingest_bench.py`` over the PyTorch port. Each sweep
entry (record count x parser x prefetch depth) trains the same
MLP-on-libsvm workload (``MLP((features, width, width, 3))``, Adam 1e-3)
three ways:

- ``sync`` — ``read_libsvm`` reads the whole file, then a ``DataLoader``
  iterates it (parse and train in series);
- ``stream_off`` — ``StreamingPipeline`` with ``buffer=0``: streamed
  record assembly, every batch parsed inline between steps;
- ``stream_on`` — the whole pipeline: the bounded producer thread and the
  device stage (pinned copies on a side stream, ``device_prefetch=2``
  ahead), the parse overlapped with the steps.

The number to read is ``stream_on`` against ``stream_off`` and ``sync``
epoch seconds on the python-parser entry, with the steady step time
(``step_p50_ms``, the second half's median of the ``train.step`` spans)
flat across the arms: a gain must come from overlap, not from the
compute. The gates (all must hold for ``ok``): the stream's batches are
the sync loader's bit for bit, two stream epochs are the same, and no
pipeline thread outlives its run. An online-packing on/off micro-sweep
rides along.

The model trains on the card unless ``--smoke`` or ``--cpu`` keeps it on
the host; a run that asks for the card where there is none raises. The
artifact is written where ``--out`` says, else printed.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from machine_learning_apache_spark_tpu_torch import ingest, telemetry  # noqa: E402
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm, write_libsvm  # noqa: E402
from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset, DataLoader  # noqa: E402
from machine_learning_apache_spark_tpu_torch.models.mlp import MLP  # noqa: E402
from machine_learning_apache_spark_tpu_torch.train.loop import fit  # noqa: E402
from machine_learning_apache_spark_tpu_torch.train.losses import cross_entropy  # noqa: E402
from machine_learning_apache_spark_tpu_torch.train.metrics import logits_accuracy  # noqa: E402
from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer  # noqa: E402

CLASSES = 3
#: The tier-1 entry (the JAX bench's ``--smoke``) and the full sweep.
SMOKE_ENTRIES = [dict(records=1200, features=32, batch=32, width=64, parser="python", buffer_on=4)]
FULL_ENTRIES = [
    # Input-heavy: a pure-python parse of a ~10 MB file, host input prep
    # comparable to the step, where overlap pays most.
    dict(records=20000, features=64, batch=64, width=1024, parser="python", buffer_on=4),
    # The native parser: input prep is cheap, the overlap's win small —
    # the control showing streaming costs nothing when input-light.
    dict(records=20000, features=64, batch=64, width=1024, parser="auto", buffer_on=4),
]


def _write_corpus(path: str, records: int, features: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(records, features)).astype(np.float32)
    # ~25 % explicit zeros: sparse files skip them, so lines vary in length.
    feats[rng.random(feats.shape) < 0.25] = 0.0
    labels = rng.integers(0, CLASSES, records)
    write_libsvm(path, feats, labels)


def _workload(features: int, width: int, device):
    """The loss and a maker of fresh train states (the same initial
    weights each time, on ``device``)."""
    model0 = MLP((features, width, width, CLASSES), generator=torch.Generator().manual_seed(0))

    def loss_fn(module, batch, rng):
        del rng
        x, y = batch
        logits = module(x)
        return cross_entropy(logits, y), {"accuracy": logits_accuracy(logits, y)}

    def fresh_state():
        return TrainState.create(model=copy.deepcopy(model0).to(device), tx=make_optimizer("adam", 1e-3))

    return loss_fn, fresh_state


def _steady_step_ms() -> float | None:
    """The steady step time from this run's ``train.step`` spans: the
    median of the second half (past the first steps' warm-up)."""
    durs = [ev.value for ev in telemetry.get_log().snapshot()
            if ev.kind == "span_end" and ev.name == "train.step" and ev.value is not None]
    if len(durs) < 4:
        return None
    tail = sorted(durs[len(durs) // 2:])
    return round(tail[len(tail) // 2] * 1e3, 4)


def _leaves(batch):
    if isinstance(batch, dict):
        for k in sorted(batch):
            yield from _leaves(batch[k])
    elif isinstance(batch, (tuple, list)):
        for b in batch:
            yield from _leaves(b)
    else:
        yield batch


def _batch_checksum(batches) -> list[int]:
    out = []
    for batch in batches:
        h = 0
        for leaf in _leaves(batch):
            arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            h = zlib.crc32(np.ascontiguousarray(arr).tobytes(), h)
        out.append(h)
    return out


def _sync_card(state) -> None:
    """Wait for the steps queued on the card: the wall ends when they do."""
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_sync(path, num_features, batch, epochs, use_native, loss_fn, state):
    telemetry.reset()
    t0 = time.perf_counter()
    frame = read_libsvm(path, num_features=num_features, use_native=use_native)
    loader = DataLoader(ArrayDataset(frame.features, frame.labels), batch, shuffle=False, drop_last=True)
    fit(state, loss_fn, loader, epochs=epochs, log_every=0)
    _sync_card(state)
    wall = time.perf_counter() - t0
    return {"wall_s": round(wall, 4), "epoch_s": round(wall / epochs, 4), "step_p50_ms": _steady_step_ms()}


def _run_stream(path, num_features, batch, epochs, use_native, loss_fn, state, buffer):
    telemetry.reset()
    t0 = time.perf_counter()
    source = ingest.LibsvmStreamSource(path, num_features=num_features, use_native=use_native)
    # The device stage targets the model's device (``fit`` binds it).
    pipe = ingest.StreamingPipeline(source, batch, tail="drop", buffer=buffer, device_prefetch=2)
    try:
        fit(state, loss_fn, data=pipe, epochs=epochs, log_every=0)
        _sync_card(state)
    finally:
        pipe.shutdown()
    wall = time.perf_counter() - t0
    return {
        "buffer": buffer,
        "wall_s": round(wall, 4),
        "epoch_s": round(wall / epochs, 4),
        "step_p50_ms": _steady_step_ms(),
        "batches_per_epoch": pipe.last_epoch_batches,
        "device": str(pipe.target_device()),
        "h2d_copies": pipe.h2d_copies,
    }


def _warmup(device) -> None:
    """Pay the first use of the device (context, allocator, the first
    kernels) outside the timed arms, which must not absorb it."""
    loss_fn, fresh_state = _workload(8, 16, device)
    loader = DataLoader(ArrayDataset(np.zeros((64, 8), np.float32), np.zeros(64, np.int64)), 32,
                        shuffle=False, drop_last=True)
    fit(fresh_state(), loss_fn, loader, epochs=1, log_every=0)
    telemetry.reset()


def _gates(path, num_features, batch) -> dict:
    """The semantic gates, independent of timing."""
    frame = read_libsvm(path, num_features=num_features)
    loader = DataLoader(ArrayDataset(frame.features, frame.labels), batch, shuffle=False, drop_last=True)
    sync_sums = _batch_checksum(iter(loader))

    def stream_sums():
        pipe = ingest.StreamingPipeline(ingest.LibsvmStreamSource(path, num_features=num_features),
                                        batch, tail="drop", buffer=2, device=False)
        try:
            return _batch_checksum(iter(pipe))
        finally:
            pipe.shutdown()

    first, second = stream_sums(), stream_sums()
    time.sleep(0.2)  # joined threads may take a beat to leave the registry
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(ingest.WORKER_PREFIX) and t.is_alive()]
    return {"parity_sync_vs_stream": first == sync_sums, "determinism": first == second,
            "threads_clean": not leaked}


def _packing_sweep(pairs_n: int, seed: int) -> dict:
    """The pipeline alone, packing on against off, over one pair corpus."""
    rng = np.random.default_rng(seed)
    src_len, trg_len = 48, 56
    pairs = [(list(rng.integers(4, 1000, rng.integers(4, 20))), list(rng.integers(4, 1000, rng.integers(5, 24))))
             for _ in range(pairs_n)]
    source = ingest.PairSource(pairs)

    def pad_transform(rec):
        s = np.zeros(src_len, np.int32)
        t = np.zeros(trg_len, np.int32)
        s[: len(rec[0])] = rec[0][:src_len]
        t[: len(rec[1])] = rec[1][:trg_len]
        return (s, t)

    out = {"pairs": pairs_n, "src_len": src_len, "trg_len": trg_len}
    for mode in ("off", "on"):
        pipe = ingest.StreamingPipeline(
            source, 16, tail="drop", buffer=4, device=False,
            pack=dict(src_len=src_len, trg_len=trg_len) if mode == "on" else None,
            transform=None if mode == "on" else pad_transform,
        )
        t0 = time.perf_counter()
        batches = sum(1 for _ in pipe)
        wall = time.perf_counter() - t0
        pipe.shutdown()
        out[f"pack_{mode}"] = {"batches": batches, "wall_s": round(wall, 4),
                               "pairs_per_s": round(pairs_n / wall, 1) if wall else None}
    # One pass of the packer over the same corpus, for the efficiency.
    packer = ingest.OnlinePacker(src_len=src_len, trg_len=trg_len)
    for s, t in pairs:
        packer.add(s, t)
    packer.flush()
    out["token_efficiency_packed"] = round(packer.token_efficiency, 4)
    out["rows_packed"] = packer.rows_emitted
    out["rows_unpacked"] = pairs_n
    return out


def run(entries: list[dict], epochs: int, pairs_n: int, device, *, smoke: bool) -> dict:
    """Every entry's three arms and gates, then the packing sweep: the
    artifact."""
    from machine_learning_apache_spark_tpu_torch import native

    device = torch.device(device)
    _warmup(device)
    sweep = []
    gates_all: dict[str, bool] = {}
    with tempfile.TemporaryDirectory(prefix="torch_ingest_bench_") as tmp:
        for spec in entries:
            path = os.path.join(tmp, f"corpus_{spec['records']}x{spec['features']}.libsvm")
            _write_corpus(path, spec["records"], spec["features"], seed=7)
            use_native = None if spec["parser"] == "auto" else False
            loss_fn, fresh_state = _workload(spec["features"], spec["width"], device)
            args = (path, spec["features"], spec["batch"], epochs, use_native, loss_fn)
            entry = dict(spec)
            entry["epochs"] = epochs
            entry["sync"] = _run_sync(*args, fresh_state())
            entry["stream_off"] = _run_stream(*args, fresh_state(), buffer=0)
            entry["stream_on"] = _run_stream(*args, fresh_state(), buffer=spec["buffer_on"])
            on, off = entry["stream_on"], entry["stream_off"]
            entry["speedup_on_vs_off"] = round(off["epoch_s"] / on["epoch_s"], 3)
            entry["speedup_on_vs_sync"] = round(entry["sync"]["epoch_s"] / on["epoch_s"], 3)
            sweep.append(entry)
            for k, v in _gates(path, spec["features"], spec["batch"]).items():
                gates_all[k] = gates_all.get(k, True) and v
    telemetry.reset()
    packing = _packing_sweep(pairs_n, seed=11)
    return {
        "artifact": "ingest_bench",
        "created_unix": round(time.time(), 1),
        "smoke": smoke,
        "ok": all(gates_all.values()),
        "gates": gates_all,
        "sweep": sweep,
        "packing": packing,
        "env": {
            "device": str(device),
            "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
            "torch": torch.__version__,
            "native_parser_built": native.available(),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true", help="tier-1: one tiny entry on the host, the gates")
    ap.add_argument("--cpu", action="store_true", help="the full sweep on the host")
    ap.add_argument("--out", default=None, help="artifact path (else printed)")
    ap.add_argument("--epochs", type=int, default=None)
    ns = ap.parse_args(argv)
    if ns.smoke:
        entries, epochs, pairs_n, device = SMOKE_ENTRIES, ns.epochs or 2, 600, "cpu"
    else:
        entries, epochs, pairs_n = FULL_ENTRIES, ns.epochs or 3, 4000
        if ns.cpu:
            device = "cpu"
        elif not torch.cuda.is_available():
            raise RuntimeError("the full sweep trains on device 'cuda' and none is available; "
                               "--smoke or --cpu runs it on the host")
        else:
            from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

            device = resolve_device(None)
    artifact = run(entries, epochs, pairs_n, device, smoke=bool(ns.smoke))
    text = json.dumps(artifact, indent=2) + "\n"
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(text)
        print(f"torch_ingest_bench: ok={artifact['ok']} entries={len(artifact['sweep'])} -> {ns.out}")
    else:
        print(text, end="")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
