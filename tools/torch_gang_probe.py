#!/usr/bin/env python3
"""Where a data-parallel step's host time goes: a 2-rank gang on one card.

    python3 tools/torch_gang_probe.py

Spawns a 2-rank gang (``launcher.Distributor``; the ranks share the card,
so the backend is gloo over CUDA tensors) and, in each rank, for TinyVGG
on CIFAR-10 at 32 a replica (SGD) and the MT recipe's model on the
fixture's vocabularies at 16 a replica (Adam, dropout 0), the models and
batches ``chip_smoke.py`` times in its phase 8:

- ms per step of ``parallel.make_data_parallel_step`` over 20 steps after
  5 (host-timed, the card synchronised at both ends);
- the same step split into its parts over 20 more steps, the card
  synchronised after each part: the loss weight's host all-reduce, the
  batch's copy to the card, the forward through DDP, the backward (with
  DDP's gradient all-reduce), the optimizer update and the loss
  all-reduce;
- the median of 20 lone gloo all-reduces (after 5) at the step's sizes:
  8 bytes on the host and on the card, and the model's gradient bytes on
  the card, handed to gloo as a CUDA tensor and staged through pageable
  host memory with ``.cpu()``.

Prints each rank's numbers as a JSON line, then the card's name and
power limit. Needs the card; the kernels build before the gang spawns.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS = 20
WARMUP = 5


def _models(torch, dev):
    """``kind -> (model, loss_fn, optimizer, dataset, batch per replica)``."""
    import chip_smoke as cs
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_cifar10
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
    from machine_learning_apache_spark_tpu_torch.models.cnn import TinyVGG
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss
    from machine_learning_apache_spark_tpu_torch.train.state import make_optimizer

    frame = load_cifar10(str(cs.FIXTURES), train=True)
    cnn = TinyVGG(hidden_units=10, num_classes=10, input_shape=frame.features.shape[1:],
                  generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    yield "cnn", (cnn, classification_loss(), make_optimizer("sgd", 0.01),
                  ArrayDataset(*frame.arrays()), cs.GANG_CNN_BATCH)
    mt, ds, r = cs._mt_model(torch, dev)
    yield "mt", (mt, make_translation_loss(mt.cfg.pad_id), make_optimizer("adam", r.learning_rate),
                 ds, cs.GANG_MT["batch_size"])


def _median_ms(torch, fn, n: int = STEPS) -> float:
    times = []
    for _ in range(WARMUP + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times[WARMUP:]))


def probe_rank() -> list:
    """One rank's numbers; every rank's, in rank order."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel as dp
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState

    mesh = data_parallel_mesh()
    dev, rank, world = mesh.device, mesh.rank, mesh.size
    out = {"rank": rank}
    for kind, (model, loss_fn, tx, ds, per) in _models(torch, dev):
        batches = cs._rank_batches(ds, per, rank)
        state = TrainState.create(model=model, tx=tx)
        step = dp.make_data_parallel_step(loss_fn, mesh)
        for i in range(WARMUP):
            step(state, batches[i % len(batches)], None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            step(state, batches[i % len(batches)], None)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / STEPS

        ddp = step.replica(state.model)
        weight_of = dp.loss_weight_of(loss_fn)
        parts = dict.fromkeys(("weight", "to_device", "forward", "backward", "update", "loss"), 0.0)
        for i in range(STEPS):
            batch = batches[i % len(batches)]
            marks = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            w = float(weight_of(batch))
            total = dp._total_weight(mesh, w)
            mark()
            on_card = to_device(batch, dev)
            mark()
            loss, aux = loss_fn(ddp, on_card, None)
            mark()
            (loss * (w * world / total)).backward()
            mark()
            state.apply_gradients()
            mark()
            dp._global_means(mesh, w, loss, aux, total)
            mark()
            for name, a, b in zip(parts, marks, marks[1:]):
                parts[name] += b - a

        numel = sum(p.numel() for p in model.parameters())

        def staged():
            x = torch.zeros(numel, device=dev)
            h = x.cpu()
            dist.all_reduce(h)
            x.copy_(h)

        collectives = {
            "8 bytes, host": _median_ms(torch, lambda: dist.all_reduce(torch.zeros(1, dtype=torch.float64))),
            "8 bytes, card": _median_ms(torch, lambda: dist.all_reduce(torch.zeros(2, device=dev))),
            f"{4 * numel} bytes, card": _median_ms(torch, lambda: dist.all_reduce(torch.zeros(numel, device=dev))),
            f"{4 * numel} bytes, staged with .cpu()": _median_ms(torch, staged),
        }
        out[kind] = dict(
            parameters=numel, batch=per, ms_per_step=ms,
            parts_ms={k: 1e3 * v / STEPS for k, v in parts.items()},
            allreduce_median_ms=collectives,
        )
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    return gathered


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gang_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY

    LIBRARY.kernels()
    ranks = Distributor(num_processes=2, timeout=600).run("torch_gang_probe:probe_rank")
    stray = kill_stray_gangs()
    for r in ranks:
        print(json.dumps(r))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip())
    return 1 if stray else 0


if __name__ == "__main__":
    sys.exit(main())
