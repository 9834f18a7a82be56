#!/usr/bin/env python3
"""What the gloo backend does with the ZeRO-1 step's collectives on CUDA
tensors, in a 2-rank gang on one card.

    python3 tools/torch_zero1_probe.py [--device cuda|cpu] [--mib 4]

Two processes join a gloo group over ``tcp://127.0.0.1``. For each wire
dtype (float32, bfloat16, int8) each rank tries ``reduce_scatter_tensor``
and ``all_gather_into_tensor`` on tensors on the device, and checks the
result against the same collective run on host copies. Then, for a
bucket of ``--mib`` MiB of float32 (and its bf16 and int8 wires), it
times on the host clock (the card synchronised at both ends, median of
20 after 3):

- the reduce-scatter and the all-gather on the device tensors (when gloo
  takes them);
- the same through an explicit pinned host buffer (copy out, collective
  on the host, copy back);
- the all-reduce of the whole bucket, which the replicated step runs.

Prints one JSON line per rank 0 with the results and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

DTYPES = ("float32", "bfloat16", "int8")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def _median_ms(torch, fn, dev, n: int = 20, warmup: int = 3) -> float:
    times = []
    for i in range(warmup + n):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def rank_main(rank: int, world: int, port: int, device: str, mib: float, out: str) -> None:
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(rank)
    result: dict = {"device": device, "world": world, "torch": torch.__version__, "support": {}, "ms": {}}
    n = world * 1024
    for name in DTYPES:
        dt = getattr(torch, name)
        host = (torch.randn(n, generator=gen) * 20).to(dt)
        want_rs = torch.empty(n // world, dtype=dt)
        dist.reduce_scatter_tensor(want_rs, host.clone())
        want_ag = torch.empty(n * world, dtype=dt)
        dist.all_gather_into_tensor(want_ag, host.clone())
        entry = {}
        for op, call, want in (
            ("reduce_scatter_tensor", lambda o, i: dist.reduce_scatter_tensor(o, i), want_rs),
            ("all_gather_into_tensor", lambda o, i: dist.all_gather_into_tensor(o, i), want_ag),
        ):
            x = host.to(dev)
            o = torch.empty(want.shape, dtype=dt, device=dev)
            try:
                call(o, x)
                entry[op] = "ok" if torch.equal(o.cpu(), want) else "wrong result"
            except Exception as e:  # noqa: BLE001 - the probe reports what the backend says
                entry[op] = f"raises {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        result["support"][name] = entry
    elems = int(mib * 2**20 // 4) // world * world
    for name in DTYPES:
        dt = getattr(torch, name)
        x = (torch.randn(elems, generator=gen)).to(dt).to(dev)
        piece = torch.empty(elems // world, dtype=dt, device=dev)
        full = torch.empty(elems, dtype=dt, device=dev)
        pin = {"pin_memory": True} if dev.type == "cuda" else {}
        hx = torch.empty(elems, dtype=dt, **pin)
        hp = torch.empty(elems // world, dtype=dt, **pin)
        hf = torch.empty(elems, dtype=dt, **pin)
        ms = {}
        sup = result["support"][name]
        if sup["reduce_scatter_tensor"] == "ok":
            ms["reduce_scatter_device"] = _median_ms(torch, lambda: dist.reduce_scatter_tensor(piece, x), dev)
        if sup["all_gather_into_tensor"] == "ok":
            ms["all_gather_device"] = _median_ms(torch, lambda: dist.all_gather_into_tensor(full, piece), dev)

        def staged_rs():
            hx.copy_(x)
            dist.reduce_scatter_tensor(hp, hx)
            piece.copy_(hp, non_blocking=True)

        def staged_ag():
            hp.copy_(piece)
            dist.all_gather_into_tensor(hf, hp)
            full.copy_(hf, non_blocking=True)

        ms["reduce_scatter_staged"] = _median_ms(torch, staged_rs, dev)
        ms["all_gather_staged"] = _median_ms(torch, staged_ag, dev)
        if name != "int8":
            ms["all_reduce_device"] = _median_ms(torch, lambda: dist.all_reduce(x), dev)
        result["ms"][name] = ms
    result["bucket_bytes_fp32"] = elems * 4
    if rank == 0:
        result["card"] = _card() if device == "cuda" else "cpu"
        with open(out, "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mib", type=float, default=4.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.rank is not None:
        rank_main(a.rank, 2, a.port, a.device, a.mib, a.out)
        return 0
    import tempfile

    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "probe.json")
        procs = [
            subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port),
                              "--device", a.device, "--mib", str(a.mib), "--out", out])
            for r in range(2)
        ]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs) or not os.path.exists(out):
            print(f"torch_zero1_probe: ranks exited {rcs}", file=sys.stderr)
            return 1
        with open(out) as f:
            print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
