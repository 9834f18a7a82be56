"""Probe gloo point-to-point hops between two processes sharing one card,
at the pipeline's microbatch activation shapes.

For each shape ``[rows, 200, 512]`` fp32 (a 32-row batch cut into M = 4,
8 and 2 microbatches of a 16-row data half, and one 32-row batch), rank
0 sends a CUDA tensor to rank 1 two ways: handed to ``dist.send`` as it
is, and staged explicitly (copied into pinned host memory, sent, received
into pinned host memory, copied back to the card). It reports whether
each way delivers the sender's values bit for bit and the median time of
a hop (send issue to the receiver's copy on the card done, timed on the
receiver), and the card's name and power limit.

    python3 tools/torch_pp_probe.py [--reps 10]

Prints one JSON line; exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

SHAPES = ((8, 200, 512), (4, 200, 512), (16, 200, 512), (32, 200, 512))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, reps: int, path: str) -> None:
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")
    # A rank killed by a bad hop must not leave its peer waiting long.
    dist.init_process_group("gloo", rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    out: dict = {}
    # Staged first: a direct hop that reads a card pointer as host memory
    # may kill the ranks, and the staged figures are written by then.
    for way in ("staged", "direct"):
        for shape in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(sum(shape))
            want = torch.randn(shape, device=dev, generator=gen)
            row = out.setdefault("x".join(map(str, shape)), {"bytes": want.numel() * want.element_size()})
            times, ok = [], True
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if rank == 0:
                    if way == "direct":
                        dist.send(want, 1)
                    else:
                        host = torch.empty(shape, pin_memory=True)
                        host.copy_(want)
                        dist.send(host, 1)
                else:
                    if way == "direct":
                        got = torch.empty(shape, device=dev)
                        dist.recv(got, 0)
                    else:
                        host = torch.empty(shape, pin_memory=True)
                        dist.recv(host, 0)
                        got = host.to(dev, non_blocking=True)
                    torch.cuda.synchronize()
                    ok = ok and bool(torch.equal(got, want))
                times.append(time.perf_counter() - t0)
            times.sort()
            row[way] = {"bit_exact": ok, "median_ms": 1e3 * times[len(times) // 2]}
        if rank == 1:
            with open(path, "w") as f:
                json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    if a.rank is not None:
        _rank(a.rank, a.port, a.reps, a.out)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_pp_probe: no CUDA device is available", file=sys.stderr)
        return 2
    port = _free_port()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build", "pp_probe.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port),
                               "--reps", str(a.reps), "--out", path]) for r in (0, 1)]
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=300))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if not os.path.exists(path):
        print(f"torch_pp_probe: ranks exited {codes}", file=sys.stderr)
        return 1
    with open(path) as f:
        result = json.load(f)
    if any(codes):
        for row in result.values():
            row.setdefault("direct", f"the ranks exited {codes} during the direct hops")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "hops": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
