#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors, and what an all-reduce of one
training step's gradients costs through gloo, with two ranks sharing one card.

    python3 tools/gloo_cuda_probe.py [--gb 1.121] [--reps 3]

Each probe runs in ranks of its own (`repro_torch.dist.spawn`, gloo):
  1. all_reduce, broadcast and all_gather on CUDA tensors, results checked;
  2. send / recv of a CUDA tensor (a rank that aborts inside gloo is
     reported as such: the probe reads its exit code);
  3. an all-reduce of --gb GB of f32 on the card, timed on the host clock
     (synchronized) both ways: gloo's own all_reduce of the CUDA tensor (what
     `dist.all_reduce_sum_` does), and the same through a pinned host buffer
     (`dist.to_host`, all_reduce, copy back); the two sums compared bitwise.
Prints one JSON object, with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def collectives(rank, world):
    import torch
    import torch.distributed as dist
    x = torch.full((1024,), float(rank + 1), device="cuda")
    y = x.clone()
    dist.all_reduce(y)
    z = x.clone()
    dist.broadcast(z, 0)
    g = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(g, x)
    return {"all_reduce": float(y[0]), "broadcast": float(z[0]),
            "all_gather": [float(t[0]) for t in g]}


def p2p(rank, world):
    import torch
    import torch.distributed as dist
    x = torch.full((1024,), float(rank + 1), device="cuda")
    if rank == 0:
        dist.send(x, 1)
        return {"send": "returned"}
    dist.recv(x, 0)
    return {"recv": float(x[0])}


def timed_all_reduce(rank, world, n, reps):
    import torch
    import torch.distributed as dist
    from repro_torch import dist as D
    g = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn(n, generator=g, device="cuda")
    out = {}
    for name in ("gloo_cuda", "host_staged"):
        times = []
        for i in range(reps + 1):
            y = x.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "gloo_cuda":
                dist.all_reduce(y)
            else:
                buf = D.to_host(y)
                dist.all_reduce(buf)
                y.copy_(buf)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": times, "checksum": D.checksum([y])}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", type=float, default=1.121)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch import dist as D
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    res = {"card": smi.stdout.strip(), "torch": torch.__version__}
    res["collectives"] = D.spawn(collectives, 2, backend="gloo", timeout_s=120,
                                 pg_timeout_s=30)
    try:
        res["p2p"] = D.spawn(p2p, 2, backend="gloo", timeout_s=120,
                             pg_timeout_s=30)
    except RuntimeError as e:  # the probe's finding: a rank failed
        res["p2p"] = {"failed": str(e)[-400:]}
    n = int(args.gb * 1e9 / 4)
    ranks = D.spawn(timed_all_reduce, 2, (n, args.reps), backend="gloo",
                    timeout_s=600, pg_timeout_s=300)
    res["all_reduce"] = {"bytes": 4 * n, "ranks": ranks, "bitwise": all(
        r["gloo_cuda"]["checksum"] == r["host_staged"]["checksum"]
        for r in ranks)}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
