#!/usr/bin/env python3
"""Device and host time of the unsharded bf16 serving step of llama-200m.

    PYTHONPATH=src python3 tools/bf16_step_time.py [--layers 10] [--slots 4]
        [--reps 20] [--label NAME] [--json PATH]

Runs the engine's step (`serve.decode.make_paged_serve_step(cfg, "bf16")`)
over a paged pool of `--slots` slots, seeded weights, in the two shapes a
bf16 engine runs: a 16-token prefill chunk (16 x slots rows a GEMM) and a
one-token decode step (slots rows). For each it prints the wall time of a
step from CUDA events (median of `--reps`), the device time of a step
(the sum of every CUDA kernel in a torch.profiler window, or null when the
profiler shows none) and the kernels a step launches.

It reads only APIs the port has had since its paged engine, so the same
script times another checkout of the port: put that checkout's `src` first
on PYTHONPATH. Comparing two checkouts, run both in one process group on
one card (parent, change, change, parent). The last line is one JSON
object; `--json PATH` also appends it to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve import decode as serve_decode
from repro_torch.serve.kv_pool import KVPool

CHUNK = 16
MAX_LEN = 80


def device_ms(fn, reps: int = 5):
    """(device ms a call: every CUDA kernel in the profiler's window, kernels
    a call), or (None, 0) when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in evs)
    n = sum(ev.count for ev in evs)
    return (us / 1e3 / reps if us > 0 else None), n / reps


def wall_ms(fn, reps: int) -> float:
    """Median ms a call between CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_step_time needs a CUDA device")
    dev = torch.device("cuda")
    full = registry.get("llama_200m")
    cfg = dataclasses.replace(full, n_layers=min(a.layers, full.n_layers))
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pool = KVPool(cfg, a.slots, MAX_LEN, block_size=16, device=dev)
    for slot in range(a.slots):
        pool.commit(slot, CHUNK + 1)
        pool.ensure(slot, CHUNK + 1)
    step = serve_decode.make_paged_serve_step(cfg, "bf16")
    g = torch.Generator().manual_seed(17)
    toks = torch.randint(0, cfg.vocab, (a.slots, CHUNK + 1), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)
    active = torch.ones(a.slots, dtype=torch.bool, device=dev)
    tables = pool.tables_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"label": a.label, "card": smi.stdout.strip().splitlines()[0]
           if smi.returncode == 0 and smi.stdout.strip() else None,
           "layers": cfg.n_layers, "slots": a.slots, "steps": {}}
    for name, start, size in (("prefill_chunk", 0, CHUNK),
                              ("decode", CHUNK, 1)):
        t = toks[:, start:start + size].contiguous()
        pos = torch.full((a.slots,), start, dtype=torch.int32, device=dev)

        def fn():
            with torch.no_grad():
                step(params, pool.caches, tables, t, pos, active)
        ms = wall_ms(fn, a.reps)
        dms, kernels = device_ms(fn)
        out["steps"][name] = {"rows": a.slots * size, "wall_ms": ms,
                              "device_ms": dms, "kernels": kernels}
        print(f"{a.label} {name} ({a.slots * size} rows a GEMM): wall {ms:.4f} "
              f"ms, device {dms} ms, {kernels:g} kernels a step")
    line = json.dumps(out)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        with open(a.json, "a") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
