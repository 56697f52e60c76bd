#!/usr/bin/env python3
"""Split length of the paged GQA decode kernels (#5, #6) on one NVIDIA GPU.

    python3 tools/gqa_split_probe.py [--split-keys 16 32 64]

Times `ops.paged_gqa` (bf16 pool) and `ops.paged_gqa_q` (NVFP4 pool) over
chip_smoke.py's timed set (one llama-200m decode step: 10 calls, 4 slots,
H = KV = 10, hd 128, block 16, lengths 47/100/131/18), at a yi-9b decode
shape (H 32, KV 4) and at the 16-token prefill chunk, once for each value
of `paged_attention.SPLIT_KEYS` (the keys of one split, which `plan` turns
into blocks a split). Each call is held against the plain version under
the attention bar first. Times: CUDA events over the calls, and the
kernels' own device time from torch.profiler (both kernels, and the split
and merge kernels apart); SDPA over the gathered view beside them. Then, for yi-9b's heads at a 16-token chunk over the bf16
pool with K/V drawn at 3x unit scale (two of chip_smoke.py's split cases,
which it runs over the NVFP4 pool), how far the kernel and the plain
version each are from the same attention in float64, and how many elements
of each lie outside the attention bar around the other. Prints one line per (shape, pool, split) and the card's name and
power limit; writes chiprun_out/gqa_split_probe.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {  # name: (b, sq, h, kv, lens)
    "llama-200m decode": (4, 1, 10, 10, [47, 100, 131, 18]),
    "yi-9b decode": (4, 1, 32, 4, [47, 100, 131, 18]),
    "llama-200m chunk": (4, 16, 10, 10, [16, 64, 100, 33]),
}


def device_split(torch, fn, reps: int = 3) -> dict:
    """Device ms per call of fn from one torch.profiler window: both GQA
    kernels together and the split and merge kernels apart (0 where a
    kernel did not run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {"split": 0.0, "merge": 0.0}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for part in us:
                if f"paged_gqa_{part}" in ev.key:
                    us[part] += ev.self_device_time_total
    return {"profiler_ms": (us["split"] + us["merge"]) / 1e3 / reps,
            "split_kernel_ms": us["split"] / 1e3 / reps,
            "merge_kernel_ms": us["merge"] / 1e3 / reps}


def f64_attention(torch, q, k, v, pos, window=None):
    """The plain version's attention in float64 over gathered (B, T, KV, d)
    views: causal per absolute position (and windowed), IEEE softmax."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qd = q.double().reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqgrd,btgd->bgrqt", qd, k.double()) / hd ** 0.5
    qpos = pos.long()[:, None] + torch.arange(sq, device=q.device)[None]
    kj = torch.arange(k.shape[1], device=q.device)[None, None]
    ok = kj <= qpos[..., None]
    if window is not None:
        ok &= kj > qpos[..., None] - window
    p = torch.softmax(torch.where(ok[:, None, None], s, -1e30), -1)
    return torch.einsum("bgrqt,btgv->bqgrv", p, v.double()).reshape(b, sq, h, -1)


# chip_smoke.py's yi-9b split cases (phase_gqa_splits), over the bf16 pool
ACCURACY_CASES = {
    "yi-9b chunk B4 Sq16 H32 KV4": (301, dict(b=4, sq=16, lens=[16, 64, 100, 33])),
    "window 50, Sq 16, yi-9b heads": (306, dict(b=2, sq=16, lens=[256, 70],
                                                window=50)),
}


def accuracy(torch, cs, F, ops, PA, KV):
    """Kernel and plain version against float64 over the bf16 pool with
    yi-9b's heads at the 3x data of chip_smoke.py's split cases."""
    def outside(a, b):
        return int(((a.double() - b.double()).abs()
                    > 5e-6 + 1e-5 * b.double().abs()).sum())
    rows = []
    for label, (seed, c) in ACCURACY_CASES.items():
        c = dict(c)
        window = c.pop("window", None)
        q, k, v, table, pos = cs.gqa_q_case(
            torch, F, h=32, kv=4, hd=128, bs=16, maxb=16, seed=seed,
            packed=False, **c)
        out = ops.paged_gqa(q, k, v, table, pos, window=window)
        ref = PA.paged_gqa_plain(q, k, v, table, pos, window=window)
        truth = f64_attention(torch, q, KV.gather_view(k, table),
                              KV.gather_view(v, table), pos, window)
        row = dict(case=label + ", bf16 pool, 3x data",
                   kernel_vs_plain=(out - ref).abs().max().item(),
                   kernel_outside_bar_of_plain=outside(out, ref),
                   kernel_vs_f64=(out.double() - truth).abs().max().item(),
                   plain_vs_f64=(ref.double() - truth).abs().max().item(),
                   kernel_outside_bar_of_f64=outside(out, truth),
                   plain_outside_bar_of_f64=outside(ref, truth))
        print("accuracy: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                       else f"{k} {v}" for k, v in row.items()),
              flush=True)
        rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split-keys", type=int, nargs="+", default=[16, 32, 64])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("gqa_split_probe: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    default_keys = PA.SPLIT_KEYS
    for shape, (b, sq, h, kv, lens) in SHAPES.items():
        for packed in (False, True):
            name = "paged_gqa_q" if packed else "paged_gqa"
            kern = ops.paged_gqa_q if packed else ops.paged_gqa
            plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
            calls = [cs.gqa_q_case(torch, F, b=b, sq=sq, h=h, kv=kv, hd=128,
                                   bs=16, maxb=16, lens=lens, seed=100 + i,
                                   packed=packed) for i in range(10)]
            sd = []
            for c in calls:
                q, table, pos = c[0], c[-2], c[-1]
                pools = ((KV.PackedKV(c[1], c[2]), KV.PackedKV(c[3], c[4]))
                         if packed else (c[1], c[2]))
                k, v = (KV.gather_view(p, table) for p in pools)
                sd.append(cs.gather_sdpa(torch, q, k, v, pos))
            sdpa = lambda sd=sd: [f() for f in sd]
            lib_ms = cs.time_ms(torch, sdpa, 20)
            lib_dev = cs.device_ms(torch, sdpa, "")
            for keys in args.split_keys:
                PA.SPLIT_KEYS = keys
                p = PA.plan(b, sq, h, kv, 16, 16, 128)
                out = kern(*calls[0])
                torch.cuda.synchronize()
                cs.check_against_plain(torch, name, out, plain(*calls[0]), (),
                                       f"{shape} split {keys}")
                fn = lambda calls=calls, kern=kern: [kern(*c) for c in calls]
                row = dict(shape=shape, kernel=name, split_keys=keys,
                           splits=p.splits, ctas=p.grid,
                           row_groups=p.row_groups,
                           ms=cs.time_ms(torch, fn, 20),
                           **device_split(torch, fn),
                           sdpa_ms=lib_ms, sdpa_profiler_ms=lib_dev)
                rows.append(row)
                print(f"{shape:18s} {name:11s} split {keys:3d} keys: "
                      f"{p.splits:2d} splits, {p.grid:4d} CTAs, events "
                      f"{row['ms']:.4f} ms, profiler {row['profiler_ms']:.4f} ms "
                      f"(split {row['split_kernel_ms']:.4f} + merge "
                      f"{row['merge_kernel_ms']:.4f}) "
                      f"(SDPA {lib_ms:.4f}, profiler {lib_dev:.4f}) per 10 calls",
                      flush=True)
    PA.SPLIT_KEYS = default_keys
    acc = accuracy(torch, cs, F, ops, PA, KV)
    print(card)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gqa_split_probe.json").write_text(json.dumps(
        {"card": card, "rows": rows, "accuracy": acc}, indent=1))


if __name__ == "__main__":
    main()
