#!/usr/bin/env python3
"""Measurements of the MLA decode kernels (#7 `ops.paged_mla`: the
tensor-core `paged_mla_tc_kernel` + `paged_mla_merge_kernel`, or in an older
checkout the CUDA-core `paged_mla_kernel`; #8 `ops.paged_mla_q`:
`paged_mla_split_kernel` + `paged_mla_merge_kernel`) on one NVIDIA GPU, for
PERF.md.

    python3 tools/mla_probe.py --trees PARENT CHANGE CHANGE PARENT

For each checkout in turn (one fresh process each, its kernels built into
its own build/): one deepseek-v3 decode step's calls of #7 and #8
(`chip_smoke.mla_step_group`: 2 layers, 4 rows, H 128, lora 512, rope 64,
BS 16) at phase 3's lengths (40, 57, 72, 25 tokens), at 4 rows x 4,096
tokens, and as 16-token prefill chunks (Sq 16 over rows of 16, 64, 100, 33
tokens, phase 3's chunk case): CUDA-event time, the device time of every kernel the calls launch
(torch.profiler, so the checkout's kernel names do not matter), kernels a
call and their names, the bound, and SDPA over the gathered view as the
yardstick. With --waves, #7 of the second tree (CHANGE in the order above) is
timed again with
`paged_attention.MLA_TC_WAVE` set to each value (the wave its split count
fills).

Prints one line per measurement and writes everything to --out as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, sys
tree, root, waves = sys.argv[1], sys.argv[2], [int(w) for w in sys.argv[3:]]
sys.path[:0] = [tree + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.core import formats as F
from repro_torch.kernels import build, ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.serve import kv_pool as KV
build.library()


def kernel_names(fn):  # the CUDA kernels one call of fn launches, by short name
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    keys = {ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
    return sorted({(re.findall(r"[A-Za-z_]\w*_kernel", k) or [k[:40]])[0] for k in keys})


out = {}
default_wave = getattr(PA, "MLA_TC_WAVE", None)
runs = [(False, "paged_mla", None), (True, "paged_mla_q", None)]
runs += [(False, f"paged_mla wave {w}", w) for w in waves]
for label, lens, maxb, reps, sq in (("phase3", [40, 57, 72, 25], 16, 20, 1),
                                    ("4x4096", [4096] * 4, 256, 5, 1),
                                    ("chunk16", [16, 64, 100, 33], 16, 20, 16)):
    for packed, name, wave in runs:
        PA.MLA_TC_WAVE = wave or default_wave
        r = cs.mla_step_group(torch, F, PA, ops, KV, packed, lens, maxb, reps,
                              seed=500, plain_reps=0, sq=sq)
        dev, kernels = cs.call_device_ms(torch, r["fn"])
        t_bytes = r["bytes"] / cs.HBM_BYTES_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        out[f"{name} {label}"] = {
            "calls": r["calls"], "ms": r["ms"], "profiler_ms": dev,
            "kernels_per_call": kernels / r["calls"], "kernels": kernel_names(r["fn"]),
            "library_ms": r["library_ms"],
            "library_profiler_ms": r["library_profiler_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del r
        torch.cuda.empty_cache()
print("PROBE_JSON " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path, waves=()) -> dict:
    p = subprocess.run([sys.executable, "-c", WORKER, str(tree), str(ROOT),
                        *map(str, waves)], capture_output=True, text=True)
    for line in p.stdout.splitlines():
        if line.startswith("PROBE_JSON "):
            return json.loads(line[len("PROBE_JSON "):])
    sys.exit(f"mla_probe: run in {tree} failed (rc {p.returncode}):\n"
             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "mla_probe.json"))
    ap.add_argument("--waves", nargs="*", type=int, default=[],
                    help="also time #7 of the second tree with MLA_TC_WAVE set to "
                         "each of these (CTAs of one wave: the split choice)")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("mla_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    out = {"card": card, "trees": []}
    for i, tree in enumerate(a.trees):
        r = run_tree(Path(tree).resolve(), a.waves if i == 1 else ())
        out["trees"].append({"tree": tree, **r})
        for name, v in r.items():
            print(f"{tree}: {name}: {v['calls']} calls, {v['kernels_per_call']:.2f} "
                  f"kernels a call ({', '.join(v['kernels'])}): events {v['ms']:.4f} ms, "
                  f"device {v['profiler_ms']} "
                  f"ms, SDPA {v['library_ms']:.4f} ms (device {v['library_profiler_ms']}), "
                  f"bound {v['bound_ms']:.5f} ms ({v['bound_by']})", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
