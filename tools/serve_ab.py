#!/usr/bin/env python3
"""Interleaved A/B of chip_smoke.py's llama-200m serving phases between two
checkouts on one NVIDIA GPU.

    python3 tools/serve_ab.py PARENT_DIR CHANGE_DIR [--pairs 6] [--out FILE]

Each run is a fresh Python process in one checkout that calls that
checkout's own `chip_smoke.phase_serving` twice, over the bf16 pool (phase 4)
and over the NVFP4 pool (phase 4b), after building its kernels (once per
checkout, into its own build/, before the first pair). Pairs alternate which
side runs first (parent, change, change, parent, ...), so drift in the host's
load falls on both sides. Prints one line per run (decode tok/s, host ms per
decode step, device ms per decode step, TTFT median) and, per metric, the
medians of both sides and how many pairs the change won; writes every run to
--out as JSON. Exits 1 if a run fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
out = {}
for name, kvq in (("bf16", False), ("nvfp4", True)):
    r = cs.phase_serving(torch, "", kv_quant=kvq)
    prof = r.get("profile") or {}
    out[name] = {"decode_tok_s": r["decode_tok_s"], "decode_step_ms": r["decode_step_ms"],
                 "ttft_s_median": r["ttft_s_median"],
                 "device_ms_per_step": prof.get("device_ms_per_step")}
print("AB_JSON " + json.dumps(out), flush=True)
"""

BUILD = ("import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import build; build.library()")

METRICS = (("decode_tok_s", "tok/s", True), ("decode_step_ms", "host ms/step", False),
           ("device_ms_per_step", "device ms/step", False),
           ("ttft_s_median", "TTFT median s", False))


def run(tree: Path) -> dict:
    p = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                       text=True)
    for line in p.stdout.splitlines():
        if line.startswith("AB_JSON "):
            return json.loads(line[len("AB_JSON "):])
    sys.exit(f"serve_ab: run in {tree} failed (rc {p.returncode}):\n"
             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/serve_ab.json"))
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    for tree in trees.values():
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True,
                       capture_output=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    runs = []
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        pair = {}
        for side in order:
            pair[side] = run(trees[side])
            for pool, r in pair[side].items():
                dev = r["device_ms_per_step"]
                print(f"pair {i} {side:6s} {pool:5s}: {r['decode_tok_s']:.2f} tok/s, "
                      f"host {r['decode_step_ms']:.2f} ms/step, device "
                      f"{'n/a' if dev is None else f'{dev:.3f}'} ms/step, TTFT "
                      f"median {r['ttft_s_median']:.3f} s", flush=True)
        runs.append(pair)
    for pool in ("bf16", "nvfp4"):
        for key, label, higher_better in METRICS:
            vals = {side: [p[side][pool][key] for p in runs
                           if p[side][pool][key] is not None] for side in trees}
            if not all(vals.values()):
                continue
            wins = sum((p["change"][pool][key] > p["parent"][pool][key]) == higher_better
                       for p in runs if p["change"][pool][key] != p["parent"][pool][key])
            print(f"{pool:5s} {label:15s} median parent "
                  f"{statistics.median(vals['parent']):.3f}, change "
                  f"{statistics.median(vals['change']):.3f}; change better in "
                  f"{wins} of {len(runs)} pairs")
    print(card)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
