#!/usr/bin/env python3
"""What the serving engine's instrumentation (`obs/`) costs on the host, on
one NVIDIA GPU.

    python3 tools/obs_ab.py [--pairs 12] [--steps 16] [--out FILE]

Two engines over chip_smoke.py's llama-200m weights (seed 0; quartet2, the
bf16 pool, 4 slots), one with `EngineConfig(obs=Instrumentation())` and one
without, each filled with 4 requests of phase 4's prompts cut to 16 tokens,
all decoding. Then `--pairs` pairs of `--steps`-step windows of direct
`engine.step()` calls in the main thread (host clock, synchronized at both
ends), alternating which engine runs first. Prints the medians and
quartiles of host ms a decode step for both, how many pairs obs-off won,
and the host ms a step spent inside the obs hooks themselves (every
`Instrumentation.on_*` call and the scheduler's `observe`, timed by
wrappers) and inside the registry-backed stats view. Writes every window to
--out as JSON. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"p25": q[0], "median": statistics.median(xs), "p75": q[2]}


def _timed(obj, name, acc):
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[0] += time.perf_counter() - t0

    setattr(obj, name, wrapped)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "obs_ab.json"))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("obs_ab: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.obs import instrumentation as I
    from repro_torch.serve.engine import Request
    build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = registry.get("llama_200m")
    params = cs.llama_weights(torch)
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 101, (8,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in lens]
    obs = cs.new_obs()
    engines = {"off": cs.http_engine(cfg, params, "cuda"),
               "on": cs.http_engine(cfg, params, "cuda", obs=obs)}
    budget = args.pairs * args.steps + 8  # each engine runs pairs windows
    for eng in engines.values():
        for p in prompts[:4]:
            eng.submit(Request(p[:16], budget))
        while any(s.state != "decode" for s in eng.slots):
            eng.step()
    hooks, view = [0.0], [0.0]
    for name in [n for n in dir(obs) if n.startswith("on_")]:
        _timed(obs, name, hooks)
    _timed(engines["on"].sched, "observe", hooks)
    for name in ("__getitem__", "__setitem__"):
        _timed(I._StatsView, name, view)

    def window(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.steps * 1e3

    ms = {"off": [], "on": []}
    hooks[0] = view[0] = 0.0
    for i in range(args.pairs):
        for k in (("off", "on") if i % 2 == 0 else ("on", "off")):
            ms[k].append(window(engines[k]))
    won = sum(a < b for a, b in zip(ms["off"], ms["on"]))
    steps_on = args.pairs * args.steps
    out = {"card": card, "pairs": args.pairs, "steps": args.steps,
           "off": _quartiles(ms["off"]), "on": _quartiles(ms["on"]),
           "off_won": won, "hook_ms_per_step": hooks[0] / steps_on * 1e3,
           "stats_view_ms_per_step": view[0] / steps_on * 1e3, "windows": ms}
    Path(args.out).parent.mkdir(exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    for k in ("off", "on"):
        q = out[k]
        print(f"obs {k:3s}: host ms a decode step median {q['median']:.3f} "
              f"(quartiles {q['p25']:.3f}-{q['p75']:.3f}) over {args.pairs} "
              f"windows of {args.steps} steps")
    print(f"obs off faster in {won} of {args.pairs} pairs; inside the hooks "
          f"{out['hook_ms_per_step']:.4f} ms a step, inside the stats view "
          f"{out['stats_view_ms_per_step']:.4f} ms a step")


if __name__ == "__main__":
    main()
