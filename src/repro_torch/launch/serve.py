"""Serve a model through the port's continuous-batching engine.

    python -m repro_torch.launch.serve --arch llama_200m [--tokens 32]

Builds seeded random weights, prequantizes them (quartet2: NVFP4 4/6 packed
weights), serves `--batch` requests through `ServeEngine` on the paged bf16
pool, and prints prefill and decode tokens per second labelled with the
device they ran on. Runs on the card unless `--device cpu` is given
(`--reduced` shrinks the model to its CPU smoke size).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"{torch.cuda.get_device_name(device)} "
                f"(x{torch.cuda.device_count()})")
    return "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama_200m")
    ap.add_argument("--batch", type=int, default=4, help="requests (= slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32, help="new tokens each")
    ap.add_argument("--scheme", default="quartet2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU smoke size (ArchConfig.reduced)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(cfg, gen, device)
    block = 16
    max_len = -(-(args.prompt_len + args.tokens) // block) * block
    econf = EngineConfig(n_slots=args.batch, max_len=max_len, block_size=block,
                         scheme=args.scheme, base_seed=args.seed,
                         device=str(device))
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, econf)
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    for _ in range(args.batch):
        eng.submit(Request(rng.randint(0, cfg.vocab, args.prompt_len).tolist(),
                           args.tokens))
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    st = eng.stats
    out = {
        "device": device_label(device), "arch": cfg.name, "scheme": args.scheme,
        "requests": len(results), "setup_s": setup_s, "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
        "decode_tok_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
        "free_blocks": eng.pool.free_block_count,
        "n_blocks": eng.pool.n_blocks,
    }
    print(f"[{out['device']}] {cfg.name} {args.scheme}: {len(results)} "
          f"requests, prefill {out['prefill_tok_s']:.1f} tok/s, decode "
          f"{out['decode_tok_s']:.1f} tok/s, wall {wall:.2f} s, pool blocks "
          f"free {out['free_blocks']}/{out['n_blocks']}")
    print("sample ids:", results[0].tokens[:8] if results else [])
    return out


if __name__ == "__main__":
    main()
