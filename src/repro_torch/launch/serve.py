"""Serve a model through the port's continuous-batching engine.

    python -m repro_torch.launch.serve --arch llama_200m [--tokens 32] [--kv-quant]
        [--prefix-cache [--prefix-spill] [--host-budget-bytes N]]
        [--scheduler fifo|latency] [--shared-prefix N]
        [--spec-k K --draft-layers L] [--temperature T] [--top-k K]

Builds seeded random weights, prequantizes them (quartet2: NVFP4 4/6 packed
weights), serves `--batch` requests through `ServeEngine` on the paged bf16
pool (`--kv-quant`: the NVFP4 pool), and prints prefill and decode tokens
per second labelled with the device they ran on. `--shared-prefix N` serves
N requests over one `--prompt-len`-token system prompt, each with 4 tokens
of its own, through a cold engine (cache off) and a hot one (prefix cache
on, primed with the system prompt), and prints the prefill tokens the hot
engine skipped and its cache hit rate. `--spec-k K --draft-layers L`
decodes self-speculatively (the first L layers draft K tokens a round, the
full model verifies them in one chunk) and prints the acceptance rate and
the tokens each slot emits a round; `--temperature` and `--top-k` set every
request's sampling (greedy by default). Runs on the card unless `--device
cpu` is given (`--reduced` shrinks the model to its CPU smoke size).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import FifoPolicy, LatencyPolicy

SHARED_SUFFIX = 4   # --shared-prefix: each request's own tokens


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"{torch.cuda.get_device_name(device)} "
                f"(x{torch.cuda.device_count()})")
    return "cpu"


def _serve(cfg, params, econf, prompts, max_new, sampling=SamplingParams()):
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, econf)
    setup_s = time.perf_counter() - t0
    for p in prompts:
        eng.submit(Request(p, max_new, sampling))
    t0 = time.perf_counter()
    results = eng.run()
    return eng, results, setup_s, time.perf_counter() - t0


def _shared_prefix(cfg, params, econf, args, rng, label) -> dict:
    """N requests over one system prompt, cold (cache off) then hot (cache
    on, primed with the system prompt alone; counts reset after it)."""
    system = rng.randint(0, cfg.vocab, args.prompt_len).tolist()
    prompts = [system + rng.randint(0, cfg.vocab, SHARED_SUFFIX).tolist()
               for _ in range(args.shared_prefix)]
    cold, _, _, cold_wall = _serve(
        cfg, params, dataclasses.replace(econf, prefix_cache=False,
                                         prefix_spill=False),
        prompts, args.tokens)
    eng = ServeEngine(cfg, params,
                      dataclasses.replace(econf, prefix_cache=True))
    eng.submit(Request(list(system), 1))
    eng.run()
    for k in eng.stats:
        eng.stats[k] = type(eng.stats[k])(0)
    for k in eng.cache.stats:
        eng.cache.stats[k] = type(eng.cache.stats[k])(0)
    for p in prompts:
        eng.submit(Request(p, args.tokens))
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    st, cs = eng.stats, eng.cache.stats
    out = {"device": label, "arch": cfg.name, "scheme": args.scheme,
           "requests": len(results), "wall_s": wall, "cold_wall_s": cold_wall,
           "prefill_tokens": st["prefill_tokens"],
           "cold_prefill_tokens": cold.stats["prefill_tokens"],
           "prefill_skipped_tokens": st["prefill_skipped_tokens"],
           "prefix_hits": st["prefix_hits"],
           "hit_rate": cs["hits"] / max(cs["lookups"], 1)}
    print(f"[{label}] {cfg.name} {args.scheme}: {len(results)} requests x "
          f"[{args.prompt_len} shared + {SHARED_SUFFIX} own] tokens: cold "
          f"prefill {out['cold_prefill_tokens']} tokens, wall {cold_wall:.2f} s; "
          f"hot prefill {out['prefill_tokens']} tokens "
          f"({out['prefill_skipped_tokens']} skipped in {out['prefix_hits']} "
          f"prefix hits), cache hit rate {out['hit_rate']:.2f}, wall {wall:.2f} s")
    print("sample ids:", results[0].tokens[:8] if results else [])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama_200m")
    ap.add_argument("--batch", type=int, default=4, help="requests (= slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32, help="new tokens each")
    ap.add_argument("--scheme", default="quartet2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quant", action="store_true",
                    help="NVFP4-quantized paged KV pool (PackedKV)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the pool")
    ap.add_argument("--prefix-spill", action="store_true",
                    help="the prefix cache's host-RAM tier")
    ap.add_argument("--host-budget-bytes", type=int, default=None)
    ap.add_argument("--scheduler", choices=("fifo", "latency"), default="fifo")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="N requests over one system prompt, cold vs hot")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft tokens a round")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers of the truncated-stack draft")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest logits (0: all)")
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
    extra = SHARED_SUFFIX if args.shared_prefix else 0
    max_len = -(-(args.prompt_len + extra + args.tokens + args.spec_k)
                // block) * block
    econf = EngineConfig(
        n_slots=min(args.batch, args.shared_prefix or args.batch),
        max_len=max_len, block_size=block, scheme=args.scheme,
        base_seed=args.seed, kv_quant=args.kv_quant,
        prefix_cache=args.prefix_cache or args.prefix_spill,
        prefix_spill=args.prefix_spill,
        host_budget_bytes=args.host_budget_bytes,
        scheduler=LatencyPolicy() if args.scheduler == "latency"
        else FifoPolicy(), spec_k=args.spec_k,
        draft_layers=args.draft_layers, device=str(device))
    rng = np.random.RandomState(args.seed)
    label = device_label(device)
    if args.shared_prefix:
        return _shared_prefix(cfg, params, econf, args, rng, label)
    prompts = [rng.randint(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.batch)]
    eng, results, setup_s, wall = _serve(
        cfg, params, econf, prompts, args.tokens,
        SamplingParams(args.temperature, args.top_k))
    st = eng.stats
    out = {
        "device": label, "arch": cfg.name, "scheme": args.scheme,
        "requests": len(results), "setup_s": setup_s, "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
        "decode_tok_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
        "free_blocks": eng.pool.free_block_count,
        "n_blocks": eng.pool.n_blocks,
    }
    spec = ""
    if args.spec_k:
        out["acceptance_rate"] = (st["accepted_tokens"]
                                  / max(st["draft_tokens"], 1))
        # each slot's round emits its accepted drafts plus one token
        slot_rounds = st["decode_tokens"] - st["accepted_tokens"]
        out["tokens_per_round"] = st["decode_tokens"] / max(slot_rounds, 1)
        spec = (f", spec_k {args.spec_k} over {args.draft_layers} draft "
                f"layers: acceptance {out['acceptance_rate']:.3f}, "
                f"{out['tokens_per_round']:.2f} tokens a slot a round")
    print(f"[{out['device']}] {cfg.name} {args.scheme}: {len(results)} "
          f"requests, prefill {out['prefill_tok_s']:.1f} tok/s, decode "
          f"{out['decode_tok_s']:.1f} tok/s{spec}, wall {wall:.2f} s, pool "
          f"blocks free {out['free_blocks']}/{out['n_blocks']}")
    print("sample ids:", results[0].tokens[:8] if results else [])
    return out


if __name__ == "__main__":
    main()
