"""Serve a model through the port's continuous-batching engine.

    python -m repro_torch.launch.serve --arch llama_200m [--tokens 32] [--kv-quant]
        [--dense] [--legacy]
        [--prefix-cache [--prefix-spill] [--host-budget-bytes N]]
        [--scheduler fifo|latency] [--shared-prefix N]
        [--spec-k K --draft-layers L] [--temperature T] [--top-k K]
        [--disagg] [--obs] [--http PORT]
        [--data-shards N [--shard-devices DEV,DEV,...]]

Builds seeded random weights, packed as they are drawn (quartet2: NVFP4 4/6;
`serve.prequant.init_packed`, with one chunk of f32 matrices alive at a
time, so every config of the registry fits one card at its published widths
but deepseek-v3; rwkv6_7b and recurrentgemma_9b included). On the CPU they are bitwise the prequantized `lm.init`; on
the card only leaves of at most one chunk of matrices are, since the card's
generator draws other numbers when a leaf is drawn in pieces. It serves
`--batch` requests through `ServeEngine` on the paged bf16 pool
(`--kv-quant`: the NVFP4 pool; `--dense`: dense per-slot caches), and prints
prefill and decode tokens per second labelled with the device they ran on.
`--legacy` runs the fixed-batch seed loop instead
(`serve.decode.greedy_generate`: one prefill of the `--batch` prompts, then
batched single-token steps over dense caches, every weight re-quantized at
every step) and prints its tokens per second. `--shared-prefix N` serves
N requests over one `--prompt-len`-token system prompt, each with 4 tokens
of its own, through a cold engine (cache off) and a hot one (prefix cache
on, primed with the system prompt), and prints the prefill tokens the hot
engine skipped and its cache hit rate. `--spec-k K --draft-layers L`
decodes self-speculatively (the first L layers draft K tokens a round, the
full model verifies them in one chunk) and prints the acceptance rate and
the tokens each slot emits a round; `--temperature` and `--top-k` set every
request's sampling (greedy by default). `--disagg` serves through a disaggregated pair instead
(`serve.frontend.make_disagg_pair`: a prefill worker hands each finished
prompt's KV to a decode worker through pinned host buffers; one set of
weights) and prints the handoffs and both pools' free blocks. `--obs`
attaches an `obs.Instrumentation` (registry counters, request traces) and
prints the traces' TTFT, queue-wait and per-token decode percentiles.
`--data-shards N` serves through a mesh-sharded engine
(`EngineConfig(mesh=launch.mesh.make_serve_mesh(N, 1, devices=...))`: the
slots and the slot-affine pool split over N data shards, each shard's step
on its own device; the counterpart of the reference's
`examples/serve_decode.py --data-shards`) and prints each shard's free
blocks. `--model-shards M` splits every linear weight's out-features (and
the embedding's and the head's vocab rows) over M model devices a data
shard, the rest of each step on its first device
(`make_serve_mesh(N, M, ...)`; the dense GQA families), and prints each
device's resident packed weight bytes. `--shard-devices` names the
devices, N x M in (data, model) order (`cuda:0,cuda:0` puts two shards on
one card); without it each takes a card of its own (fewer cards than
shards refuse), or the CPU under `--device cpu`. `--http PORT`
serves the engine the other flags build over HTTP instead
(`serve/frontend.py`: POST /v1/completions with SSE streaming, /metrics,
/healthz, /v1/stats, /admin/drain) on 127.0.0.1:PORT until interrupted; 0
binds an ephemeral port, and the bound port is printed. Requests over
`--prompt-len` + `--tokens` positions are refused as unservable. Runs on the
card unless `--device cpu` is given (`--reduced` shrinks the model to its
CPU smoke size). Enc-dec models (whisper_tiny) are not served, as in the
reference: the command exits naming the explicit encoder path
(`lm.forward`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.dist.sharding import packed_bytes
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import lm
from repro_torch.obs import Instrumentation, MetricsRegistry
from repro_torch.serve.decode import greedy_generate
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.frontend import (FrontendConfig, make_disagg_pair,
                                        serve_forever)
from repro_torch.serve.prequant import init_packed
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import FifoPolicy, LatencyPolicy

SHARED_SUFFIX = 4   # --shared-prefix: each request's own tokens


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"{torch.cuda.get_device_name(device)} "
                f"(x{torch.cuda.device_count()})")
    return "cpu"


def _engine(cfg, params, econf, disagg: bool = False):
    if disagg:
        return make_disagg_pair(cfg, params, econf)
    return ServeEngine(cfg, params, econf)


def _serve(cfg, params, econf, prompts, max_new, sampling=SamplingParams(),
           disagg=False):
    t0 = time.perf_counter()
    eng = _engine(cfg, params, econf, disagg)
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
                                         prefix_spill=False, obs=None),
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


def _legacy(cfg, params, args, rng, device, label) -> dict:
    """The fixed-batch seed loop over `--batch` prompts of `--prompt-len`
    tokens: wall time of the whole `greedy_generate` call, synchronized."""
    prompts = rng.randint(0, cfg.vocab, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    gen = greedy_generate(params, cfg, args.scheme, prompts, args.tokens,
                          device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    n = args.batch * args.tokens
    out = {"device": label, "arch": cfg.name, "scheme": args.scheme,
           "legacy": True, "requests": args.batch, "wall_s": wall,
           "tok_s": n / wall, "tokens": gen.cpu().tolist()}
    print(f"[{label}] {cfg.name} {args.scheme} legacy loop: generate "
          f"{args.batch}x{args.tokens} tokens in {wall * 1e3:.0f} ms = "
          f"{out['tok_s']:.1f} tok/s")
    print("sample ids:", out["tokens"][0][:8])
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
    ap.add_argument("--dense", action="store_true",
                    help="dense per-slot caches instead of the paged pool")
    ap.add_argument("--legacy", action="store_true",
                    help="the fixed-batch greedy loop (greedy_generate) "
                    "instead of the engine")
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
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode (EnginePair)")
    ap.add_argument("--obs", action="store_true",
                    help="attach an obs.Instrumentation (metrics, traces)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP on 127.0.0.1:PORT (0: ephemeral)")
    ap.add_argument("--data-shards", type=int, default=1, metavar="N",
                    help="mesh-sharded serving over N data shards")
    ap.add_argument("--model-shards", type=int, default=1, metavar="M",
                    help="split linear weights over M model devices a data "
                    "shard")
    ap.add_argument("--shard-devices", default=None, metavar="DEV,...",
                    help="the shards' devices, data x model in (data, model) "
                    "order (default: a card a shard; the CPU under --device "
                    "cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU smoke size (ArchConfig.reduced)")
    args = ap.parse_args(argv)
    if args.dense and (args.shared_prefix or args.prefix_cache
                       or args.prefix_spill):
        ap.error("the prefix cache shares pool blocks: it needs the paged "
                 "pool (drop --dense)")
    if args.disagg and (args.dense or args.legacy or args.shared_prefix
                        or args.spec_k):
        ap.error("--disagg hands paged blocks from a prefill worker to a "
                 "decode worker: drop --dense, --legacy, --shared-prefix "
                 "and --spec-k")
    sharded = args.data_shards > 1 or args.model_shards > 1
    if sharded and (args.legacy or args.disagg):
        ap.error("--data-shards and --model-shards shard the engine: drop "
                 "--legacy and --disagg")
    if args.model_shards > 1 and args.dense:
        ap.error("--model-shards serves the paged pool: drop --dense")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.enc_dec:  # the reference's ServeEngine refuses enc-dec alike
        raise SystemExit(f"{cfg.name}: enc-dec serving: use the explicit "
                         "encoder path (examples)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # the seed loop re-quantizes raw weights every step, as the reference's;
    # the engine serves them packed as drawn
    params = (lm.init(cfg, gen, device) if args.legacy else
              init_packed(cfg, gen, args.scheme, device))
    block = 16
    extra = SHARED_SUFFIX if args.shared_prefix else 0
    max_len = -(-(args.prompt_len + extra + args.tokens + args.spec_k)
                // block) * block
    rng = np.random.RandomState(args.seed)
    label = device_label(device)
    if args.legacy:
        return _legacy(cfg, params, args, rng, device, label)
    mesh = None
    if sharded:
        n = args.data_shards * args.model_shards
        names = (args.shard_devices.split(",") if args.shard_devices
                 else [str(device)] * n if device.type == "cpu" else None)
        mesh = make_serve_mesh(args.data_shards, args.model_shards,
                               devices=names)
    econf = EngineConfig(
        n_slots=min(args.batch, args.shared_prefix or args.batch),
        max_len=max_len, block_size=block, scheme=args.scheme,
        paged=not args.dense, prequant=False,  # packed as drawn
        base_seed=args.seed, kv_quant=args.kv_quant,
        prefix_cache=args.prefix_cache or args.prefix_spill,
        prefix_spill=args.prefix_spill,
        host_budget_bytes=args.host_budget_bytes,
        scheduler=LatencyPolicy() if args.scheduler == "latency"
        else FifoPolicy(), spec_k=args.spec_k,
        draft_layers=args.draft_layers, device=str(device), mesh=mesh,
        obs=Instrumentation(registry=MetricsRegistry()) if args.obs else None)
    if args.http is not None:
        def ready(port):
            print(f"[{label}] {cfg.name} {args.scheme}: serving "
                  f"http://127.0.0.1:{port}/v1/completions (port {port})",
                  flush=True)

        try:
            serve_forever(_engine(cfg, params, econf, args.disagg),
                          FrontendConfig(port=args.http), on_ready=ready)
        except KeyboardInterrupt:
            pass  # Ctrl-C: the bridge and the socket are closed on the way
        return {}
    if args.shared_prefix:
        return _shared_prefix(cfg, params, econf, args, rng, label)
    prompts = [rng.randint(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.batch)]
    eng, results, setup_s, wall = _serve(
        cfg, params, econf, prompts, args.tokens,
        SamplingParams(args.temperature, args.top_k), args.disagg)
    st = eng.stats
    pools = [eng.prefill.pool, eng.decode.pool] if args.disagg else [eng.pool]
    out = {
        "device": label, "arch": cfg.name, "scheme": args.scheme,
        "requests": len(results), "setup_s": setup_s, "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
        "decode_tok_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
        "free_blocks": sum(p.free_block_count for p in pools),
        "n_blocks": sum(p.n_blocks for p in pools),
    }
    shards = ""
    if mesh is not None:
        out.update(data_shards=mesh.data, model_shards=mesh.model,
                   shard_devices=[str(d) for d in mesh.devices],
                   free_by_shard=eng.pool.utilization()["free_by_shard"])
        shards = (f", {mesh.data} data shards on "
                  f"{','.join(out['shard_devices'])} (free blocks by shard "
                  f"{out['free_by_shard']})")
        if mesh.model > 1:
            out["packed_bytes"] = [[packed_bytes(t, j)
                                    for j in range(mesh.model)]
                                   for t in eng.shard_params]
            out["packed_bytes_whole"] = packed_bytes(params)
            shards += (f", {mesh.model} model shards a data shard: resident "
                       f"packed bytes by (data, model) device "
                       f"{out['packed_bytes']} of {out['packed_bytes_whole']}")
    disagg = ""
    if args.disagg:
        out.update(disagg=True, handoffs=st["handoffs"],
                   decode_prefill_steps=eng.decode.stats["prefill_steps"])
        disagg = (f", disaggregated: handoffs {out['handoffs']}, prefill "
                  f"forwards on the decode worker "
                  f"{out['decode_prefill_steps']}")
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
          f"{out['decode_tok_s']:.1f} tok/s{spec}{disagg}{shards}, wall "
          f"{wall:.2f} s, "
          f"pool blocks free {out['free_blocks']}/{out['n_blocks']}")
    if eng.obs.enabled:
        out["traces"] = agg = eng.obs.trace_sink.aggregates()
        print(f"[{out['device']}] traces of {agg['retired']} requests: "
              + ", ".join(f"{k} p50 {agg[k]['p50'] * 1e3:.2f} ms p99 "
                          f"{agg[k]['p99'] * 1e3:.2f} ms"
                          for k in ("queue_wait_s", "ttft_s", "decode_tok_s")))
    print("sample ids:", results[0].tokens[:8] if results else [])
    return out


if __name__ == "__main__":
    main()
