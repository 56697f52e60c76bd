#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`src/repro_torch/`): proves on one NVIDIA
GPU that the port builds, that each hand-written kernel agrees with its plain
PyTorch version, and that the serving path runs through those kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. device  — a CUDA device must be present; prints the card's name and
               power limit as nvidia-smi reports them.
  2. build   — compiles the CUDA sources (kernels/csrc/*.cu) with nvcc.
  3. kernels — every kernel against its plain version at the shapes the
               llama-200m serving path gives it, with the port's bars; times
               one decode step's worth of calls of each (CUDA events): the
               kernel, the plain version, a PyTorch yardstick call, and the
               least time the card could take (bytes or operations).
               Then the whole paged step at reduced size, card against CPU.
  4. serving — full-width llama-200m (seeded random weights), quartet2,
               quantize-once weights, paged bf16 pool, 4 slots: 8 requests
               with ragged prompts of 16-100 tokens, 32 new tokens each,
               through ServeEngine; every kernel must have launched.
Then, on their own lines: the card (nvidia-smi), the kernels JSON, and last
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rates for the arithmetic each kernel does.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12   # tensor cores: bf16-exact block values, fp32 accumulate
F32_FLOPS = 67e12     # CUDA cores: the quantizer's and attention's f32 math
QUANT_FLOPS_PER_ELEMENT = 14  # 2 branches x (div, round, mul, sub, sq, add) + code

ARCH_SHAPES = {  # (N, K) of the 7 quantized linears of one dense layer
    "wq": (1280, 1280), "wk": (1280, 1280), "wv": (1280, 1280),
    "wo": (1280, 1280), "wi": (3456, 1280), "wg": (3456, 1280),
    "w2": (1280, 3456),
}
REPLACES = {
    "nvfp4_fos_quant": "src/repro/kernels/nvfp4_quant.py:101",
    "fp4_matmul": "src/repro/kernels/fp4_matmul.py:82",
    "paged_gqa": "src/repro/kernels/paged_attention.py:307",
}
SOURCES = {
    "nvfp4_fos_quant": "src/repro_torch/kernels/csrc/nvfp4_quant.cu",
    "fp4_matmul": "src/repro_torch/kernels/csrc/fp4_matmul.cu",
    "paged_gqa": "src/repro_torch/kernels/csrc/paged_attention.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_quant(torch, F, NQ, ops, x):
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    plain = NQ.nvfp4_fos_quant_plain(x)
    (pk, sk, gk), (pr, sr, gr) = kern, plain
    if not torch.equal(gk, gr) or not torch.equal(sk, sr):
        fail(f"nvfp4_fos_quant {tuple(x.shape)}: scales or gscale differ")

    def ordinal(p):
        c = F.unpack_fp4(p).long()
        return torch.where((c & 8) > 0, -(c & 7), c & 7)
    ok, orr = ordinal(pk), ordinal(pr)
    diff = ok != orr
    frac = diff.double().mean().item()
    step = int((ok - orr).abs().max().item())
    if frac >= 1e-4 or step > 1:
        fail(f"nvfp4_fos_quant {tuple(x.shape)}: code mismatch {frac} step {step}")
    deq = lambda p, s, g: F.fp4_decode(F.unpack_fp4(p)) * torch.repeat_interleave(
        F.bits_to_e4m3(s), F.GROUP, dim=-1) * g
    err = (deq(pk, sk, gk) - deq(pr, sr, gr)).abs().max().item()
    log(f"  nvfp4_fos_quant {str(tuple(x.shape)):14s} {str(x.dtype):15s} "
        f"code mismatch {frac:.2e} (max step {step}), max|d deq| {err:.3g}")
    return err


def check_matmul(torch, FM, ops, a, b):
    c = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2])
    torch.cuda.synchronize()
    ref = FM.fp4_matmul_plain(a[0], a[1], b[0], b[1], a[2], b[2])
    err = (c - ref).abs().max().item()
    bar = 1e-5 * ref.abs().max().item()
    shape = (a[0].shape[0], b[0].shape[0], a[0].shape[1] * 2)
    log(f"  fp4_matmul (M,N,K)={str(shape):18s} max|dC| {err:.3g} (bar {bar:.3g})")
    if not err <= bar:
        fail(f"fp4_matmul {shape}: {err} > {bar}")
    return err


def attn_case(torch, b, sq, h, kv, hd, bs, maxb, lens, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * maxb
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            table[i, j] = perm.pop()
    pos = torch.tensor([n - sq for n in lens], dtype=torch.int32)
    q = torch.randn((b, sq, h, hd), generator=g).bfloat16()
    kp = torch.randn((n_blocks, bs, kv, hd), generator=g).bfloat16()
    vp = torch.randn((n_blocks, bs, kv, hd), generator=g).bfloat16()
    return [t.cuda() for t in (q, kp, vp, table, pos)]


def check_attn(torch, PA, ops, case, name):
    q, kp, vp, table, pos = case
    out = ops.paged_gqa(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    ref = PA.paged_gqa_plain(q, kp, vp, table, pos)
    err = (out - ref).abs().max().item()
    bad = ((out - ref).abs() > 5e-6 + 1e-5 * ref.abs()).double().mean().item()
    log(f"  paged_gqa {name:32s} max|do| {err:.3g}, outside 5e-6/1e-5: {bad:.2e}")
    if bad > 0:
        fail(f"paged_gqa {name}: {bad} of elements outside the bar")
    return err


def attn_bytes_ops(q, kp, vp, table, pos):
    """Least bytes and operations of one paged_gqa call on these inputs: q
    and the output once, and the keys/values each query row needs."""
    b, sq, h, hd = q.shape
    kv, vd = kp.shape[2], vp.shape[3]
    keys = int((pos.long() + sq).clamp(min=0).sum())  # keys 0 .. newest query
    pairs = int(sum(sum(int(p) + s + 1 for s in range(sq)) for p in pos))
    nbytes = (q.numel() * q.element_size() + keys * kv * (hd + vd) * 2
              + table.numel() * 4 + pos.numel() * 4 + b * sq * h * vd * 4)
    ops = pairs * h * (2 * hd + 2 * vd)
    return nbytes, ops


def sdpa_yardstick(torch, q, kp, vp, table, pos, KV):
    """F.scaled_dot_product_attention over the gathered view (the yardstick
    PyTorch call; never used by the port)."""
    import torch.nn.functional as Fn
    kg = KV.gather_view(kp, table).transpose(1, 2)   # (B, KV, S, hd)
    vg = KV.gather_view(vp, table).transpose(1, 2)
    qt = q.transpose(1, 2)                           # (B, H, Sq, hd)
    sq, s = q.shape[1], kg.shape[2]
    qpos = pos[:, None].long() + torch.arange(sq, device=q.device)[None]
    mask = (torch.arange(s, device=q.device)[None, None] <= qpos[..., None])[:, None]
    return lambda: Fn.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask, enable_gqa=True)


def phase_kernels(torch):
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {k: 0.0 for k in REPLACES}
    log("phase 3: kernels against their plain versions")
    for m in (4, 64):
        for k in (1280, 3456):
            x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    weights = {}
    for name, (n, k) in ARCH_SHAPES.items():
        w = torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, w))
        weights[name] = ops.nvfp4_fos_quant(w)
    acts = {}
    for m in (4, 64):
        for k in (1280, 3456):
            acts[m, k] = ops.nvfp4_fos_quant(
                torch.randn((m, k), generator=g, device="cuda").bfloat16())
    for m in (4, 64):
        for name in ("wq", "wi", "w2"):
            w = weights[name]
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(
                torch, FM, ops, acts[m, w[0].shape[1] * 2], w))
    cases = {
        "llama-200m decode B4 Sq1 H10 KV10": dict(b=4, sq=1, h=10, kv=10, lens=[47, 100, 131, 18]),
        "llama-200m chunk B4 Sq16 H10 KV10": dict(b=4, sq=16, h=10, kv=10, lens=[16, 64, 100, 33]),
        "yi-9b decode B4 Sq1 H32 KV4": dict(b=4, sq=1, h=32, kv=4, lens=[47, 100, 131, 18]),
        "yi-9b chunk B4 Sq16 H32 KV4": dict(b=4, sq=16, h=32, kv=4, lens=[16, 64, 100, 33]),
    }
    for i, (name, c) in enumerate(cases.items()):
        case = attn_case(torch, hd=128, bs=16, maxb=16, seed=i, **c)
        errs["paged_gqa"] = max(errs["paged_gqa"], check_attn(torch, PA, ops, case, name))

    # ---- one decode step's worth of calls (llama-200m, 4 slots, 10 layers)
    log("phase 3: timing one decode step's worth of calls per kernel "
        "(10 layers, distinct weights per layer)")
    layers = 10
    layer_w = [{name: ops.nvfp4_fos_quant(torch.randn(
        (n, k), generator=g, device="cuda") * k ** -0.5)
        for name, (n, k) in ARCH_SHAPES.items()} for _ in range(layers)]
    dec_x = {k: torch.randn((4, k), generator=g, device="cuda").bfloat16()
             for k in (1280, 3456)}
    quant_in = [dec_x[1280]] * 6 + [dec_x[3456]]   # per layer: 6 at K=1280, 1 at 3456
    mm_calls = [(acts[4, w[0].shape[1] * 2], w) for lw in layer_w
                for w in lw.values()]
    blockvals = [(FM.block_values(a[0], a[1]).bfloat16(),
                  FM.block_values(w[0], w[1]).bfloat16().T.contiguous())
                 for a, w in mm_calls]
    attn_layers = [attn_case(torch, b=4, sq=1, h=10, kv=10, hd=128, bs=16,
                             maxb=16, lens=[47, 100, 131, 18], seed=100 + i)
                   for i in range(layers)]
    sdpa_calls = [sdpa_yardstick(torch, *c, KV) for c in attn_layers]

    def step_quant(fn):
        return lambda: [fn(x) for _ in range(layers) for x in quant_in]

    results = {}
    q_bytes = sum(x.numel() * 2 + x.numel() // 2 + x.numel() // 16 + 4
                  for x in quant_in) * layers
    q_ops = sum(x.numel() for x in quant_in) * layers * QUANT_FLOPS_PER_ELEMENT
    results["nvfp4_fos_quant"] = dict(
        ms=time_ms(torch, step_quant(ops.nvfp4_fos_quant), 20),
        plain_ms=time_ms(torch, step_quant(NQ.nvfp4_fos_quant_plain), 3),
        library_ms=None, bytes=q_bytes, ops=q_ops, peak=F32_FLOPS,
        calls=len(quant_in) * layers)
    mm_bytes = sum(a[0].numel() + a[1].numel() + w[0].numel() + w[1].numel()
                   + a[0].shape[0] * w[0].shape[0] * 4 + 8 for a, w in mm_calls)
    mm_ops = sum(2 * a[0].shape[0] * w[0].shape[0] * a[0].shape[1] * 2
                 for a, w in mm_calls)
    results["fp4_matmul"] = dict(
        ms=time_ms(torch, lambda: [ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2])
                                   for a, w in mm_calls], 20),
        plain_ms=time_ms(torch, lambda: [FM.fp4_matmul_plain(a[0], a[1], w[0], w[1], a[2], w[2])
                                         for a, w in mm_calls], 3),
        library_ms=time_ms(torch, lambda: [torch.matmul(a, w) for a, w in blockvals], 20),
        bytes=mm_bytes, ops=mm_ops, peak=BF16_FLOPS, calls=len(mm_calls))
    at_bytes, at_ops = map(sum, zip(*(attn_bytes_ops(*c) for c in attn_layers)))
    results["paged_gqa"] = dict(
        ms=time_ms(torch, lambda: [ops.paged_gqa(*c) for c in attn_layers], 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_plain(*c) for c in attn_layers], 3),
        library_ms=time_ms(torch, lambda: [f() for f in sdpa_calls], 20),
        bytes=at_bytes, ops=at_ops, peak=F32_FLOPS, calls=len(attn_layers))
    for name, r in results.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = errs[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name:16s} {r['calls']:3d} calls/step: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
            f"{r['ops'] / 1e9:.3f} GFLOP)")
    return results


def phase_small_reference(torch):
    """The paged step at reduced size: kernels on the card against the plain
    versions on the CPU, same weights and tokens."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import decode as serve_decode
    from repro_torch.serve.kv_pool import KVPool
    from repro_torch.serve.prequant import prequantize

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    for scheme in ("bf16", "quartet2"):
        outs = {}
        for d in ("cpu", "cuda"):
            p = prequantize(to(params, d), cfg, scheme)
            pool = KVPool(cfg, 2, 32, block_size=16, device=d)
            for s in range(2):
                pool.commit(s, 20)
                pool.ensure(s, 20)
            step = serve_decode.make_paged_serve_step(cfg, scheme)
            seq = []
            for start, size in ((0, 16), (16, 1), (17, 1), (18, 1)):
                lg, _ = step(p, pool.caches, pool.tables_device(),
                             toks[:, start:start + size].to(d),
                             torch.full((2,), start, dtype=torch.int32, device=d),
                             torch.ones(2, dtype=torch.bool, device=d))
                seq.append(lg.float().cpu())
            outs[d] = seq
        worst_abs = max((a - b).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
        worst_rel = max(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()
                        for a, b in zip(outs["cuda"], outs["cpu"]))
        finite = all(torch.isfinite(a).all() for a in outs["cuda"])
        log(f"  reduced llama-200m paged step, {scheme}: card vs CPU max|dlogit| "
            f"{worst_abs:.3g}, rel RMS {worst_rel:.3g}")
        # bf16: the sums differ in order only; quartet2: below the ~0.3
        # relative error that quantization itself adds at this size
        if not finite or (scheme == "bf16" and worst_abs > 2e-2) or worst_rel > 0.3:
            fail(f"reduced paged step ({scheme}): card disagrees with the CPU")


# --------------------------------------------------------------------------
# phase 4: serving through ServeEngine at full width
# --------------------------------------------------------------------------

def serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine, prompts,
               max_new):
    econf = EngineConfig(n_slots=4, max_len=256, block_size=16, prefill_chunk=16,
                         scheme="quartet2", prequant=True, device="cuda")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, econf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for p in prompts:
        eng.submit(Request(p, max_new))
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return eng, results, setup_s, time.perf_counter() - t0


def phase_serving(torch, card):
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    log("phase 4: serving full-width llama-200m (quartet2, prequant, paged, 4 slots)")
    cfg = registry.get("llama_200m")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 101, (8,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    # warm-up run (first launches, allocator, cuBLAS handles), not measured
    serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
               prompts[:2], 4)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng, results, setup_s, wall = serve_once(
        torch, cfg, params, EngineConfig, Request, ServeEngine, prompts, 32)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if sorted(r.req_id for r in results) != list(range(8)):
        fail(f"served {len(results)} of 8 requests")
    if any(len(r.tokens) != 32 for r in results):
        fail("a request returned the wrong number of tokens")
    vocab_ok = all(0 <= t < cfg.vocab for r in results for t in r.tokens)
    if not vocab_ok:
        fail("token ids outside the vocabulary")
    if eng.pool.free_block_count != eng.pool.n_blocks:
        fail(f"{eng.pool.n_blocks - eng.pool.free_block_count} pool blocks leaked")
    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")
    st = eng.stats
    ttft = sorted(r.ttft_s for r in results)
    out = {
        "prompt_lens": lens, "setup_s": setup_s, "wall_s": wall,
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "ttft_s_median": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "decode_steps": st["decode_steps"], "prefill_steps": st["prefill_steps"],
        "peak_mem_bytes": peak, "launches": launches,
        "launches_per_decode_step": None,
    }
    # launches of one decode step at full batch, counted on one tick
    fill_decode(eng, Request, prompts, 12)
    ops.reset_launches()
    eng.step()
    out["launches_per_decode_step"] = dict(ops.LAUNCHES)
    eng.run()
    # the logits of one full-width decode step are finite and shaped (4, 1, V)
    import numpy as np
    logits = eng._forward(np.zeros((4, 1), np.int32), np.zeros(4, np.int32),
                          np.zeros(4, bool))
    if tuple(logits.shape) != (4, 1, cfg.vocab) or not torch.isfinite(logits).all():
        fail("full-width logits are not finite of shape (4, 1, vocab)")
    log(f"  [{card}] 8 requests x 32 tokens: decode {out['decode_tok_s']:.1f} tok/s "
        f"({out['decode_step_ms']:.2f} ms/step), prefill {out['prefill_tok_s']:.1f} tok/s, "
        f"TTFT median {out['ttft_s_median'] * 1e3:.1f} ms max {out['ttft_s_max'] * 1e3:.1f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB, wall {wall:.2f} s")
    log(f"  launches on the main path: {launches}; per decode step: "
        f"{out['launches_per_decode_step']}")
    out["profile"] = profile_decode(torch, eng, Request, prompts,
                                    out["decode_step_ms"])
    return out


def fill_decode(eng, Request, prompts, max_new):
    """Admit 4 short requests and tick until every slot decodes (each has
    room for at least 8 more decode steps)."""
    for p in prompts[:4]:
        eng.submit(Request(p[:16], max_new))
    while any(s.state != "decode" for s in eng.slots):
        eng.step()


def profile_decode(torch, eng, Request, prompts, step_ms):
    """Device time by kernel over 8 decode steps at full batch
    (torch.profiler), and the device's busy share: device time per step over
    the decode step time measured without the profiler (`step_ms`; the
    profiler's own host overhead inflates the wall time of a traced step)."""
    from torch.profiler import ProfilerActivity, profile
    fill_decode(eng, Request, prompts, 16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    from torch.autograd import DeviceType
    rows = []
    total_us = 0.0
    for ev in prof.key_averages():  # device-side events only (no CPU ops)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            total_us += dev_us
    rows.sort(reverse=True)
    if total_us == 0:
        log("  profile: no device time in key_averages() (not measured)")
        return None
    dev_step_ms = total_us / 1e3 / 8
    busy = dev_step_ms / step_ms
    log(f"  profile of 8 decode steps: device time {dev_step_ms:.3f} ms/step "
        f"against a {step_ms:.2f} ms step: busy {busy:.1%}, idle {1 - busy:.1%}; "
        f"device time per step by kernel:")
    for us, key, n in rows[:10]:
        log(f"    {us / 1e3 / 8:8.4f} ms  {n // 8:4d}x  {key[:90]}")
    return {"device_ms_per_step": dev_step_ms, "busy_share": busy,
            "top": [(key, us / 1e3 / 8, n // 8) for us, key, n in rows[:12]]}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")

    log("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    log(f"  {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); {card}")

    log("phase 2: build")
    t0 = time.perf_counter()
    build.library()
    log(f"  built {build.BUILD_INFO['path']} in {time.perf_counter() - t0:.1f} s")
    spills = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    if spills:
        log("  ptxas reports spills: " + "; ".join(spills))

    kern = phase_kernels(torch)
    phase_small_reference(torch)
    serving = phase_serving(torch, card)

    kernels = []
    for k, r in kern.items():
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": serving["launches"][k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "device": name, "torch": torch.__version__,
         "build_s": build.BUILD_INFO.get("seconds"), "kernels": kernels,
         "kernel_detail": kern, "serving": serving}, indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
