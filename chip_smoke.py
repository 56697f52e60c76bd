#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`src/repro_torch/`): proves on one NVIDIA
GPU that the port builds, that each hand-written kernel agrees with its plain
PyTorch version, and that the serving path and the training path run through
those kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. device  — a CUDA device must be present; prints the card's name and
               power limit as nvidia-smi reports them.
  2. build   — compiles the CUDA sources (kernels/csrc/*.cu) with nvcc.
  3. kernels — every kernel against its plain version at the shapes the
               llama-200m serving path gives it, and the quantizer and the
               GEMM at every shape of one full-width training step (T =
               2048 bf16 activations; the forward, dX and dW GEMMs), with
               the port's bars; the quantizer also on both of its plan
               regimes at their boundaries and one past, at deepseek-v3's
               decode shapes and on edge inputs (zeros, one huge element
               in the last chunk, denormals), and timed as whole calls
               (every kernel a call launches) over one step of llama-200m
               decode (70 calls), deepseek-v3 decode (197) and training
               (140); the GEMM also at M = 1, 8, 16, 17 (both
               kernels and their boundary) and at deepseek-v3's decode
               shapes (M = 8 and 4), its bf16 output bitwise the f32
               output's cast, and timed over one deepseek-v3 decode step's
               calls and one training step's 210 GEMMs as well; times
               one decode step's worth of calls of each (CUDA events): the
               kernel, the plain version, a PyTorch yardstick call, and the
               least time the card could take (bytes or operations).
               The two MS-EDEN requant phases at every operand shape of one
               full-width training step (T = 2048 tokens), an M that is no
               multiple of 128 and an all-zero tensor, bitwise; phase 2
               both with uniforms hashed in the kernel from a key pair and
               with a uniforms tensor, one operand and both operands of
               each backward GEMM a launch; phase 1 also on every operand
               as the backward hands it (E^T, W^T, X^T as transposed views
               read in place); the quartet2 backward GEMM against its plain
               composition; the 280 phase-1 calls and the 140 two-operand
               phase-2 launches of one training step timed on those views
               (phase 1 also on contiguous copies; phase 2 also as 280
               one-operand launches on uniforms tensors, and the 280
               uniform draws it no longer needs timed apart). The packed
               GQA decode (#6) at llama-200m's decode and chunk shapes and
               the MLA decode over bf16 (#7, on the tensor cores) and NVFP4
               (#8) latent pools at deepseek-v3's (H 128, lora 512, rope 64;
               Sq 1 and 16, ragged lengths, an inactive row, 4 rows x 4,096
               tokens; each kernel's two calls bitwise equal), each timed
               over one decode step's calls at phase 6's lengths and at
               4,096 tokens (#7's bound at the bf16 tensor-core peak). The split-KV GQA decode (#5, #6) also on cases that
               stress its splits (yi-9b at Sq 1 and 16 over the NVFP4 pool;
               over both pools a 1,024-token row, lengths ending on a split
               edge and one past it, windows that leave whole splits dead),
               two calls bitwise equal. Every kernel's time is also read
               from the profiler (its own device time), and so is the
               yardstick call's. Then the whole paged step (llama-200m;
               deepseek-v3 with both pools) and a quartet2 train step at
               reduced size, card against CPU.
  4. serving — full-width llama-200m (seeded random weights), quartet2,
               quantize-once weights, paged bf16 pool, 4 slots: 8 requests
               with ragged prompts of 16-100 tokens, 32 new tokens each,
               through ServeEngine; every kernel must have launched.
  4b. the same with kv_quant=True (the NVFP4 pool): paged_gqa_q launched,
               paged_gqa not, the pool's token leaves uint8 at 0.28125x the
               bf16 bytes.
  6. deepseek-v3 at its published widths, depth cut to 2 layers (two whole
               MLA + MoE periods; 61 layers of 6.54 GB packed do not fit
               one card), quartet2, weights packed as drawn (init_packed),
               4 slots, 4 requests of 16-64 prompt tokens and 16 new tokens
               each, once with the bf16 latent pool (paged_mla) and once
               with the NVFP4 pool (paged_mla_q).
  5. training — full-width llama-200m, quartet2, AdamW, warmup-cosine at
               base lr 2e-3, batch 8 x seq 256 on the synthetic corpus, 6
               steps through `repro_torch.launch.train`: losses and weights
               finite, the last loss below the first, each of the four
               kernels of the path launched the expected number of times
               (phase 2 once per backward GEMM), and no SR uniform tensor
               drawn (phase 2 hashes them); then one step under the
               profiler, with all its launches and its PyTorch copy, abs,
               reduction and int64 launches counted (so in the decode
               profiles of phases 4, 4b and 6).
  7. pre-training as users run it, through `Trainer` (checkpoints in a
               temporary directory, removed at the end; the free disk is
               checked against two checkpoints' bytes first, and too little
               fails the run):
     7a. resume — full-width llama-200m, quartet2, AdamW, batch 8 x seq 256:
               run A takes 8 steps with an async checkpoint every 4 (the
               reference's rule puts it after the step of index 4, so it
               holds 5 steps; keep 1); a fresh Trainer over freshly built
               state resumes from it and runs to 8. Check 1: the restored
               leaves are bitwise a host snapshot A took of that state.
               Check 2: the resumed run's first loss is bitwise A's at that
               step. Check 3: an uninterrupted repeat B of A; if A and B
               agree bitwise, the resumed run must equal A bitwise in its
               later losses and final weights, otherwise it is held to the
               A-B spread, and the ops PyTorch reports as nondeterministic in
               a step (use_deterministic_algorithms, warn_only) are named.
               Prints the host ms save(blocking=False) blocks, the write's
               seconds, the bytes on disk and the step times around it.
     7b. the nanochat recipe — llama-200m widths with QK-norm and ReLU^2,
               quartet2, Muon, WSD, 6 steps, QuantProbe(every_n=2): finite
               losses and weights, the last loss below the first, kernels
               #1-#4 launched exactly as counted (the probe's included); the
               probe's MS-EDEN and SR relative MSE beside the paper's Table 1
               (9.4e-3, 23.5e-3), SR's at least 2x MS-EDEN's at each probe;
               one site's probe on the card within PROBE_CPU_RTOL of the same
               probe on the CPU; one step profiled, with Newton-Schulz's
               share of its device time.
Phases run in the order 1, 2, 3, 4, 4b, 6, 5, 7a, 7b. Then, on their own lines:
the card (nvidia-smi), the kernels JSON, and last
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rates for the arithmetic each kernel does.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12   # tensor cores: bf16-exact operands, fp32 accumulate (#2, #7)
F32_FLOPS = 67e12     # CUDA cores: the quantizers' and the other attention kernels' f32 math
QUANT_FLOPS_PER_ELEMENT = 14  # 2 branches x (div, round, mul, sub, sq, add) + code
# MS-EDEN phase 1 per element: sign and 1/sqrt(b) multiplies, log2(b) butterfly
# adds, abs/max, the divide, q * denom, two products and two sums
PHASE1_FLOPS_BASE = 10
PHASE2_FLOPS_PER_GROUP = 10  # two divides, a multiply, clips, lattice step, p_up
TRAIN_T = 2048  # tokens of one training step: batch 8 x seq 256

ARCH_SHAPES = {  # (N, K) of the 7 quantized linears of one dense layer
    "wq": (1280, 1280), "wk": (1280, 1280), "wv": (1280, 1280),
    "wo": (1280, 1280), "wi": (3456, 1280), "wg": (3456, 1280),
    "w2": (1280, 3456),
}
REPLACES = {
    "nvfp4_fos_quant": "src/repro/kernels/nvfp4_quant.py:101",
    "fp4_matmul": "src/repro/kernels/fp4_matmul.py:82",
    "paged_gqa": "src/repro/kernels/paged_attention.py:307",
    "ms_eden_phase1": "src/repro/kernels/ms_eden_requant.py:110",
    "ms_eden_phase2": "src/repro/kernels/ms_eden_requant.py:141",
    "paged_gqa_q": "src/repro/kernels/paged_attention.py:345",
    "paged_mla": "src/repro/kernels/paged_attention.py:382",
    "paged_mla_q": "src/repro/kernels/paged_attention.py:421",
}
SERVING_KERNELS = ("nvfp4_fos_quant", "fp4_matmul", "paged_gqa")
# launches of one full-width training step (10 layers x 7 quantized linears;
# the dX GEMM reuses the forward's packed W; phase 2 once per backward GEMM)
TRAIN_LAUNCHES_PER_STEP = {"nvfp4_fos_quant": 140, "fp4_matmul": 210,
                           "ms_eden_phase1": 280, "ms_eden_phase2": 140}
# launches of one full-width nanochat-recipe step (phase 7b): ReLU^2 leaves
# 6 quantized linears a layer, 60 in all; otherwise as above
NANOCHAT_LAUNCHES_PER_STEP = {"nvfp4_fos_quant": 120, "fp4_matmul": 180,
                              "ms_eden_phase1": 240, "ms_eden_phase2": 120}
# launches of the quantization-health probe per site it probes: the weight's
# 4/6 quantization (#1) and its MS-EDEN requant (#3, #4); SR stays plain
PROBE_LAUNCHES_PER_SITE = {"nvfp4_fos_quant": 1, "fp4_matmul": 0,
                           "ms_eden_phase1": 1, "ms_eden_phase2": 1}
PAPER_TABLE1 = {"ms_eden_mse_rel": 9.4e-3, "sr_mse_rel": 23.5e-3}
# phase 7: 7a's run and its async checkpoint period; 7b's recipe run
RESUME_STEPS, RESUME_EVERY = 8, 4
NANOCHAT_STEPS, NANOCHAT_LR, NANOCHAT_PROBE_EVERY = 6, 2e-2, 2
# the probe's card output against the CPU's on one site: its 4/6 and MS-EDEN
# codes come from kernels bitwise their plain versions, SR and the RHT from
# the same hashed draws and f32 ops; only the f32 means sum in another order
PROBE_CPU_RTOL = 1e-5
# the full-width training run of phase 5 (and of tools/quant_probe.py --train)
TRAIN_ARGS = ["--arch", "llama_200m", "--scheme", "quartet2", "--steps", "6",
              "--seq", "256", "--batch", "8", "--lr", "2e-3", "--log-every", "1"]
SOURCES = {
    "nvfp4_fos_quant": "src/repro_torch/kernels/csrc/nvfp4_quant.cu",
    "fp4_matmul": "src/repro_torch/kernels/csrc/fp4_matmul.cu",
    "paged_gqa": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ms_eden_phase1": "src/repro_torch/kernels/csrc/ms_eden_requant.cu",
    "ms_eden_phase2": "src/repro_torch/kernels/csrc/ms_eden_requant.cu",
    "paged_gqa_q": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_mla": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_mla_q": "src/repro_torch/kernels/csrc/paged_attention.cu",
}
# the CUDA functions each kernel's profiler time is summed over, by a part of
# their names (nvfp4_fos_quant: nvfp4_fos_quant_cluster_kernel, _absmax_kernel,
# _encode_kernel; fp4_matmul: fp4_matmul_gemv_kernel,
# fp4_matmul_splitk_reduce_kernel, fp4_matmul_mma_kernel; paged_gqa and
# paged_gqa_q: paged_gqa_split_kernel, paged_gqa_merge_kernel; paged_mla:
# paged_mla_tc_kernel, paged_mla_merge_kernel; paged_mla_q:
# paged_mla_split_kernel, paged_mla_merge_kernel)
KERNEL_SYMBOLS = {
    "nvfp4_fos_quant": ("nvfp4_fos_quant_",), "fp4_matmul": ("fp4_matmul_",),
    "paged_gqa": ("paged_gqa_",), "ms_eden_phase1": ("ms_eden_phase1_kernel",),
    "ms_eden_phase2": ("ms_eden_phase2_kernel",), "paged_gqa_q": ("paged_gqa_",),
    "paged_mla": ("paged_mla_tc_kernel", "paged_mla_merge_kernel"),
    "paged_mla_q": ("paged_mla_split_kernel", "paged_mla_merge_kernel"),
}


def of_kernel(key: str, symbols) -> bool:
    """Whether a profiler row's kernel name holds one of `symbols` (a name
    part, or a tuple of them; "" matches every kernel)."""
    return any(sym in key for sym in ((symbols,) if isinstance(symbols, str)
                                      else symbols))
DEEPSEEK_LAYERS = 2  # the depth cut of phase 6 (see the module docstring)
# (N, K) of deepseek-v3's quantized linears on its decode path: the 4 MLA
# projections and the shared expert at M = 4 rows (4 slots), each routed
# expert at M = 8 (its capacity)
DEEPSEEK_SHAPES = {
    "wq_a": (1536, 7168), "wq_b": (24576, 1536), "wkv_a": (576, 7168),
    "wo": (7168, 16384), "ffn_in": (2048, 7168), "ffn_out": (7168, 2048),
}
DEEPSEEK_LIVE_EXPERTS = 32  # at most 4 tokens x top-8 distinct experts a layer
# live experts in phase 6's two layers at one decode step: 197 quantizer
# calls, the count its profiles show
QUANT_DEEPSEEK_LIVE = (31, 30)


def quant_step_sets(t=TRAIN_T):
    """(M, K, dtype) of every nvfp4_fos_quant call of one step of each path:
    llama-200m decode (4 slots, 10 layers: 6 inputs at K = 1280, 1 at 3456),
    deepseek-v3 decode (2 layers: wq_a, wq_b, wkv_a, wo, the shared expert's
    3 at M = 4, each live routed expert's 3 at M = 8), llama-200m training
    (10 layers: 6 + 1 bf16 activations of T rows, the 7 f32 weights)."""
    llama = ([(4, 1280, "bf16")] * 6 + [(4, 3456, "bf16")]) * 10
    deepseek = []
    for live in QUANT_DEEPSEEK_LIVE:
        deepseek += [(4, 7168, "bf16"), (4, 1536, "bf16"), (4, 7168, "bf16"),
                     (4, 16384, "bf16")]
        deepseek += [(4, 7168, "bf16")] * 2 + [(4, 2048, "bf16")]
        deepseek += [(8, 7168, "bf16"), (8, 7168, "bf16"), (8, 2048, "bf16")] * live
    train = ([(t, 1280, "bf16")] * 6 + [(t, 3456, "bf16")]
             + [(n, k, "f32") for n, k in ARCH_SHAPES.values()]) * 10
    return {"llama_decode": llama, "deepseek_decode": deepseek, "train_step": train}


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


def device_ms(torch, fn, symbols, reps: int = 3):
    """The device time of the CUDA functions `symbols` names (see of_kernel)
    per call of fn, from torch.profiler; None when the profiler shows no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and of_kernel(ev.key, symbols))
    return us / 1e3 / reps if us > 0 else None


def call_device_ms(torch, fn, reps: int = 3):
    """The device time of everything fn launches, per call of fn (the sum of
    every CUDA kernel in the profiler's window), and the launches per call;
    (None, 0) when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
           and getattr(ev, "self_device_time_total", 0.0) > 0]
    us = sum(ev.self_device_time_total for ev in evs)
    return (us / 1e3 / reps if us > 0 else None,
            sum(ev.count for ev in evs) / reps)


def quant_group(torch, NQ, ops, calls, g, reps, plain_reps=1):
    """One step set of nvfp4_fos_quant calls [(M, K, dtype)] on distinct
    seeded inputs: events time, the whole call's device time (every kernel
    a call launches), kernels launched, plain time and bound (each input
    read once, codes and scale bytes written once)."""
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    xs = [torch.randn((m, k), generator=g, device="cuda").to(dts[dt])
          for m, k, dt in calls]
    fn = lambda: [ops.nvfp4_fos_quant(x) for x in xs]
    dev_ms, kernels = call_device_ms(torch, fn)
    r = {"calls": len(calls), "ms": time_ms(torch, fn, reps),
         "profiler_ms": dev_ms, "kernels_per_call": kernels / len(calls),
         "plain_ms": (time_ms(torch, lambda: [NQ.nvfp4_fos_quant_plain(x) for x in xs],
                              plain_reps, warmup=1) if plain_reps else None),
         "library_ms": None, "library_profiler_ms": None}
    nbytes = sum(x.numel() * (x.element_size() + 0.5 + 1 / 16) + 4 for x in xs)
    n_ops = sum(x.numel() for x in xs) * QUANT_FLOPS_PER_ELEMENT
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / F32_FLOPS * 1e3
    r.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             regimes=sorted({NQ.plan(m, k).regime for m, k, _ in calls})
             if hasattr(NQ, "plan") else [])
    return r


def finish_results(results, errs):
    """Bound (bytes or operations, whichever is slower), profiler time and
    max error of each timed kernel; logs one line each."""
    import torch
    for name, r in results.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = errs[name]
        r["profiler_ms"] = device_ms(torch, r.pop("fn"), KERNEL_SYMBOLS[name])
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r.get("library_profiler_ms") is not None:
            lib += f" (profiler {r['library_profiler_ms']:.4f})"
        prof = "n/a" if r["profiler_ms"] is None else f"{r['profiler_ms']:.4f}"
        log(f"  {name:16s} {r['calls']:3d} calls/step: kernel {r['ms']:.4f} ms "
            f"(profiler {prof}), plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
            f"{r['ops'] / 1e9:.3f} GFLOP)")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def matmul_bytes_ops(calls, out_bytes):
    """Least bytes (both packed operands and their scales read once, the
    output of out_bytes an element written once, ga and gb) and operations
    (2 M N K) of a list of fp4_matmul calls [(a, w)] or [(a, w, out_bytes)]."""
    nbytes = ops = 0
    for c in calls:
        a, w = c[0], c[1]
        ob = c[2] if len(c) > 2 else out_bytes
        m, n, k = a[0].shape[0], w[0].shape[0], a[0].shape[1] * 2
        nbytes += (m + n) * k * 9 // 16 + m * n * ob + 8
        ops += 2 * m * n * k
    return nbytes, ops


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
    """The kernel M picks against the plain version: f32 within 1e-5 of
    max|C| (exact block values; only the f32 summation order differs), and
    the bf16 output bitwise the f32 output rounded to bf16."""
    c = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2])
    cb = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2], torch.bfloat16)
    torch.cuda.synchronize()
    ref = FM.fp4_matmul_plain(a[0], a[1], b[0], b[1], a[2], b[2])
    err = (c - ref).abs().max().item()
    bar = 1e-5 * ref.abs().max().item()
    shape = (a[0].shape[0], b[0].shape[0], a[0].shape[1] * 2)
    regime = FM.plan(*shape).regime
    cast = torch.equal(cb, c.to(torch.bfloat16))
    log(f"  fp4_matmul (M,N,K)={str(shape):18s} {regime:4s} max|dC| {err:.3g} "
        f"(bar {bar:.3g}); bf16 {'= f32 cast' if cast else 'DIFFERS from the f32 cast'}")
    if not err <= bar or not cast:
        fail(f"fp4_matmul {shape}: {err} > {bar} or bf16 is not the f32 cast")
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
    errs = {k: 0.0 for k in ("nvfp4_fos_quant", "fp4_matmul", "paged_gqa")}
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
    for m in (1, 4, 8, 16, 17, 64):
        for k in (1280, 3456):
            acts[m, k] = ops.nvfp4_fos_quant(
                torch.randn((m, k), generator=g, device="cuda").bfloat16())
    # the bf16 activations of one training step (T tokens, K = 1280 and 3456)
    for k in (1280, 3456):
        x = torch.randn((TRAIN_T, k), generator=g, device="cuda").bfloat16()
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, x))
        acts[TRAIN_T, k] = ops.nvfp4_fos_quant(x)
    # both plan regimes at their boundary (the last cluster shape) and one
    # past it, deepseek-v3's decode shapes, and edge inputs in the last chunk
    for m, k in ((4, 2 * NQ.SMALL_MAX_CHUNKS), (4, 2 * NQ.SMALL_MAX_CHUNKS + 16),
                 (8, 7168), (4, 7168), (4, 1536), (8, 2048)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    for m, k in ((4, 1280), (2048, 1280)):
        huge = torch.randn((m, k), generator=g, device="cuda")
        huge[-1, -1] = 3e4
        tiny = torch.randn((m, k), generator=g, device="cuda") * 1e-39
        for x in (huge.bfloat16(), huge, tiny, torch.zeros((m, k), device="cuda")):
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    # decode and prefill shapes, then every forward GEMM shape of a training
    # step: (T, 1280, 1280), (T, 3456, 1280), (T, 1280, 3456)
    for m in (1, 4, 8, 16, 17, 64, TRAIN_T):
        for name in ("wq", "wi", "w2"):
            w = weights[name]
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(
                torch, FM, ops, acts[m, w[0].shape[1] * 2], w))
    # the deepseek-v3 decode shapes: experts at M = 8, the rest at M = 4
    for n, k in DEEPSEEK_SHAPES.values():
        w = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda") * k ** -0.5)
        for m in (8, 4):
            x = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g, device="cuda").bfloat16())
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(torch, FM, ops, x, w))
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
    mm_calls = [(acts[4, w[0].shape[1] * 2], w) for lw in layer_w
                for w in lw.values()]
    blockvals = [(FM.block_values(a[0], a[1]).bfloat16(),
                  FM.block_values(w[0], w[1]).bfloat16().T.contiguous())
                 for a, w in mm_calls]
    attn_layers = [attn_case(torch, b=4, sq=1, h=10, kv=10, hd=128, bs=16,
                             maxb=16, lens=[47, 100, 131, 18], seed=100 + i)
                   for i in range(layers)]
    sdpa_calls = [sdpa_yardstick(torch, *c, KV) for c in attn_layers]

    results = {}
    mm_fn = lambda: [ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2], torch.bfloat16)
                     for a, w in mm_calls]
    at_fn = lambda: [ops.paged_gqa(*c) for c in attn_layers]
    mm_bytes, mm_ops = matmul_bytes_ops(mm_calls, 2)
    lib_fn = lambda: [torch.matmul(a, w) for a, w in blockvals]
    results["fp4_matmul"] = dict(
        fn=mm_fn, ms=time_ms(torch, mm_fn, 20),
        plain_ms=time_ms(torch, lambda: [FM.fp4_matmul_plain(
            a[0], a[1], w[0], w[1], a[2], w[2], torch.bfloat16) for a, w in mm_calls], 3),
        library_ms=time_ms(torch, lib_fn, 20),
        library_profiler_ms=device_ms(torch, lib_fn, ""),
        bytes=mm_bytes, ops=mm_ops, peak=BF16_FLOPS, calls=len(mm_calls))
    at_bytes, at_ops = map(sum, zip(*(attn_bytes_ops(*c) for c in attn_layers)))
    sdpa_fn = lambda: [f() for f in sdpa_calls]
    results["paged_gqa"] = dict(
        fn=at_fn, ms=time_ms(torch, at_fn, 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_plain(*c) for c in attn_layers], 3),
        library_ms=time_ms(torch, sdpa_fn, 20),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=at_bytes, ops=at_ops, peak=F32_FLOPS, calls=len(attn_layers))
    p = PA.plan(4, 1, 10, 10, 16, 16, 128)
    log(f"  paged_gqa plan at the timed shape: {p.splits} splits of "
        f"{p.blocks_per_split} blocks, {p.grid} CTAs, row groups {p.row_groups}")
    finish_results(results, errs)

    # ---- #1 over each path's step: the whole call's device time (every
    # kernel a call launches), distinct inputs in every call
    log("phase 3: nvfp4_fos_quant over one step of each path (llama-200m "
        "decode, deepseek-v3 decode, training), whole calls")
    groups = {}
    for gname, calls in quant_step_sets().items():
        train = gname == "train_step"
        grp = groups[gname] = quant_group(torch, NQ, ops, calls, g, 5 if train else 20,
                                          1 if train else 3)
        log(f"  {gname:16s} {grp['calls']:3d} calls ({'+'.join(grp['regimes'])}, "
            f"{grp['kernels_per_call']:.2f} kernels a call): events {grp['ms']:.4f} ms, "
            f"device {grp['profiler_ms']} ms, plain {grp['plain_ms']:.3f} ms, bound "
            f"{grp['bound_ms']:.5f} ms ({grp['bound_by']}: {grp['bytes'] / 1e6:.2f} MB)")
    q = results["nvfp4_fos_quant"] = dict(groups.pop("llama_decode"))
    q["groups"] = groups
    q["max_abs_err"] = errs["nvfp4_fos_quant"]
    torch.cuda.empty_cache()
    return results


def matmul_group(torch, FM, ops, calls, reps, plain_reps=1):
    """Events, profiler, plain and library (torch.matmul on the bf16 block
    values) times and the bound of one list of fp4_matmul calls [(a, w,
    out_dtype)]; the block values (GBs) exist only while the library runs."""
    fn = lambda: [ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2], dt)
                  for a, w, dt in calls]
    r = {"calls": len(calls), "ms": time_ms(torch, fn, reps)}
    r["profiler_ms"] = device_ms(torch, fn, KERNEL_SYMBOLS["fp4_matmul"])
    r["plain_ms"] = time_ms(torch, lambda: [FM.fp4_matmul_plain(
        a[0], a[1], w[0], w[1], a[2], w[2], dt) for a, w, dt in calls],
        plain_reps, warmup=1)
    vals = [(FM.block_values(a[0], a[1]).bfloat16(),
             FM.block_values(w[0], w[1]).bfloat16().T.contiguous()) for a, w, _ in calls]
    lib_fn = lambda: [torch.matmul(a, w) for a, w in vals]
    lib = r["library_ms"] = time_ms(torch, lib_fn, reps)
    r["library_profiler_ms"] = device_ms(torch, lib_fn, "")
    del vals, lib_fn
    nbytes, n_ops = matmul_bytes_ops(
        [(a, w, 2 if dt == torch.bfloat16 else 4) for a, w, dt in calls], 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / BF16_FLOPS * 1e3
    r.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             regimes=sorted({FM.plan(a[0].shape[0], w[0].shape[0],
                                     a[0].shape[1] * 2).regime for a, w, _ in calls}))
    prof = "n/a" if r["profiler_ms"] is None else f"{r['profiler_ms']:.4f}"
    log(f"  {len(calls)} calls ({'+'.join(r['regimes'])}): kernel {r['ms']:.4f} ms "
        f"(profiler {prof}), plain {r['plain_ms']:.3f} ms, library {lib:.4f} ms "
        f"(profiler {r['library_profiler_ms']}), "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.1f} GFLOP)")
    return r


def phase_matmul_groups(torch):
    """fp4_matmul over one deepseek-v3 decode step's calls and over one
    full-width llama-200m training step's 210 GEMMs, distinct operands in
    every call, as the main paths give them."""
    from repro_torch.core import rht as R
    from repro_torch.core import rng
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(11)
    quant = lambda shape, scale=1.0: ops.nvfp4_fos_quant(
        torch.randn(shape, generator=g, device="cuda") * scale)
    groups = {}
    log(f"phase 3: fp4_matmul over one deepseek-v3 decode step ({DEEPSEEK_LAYERS} "
        f"layers: 4 MLA projections and the shared expert at M = 4, "
        f"{DEEPSEEK_LIVE_EXPERTS} live experts x 3 at M = 8; bf16 out)")
    acts = {(m, k): ops.nvfp4_fos_quant(torch.randn(
        (m, k), generator=g, device="cuda").bfloat16())
        for m in (4, 8) for k in (1536, 2048, 7168, 16384)}
    calls = []
    for _ in range(DEEPSEEK_LAYERS):
        per_layer = [(4, DEEPSEEK_SHAPES[nm]) for nm in ("wq_a", "wq_b", "wkv_a", "wo")]
        per_layer += [(4, DEEPSEEK_SHAPES[nm]) for nm in ("ffn_in", "ffn_in", "ffn_out")]
        per_layer += [(8, DEEPSEEK_SHAPES[nm]) for _ in range(DEEPSEEK_LIVE_EXPERTS)
                      for nm in ("ffn_in", "ffn_in", "ffn_out")]
        for m, (n, k) in per_layer:
            calls.append((acts[m, k], quant((n, k), k ** -0.5), torch.bfloat16))
    groups["deepseek_decode"] = matmul_group(torch, FM, ops, calls, 10)
    del calls
    torch.cuda.empty_cache()

    log(f"phase 3: fp4_matmul over one training step's 210 GEMMs (T = {TRAIN_T}: "
        "the forward on 4/6 operands, bf16 out; dX and dW on MS-EDEN operands, f32)")
    draws = rng.HashDraws([11, 3])

    def requant(shape, tag):
        x = torch.randn(shape, generator=g, device="cuda")
        d = shape[1]
        return ops.ms_eden_requant(x, draws.signs(tag, R.block_size(d), "cuda"),
                                   draws.uniform(tag + 1, (shape[0], d // 16), "cuda"))
    calls = []
    for _ in range(10):
        for n, k in ARCH_SHAPES.values():
            calls.append((quant((TRAIN_T, k)), quant((n, k), k ** -0.5), torch.bfloat16))
            calls.append((requant((TRAIN_T, n), 1), requant((k, n), 3), torch.float32))
            calls.append((requant((n, TRAIN_T), 5), requant((k, TRAIN_T), 7), torch.float32))
    groups["train_step"] = matmul_group(torch, FM, ops, calls, 3)
    del calls
    torch.cuda.empty_cache()
    return groups


def backward_gemms(t):
    """The (Ma, Mb, D) of the backward GEMMs of one dense layer at T tokens:
    per quantized linear (N, K), dX = E (T, N) . W^T (K, N) and
    dW = E^T (N, T) . X^T (K, T)."""
    shapes = []
    for n, k in ARCH_SHAPES.values():
        shapes += [(t, k, n), (n, k, t)]
    return sorted(set(shapes))


def requant_operands(t):
    """The 28 requant operand shapes of one dense layer's backward at T
    tokens: per quantized linear (N, K), E (T, N) and W^T (K, N) of the dX
    GEMM, E^T (N, T) and X^T (K, T) of the dW GEMM."""
    shapes = []
    for n, k in ARCH_SHAPES.values():
        shapes += [(t, n), (k, n), (n, t), (k, t)]
    return shapes


def check_phase1(torch, MR, ops, x, signs):
    """Phase 1 bitwise against its plain version on the same x (a contiguous
    tensor or a view, read in place)."""
    kern = ops.ms_eden_phase1(x, signs)
    torch.cuda.synchronize()
    plain = MR.phase1_plain(x, signs)
    codes_equal = torch.equal(kern[0], plain[0])
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(kern[1:], plain[1:]))
    kind, ld = MR.layout(x)
    log(f"  ms_eden_phase1 {str(tuple(x.shape)):14s} {kind} (ld {ld}) codes "
        f"{'equal' if codes_equal else 'DIFFER'}, max|d| of pseudo/num/den/"
        f"absmax {err:.3g}")
    if not codes_equal or err != 0:
        fail(f"ms_eden_phase1 {tuple(x.shape)} {kind}: not bitwise equal to its "
             "plain version")
    return plain


def backward_operands(torch, g, t):
    """The 28 requant operands of one dense layer's backward at T tokens, as
    `core.linear._bwd_gemm` hands them: per quantized linear (N, K), E (T, N)
    row-major, and the transposed views W^T (K, N), E^T (N, T), X^T (K, T)
    of W (N, K), E and X (T, K) (the order of `requant_operands`)."""
    ops_ = []
    for n, k in ARCH_SHAPES.values():
        e = torch.randn((t, n), generator=g, device="cuda")
        w = torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
        x = torch.randn((t, k), generator=g, device="cuda")
        ops_ += [e, w.T, e.T, x.T]
    return ops_


def check_phase2(torch, F, MR, ops, p1, draws, tag):
    """Phase 2 bitwise against its plain version on the tag's uniforms, both
    hashed in the kernel from the tag's key pair and read from a uniforms
    tensor (HashDraws.uniform, the same on the card as on the CPU)."""
    u = draws.uniform(tag, p1[1].shape, "cuda")
    plain = MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u)
    err = 0.0
    for mode, arg in (("hashed", draws.keys(tag)), ("uniforms", u)):
        kern = ops.ms_eden_phase2(p1[4], p1[1], p1[2], p1[3], arg)
        torch.cuda.synchronize()
        err = max(err, (F.bits_to_e4m3(kern[0]) - F.bits_to_e4m3(plain[0])).abs().max().item(),
                  abs(float(kern[1]) - float(plain[1])))
        if not (torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])):
            fail(f"ms_eden_phase2 {tuple(u.shape)} ({mode}): not bitwise equal to "
                 "its plain version")
    if not torch.equal(u.cpu(), draws.uniform(tag, p1[1].shape, "cpu")):
        fail(f"HashDraws.uniform {tuple(u.shape)}: the card's draws differ from the CPU's")
    log(f"  ms_eden_phase2 {str(tuple(u.shape)):14s} hashed and uniforms: max|d scale| "
        f"{err:.3g}, gscale {float(plain[1]):.6g}")
    return err


def check_phase2_pair(torch, MR, ops, pa, pb, draws, tag):
    """One phase-2 launch over both operands of a backward GEMM (operand a
    hashed, operand b on a uniforms tensor, then both hashed): bitwise the
    plain version of each."""
    ua = draws.uniform(tag, pa[1].shape, "cuda")
    ub = draws.uniform(tag + 1, pb[1].shape, "cuda")
    want = [MR.phase2_plain(pa[4], *pa[1:4], ua), MR.phase2_plain(pb[4], *pb[1:4], ub)]
    for arg_b in (ub, draws.keys(tag + 1)):
        got = ops.ms_eden_phase2_batch([(pa[4], *pa[1:4], draws.keys(tag)),
                                        (pb[4], *pb[1:4], arg_b)])
        torch.cuda.synchronize()
        for (bits, gs), (wb, wg) in zip(got, want):
            if not (torch.equal(bits, wb) and torch.equal(gs, wg)):
                fail(f"ms_eden_phase2 over two operands {tuple(pa[1].shape)}, "
                     f"{tuple(pb[1].shape)}: not bitwise equal to the plain version")


def phase_requant(torch):
    """Kernels #3/#4 against their plain versions at the training shapes, the
    backward GEMM against its plain composition, and the time of the 280
    requant calls of one full-width training step."""
    from repro_torch.core import formats as F
    from repro_torch.core import rht as R
    from repro_torch.core import rng
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ms_eden_requant as MR
    from repro_torch.kernels import ops

    log("phase 3: MS-EDEN requant kernels against their plain versions "
        f"(training shapes at T = {TRAIN_T}; bitwise)")
    g = torch.Generator(device="cuda").manual_seed(7)
    draws = rng.HashDraws([7, 7])
    errs = {"ms_eden_phase1": 0.0, "ms_eden_phase2": 0.0}
    shapes = sorted(set(requant_operands(TRAIN_T)))
    shapes += [(1000, 1280), (256, 1280), (96, 48)]  # odd M, zeros, b = 16
    p1s = {}
    for i, (m, k) in enumerate(shapes):
        x = torch.randn((m, k), generator=g, device="cuda")
        if (m, k) == (256, 1280):
            x.zero_()
        signs = draws.signs(i, R.block_size(k), "cuda")
        p1s[m, k] = check_phase1(torch, MR, ops, x, signs)
        errs["ms_eden_phase2"] = max(errs["ms_eden_phase2"], check_phase2(
            torch, F, MR, ops, p1s[m, k], draws, 100 + i))
    # both operands of each backward GEMM shape in one launch
    for i, (ma, mb, d) in enumerate(backward_gemms(TRAIN_T)):
        check_phase2_pair(torch, MR, ops, p1s[ma, d], p1s[mb, d], draws, 150 + 2 * i)
    log(f"  ms_eden_phase2 over both operands of each of the {len(backward_gemms(TRAIN_T))} "
        "backward GEMM shapes in one launch (hashed / uniforms): bitwise")
    del p1s
    # every operand as the backward hands it (transposed views read in
    # place), and transposes whose M is no multiple of 4 (4-byte chunks)
    seen = set()
    for x in backward_operands(torch, g, TRAIN_T) + [
            torch.randn((80, 33), generator=g, device="cuda").T,
            torch.randn((48, 1000), generator=g, device="cuda").T]:
        key = (tuple(x.shape), x.stride())
        if key not in seen:
            seen.add(key)
            check_phase1(torch, MR, ops, x, draws.signs(len(seen), R.block_size(
                x.shape[1]), "cuda"))
    # every dX and dW GEMM shape of a training step: the backward GEMM
    # against its plain composition, and fp4_matmul on its requant operands
    mm_err = 0.0
    for ma, mb, d in backward_gemms(TRAIN_T):
        a = torch.randn((ma, d), generator=g, device="cuda")
        b = torch.randn((mb, d), generator=g, device="cuda")
        signs = draws.signs(1, R.block_size(d), "cuda")
        ua = draws.uniform(2, (ma, d // 16), "cuda")
        ub = draws.uniform(3, (mb, d // 16), "cuda")
        mm_err = max(mm_err, check_matmul(torch, FM, ops, ops.ms_eden_requant(a, signs, ua),
                                          ops.ms_eden_requant(b, signs, ub)))
        c = ops.quartet2_backward_gemm(a, b, signs, ua, ub)
        c_keys = ops.quartet2_backward_gemm(a, b, signs, draws.keys(2), draws.keys(3))
        torch.cuda.synchronize()
        if not torch.equal(c, c_keys):
            fail(f"quartet2_backward_gemm ({ma},{mb},{d}): hashed uniforms differ "
                 "from the same uniforms as tensors")
        qa, qb = MR.phase1_plain(a, signs), MR.phase1_plain(b, signs)
        sa = MR.phase2_plain(qa[4], *qa[1:4], ua)
        sb = MR.phase2_plain(qb[4], *qb[1:4], ub)
        ref = FM.fp4_matmul_plain(qa[0], sa[0], qb[0], sb[0], sa[1], sb[1])
        err = (c - ref).abs().max().item()
        bar = 1e-3 * ref.abs().max().item()
        exact = (a @ b.T)
        rel = ((c - exact).norm() / exact.norm()).item()
        log(f"  quartet2_backward_gemm (Ma,Mb,D)=({ma},{mb},{d}): max|dC| vs plain "
            f"composition {err:.3g} (bar {bar:.3g}); relative error vs the "
            f"exact f32 product {rel:.4f}")
        if not err <= bar:
            fail(f"quartet2_backward_gemm ({ma},{mb},{d}): {err} > {bar}")

    # ---- one full-width training step's requant: 280 phase-1 calls on the
    # operands as the backward hands them (E row-major; W^T, E^T, X^T views),
    # and phase 2 once per backward GEMM (dX: E, W^T; dW: E^T, X^T) on
    # hashed uniforms, 140 launches
    log("phase 3: timing one training step's worth of requant calls "
        f"(10 layers x 28 operands as _bwd_gemm hands them, T = {TRAIN_T}; "
        "phase 2 over both operands of each of the 140 backward GEMMs)")
    calls = [x for _ in range(10) for x in backward_operands(torch, g, TRAIN_T)]
    signs = draws.signs(0, 128, "cuda")
    p1s = [ops.ms_eden_phase1(x, signs) for x in calls]
    keys = [draws.keys(200 + i) for i in range(len(p1s))]
    pairs = [[(p1s[i + j][4], *p1s[i + j][1:4], keys[i + j]) for j in (0, 1)]
             for i in range(0, len(p1s), 2)]
    n_el = sum(x.numel() for x in calls)
    n_groups = n_el // 16
    results = {}
    p1_fn = lambda: [ops.ms_eden_phase1(x, signs) for x in calls]
    p2_fn = lambda: [ops.ms_eden_phase2_batch(pair) for pair in pairs]
    results["ms_eden_phase1"] = dict(
        fn=p1_fn, ms=time_ms(torch, p1_fn, 5),
        plain_ms=time_ms(torch, lambda: [MR.phase1_plain(x, signs) for x in calls], 1,
                         warmup=1),
        library_ms=None, bytes=n_el * (4 + 0.5 + 12 / 16) + len(calls) * (4 + 512),
        ops=n_el * (PHASE1_FLOPS_BASE + 7), peak=F32_FLOPS, calls=len(calls))
    # 13 bytes a group (pseudo, num, den read; the scale byte written), the
    # absmax read and the gscale written per operand
    results["ms_eden_phase2"] = dict(
        fn=p2_fn, ms=time_ms(torch, p2_fn, 5),
        plain_ms=time_ms(torch, lambda: [MR.phase2_plain(*op) for pair in pairs
                                         for op in pair], 1, warmup=1),
        library_ms=None, bytes=n_groups * 13 + len(calls) * 8,
        ops=n_groups * PHASE2_FLOPS_PER_GROUP, peak=F32_FLOPS, calls=len(pairs))
    finish_results(results, errs)
    # what the step paid before: the 280 uniform tensors drawn by
    # HashDraws.uniform (PyTorch int64 kernels), then one phase-2 launch
    # per operand reading them (17 bytes a group)
    r = results["ms_eden_phase2"]
    shapes = [p[1].shape for p in p1s]
    draw_fn = lambda: [draws.uniform(200 + i, sh, "cuda") for i, sh in enumerate(shapes)]
    us = draw_fn()
    one_fn = lambda: [ops.ms_eden_phase2(p[4], p[1], p[2], p[3], u)
                      for p, u in zip(p1s, us)]
    draws_dev, draws_launches = call_device_ms(torch, draw_fn)
    t_bytes = (n_groups * 17 + len(calls) * 8) / HBM_BYTES_S * 1e3
    r["groups"] = {"one_operand_uniforms": dict(
        calls=len(calls), ms=time_ms(torch, one_fn, 5),
        profiler_ms=device_ms(torch, one_fn, KERNEL_SYMBOLS["ms_eden_phase2"]),
        plain_ms=r["plain_ms"], library_ms=None, library_profiler_ms=None,
        bound_ms=max(t_bytes, r["ops"] / F32_FLOPS * 1e3), bound_by="bytes")}
    r["draws"] = {"calls": len(shapes), "ms": time_ms(torch, draw_fn, 5),
                  "profiler_ms": draws_dev, "launches": draws_launches}
    one = r["groups"]["one_operand_uniforms"]
    log(f"  ms_eden_phase2 as before, one operand a launch on uniforms tensors: "
        f"{one['calls']} launches {one['ms']:.4f} ms (profiler {one['profiler_ms']}); "
        f"the {len(shapes)} uniform draws it read: {r['draws']['ms']:.4f} ms "
        f"(profiler {draws_dev}, {draws_launches:g} PyTorch launches)")
    del us
    # the same 280 calls on contiguous copies of the operands (what phase 1
    # read before it took views; the copies themselves are not timed)
    flat = [x.contiguous() for x in calls]
    flat_fn = lambda: [ops.ms_eden_phase1(x, signs) for x in flat]
    r = results["ms_eden_phase1"]
    r["contiguous_ms"] = time_ms(torch, flat_fn, 5)
    r["contiguous_profiler_ms"] = device_ms(torch, flat_fn, KERNEL_SYMBOLS["ms_eden_phase1"])
    log(f"  ms_eden_phase1 on contiguous copies of the same operands: "
        f"{r['contiguous_ms']:.4f} ms (profiler {r['contiguous_profiler_ms']})")
    del calls, p1s, pairs, flat
    torch.cuda.empty_cache()
    return results, mm_err


def paged_table(torch, g, b, maxb, bs, lens, dead=()):
    """A (b, maxb) block table over b * maxb pool blocks, randomly placed;
    dead rows hold only the sentinel."""
    n_blocks = b * maxb
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        if i not in dead:
            for j in range(-(-n // bs)):
                table[i, j] = perm.pop()
    return table, n_blocks


def gqa_q_case(torch, F, b, sq, h, kv, hd, bs, maxb, lens, dead=(), seed=0,
               packed=True):
    """(q, k codes, k scales, v codes, v scales, table, pos) on the card, or
    with packed=False (q, k, v, table, pos) over the same draws in bf16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table, n_blocks = paged_table(torch, g, b, maxb, bs, lens, dead)
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    q = torch.randn((b, sq, h, hd), generator=g).bfloat16()
    k, v = ((torch.randn((n_blocks, bs, kv, hd), generator=g) * 3).bfloat16()
            for _ in range(2))
    pools = ((*F.nvfp4_cache_encode(k), *F.nvfp4_cache_encode(v)) if packed
             else (k, v))
    return [t.cuda() for t in (q, *pools, table, pos)]


def mla_case(torch, F, b, sq, bs, maxb, lens, packed, dead=(), seed=0,
             h=128, lora=512, rope=64):
    """(q_abs f32, q_rope bf16, latent pool leaves..., table, pos) on the
    card at deepseek-v3's widths: (cc, kc) bf16, or their codes and scale
    bits when packed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table, n_blocks = paged_table(torch, g, b, maxb, bs, lens, dead)
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    qa = torch.randn((b, sq, h, lora), generator=g) * 0.1
    qr = torch.randn((b, sq, h, rope), generator=g).bfloat16()
    cc = torch.randn((n_blocks, bs, lora), generator=g).bfloat16()
    kc = (torch.randn((n_blocks, bs, rope), generator=g) * 2).bfloat16()
    pools = ((*F.nvfp4_cache_encode(cc), *F.nvfp4_cache_encode(kc)) if packed
             else (cc, kc))
    return [t.cuda() for t in (qa, qr, *pools, table, pos)]


def check_against_plain(torch, name, out, ref, dead, label):
    """The attention bar: |out - ref| <= 5e-6 + 1e-5 |ref|; dead rows 0."""
    err = (out - ref).abs().max().item()
    bad = ((out - ref).abs() > 5e-6 + 1e-5 * ref.abs()).double().mean().item()
    zeros = all(int((out[r] != 0).sum()) == 0 for r in dead)
    log(f"  {name} {label:38s} max|do| {err:.3g}, outside 5e-6/1e-5: {bad:.2e}"
        f"{', inactive rows exactly 0' if dead else ''}")
    if bad > 0 or not zeros:
        fail(f"{name} {label}: outside the bar ({bad}) or a nonzero inactive row")
    return err


def keys_and_pairs(pos, sq):
    """Cache rows each batch row reads (positions 0 .. its newest query) and
    (query, key) pairs attended, from this run's positions."""
    keys = sum(int(p) + sq for p in pos)
    pairs = sum(int(p) + s + 1 for p in pos for s in range(sq))
    return keys, pairs


def gather_sdpa(torch, q, k, v, pos, scale=None):
    """F.scaled_dot_product_attention over already-gathered views (the
    yardstick PyTorch call; never used by the port): q (B, Sq, H, d), k/v
    (B, T, KV, d) with KV dividing H."""
    import torch.nn.functional as Fn
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sq, t = q.shape[1], k.shape[1]
    qpos = pos[:, None].long() + torch.arange(sq, device=q.device)[None]
    mask = (torch.arange(t, device=q.device)[None, None] <= qpos[..., None])[:, None]
    return lambda: Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   scale=scale, enable_gqa=True)


def phase_paged_q_mla(torch):
    """Kernels #6 (packed GQA), #7 (MLA) and #8 (packed MLA) against their
    plain versions, then one decode step's calls of each timed."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    log("phase 3: packed GQA and MLA decode kernels against their plain versions")
    errs = {"paged_gqa_q": 0.0, "paged_mla": 0.0, "paged_mla_q": 0.0}
    gqa_cases = {
        "llama-200m decode B4 Sq1 H10 KV10": dict(sq=1, lens=[47, 100, 131, 18], dead=(3,)),
        "llama-200m chunk B4 Sq16 H10 KV10": dict(sq=16, lens=[16, 64, 100, 33]),
    }
    for i, (label, c) in enumerate(gqa_cases.items()):
        q, kc, ks, vc, vs, table, pos = gqa_q_case(
            torch, F, b=4, h=10, kv=10, hd=128, bs=16, maxb=16, seed=i, **c)
        out = ops.paged_gqa_q(q, kc, ks, vc, vs, table, pos)
        torch.cuda.synchronize()
        ref = PA.paged_gqa_q_plain(q, kc, ks, vc, vs, table, pos)
        errs["paged_gqa_q"] = max(errs["paged_gqa_q"], check_against_plain(
            torch, "paged_gqa_q", out, ref, c.get("dead", ()), label))
    mla_cases = {
        "deepseek-v3 decode B4 Sq1 H128": dict(sq=1, lens=[47, 100, 1, 64], dead=(2,)),
        "deepseek-v3 chunk B4 Sq16 H128": dict(sq=16, lens=[16, 64, 100, 33], dead=(3,)),
        "deepseek-v3 decode B4 Sq1 4,096 tokens": dict(sq=1, lens=[4096] * 4, maxb=256),
        "Sq16, scratch cap binds (3 splits)": dict(b=2, sq=16, lens=[1000, 517],
                                                   maxb=64, dead=()),
    }
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        for i, (label, c) in enumerate(mla_cases.items()):
            c = {"b": 4, "maxb": 16, **c}
            args = mla_case(torch, F, bs=16, packed=packed, seed=10 + i,
                            **{k: v for k, v in c.items() if k != "dead"},
                            dead=c.get("dead", ()))
            kern = ops.paged_mla_q if packed else ops.paged_mla
            plain = PA.paged_mla_q_plain if packed else PA.paged_mla_plain
            out = kern(*args, qk_dim=192)
            again = kern(*args, qk_dim=192)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], check_against_plain(
                torch, name, out, plain(*args, 192), c.get("dead", ()), label))
            if not torch.equal(out, again):
                fail(f"{name} {label}: two calls on the same inputs differ")
            del args, out, again

    # ---- one decode step's calls: llama-200m (10 layers) for #6, phase 6's
    # deepseek-v3 (2 layers) for #7 and #8; 4 slots
    log("phase 3: timing one decode step's calls (llama-200m: 10 layers, "
        f"4 slots; deepseek-v3: {DEEPSEEK_LAYERS} layers, 4 slots)")
    results = {}
    gl = [gqa_q_case(torch, F, b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16,
                     lens=[47, 100, 131, 18], seed=100 + i) for i in range(10)]
    sd = []
    nbytes = ops_n = 0
    for q, kc, ks, vc, vs, table, pos in gl:
        kg = KV.gather_view(KV.PackedKV(kc, ks), table)
        vg = KV.gather_view(KV.PackedKV(vc, vs), table)
        sd.append(gather_sdpa(torch, q, kg, vg, pos))
        keys, pairs = keys_and_pairs(pos.tolist(), 1)
        nbytes += (q.numel() * 2 + keys * 10 * 256 * 0.5625 + table.numel() * 4
                   + pos.numel() * 4 + q.numel() * 4)
        ops_n += pairs * 10 * (2 * 128 + 2 * 128)
    fn = lambda: [ops.paged_gqa_q(*c) for c in gl]
    sdpa_fn = lambda sd=sd: [f() for f in sd]
    results["paged_gqa_q"] = dict(
        fn=fn, ms=time_ms(torch, fn, 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_q_plain(*c) for c in gl], 3),
        library_ms=time_ms(torch, sdpa_fn, 20),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=nbytes, ops=ops_n, peak=F32_FLOPS, calls=len(gl))
    lens = [40, 57, 72, 25]  # phase 6's prompts of 16-64 tokens, mid-decode
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        results[name] = mla_step_group(torch, F, PA, ops, KV, packed, lens, 16, 20,
                                       seed=200)
    finish_results(results, errs)
    log(f"phase 3: #7 and #8 over one deepseek-v3 decode step ({DEEPSEEK_LAYERS} "
        "layers) at 4 rows x 4,096 tokens")
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        grp = mla_step_group(torch, F, PA, ops, KV, packed, [4096] * 4, 256, 5,
                             seed=400, plain_reps=1)
        finish_results({name: grp}, errs)
        results[name]["groups"] = {"4x4096": grp}
        torch.cuda.empty_cache()
    return results


def mla_step_group(torch, F, PA, ops, KV, packed, lens, maxb, reps, seed,
                   plain_reps=3, sq=1):
    """One deepseek-v3 decode step's #7 (packed=False) or #8 calls (one a
    layer, 4 rows of `lens` tokens over a (4, maxb) table, Sq queries a
    row: 1 to decode, 16 for a prefill chunk): the timing
    dict finish_results completes. The yardstick is SDPA over the gathered
    latent view (q and k the latent and rope parts side by side, v the
    latent part); the bound counts the cache rows each row reads and the
    (query, key) pairs it scores, the operations at the bf16 tensor-core
    peak for #7 (its products run there) and the f32 one for #8."""
    calls = [mla_case(torch, F, b=4, sq=sq, bs=16, maxb=maxb, lens=lens,
                      packed=packed, seed=seed + i)
             for i in range(DEEPSEEK_LAYERS)]
    kern = ops.paged_mla_q if packed else ops.paged_mla
    plain = PA.paged_mla_q_plain if packed else PA.paged_mla_plain
    sd = []
    nbytes = ops_n = 0
    for c in calls:
        qa, qr, table, pos = c[0], c[1], c[-2], c[-1]
        pools = ((KV.PackedKV(c[2], c[3]), KV.PackedKV(c[4], c[5])) if packed
                 else (c[2], c[3]))
        cv, kv = (KV.gather_view(p, table).float() for p in pools)
        qcat = torch.cat([qa, qr.float()], -1)
        kcat = torch.cat([cv, kv], -1)[:, :, None]
        sd.append(gather_sdpa(torch, qcat, kcat, cv[:, :, None], pos,
                              scale=PA.mla_scale(192)))
        keys, pairs = keys_and_pairs(pos.tolist(), sq)
        row = 576 * (0.5625 if packed else 2)
        nbytes += (qa.numel() * 4 + qr.numel() * 2 + keys * row
                   + table.numel() * 4 + pos.numel() * 4 + qa.numel() * 4)
        ops_n += pairs * 128 * (2 * 576 + 2 * 512)
    fn = lambda: [kern(*c, qk_dim=192) for c in calls]
    sdpa_fn = lambda: [f() for f in sd]
    return dict(
        fn=fn, ms=time_ms(torch, fn, reps),
        plain_ms=(time_ms(torch, lambda: [plain(*c, 192) for c in calls], plain_reps,
                          warmup=1) if plain_reps else None),
        library_ms=time_ms(torch, sdpa_fn, reps),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=nbytes, ops=ops_n, peak=F32_FLOPS if packed else BF16_FLOPS,
        calls=len(calls))


def phase_gqa_splits(torch):
    """#5 and #6, the split-KV kernels, on cases that stress the splits:
    against their plain versions under the attention bar, and two calls
    bitwise equal. yi-9b's grouped heads run over the NVFP4 pool (phase 3's
    bf16 cases hold them over the bf16 pool at unit scale; at this data's 3x
    scale the plain version's own f32 error reaches the bar there, which
    tools/gqa_split_probe.py measures against float64), the rest over both
    pools. Returns the max error of each kernel."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    log(f"phase 3: split-KV GQA decode (splits of {PA.SPLIT_KEYS} keys) on both "
        "pools, two calls bitwise equal")
    cases = {
        "yi-9b decode B4 Sq1 H32 KV4": dict(b=4, sq=1, h=32, kv=4, maxb=16,
                                            lens=[47, 100, 131, 18], dead=(3,),
                                            pools=(True,)),
        "yi-9b chunk B4 Sq16 H32 KV4": dict(b=4, sq=16, h=32, kv=4, maxb=16,
                                            lens=[16, 64, 100, 33], pools=(True,)),
        "maxb 64, a 1,024-token row": dict(b=4, sq=1, h=10, kv=10, maxb=64,
                                           lens=[1024, 517, 31, 300], dead=(2,)),
        "ends on a split edge, +1, Sq 1": dict(b=4, sq=1, h=10, kv=10, maxb=16,
                                               lens=[32, 33, 64, 65]),
        "ends on a split edge, +1, Sq 16": dict(b=4, sq=16, h=10, kv=10, maxb=16,
                                                lens=[32, 33, 64, 65]),
        "window 40: whole splits dead": dict(b=4, sq=1, h=10, kv=10, maxb=64,
                                             lens=[1024, 200, 41, 90], window=40),
        "window 50, Sq 16, yi-9b heads": dict(b=2, sq=16, h=32, kv=4, maxb=16,
                                              lens=[256, 70], window=50,
                                              pools=(True,)),
    }
    errs = {"paged_gqa": 0.0, "paged_gqa_q": 0.0}
    for i, (label, c) in enumerate(cases.items()):
        c = dict(c)
        window = c.pop("window", None)
        for packed in c.pop("pools", (False, True)):
            name = "paged_gqa_q" if packed else "paged_gqa"
            args = gqa_q_case(torch, F, hd=128, bs=16, seed=300 + i,
                              packed=packed, **c)
            kern = ops.paged_gqa_q if packed else ops.paged_gqa
            plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
            out = kern(*args, window=window)
            again = kern(*args, window=window)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], check_against_plain(
                torch, name, out, plain(*args, window=window), c.get("dead", ()),
                label))
            if not torch.equal(out, again):
                fail(f"{name} {label}: two calls on the same inputs differ")
    return errs


def phase_train_reference(torch):
    """A quartet2 train step at reduced size, the card against the CPU: same
    weights, batches and hashed draws; only fp32 summation orders differ."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_train_step

    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(4), "cpu")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
    losses = {}
    for d in ("cpu", "cuda"):
        init, step = make_train_step(cfg, "quartet2", base_lr=2e-3, total_steps=3)
        state = init(to_device(params, d))
        seq = []
        for i in range(3):
            state, m = step(state, {k: v.to(d) for k, v in corpus.batch_at(i).items()})
            seq.append(float(m["loss"]))
        losses[d] = seq
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"  reduced llama-200m quartet2 train step x3: card {losses['cuda']} vs "
        f"CPU {losses['cpu']}: max relative difference {worst:.3g}")
    # the same numbers up to fp32 summation order: 1e-3 of the loss
    if not all(map(lambda v: v == v, losses["cuda"])) or worst > 1e-3:
        fail("reduced quartet2 train step: card disagrees with the CPU")


def to_device(tree, d):
    """A copy of a tree of tensors on device d (training updates in place)."""
    if isinstance(tree, dict):
        return {k: to_device(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, d) for v in tree]
    return tree.to(d, copy=True)


def phase_small_reference(torch):
    """The paged step at reduced size: kernels on the card against the plain
    versions on the CPU, same weights and tokens: llama-200m (bf16 pool) and
    deepseek-v3 (MLA + MoE; the bf16 and the NVFP4 latent pool)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import decode as serve_decode
    from repro_torch.serve.kv_pool import KVPool
    from repro_torch.serve.prequant import prequantize

    for arch, kv_quant in (("llama_200m", False), ("deepseek_v3_671b", False),
                           ("deepseek_v3_671b", True)):
        cfg = registry.get(arch).reduced()
        params = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 20),
                             generator=torch.Generator().manual_seed(2),
                             dtype=torch.int32)
        pool_name = "NVFP4 pool" if kv_quant else "bf16 pool"
        for scheme in ("bf16", "quartet2"):
            outs = {}
            for d in ("cpu", "cuda"):
                p = prequantize(to_device(params, d), cfg, scheme)
                pool = KVPool(cfg, 2, 32, block_size=16, device=d,
                              quantized=kv_quant)
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
            worst_abs = max((a - b).abs().max().item()
                            for a, b in zip(outs["cuda"], outs["cpu"]))
            worst_rel = max(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()
                            for a, b in zip(outs["cuda"], outs["cpu"]))
            finite = all(torch.isfinite(a).all() for a in outs["cuda"])
            log(f"  reduced {cfg.name} paged step ({pool_name}), {scheme}: card vs "
                f"CPU max|dlogit| {worst_abs:.3g}, rel RMS {worst_rel:.3g}")
            # bf16: the sums differ in order only; quartet2: below the ~0.3
            # relative error that quantization itself adds at this size
            if not finite or (scheme == "bf16" and worst_abs > 2e-2) or worst_rel > 0.3:
                fail(f"reduced paged step ({arch}, {pool_name}, {scheme}): card "
                     "disagrees with the CPU")


# --------------------------------------------------------------------------
# phase 4: serving through ServeEngine at full width
# --------------------------------------------------------------------------

def serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine, prompts,
               max_new, **econf_kw):
    econf = EngineConfig(**{**dict(n_slots=4, max_len=256, block_size=16,
                                   prefill_chunk=16, scheme="quartet2",
                                   prequant=True, device="cuda"), **econf_kw})
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


def served(torch, cfg, eng, results, prompts, max_new, launches, kernels):
    """Checks every serving run shares: all requests served with in-vocabulary
    tokens, every pool block free, each path kernel launched."""
    if sorted(r.req_id for r in results) != list(range(len(prompts))):
        fail(f"served {len(results)} of {len(prompts)} requests")
    if any(len(r.tokens) != max_new for r in results):
        fail("a request returned the wrong number of tokens")
    if not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        fail("token ids outside the vocabulary")
    if eng.pool.free_block_count != eng.pool.n_blocks:
        fail(f"{eng.pool.n_blocks - eng.pool.free_block_count} pool blocks leaked")
    if any(launches[k] <= 0 for k in kernels):
        fail(f"a kernel was not launched on the serving path: {launches}")


def serving_numbers(results, st, setup_s, wall, peak, launches):
    ttft = sorted(r.ttft_s for r in results)
    return {
        "setup_s": setup_s, "wall_s": wall,
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "ttft_s_median": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "decode_steps": st["decode_steps"], "prefill_steps": st["prefill_steps"],
        "peak_mem_bytes": peak, "launches": launches,
    }


def pool_byte_ratio(pool):
    """Bytes of the pool's token leaves over the bytes of bf16 leaves of the
    same logical shape."""
    from repro_torch.serve.kv_pool import PackedKV
    held = bf16 = 0
    for stage in pool.caches:
        for kinds in stage.values():
            for leaves in kinds.values():
                for leaf in leaves:
                    if isinstance(leaf, PackedKV):
                        held += leaf.codes.numel() + leaf.scales.numel()
                        bf16 += leaf.codes.numel() * 2 * 2
                    else:
                        held += leaf.numel() * leaf.element_size()
                        bf16 += leaf.numel() * 2
    return held / bf16


def phase_serving(torch, card, kv_quant=False):
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    pool_name = "NVFP4 pool" if kv_quant else "paged bf16 pool"
    log(f"phase {'4b' if kv_quant else '4'}: serving full-width llama-200m "
        f"(quartet2, prequant, {pool_name}, 4 slots)")
    cfg = registry.get("llama_200m")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 101, (8,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    # warm-up run (first launches, allocator, cuBLAS handles), not measured
    serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
               prompts[:2], 4, kv_quant=kv_quant)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng, results, setup_s, wall = serve_once(
        torch, cfg, params, EngineConfig, Request, ServeEngine, prompts, 32,
        kv_quant=kv_quant)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    attn = "paged_gqa_q" if kv_quant else "paged_gqa"
    served(torch, cfg, eng, results, prompts, 32, launches,
           ("nvfp4_fos_quant", "fp4_matmul", attn))
    ratio = pool_byte_ratio(eng.pool)
    if kv_quant and (launches["paged_gqa"] != 0 or ratio != 0.28125):
        fail(f"kv_quant serving: paged_gqa launched {launches['paged_gqa']} "
             f"times, pool bytes {ratio} of bf16 (want 0 and 0.28125)")
    out = {"prompt_lens": lens, "pool_bytes_over_bf16": ratio,
           **serving_numbers(results, eng.stats, setup_s, wall, peak, launches),
           "launches_per_decode_step": None}
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
        f"peak memory {peak / 2**30:.2f} GiB, wall {wall:.2f} s, pool bytes "
        f"{ratio:.5f} of bf16")
    log(f"  launches on the main path: {launches}; per decode step: "
        f"{out['launches_per_decode_step']}")
    out["profile"] = profile_decode(torch, eng, Request, prompts)
    return out


def phase_deepseek(torch, card):
    """Phase 6: deepseek-v3 at its published widths, 2 layers, quartet2,
    weights packed as drawn, served with the bf16 and the NVFP4 latent
    pool."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.prequant import init_packed

    t_phase = time.perf_counter()
    # depth cut only: every layer of this config is MLA + MoE, so 2 layers
    # are two whole periods; 61 layers of 6.54 GB packed (plus the 7.4 GB
    # f32 embedding and head) do not fit one 80 GB card. Widths, heads,
    # experts and vocabulary are the published ones.
    cfg = dataclasses.replace(registry.get("deepseek_v3_671b"),
                              n_layers=DEEPSEEK_LAYERS)
    log(f"phase 6: serving deepseek-v3 at full width, {cfg.n_layers} layers "
        "(quartet2, weights packed as drawn, 4 slots)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_packed(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "quartet2", "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = torch.cuda.memory_allocated()
    log(f"  weights drawn and packed in {init_s:.1f} s: {weight_bytes / 2**30:.2f} GiB "
        f"resident, init peak {init_peak / 2**30:.2f} GiB")
    g = torch.Generator().manual_seed(6)
    lens = torch.randint(16, 65, (4,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    out = {"prompt_lens": lens, "init_s": init_s, "init_peak_bytes": init_peak,
           "weight_bytes": weight_bytes}
    for kv_quant in (False, True):
        pool_name = "nvfp4_pool" if kv_quant else "bf16_pool"
        attn = "paged_mla_q" if kv_quant else "paged_mla"
        kw = dict(kv_quant=kv_quant, prequant=False)  # packed already
        serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
                   prompts[:1], 2, **kw)  # warm-up, not measured
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng, results, setup_s, wall = serve_once(
            torch, cfg, params, EngineConfig, Request, ServeEngine, prompts, 16,
            **kw)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        served(torch, cfg, eng, results, prompts, 16, launches,
               ("nvfp4_fos_quant", "fp4_matmul", attn))
        other = "paged_mla" if kv_quant else "paged_mla_q"
        if launches[other] or launches["paged_gqa"] or launches["paged_gqa_q"]:
            fail(f"deepseek-v3 ({pool_name}) launched another attention kernel: "
                 f"{launches}")
        r = serving_numbers(results, eng.stats, setup_s, wall, peak, launches)
        r["pool_bytes_over_bf16"] = pool_byte_ratio(eng.pool)
        fill_decode(eng, Request, prompts, 12)
        ops.reset_launches()
        eng.step()
        r["launches_per_decode_step"] = dict(ops.LAUNCHES)
        eng.run()
        log(f"  [{card}] {pool_name}: 4 requests x 16 tokens: decode "
            f"{r['decode_tok_s']:.2f} tok/s ({r['decode_step_ms']:.1f} ms/step host), "
            f"prefill {r['prefill_tok_s']:.1f} tok/s, TTFT median "
            f"{r['ttft_s_median']:.2f} s max {r['ttft_s_max']:.2f} s, peak memory "
            f"{peak / 2**30:.2f} GiB, wall {wall:.1f} s")
        log(f"  launches on the main path: {launches}; per decode step: "
            f"{r['launches_per_decode_step']}")
        r["profile"] = profile_decode(torch, eng, Request, prompts)
        out[pool_name] = r
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 6 took {out['phase_s']:.1f} s")
    return out


def fill_decode(eng, Request, prompts, max_new):
    """Admit 4 short requests and tick until every slot decodes (each has
    room for at least 8 more decode steps)."""
    for p in prompts[:4]:
        eng.submit(Request(p[:16], max_new))
    while any(s.state != "decode" for s in eng.slots):
        eng.step()


def profile_decode(torch, eng, Request, prompts, steps: int = 8):
    """Device time by kernel over `steps` decode steps at full batch
    (torch.profiler), and the device's busy share: device time per step
    over the host-clock time of `steps` full-batch decode steps run just
    before them without the profiler (whose own host overhead inflates the
    wall time of a traced step)."""
    from torch.profiler import ProfilerActivity, profile
    fill_decode(eng, Request, prompts, 2 * steps + 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
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
    dev_step_ms = total_us / 1e3 / steps
    busy = dev_step_ms / step_ms
    log(f"  profile of {steps} full-batch decode steps: device time {dev_step_ms:.3f} "
        f"ms/step against a {step_ms:.2f} ms step (host clock, unprofiled): busy "
        f"{busy:.1%}, idle {1 - busy:.1%}; device time per step by kernel:")
    for us, key, n in rows[:10]:
        log(f"    {us / 1e3 / steps:8.4f} ms  {n // steps:4d}x  {key[:90]}")
    # each port kernel's device ms per step (paged_gqa and paged_gqa_q share
    # their CUDA functions; a path runs one of them)
    by_kernel = {name: sum(us for us, key, _ in rows if of_kernel(key, sym)) / 1e3
                 / steps for name, sym in KERNEL_SYMBOLS.items()}
    log("    port kernels, ms per step: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in by_kernel.items() if ms > 0))
    torch_ops = launches_by_pattern(rows, steps)
    log("    PyTorch launches per step: " + ", ".join(
        f"{p} {n:g} ({ms:.4f} ms)" for p, (n, ms) in torch_ops.items()))
    return {"device_ms_per_step": dev_step_ms, "host_ms_per_step": step_ms,
            "busy_share": busy, "kernel_ms": by_kernel, "torch_launches": torch_ops,
            "top": [(key, us / 1e3 / steps, n // steps) for us, key, n in rows[:12]]}


# PyTorch kernels the quantizer's wrapper used to launch (AbsFunctor, the
# amax's reduce_kernel), the copies that fed MS-EDEN phase 1, and kernels
# with "long" in their names: the int64 functors of the hashed draws
# (core/rng.py), and also every kernel that takes an int64 size
TORCH_PATTERNS = ("AbsFunctor", "reduce_kernel", "copy_kernel", "long")


def launches_by_pattern(rows, steps):
    """{pattern: (launches, device ms)} per step over profile rows (us, key,
    count) whose kernel name holds the pattern."""
    return {p: (sum(n for _, key, n in rows if p in key) / steps,
                sum(us for us, key, _ in rows if p in key) / 1e3 / steps)
            for p in TORCH_PATTERNS}


def phase_training(torch, card):
    """Full-width llama-200m trained for 6 steps through the entry point's
    code path; then one more step under the profiler."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw

    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    log(f"phase 5: training full-width llama-200m (quartet2, AdamW, cosine, "
        f"lr 2e-3, batch 8 x seq 256, {steps} steps)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # every SR uniform tensor HashDraws draws during the run (phase 2 takes
    # key pairs and hashes the uniforms itself: there should be none)
    drawn, real_uniform = [], rng.HashDraws.uniform

    def counted_uniform(self, tag, shape, device):
        drawn.append(tuple(shape))
        return real_uniform(self, tag, shape, device)

    rng.HashDraws.uniform = counted_uniform
    ops.reset_launches()
    try:
        out, trainer, state = launch_train.run(TRAIN_ARGS)
        torch.cuda.synchronize()
    finally:
        rng.HashDraws.uniform = real_uniform
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not all(h["finite"] for h in trainer.history):
        fail(f"non-finite training loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("non-finite parameters after training")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    want = {k: v * steps for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"training launches {got}, expected {want}")
    if drawn:
        fail(f"{len(drawn)} SR uniform tensors drawn on the training path, e.g. "
             f"{drawn[:3]}")
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; "
        f"{out['step_ms']:.1f} ms/step (host clock, steps 2-{steps}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches on the training path: {launches}; SR uniform tensors drawn: 0")
    prof = profile_train_step(torch, trainer, state, out["step_ms"])
    return {"losses": losses, "step_ms": out["step_ms"],
            "step_ms_all": [h["dt"] * 1e3 for h in trainer.history],
            "tokens_per_s": out["tokens_per_s"], "peak_mem_bytes": peak,
            "launches": launches, "profile": prof}


def profile_train_step(torch, trainer, state, step_ms):
    """Device time by kernel of one training step (torch.profiler), and the
    device's busy share against the unprofiled host-clock step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = {k: v.cuda() for k, v in trainer.corpus.batch_at(state.step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows, total_us = [], 0.0
    for ev in prof.key_averages():
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
    dev_ms = total_us / 1e3
    n_launches = sum(n for _, _, n in rows)
    busy = dev_ms / step_ms
    log(f"  profile of one training step: device time {dev_ms:.2f} ms against a "
        f"{step_ms:.1f} ms step: busy {busy:.1%}, idle {1 - busy:.1%}; by kernel:")
    for us, key, n in rows[:12]:
        log(f"    {us / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")
    by_kernel = {}
    for name in ("fp4_matmul", "nvfp4_fos_quant", "ms_eden_phase1", "ms_eden_phase2"):
        by_kernel[name] = sum(us for us, key, _ in rows
                              if of_kernel(key, KERNEL_SYMBOLS[name])) / 1e3
    log("  device ms per training step by ported kernel: " + ", ".join(
        f"{k} {v:.3f}" for k, v in by_kernel.items()))
    torch_ops = launches_by_pattern(rows, 1)
    log(f"  kernel launches per training step: {n_launches} in all; PyTorch: " + ", ".join(
        f"{p} {n:g} ({ms:.3f} ms)" for p, (n, ms) in torch_ops.items()))
    return {"device_ms_per_step": dev_ms, "busy_share": busy, "launches": n_launches,
            "kernel_ms": by_kernel, "torch_launches": torch_ops,
            "top": [(key, us / 1e3, n) for us, key, n in rows[:16]]}


# --------------------------------------------------------------------------
# phase 7: pre-training as users run it
# --------------------------------------------------------------------------

def host_leaves(torch, state):
    """Host copies of every leaf of a training state, in checkpoint order."""
    from repro_torch.checkpoint import checkpointer as C
    return [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
            for x in C.flatten(C.reference_tree(state))]


def same_leaves(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def max_rel_diff(torch, a, b) -> float:
    """The largest max|x - y| / max|y| over paired tensors."""
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               for x, y in zip(a, b))


def train_setup(torch, cfg, optimizer, schedule, lr, total, seed=0):
    """(train_step, freshly built full-width state on the card): seeded
    random weights, the same for every call with the same seed."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_train_step
    init, step = make_train_step(cfg, "quartet2", optimizer=optimizer,
                                 schedule=schedule, base_lr=lr, total_steps=total)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return step, init(lm.init(cfg, gen, "cuda"))


def nondeterministic_ops(torch, step, state, batch):
    """The ops of one training step that PyTorch reports as having no
    deterministic CUDA implementation (use_deterministic_algorithms with
    warn_only: each such op warns, naming itself)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0][:160] for w in seen
                   if "determinis" in str(w.message)})


def phase_resume(torch, card):
    """7a: a full-width llama-200m quartet2 run (AdamW) checkpointed async
    every RESUME_EVERY steps, resumed from its mid checkpoint by a fresh
    Trainer over freshly built state, against the run itself and against
    an uninterrupted repeat."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = registry.get("llama_200m")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8))
    # the reference's rule saves after the step of index RESUME_EVERY: its
    # state has taken RESUME_EVERY + 1 steps, and the checkpoint is labelled so
    mid = RESUME_EVERY + 1
    log(f"phase 7a: resume (full-width llama-200m, quartet2, AdamW, batch 8 x seq "
        f"256, {RESUME_STEPS} steps, async checkpoint every {RESUME_EVERY}: "
        f"labelled {mid}, keep 1)")
    step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
    # f32 on disk: every tensor leaf at 4 bytes an element
    ckpt_bytes = sum(x.numel() * 4 if isinstance(x, torch.Tensor) else 4
                     for x in C.flatten(C.reference_tree(state)))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    # at most two checkpoints on disk at once: the one resumed from and a new one
    if free < 2.1 * ckpt_bytes:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"phase 7a needs {2.1 * ckpt_bytes / 1e9:.2f} GB free under {root} for "
             f"two {ckpt_bytes / 1e9:.2f} GB checkpoints; {free / 1e9:.2f} GB free")
    dir_a, dir_r = os.path.join(root, "a"), os.path.join(root, "resume")
    try:
        tr_a = Trainer(TrainerConfig(total_steps=RESUME_STEPS, ckpt_dir=dir_a,
                                     ckpt_every=RESUME_EVERY, keep_ckpts=1,
                                     log_every=1), step, corpus,
                       device=torch.device("cuda"))
        ck, snap, saves = tr_a.ckpt, {}, []
        real_save, real_gc = ck.save, ck._gc

        def save(s, st, extra=None, blocking=True):
            if s == mid:  # the host snapshot check 1 holds the restore to
                snap["leaves"] = host_leaves(torch, st)
            t0 = time.perf_counter()
            real_save(s, st, extra, blocking)
            saves.append({"step": s, "blocking": blocking,
                          "call_s": time.perf_counter() - t0, "last": ck.last})

        def gc_keeping_mid():
            # hard-link the mid checkpoint aside before keep=1 removes it
            src = os.path.join(dir_a, f"step_{mid:010d}")
            dst = os.path.join(dir_r, f"step_{mid:010d}")
            if os.path.isdir(src) and not os.path.exists(dst):
                os.makedirs(dst)
                for f in os.listdir(src):
                    os.link(os.path.join(src, f), os.path.join(dst, f))
            real_gc()

        ck.save, ck._gc = save, gc_keeping_mid
        ops.reset_launches()
        state = tr_a.run(state)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        a_losses = [h["loss"] for h in tr_a.history]
        a_dt = [h["dt"] * 1e3 for h in tr_a.history]
        a_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        if sorted(os.listdir(dir_a)) != [f"step_{RESUME_STEPS:010d}"]:
            fail(f"run A left {sorted(os.listdir(dir_a))} (keep 1)")
        mid_save = next((s for s in saves if s["step"] == mid), None)
        if mid_save is None or mid_save["blocking"] or "leaves" not in snap:
            fail(f"run A made no async save at step {mid}: {saves}")
        del state, tr_a
        shutil.rmtree(dir_a)
        torch.cuda.empty_cache()

        # the resumed run: a fresh Trainer and freshly built state
        step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
        check1 = {}

        def step_r(st, batch):
            if not check1:  # the state exactly as Trainer.run restored it
                check1["step"] = st.step
                check1["equal"] = same_leaves(torch, host_leaves(torch, st),
                                              snap["leaves"])
            return step(st, batch)

        tr_r = Trainer(TrainerConfig(total_steps=RESUME_STEPS, ckpt_dir=dir_r,
                                     ckpt_every=RESUME_EVERY, keep_ckpts=1,
                                     log_every=1), step_r, corpus,
                       device=torch.device("cuda"))
        t0 = time.perf_counter()
        state = tr_r.run(state, resume=True)
        torch.cuda.synchronize()
        r_wall = time.perf_counter() - t0
        r_losses = [h["loss"] for h in tr_r.history]
        r_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        del state, tr_r
        snap.clear()
        torch.cuda.empty_cache()
        if check1.get("step") != mid or not check1["equal"]:
            fail(f"check 1: the restored state is not bitwise the host snapshot "
                 f"of step {mid}: {check1}")
        if r_losses[0] != a_losses[mid]:
            fail(f"check 2: the resumed run's first loss {r_losses[0]!r} is not "
                 f"run A's {a_losses[mid]!r} at step {mid}")

        # run B: the uninterrupted repeat of A, and the ops that may differ
        step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
        tr_b = Trainer(TrainerConfig(total_steps=RESUME_STEPS, log_every=100),
                       step, corpus, device=torch.device("cuda"))
        state = tr_b.run(state)
        torch.cuda.synchronize()
        b_losses = [h["loss"] for h in tr_b.history]
        b_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        batch = {k: v.cuda() for k, v in corpus.batch_at(state.step).items()}
        nondet = nondeterministic_ops(torch, step, state, batch)
        del state, tr_b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ab_equal = a_losses == b_losses and same_leaves(torch, a_final, b_final)
    r_tail = a_losses[mid:]
    if ab_equal:
        # the card is deterministic here: the resumed run must be bitwise A
        if r_losses != r_tail or not same_leaves(torch, r_final, a_final):
            fail(f"check 3: A and its repeat agree bitwise but the resumed run "
                 f"does not: losses {r_losses} vs {r_tail}")
        bar = "bitwise"
    else:
        # hold the resumed run to the spread between A and its repeat
        loss_spread = max(abs(a - b) for a, b in zip(a_losses, b_losses))
        w_spread = max_rel_diff(torch, b_final, a_final)
        r_loss = max(abs(a - b) for a, b in zip(r_losses, r_tail))
        r_w = max_rel_diff(torch, r_final, a_final)
        if r_loss > loss_spread or r_w > w_spread:
            fail(f"check 3: the resumed run differs from A by {r_loss:.3g} in loss "
                 f"and {r_w:.3g} in weights, beyond A's repeat ({loss_spread:.3g}, "
                 f"{w_spread:.3g}); ops without a deterministic implementation: "
                 f"{nondet}")
        bar = (f"within A's own repeat spread (loss {loss_spread:.3g}, weights "
               f"{w_spread:.3g} max|w|; resumed {r_loss:.3g}, {r_w:.3g})")
    last = mid_save["last"]
    log(f"  [{card}] run A losses {[round(x, 4) for x in a_losses]}")
    log(f"  async save at step {mid}: save() blocked the host {mid_save['call_s'] * 1e3:.1f} "
        f"ms (device-to-host copy {last['copy_s'] * 1e3:.1f} ms, the first save: "
        f"its pinned buffers allocated); the write took "
        f"{last['write_s']:.2f} s on its thread, {last['bytes'] / 1e9:.3f} GB on disk "
        f"({last['bytes'] / last['write_s'] / 1e9:.2f} GB/s); step ms around it: "
        + ", ".join(f"{i}: {t:.1f}" for i, t in enumerate(a_dt)))
    final_save = next(s for s in saves if s["step"] == RESUME_STEPS)
    log(f"  final blocking save at step {RESUME_STEPS}: {final_save['call_s']:.2f} s, "
        f"of which the device-to-host copy into the pinned buffers the first "
        f"save made {final_save['last']['copy_s'] * 1e3:.1f} ms")
    log(f"  resumed at step {mid} in {r_wall:.1f} s (restore included): check 1 "
        f"(restored leaves == host snapshot) bitwise; check 2 (first loss) "
        f"{r_losses[0]!r} == {a_losses[mid]!r}; check 3: {bar}")
    log(f"  A == its uninterrupted repeat B bitwise: {ab_equal}; ops without a "
        f"deterministic CUDA implementation in one step: {nondet or 'none reported'}")
    out = {"a_losses": a_losses, "b_losses": b_losses, "r_losses": r_losses,
           "a_step_ms": a_dt, "mid": mid, "ckpt_bytes_est": ckpt_bytes,
           "save_block_ms": mid_save["call_s"] * 1e3,
           "final_copy_ms": final_save["last"]["copy_s"] * 1e3,
           "copy_ms": last["copy_s"] * 1e3, "write_s": last["write_s"],
           "bytes_on_disk": last["bytes"], "final_save_s": final_save["call_s"],
           "resume_wall_s": r_wall, "a_equals_b": ab_equal, "check3": bar,
           "nondeterministic_ops": nondet, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  phase 7a took {out['phase_s']:.1f} s")
    return out


def probe_site_vs_cpu(torch, params, step):
    """The probe over one site on the card and on the CPU, same weights,
    step and seed: {metric: (card, cpu)}."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quant_probe import QuantProbe
    name, leaf = QuantProbe.sites(params)[0]
    outs = []
    for d in ("cuda", "cpu"):
        path = name.split("/")  # "[0]/l0/ff/wi": rebuild that one site
        tree = {"stages": [{path[1]: {path[2]: {path[3]: leaf.detach().to(d)}}}]}
        probe = QuantProbe("quartet2", every_n=NANOCHAT_PROBE_EVERY, max_sites=1,
                           registry=MetricsRegistry())
        outs.append(probe.probe_params(tree, step=step)[name])
    return name, {m: (outs[0][m], outs[1][m]) for m in outs[0]}


def phase_nanochat(torch, card):
    """7b: the paper's nanochat recipe at llama-200m's widths (QK-norm,
    ReLU^2, Muon, WSD), quartet2, with the quantization-health probe
    attached."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quant_probe import QuantProbe
    from repro_torch.optim import adamw, muon
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get("llama_200m"), qk_norm=True, mlp="relu2")
    steps = NANOCHAT_STEPS
    log(f"phase 7b: the nanochat recipe (llama-200m widths, QK-norm, ReLU^2, quartet2, "
        f"Muon, WSD, lr {NANOCHAT_LR}, batch 8 x seq 256, {steps} steps), "
        f"QuantProbe(every_n={NANOCHAT_PROBE_EVERY})")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8))
    step, state = train_setup(torch, cfg, "muon", "wsd", NANOCHAT_LR, steps, seed=1)
    probe = QuantProbe("quartet2", every_n=NANOCHAT_PROBE_EVERY,
                       registry=MetricsRegistry())
    samples, real_probe = [], probe.probe_params

    def probe_params(params, step=0, phase="train"):
        out = real_probe(params, step=step, phase=phase)
        samples.append((step, out))
        return out

    probe.probe_params = probe_params
    tr = Trainer(TrainerConfig(total_steps=steps, log_every=1), step, corpus,
                 device=torch.device("cuda"), probe=probe)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = tr.run(state)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    if not all(h["finite"] for h in tr.history):
        fail(f"nanochat: non-finite loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("nanochat: non-finite parameters after training")
    if not losses[-1] < losses[0]:
        fail(f"nanochat: the loss did not fall: {losses}")
    probed = sum(len(out) for _, out in samples)
    if [s for s, _ in samples] != list(range(0, steps, NANOCHAT_PROBE_EVERY)):
        fail(f"nanochat: the probe sampled at steps {[s for s, _ in samples]}")
    want = {k: v * steps + PROBE_LAUNCHES_PER_SITE[k] * probed
            for k, v in NANOCHAT_LAUNCHES_PER_STEP.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"nanochat launches {got}, expected {want} ({steps} steps, "
             f"{probed} probed sites)")
    step_ms = sum(h["dt"] for h in tr.history[1:]) / (steps - 1) * 1e3
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms/step "
        f"(host clock, steps 2-{steps}, probe calls outside), peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches on the path ({steps} steps + {len(samples)} probe calls over "
        f"{probed} sites): {launches}")

    # the probe against the paper's Table 1, live on the weights trained
    ratios = []
    for s, out in samples:
        me = sum(v["ms_eden_mse_rel"] for v in out.values()) / len(out)
        sr = sum(v["sr_mse_rel"] for v in out.values()) / len(out)
        ratios.append(sr / me)
        log(f"  probe at step {s}: {len(out)} sites, mean relative MSE: MS-EDEN "
            f"{me:.4g} (paper Table 1: {PAPER_TABLE1['ms_eden_mse_rel']:.3g}), SR "
            f"{sr:.4g} (paper: {PAPER_TABLE1['sr_mse_rel']:.3g}), SR / MS-EDEN "
            f"{sr / me:.2f}; forward 4/6 {sum(v['fwd_mse_rel'] for v in out.values()) / len(out):.4g}")
        for site, v in out.items():
            log(f"    {site:16s} ms_eden {v['ms_eden_mse_rel']:.4g}  sr {v['sr_mse_rel']:.4g}"
                f"  fwd {v['fwd_mse_rel']:.4g}  clip(ms_eden) {v['ms_eden_clip_frac']:.4f}"
                f"  outlier mass {v['rht_outlier_mass']:.3g}")
    if min(ratios) < 2.0:
        fail(f"nanochat: SR's relative MSE is not 2x MS-EDEN's at every probe: {ratios}")

    # one site's probe on the card against the same probe on the CPU
    site, pair = probe_site_vs_cpu(torch, state.params, samples[-1][0])
    worst = max(abs(a - b) / (abs(b) + 1e-9) for a, b in pair.values())
    log(f"  probe of {site} card vs CPU, same weights: max relative difference "
        f"{worst:.3g} over {len(pair)} metrics (bar {PROBE_CPU_RTOL:g})")
    if worst > PROBE_CPU_RTOL:
        fail(f"nanochat: the probe's card output disagrees with the CPU: {pair}")

    # Newton-Schulz's share of the step: its f32 GEMMs on every Muon leaf
    mask = muon.partition_mask(state.params)
    mats = [p.detach() for p, use in zip(adamw.leaves(state.params), mask) if use]
    ns_ms, ns_launches = call_device_ms(torch, lambda: [muon.newton_schulz(m) for m in mats],
                                        reps=1)
    prof = profile_train_step(torch, tr, state, step_ms)
    share = (ns_ms / prof["device_ms_per_step"]
             if ns_ms and prof and prof["device_ms_per_step"] else None)
    ns_flops = sum(ns_gemm_flops(m.shape) for m in mats)
    log(f"  Newton-Schulz over the {len(mats)} Muon leaves: {ns_ms:.2f} ms on the device "
        f"({ns_launches:g} launches, {ns_flops / 1e12:.2f} TFLOP of f32 GEMMs: "
        f"{ns_flops / (ns_ms * 1e-3) / 1e12:.1f} TFLOP/s against the {F32_FLOPS / 1e12:g} "
        f"peak); share of the step's device time "
        + ("not measured" if share is None else f"{share:.1%}"))
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_all": [h["dt"] * 1e3 for h in tr.history],
           "peak_mem_bytes": peak, "launches": launches,
           "probe": [(s, o) for s, o in samples], "sr_over_ms_eden": ratios,
           "probe_cpu_max_rel": worst, "ns_ms": ns_ms, "ns_tflop": ns_flops / 1e12,
           "ns_share": share, "profile": prof, "phase_s": time.perf_counter() - t_phase}
    log(f"  phase 7b took {out['phase_s']:.1f} s")
    return out


def ns_gemm_flops(shape) -> float:
    """The f32 GEMM operations of one `newton_schulz` call on a (..., r, c)
    stack: per iteration X X^T, S S and (.) X at n = min(r, c), m = max."""
    *lead, r, c = shape
    n, m = min(r, c), max(r, c)
    batch = 1
    for x in lead:
        batch *= x
    return batch * 5 * (2 * n * n * m + 2 * n ** 3 + 2 * n * n * m)


def ptxas_summary(build_log: str, prefix: str):
    """One line per kernel whose mangled name holds `prefix`: its registers,
    stack, spills and static shared memory, as `nvcc -Xptxas -v` reports."""
    out, name, frame = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled if prefix in mangled else None
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            short = name[name.rindex(prefix):]
            out.append(f"{short[:60]}: {line.split(':', 1)[1].strip()}; {frame}")
            name = None
    return out


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
    for prefix in ("nvfp4_fos_quant_", "ms_eden_phase1_", "ms_eden_phase2_", "fp4_matmul_",
                   "paged_gqa_", "paged_mla_"):
        for line in ptxas_summary(build.BUILD_INFO.get("log", ""), prefix):
            log("  ptxas " + line)

    kern = phase_kernels(torch)
    requant, mm_err = phase_requant(torch)
    kern.update(requant)
    kern["fp4_matmul"]["max_abs_err"] = max(kern["fp4_matmul"]["max_abs_err"], mm_err)
    kern.update(phase_paged_q_mla(torch))
    for k, err in phase_gqa_splits(torch).items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    kern["fp4_matmul"]["groups"] = phase_matmul_groups(torch)
    phase_small_reference(torch)
    phase_train_reference(torch)
    serving = phase_serving(torch, card)
    serving_kvq = phase_serving(torch, card, kv_quant=True)
    deepseek = phase_deepseek(torch, card)
    training = phase_training(torch, card)
    resume = phase_resume(torch, card)
    nanochat = phase_nanochat(torch, card)
    path_runs = (serving, serving_kvq, deepseek["bf16_pool"],
                 deepseek["nvfp4_pool"], training, resume, nanochat)

    kernels = []
    for k, r in kern.items():
        # launches: the sum over the main-path runs (each path is driven with
        # the counts set to 0 just before it and read just after)
        launches = sum(run["launches"][k] for run in path_runs)
        if launches <= 0:
            fail(f"kernel {k} was not launched on a main path")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "profiler_ms": r["profiler_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library_profiler_ms": r["library_profiler_ms"]}
               if "library_profiler_ms" in r else {}),
            **({"groups": {gname: {key: grp[key] for key in (
                "calls", "ms", "profiler_ms", "plain_ms", "library_ms",
                "library_profiler_ms", "bound_ms", "bound_by")}
                for gname, grp in r["groups"].items()}}
               if "groups" in r else {})})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "device": name, "torch": torch.__version__,
         "build_s": build.BUILD_INFO.get("seconds"), "kernels": kernels,
         "kernel_detail": kern, "serving": serving, "serving_kv_quant": serving_kvq,
         "deepseek": deepseek, "training": training, "resume": resume,
         "nanochat": nanochat},
        indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
