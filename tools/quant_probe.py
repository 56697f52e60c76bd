#!/usr/bin/env python3
"""Measurements of the NVFP4 4/6 quantizer (`ops.nvfp4_fos_quant`, kernel #1)
on one NVIDIA GPU, for PERF.md.

    python3 tools/quant_probe.py --trees PARENT CHANGE CHANGE PARENT
    python3 tools/quant_probe.py --designs

--trees: for each checkout in turn (one fresh process each, its kernels built
into its own build/), the whole call's device time of the quantizer over one
step of each path (`chip_smoke.quant_step_sets`: llama-200m decode, 70 calls;
deepseek-v3 decode, 197; training, 140): every CUDA kernel a call launches,
summed from torch.profiler, so a wrapper's own PyTorch kernels count too.
Then MS-EDEN phase 1 over one training step's 280 operands, as that
checkout's backward hands them (transposed views, or contiguous copies made
beforehand where its phase 1 takes no views). With --train, also the
kernel launches (all, and the PyTorch copy, abs, reduction and int64 ones)
and device time of one profiled step of that checkout's full-width
training run (`chip_smoke.TRAIN_ARGS`, `chip_smoke.profile_train_step`).

--sass (this checkout): instruction counts of the quantizer kernels
(#1 and MS-EDEN phase 1) in the built library, from cuobjdump.

--designs (this checkout): (1) the two large-tensor designs at training
shapes, (2048, 1280) bf16 and (1280, 3456) f32: the port's two-pass regime
against a persistent cooperative grid (`tools/csrc/nvfp4_coop_probe.cu`, one
CTA an SM holding its chunks in shared memory across one grid barrier),
outputs bitwise equal; (2) both regimes forced on decode and prefill shapes
around the cluster threshold (`nvfp4_quant.SMALL_MAX_CHUNKS`).

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
tree, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.kernels import build, ops
from repro_torch.kernels import nvfp4_quant as NQ
build.library()
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for name, calls in cs.quant_step_sets().items():
    train = name == "train_step"
    r = cs.quant_group(torch, NQ, ops, calls, g, 5 if train else 20, 0)
    out[name] = {k: r[k] for k in ("calls", "ms", "profiler_ms", "kernels_per_call",
                                   "bound_ms", "bound_by", "regimes")}
    torch.cuda.empty_cache()
# MS-EDEN phase 1 over one training step's 280 operands, as the checkout's
# backward hands them: transposed views where phase 1 reads them in place
# (ms_eden_requant.layout exists), else contiguous copies (made beforehand)
from repro_torch.core import rng
from repro_torch.kernels import ms_eden_requant as MR
xs = [x for _ in range(10) for x in cs.backward_operands(torch, g, cs.TRAIN_T)]
if not hasattr(MR, "layout"):
    xs = [x.contiguous() for x in xs]
signs = rng.HashDraws([7, 7]).signs(0, 128, "cuda")
fn = lambda: [ops.ms_eden_phase1(x, signs) for x in xs]
dev, kernels = cs.call_device_ms(torch, fn)
out["phase1_train_step"] = {
    "calls": len(xs), "ms": cs.time_ms(torch, fn, 5), "profiler_ms": dev,
    "kernel_ms": cs.device_ms(torch, fn, "ms_eden_phase1_kernel"),
    "kernels_per_call": kernels / len(xs), "views": hasattr(MR, "layout"),
    "bound_ms": sum(x.numel() for x in xs) * (4 + 0.5 + 12 / 16) / cs.HBM_BYTES_S * 1e3}
if hasattr(MR, "layout"):  # the same calls on contiguous copies
    xs = [x.contiguous() for x in xs]
    out["phase1_train_step"]["contiguous_kernel_ms"] = cs.device_ms(
        torch, fn, "ms_eden_phase1_kernel")
if "--train" in sys.argv:  # the launches of one profiled training step
    from repro_torch.launch import train as launch_train
    res, trainer, state = launch_train.run(cs.TRAIN_ARGS)
    prof = cs.profile_train_step(torch, trainer, state, res["step_ms"])
    out["training"] = {k: prof[k] for k in ("device_ms_per_step", "kernel_ms",
                                            "launches", "torch_launches")}
print("PROBE_JSON " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path, train: bool) -> dict:
    p = subprocess.run([sys.executable, "-c", WORKER, str(tree), str(ROOT)]
                       + (["--train"] if train else []), capture_output=True, text=True)
    for line in p.stdout.splitlines():
        if line.startswith("PROBE_JSON "):
            return json.loads(line[len("PROBE_JSON "):])
    sys.exit(f"quant_probe: run in {tree} failed (rc {p.returncode}):\n"
             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")


def coop_library(torch):
    """Build tools/csrc/nvfp4_coop_probe.cu as the port builds its kernels."""
    import ctypes
    import subprocess as sp
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    out = ROOT / "build" / "quant_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libnvfp4_coop_probe.so"
    cmd = [build._nvcc(), *build.ARCH_FLAGS, *build.CFLAGS, "-shared",
           str(ROOT / "tools" / "csrc" / "nvfp4_coop_probe.cu"), "-o", str(lib)]
    p = sp.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        sys.exit(f"quant_probe: nvcc failed:\n{p.stdout}\n{p.stderr}")
    print("  ptxas (coop probe): " + " | ".join(
        ln.strip() for ln in (p.stdout + p.stderr).splitlines()
        if "coop" in ln or "Used" in ln)[:1500], flush=True)
    so = ctypes.CDLL(str(lib))
    P, I, L, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                     ctypes.c_float, ctypes.c_uint)
    so.nvfp4_fos_quant_coop_launch.argtypes = [P, I, P, P, U, P, P, P, L, L, I, L,
                                               F, F, F, P]
    so.nvfp4_fos_quant_coop_launch.restype = ctypes.c_int
    return so


def designs(out: dict) -> None:
    import torch
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import nvfp4_quant as NQ

    build.library()
    so = coop_library(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counter = torch.zeros((1,), dtype=torch.int32, device="cuda")
    partials = torch.empty((sms,), dtype=torch.float32, device="cuda")
    issued = [0]  # CTAs the counter has seen: each call's barrier target

    def coop(x):
        m, k = x.shape
        chunks = m * k // NQ.CHUNK
        per = -(-chunks // sms)
        per = -(-per // 32) * 32
        ctas = -(-chunks // per)
        packed = torch.empty((m, k // 2), dtype=torch.uint8, device="cuda")
        bits = torch.empty((m, k // 16), dtype=torch.uint8, device="cuda")
        gs = torch.empty((), dtype=torch.float32, device="cuda")
        issued[0] += ctas
        st = so.nvfp4_fos_quant_coop_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), partials.data_ptr(),
            counter.data_ptr(), issued[0], packed.data_ptr(), bits.data_ptr(),
            gs.data_ptr(), m, k, ctas, per, NQ.GDIV, NQ.S6, NQ.S4,
            torch.cuda.current_stream().cuda_stream)
        if st != 0:
            sys.exit(f"quant_probe: coop launch failed with error {st}")
        return packed, bits, gs

    g = torch.Generator(device="cuda").manual_seed(1)
    out["designs"] = {}
    print("large tensors: two-pass regime against a cooperative grid "
          "(per call; 20 calls on distinct inputs)", flush=True)
    for m, k, dt in ((2048, 1280, torch.bfloat16), (1280, 3456, torch.float32),
                     (2048, 3456, torch.bfloat16)):
        xs = [torch.randn((m, k), generator=g, device="cuda").to(dt) for _ in range(20)]
        a, b = ops.nvfp4_fos_quant(xs[0]), coop(xs[0])
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        row = {}
        for name, fn in (("two_pass", ops.nvfp4_fos_quant), ("coop", coop),
                         ("two_pass_again", ops.nvfp4_fos_quant), ("coop_again", coop)):
            f = lambda fn=fn: [fn(x) for x in xs]
            dev, _ = cs.call_device_ms(torch, f)
            row[name] = {"events_ms": cs.time_ms(torch, f, 10) / len(xs),
                         "device_ms": None if dev is None else dev / len(xs)}
        nbytes = m * k * (xs[0].element_size() + 0.5 + 1 / 16)
        row["bound_ms"] = nbytes / cs.HBM_BYTES_S * 1e3
        row["bitwise_equal"] = same
        out["designs"][f"{m}x{k} {dt}"] = row
        print(f"  ({m}, {k}) {dt}: " + ", ".join(
            f"{n} events {v['events_ms'] * 1e3:.2f} us device {v['device_ms'] * 1e3:.2f} us"
            for n, v in row.items() if isinstance(v, dict))
            + f"; bound {row['bound_ms'] * 1e3:.2f} us; outputs "
            f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            sys.exit("quant_probe: the cooperative design disagrees")

    print("regimes forced around the cluster threshold (per call, bf16; 50 calls "
          "on distinct inputs)", flush=True)
    out["regimes"] = {}
    for m, k in ((4, 1280), (4, 3456), (8, 2048), (4, 7168), (8, 7168), (4, 16384),
                 (16, 3456), (64, 1280), (64, 3456)):
        chunks = m * k // NQ.CHUNK
        xs = [torch.randn((m, k), generator=g, device="cuda").bfloat16() for _ in range(50)]
        plans = {"two_pass": NQ.two_pass_plan(chunks)}
        if chunks <= NQ.SMALL_MAX_CHUNKS:
            plans["cluster"] = NQ.cluster_plan(chunks)
        row = {"chunks": chunks, "plan": NQ.plan(m, k).regime}
        for name, p in plans.items():
            def f(p=p):
                for x in xs:
                    outs = (torch.empty((m, k // 2), dtype=torch.uint8, device="cuda"),
                            torch.empty((m, k // 16), dtype=torch.uint8, device="cuda"),
                            torch.empty((), dtype=torch.float32, device="cuda"))
                    NQ.launch(x, *outs, p=p)
            dev, _ = cs.call_device_ms(torch, f)
            row[name] = {"plan": list(p), "events_us": cs.time_ms(torch, f, 10) / len(xs) * 1e3,
                         "device_us": None if dev is None else dev / len(xs) * 1e3}
        out["regimes"][f"{m}x{k}"] = row
        print(f"  ({m}, {k}) {chunks} chunks, plan {row['plan']}: " + ", ".join(
            f"{n} {v['plan'][1]}x{v['plan'][2]} events {v['events_us']:.2f} us device "
            f"{v['device_us']:.2f} us" for n, v in row.items() if isinstance(v, dict)),
            flush=True)


def sass(out: dict) -> None:
    """Instruction counts of the port's quantizer kernels in the built
    library (cuobjdump -sass): all, and the divides' slow-path calls,
    reciprocal and shuffle instructions, branches, local memory."""
    import re
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    lib = build.build()
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out["sass"] = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search("nvfp4_fos_quant_|ms_eden_phase1_", name):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        ops_ = [i.split(".")[0] for i in ins]
        row = {"all": len(ops_), **{op: ops_.count(op) for op in (
            "CALL", "MUFU", "SHFL", "BRA", "BSSY", "LDL", "STL", "FADD", "FMUL",
            "FFMA", "FSETP", "FCHK")}}
        short = re.sub(r"^_ZN\w*?(nvfp4_fos_quant_|ms_eden_phase1_)", r"\1", name)[:60]
        out["sass"][short] = row
        print(f"  sass {short}: " + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=[])
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "quant_probe.json"))
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("quant_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    out = {"card": card, "trees": []}
    for tree in a.trees:
        r = run_tree(Path(tree).resolve(), a.train)
        out["trees"].append({"tree": tree, **r})
        train = r.pop("training", None)
        if train:
            print(f"{tree}: training step, device {train['device_ms_per_step']:.2f} ms; "
                  f"{train['launches']} launches; PyTorch {train['torch_launches']}; "
                  f"ported kernels (ms) {train['kernel_ms']}", flush=True)
        print(f"{tree}: " + "; ".join(
            f"{n} {v['calls']} calls, {v['kernels_per_call']:.2f} kernels a call: "
            f"events {v['ms']:.4f} ms, device {v['profiler_ms']} ms"
            + (f" (kernel {v['kernel_ms']} ms)" if "kernel_ms" in v else "")
            + (f" (contiguous copies: kernel {v['contiguous_kernel_ms']} ms)"
               if "contiguous_kernel_ms" in v else "")
            + f", bound {v['bound_ms']:.5f} ms" for n, v in r.items()), flush=True)
    if a.sass:
        sass(out)
    if a.designs:
        designs(out)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
