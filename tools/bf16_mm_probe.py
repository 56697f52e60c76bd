#!/usr/bin/env python3
"""bf16_matmul (the port's kernel #9) at the rows of PERF.md's kernel table,
in one or several checkouts of the port, each in a fresh process.

    python3 tools/bf16_mm_probe.py --trees PARENT CHANGE CHANGE PARENT
        [--rows 9 9a ...] [--shapes [--variants]] [--out PATH]

Each tree runs in a child process with that tree's `src` first on sys.path,
its kernels built into that tree's `build/`. The child runs every row of
`chip_smoke.BF16_MM_ROWS` (llama-200m's 71 bf16 GEMMs at M = 4, 64, 128 and
352; its head at 16,384 rows; nemotron-4-15b's head at 4 rows) through the
tree's `ops.bf16_matmul` with `chip_smoke.bf16_mm_row`: every call against
the plain version within BF16_MM_BAR, a part of the rows and each N / 2
half bitwise the whole call's, then events, profiler, plain and
torch.matmul times beside the bound. The measuring code is this
checkout's `chip_smoke.py`, so every tree is timed alike; only the kernel
and its wrapper come from the tree. Run the trees in turns (parent,
change, change, parent) in one call on one card. Prints one line a row and
tree and, last, one JSON object (`--out` also writes it); exits 1 when a
tree failed.

`--shapes` times each distinct (M, N, K) of the rows alone instead (device
us a call, the weight warm in L2 across the repetitions). `--variants` adds,
for a tree whose kernel is the wgmma design, copies of its
`csrc/bf16_matmul.cu` built into `build/` with one part removed (VARIANTS:
the loads, the cluster's exchange of partials, the main loop), which say
where a call's time goes; their outputs are wrong by design.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (anchor in csrc/bf16_matmul.cu, replacement): each variant removes a part
_LOADS = """      load_x<TA, NA>(slot, a, lda, m0, m, k, c0, c1, vec, tid, G::kThreads);
      load_rows<TB>(slot + G::kTile, G::kWPitch, b, ldb, n0, G::kWRows, n, k, c0,
                    c1, vec, tid, G::kThreads);"""
_EXCHANGE = """  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (NA <= kPushWidth) {"""
_DECL = "const int j0 = splits == 1 ? 0 : rank, j1 = splits == 1 ? kChains : rank + 1;"
_COUNT = "  for (int j = j0; j < j1; ++j) stages += chain_stages(j, nch);"
VARIANTS = {
    "no_loads": [(_LOADS, "")],
    "no_exchange": [(_EXCHANGE, "  if (acc[0] == 123.f) c[tid] = acc[1];\n  return;\n"
                     + _EXCHANGE)],
    "no_loop": [(_DECL, _DECL.replace(", j1 =", "; int j1 =")),
                (_COUNT, _COUNT + "\n  stages = 0;\n  j1 = j0;")],
}


def build_variants(tree: Path, build) -> dict:
    """VARIANTS of the tree's kernel, compiled in parallel and loaded."""
    import ctypes
    src = (tree / "src/repro_torch/kernels/csrc/bf16_matmul.cu").read_text()
    out_dir = tree / "build" / "bf16_mm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for anchor, repl in edits:
            if anchor not in text:
                raise SystemExit(f"variant {name}: its anchor is not in the source")
            text = text.replace(anchor, repl)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler",
             "-fPIC", "-shared", "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log[-2000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.bf16_matmul_launch.argtypes = list(build.SIGNATURES["bf16_matmul_launch"])
        lib.bf16_matmul_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def shapes(torch, cs, BM, ops, build, tree, rows, variants) -> dict:
    """Device us a call of each distinct (M, N, K) of `rows`, warm."""
    libs = build_variants(tree, build) if variants else {}

    def launcher(lib):
        def call(a, w):
            m, k = a.shape
            n = w.shape[0]
            p = BM.plan(m, n, k)
            out = torch.empty((m, n), device="cuda")
            build.check(lib.bf16_matmul_launch(
                a.data_ptr(), a.stride(0), 1, w.data_ptr(), w.stride(0), 0,
                out.data_ptr(), m, n, k, p.width, p.groups, p.splits,
                *p.grid, torch.cuda.current_stream().cuda_stream), "variant")
            return out
        return call
    fns = {"kernel": ops.bf16_matmul, **{k: launcher(v) for k, v in libs.items()}}
    g = torch.Generator(device="cuda").manual_seed(5)
    seen, out = set(), {}
    for row in rows:
        _, m, nk = cs.BF16_MM_ROWS[row]
        for n, k in nk:
            if (m, n, k) in seen:
                continue
            seen.add((m, n, k))
            a = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            w = torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
            reps = 10 if m * n * k < 2 ** 32 else 3
            t = {name: cs.device_ms(torch, lambda f=f: f(a, w), "bf16_matmul_", reps)
                 for name, f in fns.items()}
            out[f"{m}x{n}x{k}"] = {name: None if v is None else v * 1e3
                                   for name, v in t.items()}
            cs.log(f"  {m} x {n} x {k}: " + ", ".join(
                f"{name} {'-' if v is None else f'{v * 1e3:.2f}'} us"
                for name, v in t.items()))
            del a, w
            torch.cuda.empty_cache()
    return out


def one(tree: Path, rows, per_shape=False, variants=False) -> dict:
    """The child: every row in `tree`, printed as one JSON line."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import bf16_matmul as BM
    from repro_torch.kernels import build, ops
    if not torch.cuda.is_available():
        cs.fail("bf16_mm_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    t0 = time.perf_counter()
    build.library()
    out = {"tree": str(tree), "card": smi.stdout.strip(),
           "build_s": time.perf_counter() - t0, "rows": {},
           "ptxas": cs.ptxas_summary(build.BUILD_INFO.get("log", ""),
                                     "bf16_matmul_")}
    for line in out["ptxas"]:
        cs.log("  ptxas " + line)
    if per_shape:
        out["shapes"] = shapes(torch, cs, BM, ops, build, tree, rows, variants)
        print(json.dumps(out), flush=True)
        return out
    g = torch.Generator(device="cuda").manual_seed(18)
    for row in rows:
        out["rows"][row] = cs.bf16_mm_row(
            torch, BM, ops, g, row, 20 if len(cs.BF16_MM_ROWS[row][2]) > 1 else 10)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--rows", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    rows = a.rows or list(cs.BF16_MM_ROWS)
    if a.one:
        one(Path(a.one).resolve(), rows, a.shapes, a.variants)
        return 0
    extra = ["--shapes"] * a.shapes + ["--variants"] * a.variants
    runs, status = [], 0
    for i, tree in enumerate(a.trees):
        tree = Path(tree).resolve()
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--one", str(tree), "--rows", *rows, *extra],
                           cwd=str(tree), capture_output=True, text=True)
        print(p.stdout.rstrip("\n"), flush=True)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        if p.returncode != 0 or not last.startswith("{"):
            print(f"tree {i} ({tree}) failed, rc {p.returncode}:\n"
                  f"{p.stderr[-3000:]}", flush=True)
            status = 1
            continue
        run = json.loads(last)
        run["run"], run["wall_s"] = i, time.perf_counter() - t0
        runs.append(run)
    for run in runs:
        for shape, t in run.get("shapes", {}).items():
            print(f"run {run['run']} {shape}: " + ", ".join(
                f"{k} {'-' if v is None else f'{v:.2f}'} us" for k, v in t.items())
                + f" [{run['card']}] {run['tree']}")
        for row, r in run["rows"].items():
            print(f"run {run['run']} row {row}: events {r['ms']:.4f} ms, "
                  f"profiler {r['profiler_ms']}, plain {r['plain_ms']:.4f}, "
                  f"torch.matmul {r['library_ms']:.4f} (profiler "
                  f"{r['library_profiler_ms']}), bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']}); max |dC| {r['max_rel_err']:.2e} of "
                  f"max|C| [{run['card']}] {run['tree']}")
    line = json.dumps({"runs": runs})
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line)
    return status


if __name__ == "__main__":
    sys.exit(main())
