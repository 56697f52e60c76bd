#!/usr/bin/env python3
"""Which op makes a bf16 serving step's rows depend on how many rows run beside them.

    python3 tools/shard_step_diff.py [--device cuda] [--layers 4] [--slots 4]
        [--kv-quant] [--reduced] [--hold] [--json PATH] [--engine]

Runs one teacher-forced bf16 decode step of llama-200m (its first
`--layers` layers at full width, seeded weights; `--reduced` for the CPU
config) on the port's paged pool, twice: once over `--slots` rows (4 by
default), as the unsharded engine runs it, and once as two data shards of
half the rows (`serve.decode.make_sharded_serve_step` over
`make_serve_mesh(2, 1, devices=[device] * 2)`), each shard over its own pool
tree holding the same K/V. The step is a 16-token prefill chunk of the
prompts (64 rows at 4 slots, 128 at 8), then one token.

Every call of the model's functions (`models.lm._apply_layer`, the norms,
`mlp_apply`, `gqa_decode`, rope, the embedding lookup, the LM head) and of
the leaf ops (`core.linear._mm`, `dense`, `models.blocks.rmsnorm`, every
`kernels.ops` wrapper) is recorded by a wrapper patched over the function
wherever the package binds it. Two readings:

  - propagation: the k-th call of each shard's step against the same call
    of the whole step, the shard's rows of its outputs. The first call whose
    outputs differ is printed with its row counts, shapes and max ulps;
  - replay: every leaf op of the whole step is called again on each half
    of its row inputs (the same values), and its output held against the
    matching rows of the whole output. A leaf op whose rows change with the
    row count is named, however its result then propagates.

It also prints the geometry `kernels.paged_attention.plan` gives #5 for
the whole table and for each shard's table (the splits follow the table
width maxb, which a shard-local table could change), and says where the
engine samples (the gathered logits of all rows at once, in both layouts).

The output's last line is one JSON object: the row-dependent leaf ops, the
first differing call, the #5 plans. With `--hold` the exit code is 1 when
any op differs. `--json PATH` also writes it to a file.

`--engine` runs whole engines instead of one step, as the card test
`test_data_sharded_bf16_streams_bitwise_on_card` does (prompts of
ENGINE_LENS tokens, 12 new each, a 16-token prefill chunk): the unsharded
engine with every leaf op of every step replayed on each half of its rows
(the two shards' rows), then the two-shard engine; it prints the replays
and whether the streams are the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import linear as L  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import decode as serve_decode  # noqa: E402
from repro_torch.serve.kv_pool import KVPool  # noqa: E402

LENS = (33, 17, 49, 33)   # phase 17's prompts; the step reads their first 17
# (beyond 4 slots the lengths repeat)
MAX_LEN = 80
STEPS = ((0, 16), (16, 1))  # (first position, tokens): a chunk, then one token
ENGINE_LENS = (33, 17, 49, 33, 41, 25, 17, 49)   # --engine: the card test's
ENGINE_NEW = 12

# leaf ops, replayed on each half of their row inputs: (module, name, the
# positional arguments that carry the rows)
LEAVES = {"_mm": (L, "_mm", (0,)), "dense": (L, "dense", (0,)),
          "rmsnorm": (B, "rmsnorm", (0,)), "apply_rope": (A, "apply_rope", (0, 1, 2)),
          "rope_tables": (A, "rope_tables", (0,)),
          "embed_lookup": (B, "embed_lookup", (1,)),
          "ops.nvfp4_fos_quant": (ops, "nvfp4_fos_quant", (0,)),
          "ops.fp4_matmul": (ops, "fp4_matmul", (0, 1)),
          "ops.paged_gqa": (ops, "paged_gqa", (0, 3, 4)),
          "ops.paged_gqa_q": (ops, "paged_gqa_q", (0, 5, 6))}
if hasattr(ops, "bf16_matmul"):  # the kernel that made the step row-independent
    LEAVES["ops.bf16_matmul"] = (ops, "bf16_matmul", (0,))
# composite calls: recorded for the propagation reading only
COMPOSITES = {"norm": (B, "norm", ()), "mlp_apply": (B, "mlp_apply", ()),
              "lm_head": (B, "lm_head", ()),
              "_project_qkv": (A, "_project_qkv", ()),
              "gqa_decode": (A, "gqa_decode", ()),
              "_apply_layer": (lm, "_apply_layer", ())}

MANTISSA = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}


def first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for v in x:
            t = first_tensor(v)
            if t is not None:
                return t
    return None


def max_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in ulps of want's dtype at each element of want (an
    integer or byte tensor: 0 when equal, inf otherwise)."""
    if got.shape != want.shape:
        return float("inf")
    if want.dtype not in MANTISSA:
        return 0.0 if torch.equal(got, want) else float("inf")
    g, w = got.double().cpu(), want.double().cpu()
    tiny = torch.finfo(want.dtype).tiny
    ulp = torch.pow(2.0, torch.floor(torch.log2(w.abs().clamp_min(tiny)))
                    - MANTISSA[want.dtype])
    d = (g - w).abs()
    both_inf = torch.isinf(g) & torch.isinf(w) & (g == w)
    d = torch.where(both_inf, torch.zeros_like(d), d)
    return float((d / ulp).max()) if d.numel() else 0.0


class Recorder:
    """Patches every recorded function wherever a `repro_torch` module binds
    it; `calls[tag]` lists (name, output) in completion order."""

    def __init__(self):
        self.tag = None
        self.calls: dict = {}
        self.replays: dict = {}   # leaf name -> [calls, row-dependent, max ulps]
        self.replay = False
        self._saved = []

    def _wrap(self, name, fn, leaf, row_args):
        rec = self

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if rec.tag is None:
                return out
            t = first_tensor(out)
            rec.calls.setdefault(rec.tag, []).append(
                (name, None if t is None else t.detach().clone()))
            if leaf and rec.replay and t is not None:
                rec._replay(name, fn, args, kwargs, t, row_args)
            return out
        return wrapped

    def _replay(self, name, fn, args, kwargs, out, row_args):
        rows = out.shape[0]
        if rows % 2:
            return
        half = rows // 2

        def cut(i, x, s):
            if i in row_args and isinstance(x, torch.Tensor) and x.dim() \
                    and x.shape[0] == rows:
                return x[s * half:(s + 1) * half]
            return x
        tag, self.tag = self.tag, None
        try:
            worst = 0.0
            for s in range(2):
                got = first_tensor(fn(*(cut(i, x, s) for i, x in enumerate(args)),
                                      **kwargs))
                worst = max(worst, max_ulps(got, out[s * half:(s + 1) * half]))
        finally:
            self.tag = tag
        entry = self.replays.setdefault(name, {"calls": 0, "row_dependent": 0,
                                               "max_ulps": 0.0, "shapes": set()})
        entry["calls"] += 1
        entry["row_dependent"] += worst > 0
        entry["max_ulps"] = max(entry["max_ulps"], worst)
        if worst > 0:
            entry["shapes"].add(f"{rows} rows -> {half}: "
                                f"{tuple(out.shape)} {str(out.dtype)[6:]}")

    def install(self):
        mods = [m for n, m in sys.modules.items()
                if n.startswith("repro_torch") and m is not None]
        for table, leaf in ((LEAVES, True), (COMPOSITES, False)):
            for name, (mod, attr, row_args) in table.items():
                fn = getattr(mod, attr)
                wrapped = self._wrap(name, fn, leaf, row_args)
                for m in mods:
                    for k, v in list(vars(m).items()):
                        if v is fn:
                            self._saved.append((m, k, v))
                            setattr(m, k, wrapped)

    def remove(self):
        for m, k, v in reversed(self._saved):
            setattr(m, k, v)
        self._saved.clear()


def propagation(rec: Recorder, n_shards: int):
    """The first call of the sharded step whose outputs differ from the
    matching rows of the whole step's, or None."""
    whole = rec.calls.get("whole", [])
    for s in range(n_shards):
        if len(rec.calls.get(f"shard{s}", [])) != len(whole):
            return {"call": None, "what": "the call sequences differ in length"}
    for k, (name, w) in enumerate(whole):
        for s in range(n_shards):
            sname, g = rec.calls[f"shard{s}"][k]
            if sname != name:
                return {"call": k, "what": f"call {k} is {name} whole and "
                        f"{sname} on shard {s}"}
            if w is None or g is None or not w.dim():
                continue
            if w.shape[0] != n_shards * g.shape[0]:
                continue  # not a per-row output (a pool leaf, a scale)
            n = g.shape[0]
            u = max_ulps(g, w[s * n:(s + 1) * n])
            if u > 0:
                return {"call": k, "name": name, "shard": s,
                        "rows": [int(w.shape[0]), int(n)],
                        "shape_whole": list(w.shape), "shape_shard": list(g.shape),
                        "dtype": str(w.dtype)[6:], "max_ulps": u}
    return None


def attention_plans(cfg, pools):
    """#5's plan for the whole table and each shard's table."""
    out = {}
    whole, sharded = pools
    maxb = whole.tables_device().shape[-1]
    out["whole"] = PA.plan(whole.n_slots, 1, cfg.n_heads, cfg.n_kv_heads, maxb,
                           whole.block_size, cfg.hd)._asdict()
    for s, t in enumerate(sharded.tables_device()):
        out[f"shard{s}"] = PA.plan(t.shape[0], 1, cfg.n_heads, cfg.n_kv_heads,
                                   t.shape[-1], sharded.block_size,
                                   cfg.hd)._asdict()
    same = all(out[k]["splits"] == out["whole"]["splits"]
               and out[k]["blocks_per_split"] == out["whole"]["blocks_per_split"]
               for k in out)
    return out, same


def engine_run(cfg, params, dev, n, kv_quant):
    """--engine: the unsharded engine's streams with every leaf op replayed
    on each half of its rows, and the two-shard engine's streams."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    g = torch.Generator().manual_seed(17)
    prompts = [torch.randint(0, cfg.vocab, (ENGINE_LENS[i % len(ENGINE_LENS)],),
                             generator=g).tolist() for i in range(n)]

    def streams(mesh, rec=None):
        eng = ServeEngine(cfg, params, EngineConfig(
            n_slots=n, max_len=MAX_LEN, block_size=16, prefill_chunk=16,
            scheme="bf16", prequant=True, device=str(dev), kv_quant=kv_quant,
            mesh=mesh))
        ids = [eng.submit(Request(list(q), ENGINE_NEW)) for q in prompts]
        if rec is not None:
            rec.install()
            rec.tag, rec.replay = "engine", True
        try:
            res = {r.req_id: r.tokens for r in eng.run()}
        finally:
            if rec is not None:
                rec.tag, rec.replay = None, False
                rec.remove()
        return [res[i] for i in ids]
    rec = Recorder()
    want = streams(None, rec)
    got = streams(make_serve_mesh(2, 1, devices=[dev, dev]))
    same = [g == w for g, w in zip(got, want)]
    print(f"engine, {n} slots, {'NVFP4' if kv_quant else 'bf16'} pool: streams "
          f"of the two-shard engine the same as the unsharded engine's: {same}")
    for name, e in rec.replays.items():
        print(f"  replay {name}: {e['calls']} calls, {e['row_dependent']} "
              f"row-dependent, max {e['max_ulps']:.3g} ulps"
              + (f" ({'; '.join(sorted(e['shapes']))})" if e["shapes"] else ""))
    row_dep = sorted(n for n, e in rec.replays.items() if e["row_dependent"])
    return {"device": str(dev), "layers": cfg.n_layers, "slots": n,
            "pool": "NVFP4" if kv_quant else "bf16", "streams_same": same,
            "replays": {n: {**e, "shapes": sorted(e["shapes"])}
                        for n, e in rec.replays.items()},
            "row_dependent_ops": row_dep,
            "bitwise": all(same) and not row_dep}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4,
                    help="rows of the whole step (even: two data shards)")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--hold", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--engine", action="store_true")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu --reduced")
    base = registry.get("llama_200m")
    cfg = dataclasses.replace(base.reduced() if a.reduced else base,
                              n_layers=a.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, dev)
    g = torch.Generator().manual_seed(17)
    n = a.slots
    if n < 2 or n % 2:
        ap.error("--slots must be even and at least 2")
    if a.engine:
        result = engine_run(cfg, params, dev, n, a.kv_quant)
        return finish(a, result)
    prompts = [torch.randint(0, cfg.vocab, (LENS[i % len(LENS)],),
                             generator=g).tolist() for i in range(n)]
    mesh = make_serve_mesh(2, 1, devices=[dev, dev])
    pools = [KVPool(cfg, n, MAX_LEN, block_size=16, device=dev,
                    quantized=a.kv_quant, **kw)
             for kw in ({}, {"n_shards": 2, "devices": mesh.devices})]
    for pool in pools:
        for slot in range(n):
            pool.commit(slot, 17)
            pool.ensure(slot, 17)
    whole_step = serve_decode.make_paged_serve_step(cfg, "bf16")
    shard_step = serve_decode.make_paged_serve_step(cfg, "bf16")
    toks = torch.tensor([q[:17] for q in prompts], dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    rec = Recorder()
    rec.install()
    result = {"device": str(dev), "layers": cfg.n_layers, "slots": n,
              "pool": "NVFP4" if a.kv_quant else "bf16", "steps": []}
    if dev.type == "cuda":
        result["card"] = torch.cuda.get_device_name(0)
    plans, same = attention_plans(cfg, pools)
    result["paged_gqa_plans"] = plans
    result["paged_gqa_plans_same"] = same
    try:
        for start, size in STEPS:
            rec.calls, rec.replays = {}, {}
            t = toks[:, start:start + size]
            pos = torch.full((n,), start, dtype=torch.int32)
            rec.tag, rec.replay = "whole", True
            want, _ = whole_step(params, pools[0].caches, pools[0].tables_device(),
                                 t.to(dev), pos.to(dev), active.to(dev))
            rec.replay = False
            tables = pools[1].tables_device()
            got = []
            for s in range(2):
                r = slice(s * n // 2, (s + 1) * n // 2)
                rec.tag = f"shard{s}"
                out, _ = shard_step(params, pools[1].shard_caches[s], tables[s],
                                    t[r].to(dev), pos[r].to(dev), active[r].to(dev))
                got.append(out)
            rec.tag = None
            if dev.type == "cuda":
                torch.cuda.synchronize()
            logits_ulps = max_ulps(torch.cat(got)[:, -1].float(),
                                   want[:, -1].float())
            row_dep = {n: {**e, "shapes": sorted(e["shapes"])}
                       for n, e in rec.replays.items() if e["row_dependent"]}
            step = {"tokens": size, "first_position": start,
                    "logits_max_f32_ulps": logits_ulps,
                    "first_difference": propagation(rec, 2),
                    "row_dependent_leaves": row_dep,
                    "leaves_replayed": {n: e["calls"]
                                        for n, e in rec.replays.items()}}
            result["steps"].append(step)
            print(f"step of {size} token(s) from position {start}: logits "
                  f"{logits_ulps:.3g} f32 ulps from the {n}-row step's")
            fd = step["first_difference"]
            print("  first differing call: " + (
                "none" if fd is None else json.dumps(fd)))
            for name, e in rec.replays.items():
                print(f"  replay {name}: {e['calls']} calls, {e['row_dependent']} "
                      f"row-dependent, max {e['max_ulps']:.3g} ulps"
                      + (f" ({'; '.join(sorted(e['shapes']))})"
                         if e["shapes"] else ""))
    finally:
        rec.remove()
    print("#5 plans (splits, blocks a split): "
          + ", ".join(f"{k} {v['splits']}x{v['blocks_per_split']} (maxb "
                      f"{v['maxb']})" for k, v in plans.items())
          + ("; the same" if same else "; they DIFFER"))
    print("sampling: the engine samples the gathered logits of all rows in one "
          "call, sharded or not (serve/engine.py `_sample`), so the sampler "
          "sees the same rows in both layouts")
    ops_at_fault = sorted({n for s in result["steps"]
                           for n in s["row_dependent_leaves"]})
    result["row_dependent_ops"] = ops_at_fault
    result["bitwise"] = (not ops_at_fault and all(
        s["first_difference"] is None for s in result["steps"]) and same)
    return finish(a, result)


def finish(a, result: dict) -> dict:
    """Print (and with --json write) the JSON line; --hold exits 1 unless
    the result is bitwise."""
    line = json.dumps(result, default=str)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(line + "\n")
    print(line)
    if a.hold and not result["bitwise"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
