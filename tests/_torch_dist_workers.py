"""Rank bodies of the port's multi-rank CPU tests (tests/test_torch_dist.py,
tests/test_torch_dp_train.py), run by `repro_torch.dist.spawn` over gloo.

This module imports neither jax nor the reference package, so the spawned
ranks, which import it by name, stay jax-free; the tests hand them numpy
inputs (and the reference's uniforms) and compare what they return with
the reference in the test process. Every rank runs on one CPU thread."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import dist as D
from repro_torch.configs import registry
from repro_torch.core import linear as L
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.dist import compression as C
from repro_torch.dist import pipeline as PP
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

CFG = registry.get("llama_200m").reduced()
SEQ, BATCH = 16, 4          # the DP tests' global batch: 4 rows of 16 tokens


class Injected:
    """A rank's draw source returning given uniforms, by tag."""

    def __init__(self, by_tag: dict):
        self.by_tag = by_tag

    def uniform(self, tag, shape, device):
        u = torch.from_numpy(self.by_tag[tag]).to(device)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u


def _placement_names(tree) -> list:
    out = []
    SH.map_with_path(lambda p, x: out.append((p, None if x is None else
                                              tuple(str(e) for e in x))),
                     tree, is_leaf=lambda x: x is None or (
                         isinstance(x, tuple) and x and not isinstance(
                             x[0], tuple) and hasattr(x[0], "is_shard")))
    return out


def four_rank_body(rank: int, world: int, inputs: dict) -> dict:
    """Everything test_torch_dist.py asks of 4 gloo ranks, in one group:
    sharding on a (2, 2) mesh, compression, GPipe."""
    torch.set_num_threads(1)
    out = {}

    # sharding: reduced llama placed by state_shardings(fsdp=True)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = lm.init(CFG, torch.Generator().manual_seed(0), "cpu")
    plc = SH.state_shardings(params, mesh, fsdp=True)
    placed = SH.distribute(params, mesh, plc)
    locals_, roundtrip = {}, True
    for (path, full), (_, d) in zip(SH.leaf_paths(params),
                                    SH.leaf_paths(placed)):
        locals_[path] = tuple(d.to_local().shape)
        roundtrip &= torch.equal(d.full_tensor(), full)
    out["local_shapes"] = locals_
    out["param_paths"] = [p for p, _ in SH.leaf_paths(params)]
    out["full_tensor_bitwise"] = roundtrip
    state = ts.TrainState(params, adamw.init(params), 0)
    out["state_placements"] = _placement_names(
        SH.state_shardings(state, mesh, fsdp=True))
    out["input_placements"] = _placement_names(SH.input_shardings(
        {"tokens": torch.zeros(4, 8, dtype=torch.int32)}, mesh))
    packed = L.PackedQWeight(torch.zeros(2, 64, 16, dtype=torch.uint8),
                             torch.zeros(2, 64, 4, dtype=torch.uint8),
                             torch.ones(2))
    serve = {"embed": torch.zeros(512, 128), "final_norm": {"g": torch.ones(128)},
             "stages": [{"l0": {"mix": {"wq": packed}}}]}
    out["serve_placements"] = _placement_names(
        SH.serve_param_shardings(serve, mesh))
    out["serve_cache_placements"] = _placement_names(SH.serve_cache_shardings(
        {"kv": torch.zeros(2, 8, 16, 4, 32), "wkv": torch.zeros(2, 4, 8)}, mesh))
    out["cache_placements"] = _placement_names(SH.cache_shardings(
        {"0": {"l0": {"kv": [torch.zeros(2, 4, 8, 2, 16)] * 2,
                      "wkv": torch.zeros(2, 4, 3)}}}, mesh))

    # compression: the reference's uniforms injected, then hashed draws
    x = torch.from_numpy(inputs["x"][rank])
    draws = Injected({0: inputs["ref_u"][rank]})
    out["injected_mean"] = C.compressed_psum_mean(x, None, draws).numpy()
    out["hashed_means"] = np.stack([
        C.compressed_psum_mean(x, None, np.array([5, i], np.uint32)).numpy()
        for i in range(inputs["seeds"])])
    tree = {"w": torch.from_numpy(inputs["tree_w"][rank]),
            "g": [torch.from_numpy(inputs["tree_g"][rank])]}
    got = C.compressed_grad_mean(tree, None, np.array([9, 9], np.uint32))
    out["tree"] = {"w": got["w"].numpy(), "g": got["g"][0].numpy()}

    # GPipe: tanh(x @ w) stages, plain and with NVFP4 boundaries
    ws = torch.from_numpy(inputs["ws"])[rank: rank + 1]
    xs = torch.from_numpy(inputs["xs"])
    stage = lambda w, a: torch.tanh(a @ w)  # noqa: E731
    for compress in (False, True):
        run = PP.gpipe(stage, world, xs.shape[0], compress=compress)
        out[f"gpipe_{compress}"] = run(ws, xs).numpy()
    # tests/test_pipeline.py's compressed case: S 4, M 4, MB 2, D 32
    ws = torch.from_numpy(inputs["ws32"])[rank: rank + 1]
    xs = torch.from_numpy(inputs["xs32"])
    out["gpipe_d32"] = PP.gpipe(stage, world, xs.shape[0], compress=True)(
        ws, xs).numpy()
    return out


def failing_body(rank: int, world: int) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def corpus(global_batch: int = BATCH) -> SyntheticCorpus:
    return SyntheticCorpus(DataConfig(vocab=CFG.vocab, seq_len=SEQ,
                                      global_batch=global_batch))


def fresh_state(init):
    return init(lm.init(CFG, torch.Generator().manual_seed(0), "cpu"))


def halve(grads, seed):
    """A grad_transform that does not reduce: every grad times 0.5."""
    return ts.tree_like(grads, [g * 0.5 for g in adamw.leaves(grads)])


def dp_body(rank: int, world: int, scheme: str, steps: int,
            compress: bool, hook=None) -> dict:
    """`steps` data-parallel steps of reduced llama on this rank's shard
    (`hook`: the step's grad_transform): losses, grad norms, final params
    and a checksum of them after each step."""
    torch.set_num_threads(1)
    init, step = ts.make_train_step(CFG, scheme, base_lr=2e-3,
                                    total_steps=steps,
                                    group=dist.group.WORLD, compress=compress,
                                    grad_transform=hook)
    state = fresh_state(init)
    data = corpus()
    out = {"loss": [], "grad_norm": [], "checksums": []}
    for i in range(steps):
        state, m = step(state, data.batch_at(i, rank, world))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["checksums"].append(D.checksum(adamw.leaves(state.params)))
    out["params"] = [p.detach().clone() for p in adamw.leaves(state.params)]
    return out


def gpipe_quartet2_body(rank: int, world: int, d: int) -> dict:
    """Two stages of tanh(qlinear(x, w)) under quartet2: the output and
    the stages applied in order to each microbatch."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(3)
    ws = torch.randn(world, d, d, generator=g) / d ** 0.5
    xs = torch.randn(2, 8, d, generator=g)
    stage = lambda w, a: torch.tanh(L.qlinear(a, w, None, "quartet2"))  # noqa
    got = PP.gpipe(stage, world, 2)(ws[rank: rank + 1], xs)
    # microbatch by microbatch: the 4/6 quantizer's scale is a tensor's
    want = []
    for x in xs:
        for s in range(world):
            x = stage(ws[s], x)
        want.append(x)
    return {"got": got.numpy(), "want": torch.stack(want).numpy()}
