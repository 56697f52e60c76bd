"""GPipe-style pipeline parallelism over the ranks of a process group.

Counterpart of `repro/dist/pipeline.py`. Each rank holds one contiguous
stage of layers (the rank is the stage); microbatches stream through the
ring by point-to-point sends. The schedule is the reference's GPipe
fill-drain: with S stages and M microbatches the pipe runs M + S - 1 ticks,
of which S - 1 are bubble (`bubble_fraction`). As in the reference, every
stage applies its function on every tick (the first stage to a clamped
microbatch, the others to whatever the ring brought, zeros at first), and
only the last stage's valid outputs are kept.

Stage boundaries optionally go through NVFP4 before the hop (`compress=
True`): deterministic RTN at the MSE-optimal grid max, dequantized at once
(the reference's simulated 4.5-bit wire).

gloo's `send`/`recv` move host tensors only, so where the stages run on a
card over gloo the ring hop goes through pinned host buffers
(`dist.host_staged`); the final all-reduce takes the card's tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import dist as D
from repro_torch.core import quant as Q


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1) / (M + S - 1)."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def stack_stage_params(params, n_stages: int):
    """Split every leaf's leading (layers) axis into (n_stages, per_stage):
    stage s's layers are `[s]` of each leaf (views)."""
    def one(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} stages "
                             f"(leaf of shape {tuple(x.shape)})")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return _tree_map(one, params)


def _compress_boundary(y: torch.Tensor) -> torch.Tensor:
    """Round-trip a stage boundary through NVFP4 (simulated 4.5-bit wire)."""
    flat = y.reshape(y.shape[0], -1)
    qt = Q.quant_rtn(flat, s=Q.S_EDEN)
    return Q.dequant(qt, torch.float32).reshape(y.shape).to(y.dtype)


def _peer(group, r: int) -> int:
    """The global rank of group rank r."""
    return r if group is None else dist.get_global_rank(group, r)


def _ring_hop(wire: torch.Tensor, stage: int, n_stages: int, group):
    """Send `wire` to the next stage and receive the previous stage's."""
    if n_stages == 1:
        return wire
    staged = wire.is_cuda and D.host_staged(group)
    out = D.to_host(wire) if staged else wire.contiguous()
    buf = torch.empty(out.shape, dtype=out.dtype, device=out.device,
                      pin_memory=staged)
    ops = [dist.P2POp(dist.isend, out, _peer(group, (stage + 1) % n_stages),
                      group),
           dist.P2POp(dist.irecv, buf, _peer(group, (stage - 1) % n_stages),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(wire.device) if staged else buf


def gpipe(stage_fn, n_stages: int, n_micro: int, compress: bool = False,
          group=None):
    """The per-rank GPipe body.

    stage_fn(w, x) applies one stage. The returned `run(ws, xs)` takes this
    rank's stage params `ws` with a leading axis of 1 (its shard of the
    stacked (n_stages, ...) params, as the reference's shard_map hands it)
    and the microbatches `xs` (n_micro, ...), the same on every rank; it
    returns the final stage's (n_micro, ...) outputs on every rank.
    """
    if D.world(group) != n_stages:
        raise ValueError(f"gpipe runs one stage a rank: {n_stages} stages on "
                         f"{D.world(group)} ranks")

    def run(ws, xs):
        stage = D.rank(group)
        w = _tree_map(lambda x: x[0], ws)  # this rank's stage params
        m = n_micro
        recv = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            mb = t - stage  # the microbatch this stage works on at tick t
            inp = xs[min(max(t, 0), m - 1)] if stage == 0 else recv
            y = stage_fn(w, inp)
            wire = _compress_boundary(y) if compress else y
            recv = _ring_hop(wire, stage, n_stages, group)
            if 0 <= mb < m and stage == n_stages - 1:
                outs[mb] = y
        # outputs live on the last stage only; the sum replicates them
        mine = outs if stage == n_stages - 1 else torch.zeros_like(outs)
        return D.all_reduce_sum_([mine], group)[0]

    return run
