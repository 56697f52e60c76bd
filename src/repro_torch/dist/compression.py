"""NVFP4 gradient compression for the data-parallel all-reduce.

Counterpart of `repro/dist/compression.py`, with its arithmetic: each rank
stochastically rounds its gradient leaf to NVFP4 (`core/quant.quant_sr`,
the leaf flattened and zero-padded to whole 16-groups) and dequantizes it;
the ranks sum the dequantized f32 (`all_reduce(SUM)`) and divide by their
number. Q_SR is unbiased (paper Sec. 3.1), so the compressed mean is an
unbiased estimator of the exact mean. Leaves smaller than one scale group
are reduced exactly, as in the reference.

The reference's docstring speaks of a 4.5-bit wire while its `psum` moves
f32; the port keeps the reference's arithmetic and moves f32 too (a packed
payload gathered instead is ROADMAP work).

Ranks must not share rounding draws, or their SR errors correlate and stop
averaging out. The reference folds (axis index, leaf tag) into a threefry
key; the port hashes them (`core/rng.py`): a rank's draws come from the key
pair of (seed pair, rank), and a leaf's uniforms from that rank seed's key
pair of its tag, tag = leaf index + 1 in the reference's leaf order
(`jax.tree.flatten`: sorted dict keys, `checkpoint.checkpointer.flatten`).
Tests hand `_sr_roundtrip` the reference's own uniforms, and pass any object
with a `uniform(tag, shape, device)` method as the seed of a rank.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpointer import flatten, unflatten
from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.core import rng
from repro_torch import dist as D


def rank_draws(seed, rank: int):
    """The draw source of `rank` under a uint32[2] step seed: hashed from
    (seed pair, rank). An object with a `uniform` method is this rank's
    draw source already and is returned as it is."""
    if hasattr(seed, "uniform"):
        return seed
    return rng.HashDraws(rng.HashDraws(seed).keys(rank))


def _padded(n: int) -> int:
    return n + (-n) % F.GROUP


def _sr_roundtrip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Quantize one leaf to NVFP4 with SR against uniforms `u` of shape (1,
    n padded to a multiple of 16) and dequantize it (f32, x's shape)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % F.GROUP
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    deq = Q.dequant(Q.quant_sr(flat[None, :], u))[0]
    if pad:
        deq = deq[: x.numel()]
    return deq.reshape(x.shape)


def _uniforms(draws, tag: int, x: torch.Tensor) -> torch.Tensor:
    return draws.uniform(tag, (1, _padded(x.numel())), x.device)


def compressed_psum_mean(x: torch.Tensor, group, seed, tag: int = 0
                         ) -> torch.Tensor:
    """Unbiased NVFP4-compressed mean of one leaf over the ranks of `group`.
    `seed` is the uint32[2] step seed every rank shares (its rank is hashed
    in here), or this rank's draw source."""
    draws = rank_draws(seed, D.rank(group))
    deq = _sr_roundtrip(x, _uniforms(draws, tag, x))
    D.all_reduce_sum_([deq], group)
    return (deq / float(D.world(group))).to(x.dtype)


def compressed_grad_mean(grads, group, seed):
    """`compressed_psum_mean` over a gradient tree (dicts and lists of
    tensors), leaf i of the reference's order under tag i + 1; leaves under
    one scale group (norm gains, biases) are reduced exactly. Every leaf
    rides one collective. Returns a tree of grads' structure."""
    leaves = flatten(grads)
    draws = rank_draws(seed, D.rank(group))
    sums = [g.float().clone() if g.numel() < F.GROUP
            else _sr_roundtrip(g, _uniforms(draws, i + 1, g))
            for i, g in enumerate(leaves)]
    D.all_reduce_sum_(sums, group)
    n = float(D.world(group))
    return unflatten(grads, [(s / n).to(g.dtype) for s, g in zip(sums, leaves)])
