"""The training step: loss, grads, clipping, optimizer, seeds.

Counterpart of `repro/train/train_step.py`. Per-step quantization seeds
follow the paper's re-randomization contract (App. A item 2): a fresh uint32
pair derived from (base_seed, step, microbatch) feeds every qlinear call
site, which further mixes in (layer, site), so rotations and SR re-randomize
per tensor per microbatch. `step_seed` ports bit for bit (numpy uint32 on the
host, like `site_seed`).

Gradient accumulation splits the batch into microbatches, each with its own
quantization seed; grads are summed in microbatch order and divided by their
number, as the reference's scan does. The step runs eagerly: PyTorch has no
`jit`, and the step synchronizes with the host nowhere.

The optimizer is AdamW or Muon (`optim/muon.py`, the nanochat recipe), as
in the reference. `grad_transform(grads, seed)`, the reference's hook,
takes the mean grads as a tree shaped like the params and the seed
`step_seed(base_seed ^ 0x5555, step)`, and its result is clipped.

Data parallelism (`group`, a process group of R ranks): rank r seeds its
microbatch i with `step_seed(base_seed, step, r * M + i)`, averages its
grads over its M microbatches, then sums them over the ranks in one
`all_reduce` and divides by R; the loss likewise. So R ranks compute what
one process computes with R * M microbatches over their batches laid end
to end in rank order (at R = 2 and M = 1 bitwise: a sum of two f32 values
does not depend on its order). `compress` replaces the exact mean of the
grads with `dist.compression.compressed_grad_mean` over the group under the
hook's seed (what `examples/distributed_sim.py` passes the reference's hook);
the loss is still reduced exactly. The step owns the reduction:
`grad_transform` always gets the mean over the ranks, so a hook that does
not reduce (clipping, scaling, a recording) leaves the ranks identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import dist as D
from repro_torch.models import lm
from repro_torch.optim import adamw, muon, schedules


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState | muon.MuonState
    step: int


def step_seed(base_seed: int, step: int, micro: int = 0) -> np.ndarray:
    """uint32[2] seed of (base_seed, step, microbatch), as the reference's."""
    s = np.uint32(step)
    m = np.uint32(micro)
    with np.errstate(over="ignore"):
        return np.array([np.uint32(base_seed) ^ (s * np.uint32(0x9E3779B9)),
                         s + m * np.uint32(0x85EBCA6B)], np.uint32)


def tree_like(params, leaves: list):
    """`params`' tree of dicts and lists holding `leaves` (given in
    `adamw.leaves` order, insertion order) in place of its tensors."""
    it = iter(leaves)

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        return next(it)

    return one(params)


def make_train_step(cfg, scheme: str, *, optimizer: str = "adamw",
                    base_lr: float = 3e-4, total_steps: int = 1000,
                    schedule: str = "cosine", weight_decay: float = 0.1,
                    grad_clip: float = 1.0, base_seed: int = 0,
                    microbatches: int = 1, aux_weight: float = 0.01,
                    grad_transform=None, group=None, compress: bool = False):
    """Returns (init_state_fn, train_step_fn); train_step(state, batch) ->
    (state, metrics) with metrics {"loss", "grad_norm"} as device scalars and
    {"lr"} as a float. The loss is `lm.lm_loss`'s: the CE plus `aux_weight`
    times the MoE aux loss. `batch` is this rank's shard under a `group`
    (a process group: data parallelism, see the module docstring);
    `compress` (with a group) averages the grads over it NVFP4-compressed."""
    opt_mod = {"adamw": adamw, "muon": muon}.get(optimizer)
    if opt_mod is None:
        raise ValueError(f"unknown optimizer {optimizer}")
    if compress:
        if group is None:
            raise ValueError("compress averages grads over a group: pass group")
        # here, not at the top: compression imports the checkpointer, which
        # imports this module
        from repro_torch.dist import compression as C
    sched = schedules.get(schedule)
    world = D.world(group) if group is not None else 1
    first_micro = D.rank(group) * microbatches if group is not None else 0

    def init_state(params) -> TrainState:
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        return TrainState(params, opt_mod.init(params), 0)

    def value_and_grad(params, batch, seed):
        loss = lm.lm_loss(params, cfg, batch, scheme, seed, aux_weight)
        leaves = adamw.leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss never reads (the token table of a model fed
        # embeds) gets zeros, as the reference's gradient: weight decay
        # still moves it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, leaves)]

    def reduce(state, loss, grads):
        """The ranks' mean of loss and grads (exact, or the grads'
        compressed), then grad_transform on the mean."""
        seed = step_seed(base_seed ^ 0x5555, state.step)
        if group is not None:
            mean = [loss.reshape(1)] + ([] if compress else grads)
            D.all_reduce_sum_(mean, group)
            loss = mean[0][0] / world
            grads = (adamw.leaves(C.compressed_grad_mean(
                tree_like(state.params, grads), group, seed)) if compress
                else [g / world for g in grads])
        if grad_transform is not None:
            grads = adamw.leaves(grad_transform(
                tree_like(state.params, grads), seed))
        return loss, grads

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if microbatches == 1:
            loss, grads = value_and_grad(
                state.params, batch, step_seed(base_seed, state.step,
                                               first_micro))
        else:
            loss = torch.zeros((), device=batch["tokens"].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in adamw.leaves(state.params)]
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                li, gi = value_and_grad(
                    state.params, mb,
                    step_seed(base_seed, state.step, first_micro + i))
                loss = loss + li
                grads = [g + h for g, h in zip(grads, gi)]
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        if group is not None or grad_transform is not None:
            loss, grads = reduce(state, loss, grads)
        grads, gnorm = adamw.clip_by_global_norm(grads, grad_clip)
        lr = sched(state.step, base_lr=base_lr, total_steps=total_steps)
        params, opt = opt_mod.update(grads, state.opt, state.params, lr=lr,
                                     weight_decay=weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, state.step + 1), metrics

    return init_state, train_step
