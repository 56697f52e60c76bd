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
in the reference. Left out: the `grad_transform` hook of the reference
(data-parallel gradient compression comes with `dist/`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def make_train_step(cfg, scheme: str, *, optimizer: str = "adamw",
                    base_lr: float = 3e-4, total_steps: int = 1000,
                    schedule: str = "cosine", weight_decay: float = 0.1,
                    grad_clip: float = 1.0, base_seed: int = 0,
                    microbatches: int = 1):
    """Returns (init_state_fn, train_step_fn); train_step(state, batch) ->
    (state, metrics) with metrics {"loss", "grad_norm"} as device scalars and
    {"lr"} as a float."""
    opt_mod = {"adamw": adamw, "muon": muon}.get(optimizer)
    if opt_mod is None:
        raise ValueError(f"unknown optimizer {optimizer}")
    sched = schedules.get(schedule)

    def init_state(params) -> TrainState:
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        return TrainState(params, opt_mod.init(params), 0)

    def value_and_grad(params, batch, seed):
        loss = lm.lm_loss(params, cfg, batch, scheme, seed)
        return loss.detach(), torch.autograd.grad(loss, adamw.leaves(params))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if microbatches == 1:
            loss, grads = value_and_grad(state.params, batch,
                                         step_seed(base_seed, state.step, 0))
        else:
            loss = torch.zeros((), device=batch["tokens"].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in adamw.leaves(state.params)]
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                li, gi = value_and_grad(state.params, mb,
                                        step_seed(base_seed, state.step, i))
                loss = loss + li
                grads = [g + h for g, h in zip(grads, gi)]
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads, gnorm = adamw.clip_by_global_norm(grads, grad_clip)
        lr = sched(state.step, base_lr=base_lr, total_steps=total_steps)
        params, opt = opt_mod.update(grads, state.opt, state.params, lr=lr,
                                     weight_decay=weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, state.step + 1), metrics

    return init_state, train_step
