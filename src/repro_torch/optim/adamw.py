"""AdamW with fp32 state (paper Table 4: FP32 optimizer/accumulators) and
decoupled weight decay, over a parameter tree of dicts and lists of tensors.

Counterpart of `repro/optim/adamw.py`, with the same arithmetic in the same
order. Where the reference returns new arrays, `update` writes parameters and
moments IN PLACE (one copy of each at full width instead of two) and returns
them. Nothing here synchronizes with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


class AdamWState(NamedTuple):
    step: int
    mu: list   # f32 first moments, one per parameter leaf
    nu: list   # f32 second moments


def init(params) -> AdamWState:
    z = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    return AdamWState(0, z, [t.clone() for t in z])


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


@torch.no_grad()
def update(grads: list, state: AdamWState, params, *, lr: float, b1=0.9,
           b2=0.95, eps=1e-8, weight_decay=0.1, frozen=None):
    """One AdamW step. grads: a list aligned with `leaves(params)`. Returns
    (params, new state); params and moments are updated in place. `frozen`
    (bools aligned with the leaves, optional): a frozen leaf's moments
    advance but the leaf is left as it is (Muon updates those itself)."""
    step = state.step + 1
    t = np.float32(step)
    frozen = frozen or [False] * len(grads)
    for g, m, v, p, skip in zip(grads, state.mu, state.nu, leaves(params),
                                frozen):
        gf = g.float()
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        if skip:
            continue
        # f32 bias corrections as device scalars: a true division, as the
        # reference's (no reciprocal)
        bc1 = 1.0 - _f32(b1, p.device) ** _f32(t, p.device)
        bc2 = 1.0 - _f32(b2, p.device) ** _f32(t, p.device)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu)


def global_norm(grads: list) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def clip_by_global_norm(grads: list, max_norm: float):
    """(grads scaled to a global norm <= max_norm, the norm before)."""
    n = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, n.device) / n.clamp_min(1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], n
