"""Muon (Jordan et al. 2024): momentum and Newton-Schulz orthogonalization
for the matrix parameters; AdamW for the rest (embeddings, the head, 1-D
norm gains). Leaves of more than two dims (stacked layers) are treated
matrix by matrix over their last two dims: Newton-Schulz batches over the
leading dims.

Counterpart of `repro/optim/muon.py`, with the same arithmetic in the same
order; used by the paper's nanochat-style recipe (Sec. 6.2). The
Newton-Schulz products are f32 `torch.matmul`s, IEEE f32 with TF32 off (the
package turns it off when imported), as the reference's are outside any
kernel. The mask follows the reference exactly: every leaf of two dims or
more whose path names neither `embed` nor `head` goes to Muon, the stacked
(count, d) norm gains included (ROADMAP.md, reference caveats).

As in the reference, AdamW runs over EVERY leaf: its moments advance for
the Muon leaves too, but their new values come from Muon. Like the port's
`adamw.update`, `update` writes parameters and state in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.optim import adamw

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5


def newton_schulz(g: torch.Tensor, steps: int = NS_STEPS) -> torch.Tensor:
    """Approximate U V^T of the matrix (last two dims; leading dims batched)."""
    a, b, c = NS_COEFFS
    x = g.float()
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        s = x @ x.transpose(-1, -2)
        x = a * x + (b * s + c * (s @ s)) @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x


class MuonState(NamedTuple):
    step: int
    mom: list                # f32 momentum, one per parameter leaf
    adam: adamw.AdamWState   # AdamW over every leaf


def _paths(tree, prefix=()):
    """(path, leaf) of a tree of dicts and lists, in `adamw.leaves` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, (*prefix, i))]
    return [(prefix, tree)]


def partition_mask(params) -> list[bool]:
    """One bool per leaf of `adamw.leaves(params)`: True -> Muon, False ->
    AdamW, by the leaf's path, as the reference decides."""
    def to_muon(path, p):
        name = "/".join(str(k) for k in path).lower()
        return p.dim() >= 2 and not any(t in name for t in ("embed", "head"))
    return [to_muon(path, p) for path, p in _paths(params)]


def init(params) -> MuonState:
    return MuonState(0, [torch.zeros_like(p, dtype=torch.float32)
                         for p in adamw.leaves(params)], adamw.init(params))


@torch.no_grad()
def update(grads: list, state: MuonState, params, *, lr: float,
           momentum=0.95, adam_lr_scale=0.3, weight_decay=0.0):
    """One Muon step. grads: a list aligned with `adamw.leaves(params)`.
    Returns (params, new state); parameters and state change in place."""
    mask = partition_mask(params)
    lr32 = np.float32(lr)
    for g, m, p, use in zip(grads, state.mom, adamw.leaves(params), mask):
        if not use:
            continue
        gf = g.float()
        m.copy_(momentum * m + gf)
        upd = newton_schulz(momentum * m + gf)  # nesterov-style
        # the reference's f32 scalars: sqrt(max(1, rows/cols)) * 0.2, then
        # lr * scale and lr * weight_decay, each one f32 rounding
        scale = np.sqrt(np.float32(max(1.0, p.shape[-2] / p.shape[-1]))) \
            * np.float32(0.2)
        pf = p.float()
        p.copy_((pf - float(lr32 * scale) * upd
                 - float(lr32 * np.float32(weight_decay)) * pf).to(p.dtype))
    _, adam = adamw.update(grads, state.adam, params,
                           lr=float(lr32 * np.float32(adam_lr_scale)),
                           weight_decay=weight_decay, frozen=mask)
    return params, MuonState(state.step + 1, state.mom, adam)
