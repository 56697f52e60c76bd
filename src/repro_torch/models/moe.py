"""Mixture-of-Experts with shared experts and capacity-based dispatch.

Counterpart of `repro/models/moe.py`. The router runs in f32 and is not
quantized. Dispatch sorts the (token, expert) replicas by expert (a STABLE
sort, as `jnp.argsort`), keeps the first `capacity` rows of each expert and
drops the rest, and scatters the kept rows into one (C, D) buffer per
expert; each expert's feed-forward is three quantized linears on its own
buffer, so under quartet2 the per-tensor 4/6 scale of an expert's
activations is taken over that buffer alone, zero rows included, as the
reference's vmap does. The combine gathers the kept rows back (dropped rows
read 0), weights them and adds them into their tokens in the sorted order.

JAX drops out-of-range scatter rows and fills out-of-range gathers; PyTorch
indexing raises, so the dropped rows are masked explicitly here. An expert
that received no row is not run: its buffer is all zeros and none of its
output rows is ever gathered, so skipping it changes no value.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linear import PackedQWeight, qlinear
from repro_torch.models.blocks import mlp_apply, mlp_init, site_seed


def moe_init(draw, count: int, cfg) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    p = {
        "router": draw("router", (count, m.n_routed, d), d, 0.02),
        # routed experts: stacked (E, f, d) weights, swiglu
        "wi": draw("wi", (count, m.n_routed, f, d), d),
        "wg": draw("wg", (count, m.n_routed, f, d), d),
        "wo": draw("wo", (count, m.n_routed, d, f), f),
    }
    if m.n_shared:
        p["shared"] = mlp_init(draw, count, d, f * m.n_shared, "swiglu")
    return p


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_routed) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _expert(w, e: int):
    """Expert e of a layer's (E, N, K) stack: a raw slice or a PackedQWeight."""
    return w.layer(e) if isinstance(w, PackedQWeight) else w[e]


def route(p, xf: torch.Tensor, cfg):
    """f32 routing of xf (T, D): (scores (T, E), top_w (T, K) normalized and
    scaled, top_e (T, K))."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float().T
    if m.score == "sigmoid":          # deepseek-v3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(scores, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return scores, top_w * m.route_scale, top_e


def dispatch(top_e: torch.Tensor, cap: int, n_routed: int):
    """Sort the (token, expert) replicas by expert (stable) and give each
    its row in its expert's buffer: (order, expert, row, keep), all over the
    T * K replicas in sorted order; rows at or past `cap` are not kept."""
    fe = top_e.reshape(-1)
    order = torch.argsort(fe, stable=True)
    fe_s = fe[order]
    counts = torch.bincount(fe_s, minlength=n_routed)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(fe.numel(), device=fe.device) - seg_start[fe_s]
    return order, fe_s, pos_in_e, pos_in_e < cap


def moe_apply(p, x, cfg, scheme, seed, layer):
    """x: (B, S, D) -> (y (B, S, D) in x.dtype, the Switch-style load-balance
    aux loss f32). Serving drops the aux loss."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    scores, top_w, top_e = route(p, xf, cfg)

    cap = _capacity(t, cfg)
    order, fe_s, pos_in_e, keep = dispatch(top_e, cap, m.n_routed)
    ft_s = torch.arange(t, device=x.device).repeat_interleave(m.top_k)[order]
    fw_s = top_w.reshape(-1)[order]
    e_k, c_k, t_k = fe_s[keep], pos_in_e[keep], ft_s[keep]
    buf = torch.zeros((m.n_routed, cap, d), dtype=x.dtype, device=x.device)
    buf[e_k, c_k] = xf[t_k]

    # per-expert quantized swiglu FF; site seeds as the reference's vmap
    out_buf = torch.zeros_like(buf)
    base = site_seed(seed, layer, 20)
    for e in torch.unique(e_k).tolist():
        sd = base + np.array([0, e], np.uint32)
        h = qlinear(buf[e], _expert(p["wi"], e), sd, scheme)
        g = qlinear(buf[e], _expert(p["wg"], e), sd + np.uint32(1), scheme)
        hf = h.float()
        a = (hf * torch.sigmoid(hf)).to(x.dtype) * g  # jax.nn.silu's form
        out_buf[e] = qlinear(a, _expert(p["wo"], e), sd + np.uint32(2), scheme)

    # combine: kept rows weighted, added into their tokens in sorted order
    weighted = out_buf[e_k, c_k].float() * fw_s[keep][:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, t_k, weighted)
    y = y.to(x.dtype).reshape(b, s, d)

    if m.n_shared:
        y = y + mlp_apply(p["shared"], x, "swiglu", scheme, seed, layer)

    me = torch.nn.functional.one_hot(top_e, m.n_routed).float().mean(dim=(0, 1))
    aux = m.n_routed * torch.sum(me * scores.mean(dim=0))
    return y, aux
