"""Griffin / RecurrentGemma building blocks: the RG-LRU recurrent block with a
short depthwise temporal conv (the sliding-window local attention is
`models.attention` with a window).

Counterpart of `repro/models/griffin.py`. RG-LRU (Real-Gated Linear
Recurrent Unit):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(L) . r_t      (c = 8)
    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . x_t)

A full sequence runs `associative_scan`, the odd/even recursion that
`jax.lax.associative_scan` uses, so the f32 products and sums come in the
reference's order; a decode step is one elementwise update. softplus is
the reference's logaddexp(x, 0) (`F.softplus` switches to x above its
threshold) and the gate's gelu is jax.nn.gelu's tanh form. Projections are
quantized linears; the gates are f32 matmuls and the recurrence is
elementwise f32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linear import qlinear
from repro_torch.models.blocks import site_seed

LRU_C = 8.0
SQRT_2_OVER_PI = float(np.float32(np.sqrt(2.0 / np.pi)))


def rglru_init(draw, count: int, cfg, device) -> dict:
    """Stacked (count, ...) recurrent-block parameters in the reference's
    layout and names (`lam` so that a^c spreads over [0.9, 0.999])."""
    g = cfg.griffin
    w = g.lru_width or cfg.d_model
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros((count, *shape), dtype=torch.float32, device=device)

    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                                  device=device)) / LRU_C))
    return {
        "w_in": draw("w_in", (count, w, d), d),       # x branch
        "w_gate": draw("w_gate", (count, w, d), d),   # gelu gate branch
        "w_out": draw("w_out", (count, d, w), w),
        "conv_w": draw("conv_w", (count, g.conv_width, w), w, 0.1),
        "conv_b": zeros(w),
        "wa": draw("wa", (count, w, w), w, 0.01),
        "ba": zeros(w),
        "wx": draw("wx", (count, w, w), w, 0.01),
        "bx": zeros(w),
        "lam": lam.expand(count, w).clone(),
    }


def _conv1d(x, w, b, tail=None):
    """Causal depthwise temporal conv of width K. x: (B, S, W); tail: (B, K-1,
    W), the previous step's last K-1 inputs. Returns (out, new tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):  # the reference's sum(...), in its order
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(k - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) of f32 x, in its order of operations
    (its sqrt(2 / pi) rounded to f32, a host scalar: no upload a call)."""
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _rglru_gates(p, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p["wa"].float().T + p["ba"])
    i = torch.sigmoid(uf @ p["wx"].float().T + p["bx"])
    log_a = -LRU_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0))
    return a, beta * i * uf


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (even may be one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], 1)


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h -> a h + b under
    (x, y) -> (x_a y_a, x_b y_a + y_b): `jax.lax.associative_scan`'s
    recursion (combine adjacent pairs, scan the halves, fill in the even
    positions), so every product and sum is the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra = a[:, 0:n - 1:2] * a[:, 1::2]
    rb = b[:, 0:n - 1:2] * a[:, 1::2] + b[:, 1::2]
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        pa, pb = oa[:, :-1], ob[:, :-1]
    else:
        pa, pb = oa, ob
    ea = pa * a[:, 2::2]
    eb = pb * a[:, 2::2] + b[:, 2::2]
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(p, u, h0=None):
    """Full-sequence RG-LRU. u: (B, S, W) -> (B, S, W) in u's dtype; h0 (B,
    W) is folded in as a virtual step 0."""
    a, b = _rglru_gates(p, u)
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    _, h = associative_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(u.dtype)


def rglru_step(p, u1, h):
    """One decode step. u1: (B, 1, W); h: (B, W) f32."""
    a, b = _rglru_gates(p, u1)
    h = a[:, 0] * h.float() + b[:, 0]
    return h[:, None].to(u1.dtype), h


def recurrent_block_apply(p, x, cfg, scheme, seed, layer, *, state=None):
    """Griffin recurrent block. state = (h, conv_tail) or None (train).
    Returns (out, (h, conv_tail))."""
    s = x.shape[1]
    u = qlinear(x, p["w_in"], site_seed(seed, layer, 0), scheme)
    gate = qlinear(x, p["w_gate"], site_seed(seed, layer, 1), scheme)
    h0, tail = state if state is not None else (None, None)
    u, tail = _conv1d(u, p["conv_w"], p["conv_b"], tail)
    if s == 1 and h0 is not None:
        hseq, h = rglru_step(p, u, h0)
    else:
        hseq = rglru_scan(p, u, h0)
        h = hseq[:, -1].float()
    y = hseq * gelu_tanh(gate.float()).to(hseq.dtype)
    out = qlinear(y, p["w_out"], site_seed(seed, layer, 2), scheme)
    return out, (h, tail)


def recurrent_state_init(cfg, batch: int, device, lead=()):
    """Zero (h f32 (*lead, batch, W), conv tail bf16 (*lead, batch, K-1, W))."""
    g = cfg.griffin
    w = g.lru_width or cfg.d_model
    return (torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
            torch.zeros((*lead, batch, g.conv_width - 1, w),
                        dtype=torch.bfloat16, device=device))
