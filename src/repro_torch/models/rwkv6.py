"""RWKV-6 "Finch": attention-free time-mix with data-dependent per-channel
decay, in a chunk-parallel formulation.

Counterpart of `repro/models/rwkv6.py`. Recurrence per head (d = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

Chunked evaluation (chunk C): with logP = cumsum(log w) inside the chunk and
logQ_t = logP_{t-1} (logQ_0 = 0), the intra-chunk pairwise decays factor as
exp(logQ_t - logP_j) = exp(logQ_t) * exp(-logP_j), so

    o_t = (r_t . exp(logQ_t)) @ S_0                          (inter-chunk)
        + tril_strict[(r.exp(logQ)) @ (k.exp(-logP))^T] @ v  (intra-chunk)
        + (r_t . u . k_t) v_t                                (current token)
    S_C = exp(logP_C) . S_0 + ((k.exp(-logP)) * exp(logP_C))^T @ v

The per-step log-decay is clamped to >= LOG_W_MIN so exp(-logP) stays in
f32 (the reference's documented deviation from RWKV-6). The reference's
`lax.scan` over chunks is a Python loop over chunks here; a sequence's
remainder below one chunk runs the per-token step, as does every decode
step, so a chunk of fewer than C tokens (the speculative verify chunk)
integrates its tokens exactly as single-token steps do.

The projections (r/k/v/gate/output, channel-mix) are quantized linears; the
token-shift and decay LoRA products (`mix_w1`, `mix_w2`, `ww1`, `ww2`) are
f32 matmuls, and the recurrence is elementwise f32, as in the reference.
On the card, outside autograd, the LoRA products run in calls of one shape
(`_lora`), so that a verify chunk's rows are the decode steps' bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import qlinear
from repro_torch.models.blocks import rmsnorm, site_seed

LOG_W_MIN = -5.0  # per-step decay clamp (see the module docstring)


def rwkv_init(draw, gen: torch.Generator, count: int, cfg, device) -> dict:
    """Stacked (count, ...) time-mix and channel-mix parameters in the
    reference's layout and names. Uniform leaves (`mu`, `cm_mu`) come from
    `gen`, the rest through `draw`."""
    d = cfg.d_model
    r = cfg.rwkv.lora_rank

    def uniform(*shape):
        return torch.rand((count, *shape), generator=gen, dtype=torch.float32,
                          device=device)

    return {
        # token-shift static mixes + data-dependent LoRA (5 targets: r,k,v,w,g)
        "mu": uniform(5, d),
        "mix_w1": draw("mix_w1", (count, 5 * r, d), d, 0.01),
        "mix_w2": draw("mix_w2", (count, 5, r, d), r, 0.01),
        "wr": draw("wr", (count, d, d), d),
        "wk": draw("wk", (count, d, d), d),
        "wv": draw("wv", (count, d, d), d),
        "wg": draw("wg", (count, d, d), d),
        "wo": draw("wo", (count, d, d), d),
        # decay: w0 static + LoRA; u bonus
        "w0": torch.full((count, d), -1.0, dtype=torch.float32, device=device),
        "ww1": draw("ww1", (count, r, d), d, 0.01),
        "ww2": draw("ww2", (count, d, r), r, 0.01),
        "u": draw("u", (count, d), d, 0.1),
        "gn": torch.ones((count, d), dtype=torch.float32, device=device),
        # channel-mix
        "cm_mu": uniform(2, d),
        "cm_wr": draw("cm_wr", (count, d, d), d),
        "cm_wk": draw("cm_wk", (count, cfg.d_ff, d), d),
        "cm_wv": draw("cm_wv", (count, d, cfg.d_ff), cfg.d_ff),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1} (prev carries the last token across steps)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


LORA_ROWS = 16  # rows of each LoRA call on the card outside autograd


def _lora(fn, x: torch.Tensor) -> torch.Tensor:
    """fn, a row-wise chain of f32 GEMMs (n, K) -> (n, ...), over x (..., K)
    f32, as (..., prod of fn's output dims). On the card outside an autograd
    graph (serving) it runs on chunks of exactly LORA_ROWS rows, the last
    zero-padded: cuBLAS picks its algorithm, hence each output's summation
    order, from the shape, so with every call of one shape a row's result
    does not depend on how many rows run beside it (a speculative verify
    chunk of 4 tokens a slot against the 4 decode steps it stands for).
    Elsewhere one call over all rows."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    n = xf.shape[0]
    if not x.is_cuda or torch.is_grad_enabled():
        return fn(xf).reshape(*lead, -1)
    pad = -n % LORA_ROWS
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, xf.shape[1]))])
    out = torch.cat([fn(c) for c in xf.split(LORA_ROWS)])[:n]
    return out.reshape(*lead, -1)


def _mix_inputs(p, x, shifted):
    """Data-dependent token-shift interpolation (5 mixed variants of x)."""
    xx = shifted - x
    b, s, _ = x.shape
    r = p["mix_w2"].shape[1]
    w1, w2 = p["mix_w1"].float(), p["mix_w2"].float()

    def lora(t):
        dyn = torch.tanh(t @ w1.T).reshape(t.shape[0], 5, r)
        return torch.einsum("nfr,frd->nfd", dyn, w2)
    off = _lora(lora, xx.float()).reshape(b, s, 5, -1)
    mix = p["mu"][None, None] + off                    # (B, S, 5, D)
    return x[:, :, None, :] + xx[:, :, None, :] * mix.to(x.dtype)


def _decay(p, xw):
    """Per-token per-channel log-decay, clamped (see the module docstring)."""
    w1, w2 = p["ww1"].float(), p["ww2"].float()
    lo = _lora(lambda t: torch.tanh(t @ w1.T) @ w2.T, xw.float())
    logw = -torch.exp(torch.clamp(p["w0"][None, None] + lo, -8.0, 1.6))
    return torch.clamp(logw, LOG_W_MIN, -1e-4)


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunk-parallel WKV. r/k/v/logw: (B, S, H, d); u: (H, d); state: (B, H,
    d, d). Returns (out (B, S, H, d) in r's dtype, new f32 state)."""
    b, s, h, d = r.shape
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    n = s // chunk

    def to_chunks(x):
        return x.reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)  # (N,B,H,C,d)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    uf = u.float()
    S = state.float()
    outs = []
    for c in range(n):
        rr, kk, vv, ww = (t[c].float() for t in (rc, kc, vc, wc))
        logP = torch.cumsum(ww, dim=-2)                # (B, H, C, d)
        logQ = logP - ww                               # logP_{t-1}
        rq = rr * torch.exp(logQ)
        kp = kk * torch.exp(-logP)
        A = torch.einsum("bhtd,bhjd->bhtj", rq, kp)
        A = torch.where(tri, A, 0.0)
        intra = torch.einsum("bhtj,bhjd->bhtd", A, vv)
        bonus = torch.einsum("bhtd,hd,bhtd->bht", rr, uf, kk)
        intra = intra + bonus[..., None] * vv
        inter = torch.einsum("bhtd,bhde->bhte", rq, S)
        pC = torch.exp(logP[:, :, -1])                 # (B, H, d)
        S = pC[..., None] * S + torch.einsum(
            "bhjd,bhje->bhde", kp * pC[:, :, None, :], vv)
        outs.append(intra + inter)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)
    return out.to(r.dtype), S


def _wkv_step(rr, kk, vv, ww, u, state):
    """One recurrence step. rr/kk/vv/ww: (B, H, d) f32; state (B, H, d, d)."""
    o = torch.einsum("bhd,bhde->bhe", rr, state) + \
        torch.einsum("bhd,hd,bhd->bh", rr, u, kk)[..., None] * vv
    state = torch.exp(ww)[..., None] * state + kk[..., None] * vv[:, :, None, :]
    return o, state


def wkv_decode(r, k, v, logw, u, state):
    """Single-token WKV: O(d^2) per head. r/k/v/logw: (B, 1, H, d)."""
    rr, kk, vv, ww = (t[:, 0].float() for t in (r, k, v, logw))
    o, state = _wkv_step(rr, kk, vv, ww, u.float(), state.float())
    return o[:, None].to(r.dtype), state


def wkv_apply(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV for any sequence length: full chunks through the parallel
    form, the remainder (< chunk tokens) through the per-token step."""
    b, s, h, d = r.shape
    s_main = (s // chunk) * chunk
    outs = []
    if s_main:
        o1, state = wkv_chunked(r[:, :s_main], k[:, :s_main], v[:, :s_main],
                                logw[:, :s_main], u, state, chunk)
        outs.append(o1)
    if s > s_main:
        uf = u.float()
        S = state.float()
        tail = []
        for t in range(s_main, s):
            o, S = _wkv_step(r[:, t].float(), k[:, t].float(), v[:, t].float(),
                             logw[:, t].float(), uf, S)
            tail.append(o)
        state = S
        outs.append(torch.stack(tail, dim=1).to(r.dtype))
    return (torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]), state


def timemix_apply(p, x, cfg, scheme, seed, layer, *, state=None, prev=None):
    """RWKV-6 time-mix. state: (B, H, d, d) f32 or None; prev: (B, 1, D) the
    last token of the previous step. Returns (out, new state, x's last
    token)."""
    b, s, dm = x.shape
    hd = cfg.rwkv.head_dim
    h = dm // hd
    shifted = _shift(x, prev)
    xm = _mix_inputs(p, x, shifted)
    xr, xk, xv, xw, xg = (xm[:, :, i] for i in range(5))
    r = qlinear(xr, p["wr"], site_seed(seed, layer, 0), scheme).reshape(b, s, h, hd)
    k = qlinear(xk, p["wk"], site_seed(seed, layer, 1), scheme).reshape(b, s, h, hd)
    v = qlinear(xv, p["wv"], site_seed(seed, layer, 2), scheme).reshape(b, s, h, hd)
    g = qlinear(xg, p["wg"], site_seed(seed, layer, 3), scheme)
    logw = _decay(p, xw).reshape(b, s, h, hd)
    u = p["u"].reshape(h, hd)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    if s == 1:
        o, state = wkv_decode(r, k, v, logw, u, state)
    else:
        o, state = wkv_apply(r, k, v, logw, u, state, cfg.rwkv.chunk)
    # per-head group norm, then the gate (jax.nn.silu's form)
    o = rmsnorm(o, p["gn"].reshape(h, hd), cfg.norm_eps).reshape(b, s, dm)
    gf = g.float()
    o = o * (gf * torch.sigmoid(gf)).to(o.dtype)
    out = qlinear(o, p["wo"], site_seed(seed, layer, 4), scheme)
    return out, state, x[:, -1:]


def channelmix_apply(p, x, cfg, scheme, seed, layer, *, prev=None):
    """RWKV-6 channel-mix (the FFN analogue). Returns (out, x's last
    token)."""
    shifted = _shift(x, prev)
    xx = shifted - x
    xk = x + xx * p["cm_mu"][0].to(x.dtype)
    xr = x + xx * p["cm_mu"][1].to(x.dtype)
    k = qlinear(xk, p["cm_wk"], site_seed(seed, layer, 5), scheme)
    k = (torch.relu(k.float()) ** 2).to(x.dtype)
    v = qlinear(k, p["cm_wv"], site_seed(seed, layer, 6), scheme)
    r = qlinear(xr, p["cm_wr"], site_seed(seed, layer, 7), scheme)
    return torch.sigmoid(r.float()).to(x.dtype) * v, x[:, -1:]
