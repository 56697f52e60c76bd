"""Shared building blocks: norms, MLPs, embeddings, seed plumbing, init,
and the losses.

Counterpart of `repro/models/blocks.py`. bf16 rounding happens where the
reference rounds: `embed_lookup` returns bf16, norms compute in f32 and
return the input dtype, the swiglu gate is silu in f32 cast to bf16, the
relu2 activation is relu(h)^2 in f32 cast to bf16, and the gelu activation
is `jax.nn.gelu`'s default tanh form in f32 cast to bf16. Where PyTorch's
own function computes another form or sums in another order, the
reference's arithmetic is written out (`layernorm`'s two-pass variance,
`gelu_tanh`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.linear import ModelShard, dense, gather_whole, qlinear


def site_seed(seed, layer: int, site: int) -> np.ndarray:
    """Distinct uint32[2] sub-seed per (layer, call-site), the same LCG-style
    mixing as the reference. Host-side numpy: it feeds the stochastic
    backward's draws (`core/rng.py`); serving never consumes it."""
    s = np.asarray(seed, np.uint32)
    layer = np.uint32(layer)
    with np.errstate(over="ignore"):
        a = s[0] ^ (layer * np.uint32(2654435761)
                    + np.uint32(site) * np.uint32(40503))
        b = s[1] + layer * np.uint32(97) + np.uint32(site)
    return np.array([a, b], np.uint32)


def sum_last_fixed(s: torch.Tensor) -> torch.Tensor:
    """s summed over its last dim (keepdim) by a tree of elementwise adds
    that the width alone fixes: the first half of the columns plus the
    second, again until one column is left, an odd width's last column
    carried aside and added at the end. Each add is one IEEE add an
    element, so a row's sum does not depend on how many rows the call
    holds (a reduction kernel picks its launch shape, hence a row's
    summation order, from the row count)."""
    carry = None
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        if s.shape[-1] % 2:
            tail = s[..., 2 * h:]
            carry = tail if carry is None else tail + carry
        s = s[..., :h] + s[..., h:2 * h]
    return s if carry is None else s + carry


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / rms(x) * g in f32, returned in x's dtype. On the card outside an
    autograd graph (every serving step) the mean square is
    `sum_last_fixed`'s over the width, so a data shard's rows are bitwise
    the whole batch's; training and the CPU keep `mean`."""
    xf = x.float()
    sq = xf * xf
    if xf.is_cuda and not (torch.is_grad_enabled()
                           and (x.requires_grad or g.requires_grad)):
        ms = sum_last_fixed(sq) / xf.shape[-1]
    else:
        ms = sq.mean(dim=-1, keepdim=True)
    n = xf * torch.rsqrt(ms + eps)
    return (n * g.float()).to(x.dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The reference's layernorm in f32: the mean, then `jnp.var`'s second
    pass, the mean of the squared deviations (not `torch.var`, which may
    sum in another order)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    c = xf - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def norm(x, p, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["g"], p["b"], eps)
    return rmsnorm(x, p["g"], eps)


def norm_init(d: int, kind: str, device) -> dict:
    g = torch.ones((d,), dtype=torch.float32, device=device)
    if kind == "layernorm":
        return {"g": g, "b": torch.zeros((d,), dtype=torch.float32,
                                          device=device)}
    return {"g": g}


def linear_init(gen: torch.Generator, shape: tuple, n_in: int,
                scale: float | None = None, device="cuda") -> torch.Tensor:
    """N(0, 1) * scale weights of `shape` (..., n_out, n_in); scale defaults
    to n_in ** -0.5."""
    s = scale if scale is not None else n_in ** -0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * s


def weight_drawer(gen: torch.Generator, device):
    """The init functions' `draw(key, shape, n_in, scale=None)`: one weight
    leaf named `key` (its parameter-tree name), `linear_init` from `gen` on
    `device`. `serve.prequant.init_packed` passes a drawer that packs the
    decode path's weights as it draws them."""
    def draw(key: str, shape: tuple, n_in: int, scale: float | None = None):
        return linear_init(gen, shape, n_in, scale, device)
    return draw


SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True, its default) in the reference's
    order: x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), x^3 as
    x * x * x (`lax.integer_pow`). `F.gelu` defaults to the erf form."""
    cube = x * x * x
    return x * (0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * cube))))


def mlp_apply(p, x, kind: str, scheme: str, seed, layer):
    """swiglu | relu2 | gelu feed-forward, all matmuls quantized per scheme."""
    h = qlinear(x, p["wi"], site_seed(seed, layer, 10), scheme)
    hf = h.float()
    if kind == "swiglu":
        g = qlinear(x, p["wg"], site_seed(seed, layer, 11), scheme)
        a = (hf * torch.sigmoid(hf)).to(x.dtype) * g  # jax.nn.silu's form
    elif kind == "relu2":
        a = (torch.relu(hf) ** 2).to(x.dtype)
    else:  # gelu
        a = gelu_tanh(hf).to(x.dtype)
    return qlinear(a, p["wo"], site_seed(seed, layer, 12), scheme)


def mlp_init(draw, count: int, d_model: int, d_ff: int, kind: str):
    p = {"wi": draw("wi", (count, d_ff, d_model), d_model),
         "wo": draw("wo", (count, d_model, d_ff), d_ff)}
    if kind == "swiglu":
        p["wg"] = draw("wg", (count, d_ff, d_model), d_model)
    return p


def embed_init(draw, vocab: int, d_model: int) -> torch.Tensor:
    return draw("embed", (vocab, d_model), d_model, 0.02)


def embed_lookup(table, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """table[tokens] in `dtype`. A ModelShard table (split over a serving
    mesh's "model" axis on its vocab rows): each part looks up its own rows
    on its device, -0.0 for a token it does not hold, and the parts' rows
    are summed in model order on the tokens' device. Exact, signed zeros
    included: the one part holding a token contributes its row v, every
    other -0.0, and v + -0.0 = -0.0 + v = v."""
    if isinstance(table, ModelShard):
        if table.dim != -2:
            return embed_lookup(gather_whole(table, tokens.device), tokens,
                                dtype)
        out = None
        for j, part in enumerate(table.parts):
            rows = part.shape[0]
            t = tokens.long().to(part.device) - j * rows
            mine = (t >= 0) & (t < rows)
            vals = torch.where(mine[..., None],
                               part[t.clamp(0, rows - 1)].to(dtype),
                               torch.full((), -0.0, dtype=dtype,
                                          device=part.device)).to(tokens.device)
            out = vals if out is None else out + vals
        return out
    return table[tokens.long()].to(dtype)


def lm_head(x, w, quantize: bool, scheme: str, seed) -> torch.Tensor:
    """Final projection to vocab. Paper practice keeps this in BF16."""
    if quantize:
        return qlinear(x, w, site_seed(seed, 0, 99), scheme)
    return dense(x, w)


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor,
                z_loss: float = 0.0):
    """(summed fp32 NLL over tokens with label >= 0, their count)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).float()
    return (nll * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean CE in fp32; labels < 0 are masked out."""
    nll, cnt = _masked_nll(logits, labels, z_loss)
    return nll / cnt.clamp_min(1.0)


def chunked_head_ce(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                    quantize: bool, scheme: str, seed,
                    chunk_tokens: int = 1024) -> torch.Tensor:
    """Fused LM-head + CE that never holds the full (tokens, vocab) logits:
    the flattened token axis runs in chunks under activation checkpointing
    (the reference's jax.checkpoint), so forward and backward peak at
    (chunk_tokens x vocab). Returns the mean NLL over tokens with label >= 0.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    lf = labels.reshape(t)
    n_chunks = max(1, t // chunk_tokens)
    while t % n_chunks:
        n_chunks -= 1
    size = t // n_chunks

    def one(xi, li):
        return _masked_nll(lm_head(xi[None], head_w, quantize, scheme, seed)[0], li)

    nll = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for c in range(n_chunks):
        sl = slice(c * size, (c + 1) * size)
        a, n = checkpoint(one, xf[sl], lf[sl], use_reentrant=False)
        nll, cnt = nll + a, cnt + n
    return nll / cnt.clamp_min(1.0)
