"""Shared building blocks: norms, MLPs, embeddings, seed plumbing, init,
and the losses.

Counterpart of `repro/models/blocks.py`. bf16 rounding happens where the
reference rounds: `embed_lookup` returns bf16, norms compute in f32 and
return the input dtype, the swiglu gate is silu in f32 cast to bf16, and the
relu2 activation is relu(h)^2 in f32 cast to bf16.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.linear import dense, qlinear


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


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * g.float()).to(x.dtype)


def norm(x, p, kind: str, eps: float):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm '{kind}' comes with the whisper slice")
    return rmsnorm(x, p["g"], eps)


def norm_init(d: int, kind: str, device) -> dict:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm '{kind}' comes with the whisper slice")
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


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


def mlp_apply(p, x, kind: str, scheme: str, seed, layer):
    """swiglu | relu2 feed-forward, all matmuls quantized per scheme."""
    if kind not in ("swiglu", "relu2"):
        raise NotImplementedError(f"mlp '{kind}' comes with the whisper slice")
    h = qlinear(x, p["wi"], site_seed(seed, layer, 10), scheme)
    hf = h.float()
    if kind == "swiglu":
        g = qlinear(x, p["wg"], site_seed(seed, layer, 11), scheme)
        a = (hf * torch.sigmoid(hf)).to(x.dtype) * g  # jax.nn.silu's form
    else:
        a = (torch.relu(hf) ** 2).to(x.dtype)
    return qlinear(a, p["wo"], site_seed(seed, layer, 12), scheme)


def mlp_init(draw, count: int, d_model: int, d_ff: int, kind: str):
    if kind not in ("swiglu", "relu2"):
        raise NotImplementedError(f"mlp '{kind}' comes with the whisper slice")
    p = {"wi": draw("wi", (count, d_ff, d_model), d_model),
         "wo": draw("wo", (count, d_model, d_ff), d_ff)}
    if kind == "swiglu":
        p["wg"] = draw("wg", (count, d_ff, d_model), d_model)
    return p


def embed_init(draw, vocab: int, d_model: int) -> torch.Tensor:
    return draw("embed", (vocab, d_model), d_model, 0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
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
