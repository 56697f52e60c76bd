"""Shared building blocks: norms, MLPs, embeddings, seed plumbing, init.

Counterpart of `repro/models/blocks.py`. bf16 rounding happens where the
reference rounds: `embed_lookup` returns bf16, norms compute in f32 and
return the input dtype, and the swiglu gate is silu in f32 cast to bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linear import dense, qlinear


def site_seed(seed, layer: int, site: int) -> np.ndarray:
    """Distinct uint32[2] sub-seed per (layer, call-site), the same LCG-style
    mixing as the reference. Host-side: serving never consumes it (it feeds
    the stochastic backward of the training slice)."""
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
        raise NotImplementedError(f"norm '{kind}' comes with a later slice")
    return rmsnorm(x, p["g"], eps)


def norm_init(d: int, kind: str, device) -> dict:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm '{kind}' comes with a later slice")
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def linear_init(gen: torch.Generator, shape: tuple, n_in: int,
                scale: float | None = None, device="cuda") -> torch.Tensor:
    """N(0, 1) * scale weights of `shape` (..., n_out, n_in); scale defaults
    to n_in ** -0.5."""
    s = scale if scale is not None else n_in ** -0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * s


def mlp_apply(p, x, kind: str, scheme: str, seed, layer):
    """swiglu feed-forward, all matmuls quantized per scheme."""
    if kind != "swiglu":
        raise NotImplementedError(f"mlp '{kind}' comes with a later slice")
    h = qlinear(x, p["wi"], site_seed(seed, layer, 10), scheme)
    g = qlinear(x, p["wg"], site_seed(seed, layer, 11), scheme)
    hf = h.float()
    a = (hf * torch.sigmoid(hf)).to(x.dtype) * g  # jax.nn.silu's form
    return qlinear(a, p["wo"], site_seed(seed, layer, 12), scheme)


def mlp_init(gen, count: int, d_model: int, d_ff: int, kind: str, device):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp '{kind}' comes with a later slice")
    return {"wi": linear_init(gen, (count, d_ff, d_model), d_model, device=device),
            "wo": linear_init(gen, (count, d_model, d_ff), d_ff, device=device),
            "wg": linear_init(gen, (count, d_ff, d_model), d_model, device=device)}


def embed_init(gen, vocab: int, d_model: int, device) -> torch.Tensor:
    return linear_init(gen, (vocab, d_model), d_model, scale=0.02, device=device)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def lm_head(x, w, quantize: bool, scheme: str, seed) -> torch.Tensor:
    """Final projection to vocab. Paper practice keeps this in BF16."""
    if quantize:
        return qlinear(x, w, site_seed(seed, 0, 99), scheme)
    return dense(x, w)
