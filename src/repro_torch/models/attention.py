"""GQA attention for decode: RoPE, decode SDPA and the paged decode step.

Counterpart of `repro/models/attention.py` (its decode path). All four
projections run through the quantized linear; the softmax stays f32.
Attention over the paged pool goes through `kernels.ops.paged_gqa`: the CUDA
kernel for tensors on the card, the gather_view + decode_sdpa plain version
on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core.linear import qlinear
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import sqrt_hd
from repro_torch.models.blocks import linear_init, rmsnorm, site_seed

NEG_INF = -1e30


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for `dim` rotary dims at given positions (...,)."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** F.div_const(ar, dim))
    ang = positions.float()[..., None] * inv  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos, sin, fraction: float = 1.0):
    """Rotate the first `fraction` of head dims."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, : rot // 2]
    s = sin[..., None, : rot // 2]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


def decode_sdpa(q, k_cache, v_cache, pos, window=None):
    """Decode attention over a cache. q: (B, Sq, H, hd); caches (B, Smax, KV,
    hd); pos (B,) is the absolute position of each row's FIRST query token.
    Cache index is the absolute position. Scores and softmax are f32."""
    b, sq, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    sk = k_cache.shape[1]
    qf = q.reshape(b, sq, kv, rep, hd).float()
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k_cache.float())
    s = s / torch.tensor(sqrt_hd(hd), dtype=torch.float32, device=s.device)
    qpos = pos.long()[:, None] + torch.arange(sq, device=q.device)[None, :]
    kj = torch.arange(sk, device=q.device)
    ok = kj[None, None, :] <= qpos[:, :, None]                      # (B,Sq,Sk)
    if window is not None:
        ok &= kj[None, None, :] > qpos[:, :, None] - window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgv->bqgrv", p, v_cache.float())
    return o.reshape(b, sq, h, v_cache.shape[-1]).to(q.dtype)


def gqa_init(gen, count: int, cfg, device) -> dict:
    hd = cfg.hd
    d = cfg.d_model
    p = {"wq": linear_init(gen, (count, cfg.n_heads * hd, d), d, device=device),
         "wk": linear_init(gen, (count, cfg.n_kv_heads * hd, d), d, device=device),
         "wv": linear_init(gen, (count, cfg.n_kv_heads * hd, d), d, device=device),
         "wo": linear_init(gen, (count, d, cfg.n_heads * hd), cfg.n_heads * hd,
                           device=device)}
    if cfg.qk_norm:
        p["qn"] = torch.ones((count, hd), dtype=torch.float32, device=device)
        p["kn"] = torch.ones((count, hd), dtype=torch.float32, device=device)
    return p


def _project_qkv(p, x, cfg, scheme, seed, layer, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = qlinear(x, p["wq"], site_seed(seed, layer, 0), scheme).reshape(b, s, cfg.n_heads, hd)
    k = qlinear(x, p["wk"], site_seed(seed, layer, 1), scheme).reshape(b, s, cfg.n_kv_heads, hd)
    v = qlinear(x, p["wv"], site_seed(seed, layer, 2), scheme).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    if cfg.rope_fraction > 0:
        rot = int(hd * cfg.rope_fraction)
        cos, sin = rope_tables(positions, rot, cfg.rope_theta)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    return q, k, v


def gqa_decode(p, x, cfg, scheme, seed, layer, cache_kv, pos, *, window=None,
               active=None, block_table=None):
    """Cached decode / chunked-prefill step over the paged pool. x: (B, Sq, D).

    pos: (B,) int32 absolute position of each row's first token. active:
    (B,) bool rows whose cache may be written. block_table: (B, MAXB) int32
    (or a stacked (B, 2, MAXB) read/write pair). cache_kv holds the layer's
    pool leaves (P + 1, BS, KV, hd), the last block being the write-only
    scratch block of `serve.kv_pool` — they are UPDATED IN PLACE (the
    reference rebinds donated buffers) and returned for symmetry.

    Row-local: row b reads and writes only row b of x, positions and cache.
    """
    if block_table is None:
        raise NotImplementedError(
            "dense per-slot caches come with a later slice; pass a block table")
    from repro_torch.serve import kv_pool as KV
    b, sq = x.shape[:2]
    posb = pos.to(torch.int32).expand(b).contiguous()
    positions = posb[:, None] + torch.arange(sq, dtype=torch.int32,
                                             device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, scheme, seed, layer, positions)
    kc, vc = cache_kv
    valid = positions >= 0
    if active is not None:
        valid &= active[:, None]
    rt, wt = KV.split_tables(block_table)
    KV.scatter_tokens(kc, wt, positions, k, valid)
    KV.scatter_tokens(vc, wt, positions, v, valid)
    n = kc.shape[0] - 1  # readers never see the scratch block
    o = ops.paged_gqa(q, kc[:n], vc[:n], rt, posb, window=window).to(q.dtype)
    if active is not None:
        # Inactive rows must not read cache memory: any nonzero value would
        # leak into active rows through the per-tensor activation absmax.
        o = o * active[:, None, None, None].to(o.dtype)
    out = qlinear(o.reshape(b, sq, -1), p["wo"], site_seed(seed, layer, 3), scheme)
    return out, (kc, vc)
