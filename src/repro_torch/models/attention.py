"""GQA attention: RoPE, full-sequence SDPA (training), decode SDPA and the
paged decode step.

Counterpart of `repro/models/attention.py`. All four projections run through
the quantized linear; scores and softmax stay f32, as fp32 einsums as in the
reference. The chunked online-softmax path the reference takes above
CHUNK_THRESHOLD tokens is not ported yet: `attend` raises there.
Attention over the paged pool goes through `kernels.ops.paged_gqa` (bf16
pool) or `kernels.ops.paged_gqa_q` (NVFP4 `PackedKV` pool): the CUDA kernel
for tensors on the card, the gather_view + decode_sdpa plain version on the
CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core.linear import qlinear
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import sqrt_hd
from repro_torch.models.blocks import rmsnorm, site_seed

NEG_INF = -1e30
# the reference switches to chunked online-softmax attention above this
# sequence length (repro/models/attention.py:CHUNK_THRESHOLD)
CHUNK_THRESHOLD = 8192


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


def _mask_bias(sq: int, sk: int, q_off: int, causal: bool, window, device):
    qi = q_off + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, NEG_INF)


def sdpa(q, k, v, *, causal=True, window=None, q_off=0):
    """Plain SDPA. q: (B, Sq, H, hd), k: (B, Sk, KV, hd), v: (B, Sk, KV, vd)
    -> (B, Sq, H, vd) in q.dtype; scores and softmax in f32."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qf = q.reshape(b, sq, kv, h // kv, hd).float()
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float())
    scores = scores / torch.tensor(sqrt_hd(hd), dtype=torch.float32,
                                   device=q.device)
    scores = scores + _mask_bias(sq, k.shape[1], q_off, causal, window,
                                 q.device)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrqk,bkgv->bqgrv", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None):
    if q.shape[1] > CHUNK_THRESHOLD or k.shape[1] > CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"sequences above {CHUNK_THRESHOLD} tokens take the reference's "
            "chunked_sdpa, which a later slice ports")
    return sdpa(q, k, v, causal=causal, window=window)


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


def gqa_init(draw, count: int, cfg, device) -> dict:
    hd = cfg.hd
    d = cfg.d_model
    p = {"wq": draw("wq", (count, cfg.n_heads * hd, d), d),
         "wk": draw("wk", (count, cfg.n_kv_heads * hd, d), d),
         "wv": draw("wv", (count, cfg.n_kv_heads * hd, d), d),
         "wo": draw("wo", (count, d, cfg.n_heads * hd), cfg.n_heads * hd)}
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


def gqa_apply(p, x, cfg, scheme, seed, layer, *, causal=True, window=None,
              positions=None):
    """Full-sequence GQA (training). Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, scheme, seed, layer, positions)
    o = attend(q, k, v, causal=causal, window=window)
    out = qlinear(o.reshape(b, s, -1), p["wo"], site_seed(seed, layer, 3), scheme)
    return out, (k, v)


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
    kr, vr = KV.readable(kc), KV.readable(vc)  # without the scratch block
    if isinstance(kr, KV.PackedKV):
        o = ops.paged_gqa_q(q, kr.codes, kr.scales, vr.codes, vr.scales, rt,
                            posb, window=window)
    else:
        o = ops.paged_gqa(q, kr, vr, rt, posb, window=window)
    o = o.to(q.dtype)
    if active is not None:
        # Inactive rows must not read cache memory: any nonzero value would
        # leak into active rows through the per-tensor activation absmax.
        o = o * active[:, None, None, None].to(o.dtype)
    out = qlinear(o.reshape(b, sq, -1), p["wo"], site_seed(seed, layer, 3), scheme)
    return out, (kc, vc)
