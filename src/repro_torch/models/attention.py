"""GQA attention: RoPE, full-sequence SDPA (train and prefill), chunked
online-softmax SDPA for long sequences, decode SDPA and the cached decode
step over the paged pool or a dense per-slot cache.

Counterpart of `repro/models/attention.py`. All four projections run through
the quantized linear; scores and softmax stay f32, as fp32 einsums as in the
reference. Above CHUNK_THRESHOLD tokens `attend` takes `chunked_sdpa`, the
reference's online softmax over KV blocks. Attention over the paged pool
goes through `kernels.ops.paged_gqa` (bf16 pool) or `kernels.ops.paged_gqa_q`
(NVFP4 `PackedKV` pool): the CUDA kernel for tensors on the card, the
gather_view + decode_sdpa plain version on the CPU. A dense cache (no block
table) is attended by `decode_sdpa` itself, as in the reference; a
sliding-window layer's dense cache may be a ring of `window` positions,
addressed by position mod window and labelled by `ring_abs_pos`.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core.linear import qlinear
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import sqrt_hd
from repro_torch.models.blocks import rmsnorm, site_seed

NEG_INF = -1e30
# plain (materialized-scores) attention up to this sequence length; chunked
# online softmax above it, in blocks of Q_BLOCK queries and KV_BLOCK keys
CHUNK_THRESHOLD = 8192
Q_BLOCK = 1024
KV_BLOCK = 1024


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


def _dead_block(q_off: int, qb: int, k_off: int, kb: int, causal: bool,
                window) -> bool:
    """Whether every (query, key) pair of a block is masked: all keys in the
    future of the block's last query, or all behind the first query's
    window."""
    return ((causal and k_off > q_off + qb - 1)
            or (window is not None and k_off + kb - 1 <= q_off - window))


def chunked_sdpa(q, k, v, *, causal=True, window=None):
    """Online-softmax attention over KV blocks: never materializes (Sq, Sk)
    scores; the peak transient is (B, KV, rep, Q_BLOCK, KV_BLOCK) f32.

    The reference's block arithmetic and shape rules: Sq is a multiple of
    Q_BLOCK (or shorter, one block), Sk splits into max(Sk // KV_BLOCK, 1)
    equal blocks. Blocks whose pairs are all masked are skipped: in the
    reference's scan such a block leaves (m, l, acc) unchanged bit for bit
    after a live block (p = exp(-1e30 - m) = 0, corr = 1), and before the
    first live block (window) its sums are wiped by corr = exp(-1e30 - m)
    = 0, so skipping computes the same values with half the work (causal)."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    kv = k.shape[2]
    rep = h // kv
    sk = k.shape[1]
    nq, qb = (sq // Q_BLOCK, Q_BLOCK) if sq >= Q_BLOCK else (1, sq)
    nk = max(sk // KV_BLOCK, 1)
    kb = sk // nk
    qf = q.reshape(b, nq, qb, kv, rep, hd).float()
    kf = k.reshape(b, nk, kb, kv, hd).float()
    vf = v.reshape(b, nk, kb, kv, vd).float()
    div = torch.tensor(sqrt_hd(hd), dtype=torch.float32, device=q.device)
    outs = []
    for qi in range(nq):
        q_off = qi * qb
        m = torch.full((b, kv, rep, qb), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, rep, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, rep, qb, vd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            if _dead_block(q_off, qb, ki * kb, kb, causal, window):
                continue
            s = torch.einsum("bqgrh,bkgh->bgrqk", qf[:, qi], kf[:, ki]) / div
            s = s + _mask_bias(qb, kb, q_off - ki * kb, causal, window,
                               q.device)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgv->bgrqv", p, vf[:, ki])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))            # (b, qb, kv, rep, vd)
    return torch.cat(outs, dim=1).reshape(b, sq, h, vd).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None):
    if q.shape[1] > CHUNK_THRESHOLD or k.shape[1] > CHUNK_THRESHOLD:
        return chunked_sdpa(q, k, v, causal=causal, window=window)
    return sdpa(q, k, v, causal=causal, window=window)


def decode_sdpa(q, k_cache, v_cache, pos, window=None, abs_pos=None):
    """Decode attention over a cache. q: (B, Sq, H, hd); caches (B, Smax, KV,
    hd); pos (B,) is the absolute position of each row's FIRST query token.
    Cache index is the absolute position, or with `abs_pos` (B, Smax) (a
    ring buffer: `ring_abs_pos`) each slot's position, negative for a slot
    never written. Scores and softmax are f32."""
    b, sq, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    sk = k_cache.shape[1]
    qf = q.reshape(b, sq, kv, rep, hd).float()
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k_cache.float())
    s = s / torch.tensor(sqrt_hd(hd), dtype=torch.float32, device=s.device)
    qpos = pos.long()[:, None] + torch.arange(sq, device=q.device)[None, :]
    kj = (torch.arange(sk, device=q.device)[None, :] if abs_pos is None
          else abs_pos.long())                                        # (B|1,Sk)
    ok = kj[:, None, :] <= qpos[:, :, None]                         # (B,Sq,Sk)
    if abs_pos is not None:
        ok &= kj[:, None, :] >= 0
    if window is not None:
        ok &= kj[:, None, :] > qpos[:, :, None] - window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgv->bqgrv", p, v_cache.float())
    return o.reshape(b, sq, h, v_cache.shape[-1]).to(q.dtype)


def ring_abs_pos(pos: torch.Tensor, sq: int, cap: int) -> torch.Tensor:
    """Absolute position held by each ring-buffer slot after writing a chunk:
    (B, cap) int64. With per-row last written position P = pos + sq - 1,
    slot j holds the largest position <= P congruent to j mod cap; negative
    values mark slots never written. Exact whenever cap == window (a slot's
    previous occupant is at least one full window older, so masking by
    query position is exact)."""
    pmax = pos.long()[:, None] + (sq - 1)
    j = torch.arange(cap, device=pos.device)[None, :]
    return pmax - torch.remainder(pmax - j, cap)


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
    """Full-sequence GQA (train / prefill). Returns (out, (k, v)), which
    prefill writes into the dense decode cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, scheme, seed, layer, positions)
    o = attend(q, k, v, causal=causal, window=window)
    out = qlinear(o.reshape(b, s, -1), p["wo"], site_seed(seed, layer, 3), scheme)
    return out, (k, v)


def gqa_decode(p, x, cfg, scheme, seed, layer, cache_kv, pos, *, window=None,
               active=None, block_table=None):
    """Cached decode / chunked-prefill step. x: (B, Sq, D).

    pos: (B,) int32 absolute position of each row's first token. active:
    (B,) bool rows whose cache may be written. The cache leaves are UPDATED
    IN PLACE (the reference rebinds donated buffers) and returned for
    symmetry; each holds one write-only scratch slot that no reader sees,
    where every dropped write lands (inactive rows, negative positions,
    sentinel entries), since PyTorch indexing raises where JAX's
    `mode="drop"` drops:
      - block_table (B, MAXB) int32 (or a stacked (B, 2, MAXB) read/write
        pair): cache_kv holds the layer's paged pool leaves (P + 1, BS, KV,
        hd), the last block the scratch block of `serve.kv_pool`;
      - block_table None: dense per-slot caches (B, max_len + 1, KV, hd),
        position max_len the scratch position; readers see [:, :max_len].

    Row-local: row b reads and writes only row b of x, positions and cache.
    """
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
    if block_table is None:
        cap = kc.shape[1] - 1
        ring = window is not None and cap == window
        if ring and sq > 1:
            # in-chunk ring writes evict keys still inside earlier queries'
            # windows, and ring_abs_pos labels slots from the chunk's LAST
            # position only: correct solely for sq == 1
            raise NotImplementedError(
                "ring-buffer (cap == window) caches decode one token at a "
                "time; chunked prefill needs a full-capacity or paged cache")
        # a ring slot is position mod cap (`valid` already drops negative
        # positions, which would wrap into the ring)
        idx = torch.remainder(positions, cap) if ring else positions
        KV.scatter_dense(kc, idx, k, valid)
        KV.scatter_dense(vc, idx, v, valid)
        o = decode_sdpa(q, kc[:, :cap], vc[:, :cap], posb, window=window,
                        abs_pos=ring_abs_pos(posb, sq, cap) if ring else None)
    else:
        rt, wt = KV.split_tables(block_table)
        KV.scatter_tokens(kc, wt, positions, k, valid)
        KV.scatter_tokens(vc, wt, positions, v, valid)
        kr, vr = KV.readable(kc), KV.readable(vc)  # without the scratch block
        if isinstance(kr, KV.PackedKV):
            o = ops.paged_gqa_q(q, kr.codes, kr.scales, vr.codes, vr.scales,
                                rt, posb, window=window)
        else:
            o = ops.paged_gqa(q, kr, vr, rt, posb, window=window)
        o = o.to(q.dtype)
    if active is not None:
        # Inactive rows must not read cache memory: their stale contents are
        # layout-dependent (dense keeps retired sequences' K/V, the pool
        # reads zeros), and any nonzero value would leak into active rows
        # through the per-tensor activation absmax.
        o = o * active[:, None, None, None].to(o.dtype)
    out = qlinear(o.reshape(b, sq, -1), p["wo"], site_seed(seed, layer, 3), scheme)
    return out, (kc, vc)
