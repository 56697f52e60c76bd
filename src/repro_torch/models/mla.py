"""Multi-head Latent Attention (DeepSeek-V2/V3), decode form.

Counterpart of `repro/models/mla.py`. Decode uses the weight-absorbed form
over the compressed latent cache (kv_lora + rope values per position, shared
by every head): q_nope is absorbed through W_uk into the latent space, the
attention runs over the latent pools (`kernels.ops.paged_mla`, or
`paged_mla_q` over NVFP4 pools), and W_uv maps the latent readout back to
per-head values. The projections wq_a, wq_b, wkv_a and wo are quantized
linears; `wkv_b` enters the two absorbed einsums as a RAW f32 matrix (never
packed, `serve/prequant.py`), which run in full f32 (TF32 is off for the
package, `repro_torch/__init__.py`). The expanded form (`mla_apply`, train
and prefill) comes with the MLA training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import qlinear
from repro_torch.kernels import ops
from repro_torch.models.attention import apply_rope, rope_tables
from repro_torch.models.blocks import rmsnorm, site_seed


def mla_init(draw, count: int, cfg, device) -> dict:
    m = cfg.mla
    h = cfg.n_heads
    d = cfg.d_model
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    ones = lambda n: torch.ones((count, n), dtype=torch.float32, device=device)
    return {
        "wq_a": draw("wq_a", (count, m.q_lora_rank, d), d),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": draw("wq_b", (count, h * qk_dim, m.q_lora_rank), m.q_lora_rank),
        "wkv_a": draw("wkv_a", (count, m.kv_lora_rank + m.qk_rope_head_dim, d),
                      d),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": draw("wkv_b", (count, h * (m.qk_nope_head_dim + m.v_head_dim),
                                m.kv_lora_rank), m.kv_lora_rank),
        "wo": draw("wo", (count, d, h * m.v_head_dim), h * m.v_head_dim),
    }


def _latent(p, x, cfg, scheme, seed, layer, positions):
    """Shared projections: per-head q (nope, rope), the latent c and the
    rotated k_rope (B, S, 1, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = qlinear(rmsnorm(qlinear(x, p["wq_a"], site_seed(seed, layer, 0), scheme),
                        p["q_norm"], cfg.norm_eps),
                p["wq_b"], site_seed(seed, layer, 1), scheme).reshape(b, s, h, qk)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv = qlinear(x, p["wkv_a"], site_seed(seed, layer, 2), scheme)
    c = rmsnorm(kv[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]
    cos, sin = rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin), c, apply_rope(k_rope, cos, sin)


def mla_decode(p, x, cfg, scheme, seed, layer, cache, pos, *, active=None,
               block_table=None):
    """Absorbed-form decode over the paged latent pools. x: (B, Sq, D), Sq
    >= 1 (Sq > 1 is a chunked-prefill step).

    cache = (cc, kc): the layer's pool leaves (P + 1, BS, kv_lora) and
    (P + 1, BS, rope), bf16 or NVFP4 `PackedKV`, the last block the
    write-only scratch block of `serve.kv_pool`; they are UPDATED IN PLACE
    (the new latents are scattered before attending) and returned. pos: (B,)
    first-token positions; active: (B,) write gate; block_table as for
    `gqa_decode`.
      score_h(t) = q_nope_h^T W_uk_h c_t + q_rope_h^T kr_t  (W_uk absorbed)
      out_h      = (sum_t p_t c_t)^T W_uv_h                 (W_uv after)
    Row-local, as `gqa_decode`.
    """
    if block_table is None:
        raise NotImplementedError(
            "dense per-slot caches come with a later slice; pass a block table")
    from repro_torch.serve import kv_pool as KV
    m = cfg.mla
    b, sq = x.shape[:2]
    h = cfg.n_heads
    posb = pos.to(torch.int32).expand(b).contiguous()
    positions = posb[:, None] + torch.arange(sq, dtype=torch.int32,
                                             device=x.device)[None, :]
    q_nope, q_rope, c_new, kr_new = _latent(p, x, cfg, scheme, seed, layer,
                                            positions)
    cc, kc = cache
    valid = positions >= 0
    if active is not None:
        valid &= active[:, None]

    wkv_b = p["wkv_b"].reshape(h, m.qk_nope_head_dim + m.v_head_dim,
                               m.kv_lora_rank).float()
    w_uk = wkv_b[:, : m.qk_nope_head_dim, :]     # (H, nope, lora)
    w_uv = wkv_b[:, m.qk_nope_head_dim:, :]      # (H, v, lora)
    q_abs = torch.einsum("bqhn,hnl->bqhl", q_nope.float(), w_uk).contiguous()
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim

    rt, wt = KV.split_tables(block_table)
    KV.scatter_tokens(cc, wt, positions, c_new, valid)
    KV.scatter_tokens(kc, wt, positions, kr_new[:, :, 0, :], valid)
    cr, kr = KV.readable(cc), KV.readable(kc)  # without the scratch block
    q_rope = q_rope.contiguous()
    if isinstance(cr, KV.PackedKV):
        o_lat = ops.paged_mla_q(q_abs, q_rope, cr.codes, cr.scales, kr.codes,
                                kr.scales, rt, posb, qk_dim=qk_dim)
    else:
        o_lat = ops.paged_mla(q_abs, q_rope, cr, kr, rt, posb, qk_dim=qk_dim)
    o = torch.einsum("bqhl,hvl->bqhv", o_lat, w_uv)
    if active is not None:
        # as in gqa_decode: inactive rows must not carry cache values into
        # the per-tensor activation absmax of wo
        o = o * active[:, None, None, None].to(o.dtype)
    out = qlinear(o.reshape(b, sq, -1).to(x.dtype), p["wo"],
                  site_seed(seed, layer, 4), scheme)
    return out, (cc, kc)
