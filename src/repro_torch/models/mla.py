"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of `repro/models/mla.py`. Prefill uses the expanded form
(`mla_apply`): `wkv_b` expands the latent into per-head keys and values
through the quantized linear (site 3, on the raw f32 matrix even in a packed
tree, since `serve/prequant.py` never packs it) and standard attention runs
over them. Decode uses the weight-absorbed form over the compressed latent
cache (kv_lora + rope values per position, shared by every head): q_nope is
absorbed through W_uk into the latent space, the attention runs over the
latent pools (`kernels.ops.paged_mla`, or `paged_mla_q` over NVFP4 pools) or
over a dense per-slot latent cache (`latent_attend`), and W_uv maps the
latent readout back to per-head values. The projections wq_a, wq_b, wkv_a
and wo are quantized linears; in decode `wkv_b` enters the two absorbed
einsums RAW, in full f32 (TF32 is off for the package,
`repro_torch/__init__.py`). Training runs `mla_apply` under autograd: the
backward goes through `qlinear`'s autograd Function, so under quartet2 each
projection's dX and dW GEMM is `ops.quartet2_backward_gemm`. wkv_a's output
is kv_lora + rope wide (576 at deepseek-v3's widths), so its dX GEMM
contracts over a width that is no multiple of 128; `core/linear.py` pads it
with zeros to the next multiple (640) before the rotation, as the
reference does.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import qlinear
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import mla_scale
from repro_torch.models.attention import NEG_INF, apply_rope, attend, rope_tables
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


def mla_apply(p, x, cfg, scheme, seed, layer, *, positions=None):
    """Expanded-form MLA (prefill). Returns (out, (c, k_rope)), the latents
    prefill writes into the dense decode cache."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c, k_rope = _latent(p, x, cfg, scheme, seed, layer,
                                        positions)
    kvb = qlinear(c, p["wkv_b"], site_seed(seed, layer, 3), scheme)
    kvb = kvb.reshape(b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., : m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    # the rope part folds into the head dim, so standard SDPA applies
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, k_rope.shape[-1])],
                       dim=-1)
    o = attend(q_full, k_full, v, causal=True)
    out = qlinear(o.reshape(b, s, -1), p["wo"], site_seed(seed, layer, 4),
                  scheme)
    return out, (c, k_rope[:, :, 0, :])


def latent_attend(q_abs, q_rope, cv, kv, pos, qk_dim):
    """Absorbed-form attention over latent views (the reference's
    gathered-view / dense arithmetic): s = (q_abs.c + q_rope.kr) * scale,
    causal per absolute position, softmax, readout over c. q_abs (B, Sq, H,
    lora) f32, q_rope (B, Sq, H, rope); cv (B, T, lora), kv (B, T, rope);
    pos (B,) first-token positions. Returns o_lat f32 (B, Sq, H, lora)."""
    cv, kv = cv.float(), kv.float()
    sq = q_abs.shape[1]
    positions = pos.long()[:, None] + torch.arange(sq, device=pos.device)[None]
    s_lat = torch.einsum("bqhl,btl->bhqt", q_abs.float(), cv)
    s_rope = torch.einsum("bqhr,btr->bhqt", q_rope.float(), kv)
    s = (s_lat + s_rope) * mla_scale(qk_dim)  # an f32 value: exact scalar
    tmask = (torch.arange(cv.shape[1], device=pos.device)[None, None, :]
             <= positions[:, :, None])                         # (B, Sq, T)
    s = torch.where(tmask[:, None], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    prob = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqt,btl->bqhl", prob, cv)


def mla_decode(p, x, cfg, scheme, seed, layer, cache, pos, *, active=None,
               block_table=None):
    """Absorbed-form decode over the latent cache. x: (B, Sq, D), Sq >= 1
    (Sq > 1 is a chunked-prefill step).

    cache = (cc, kc), UPDATED IN PLACE (the new latents are written before
    attending) and returned, each with one write-only scratch slot for
    dropped writes, as in `attention.gqa_decode`:
      - block_table given (as for `gqa_decode`): the layer's pool leaves
        (P + 1, BS, kv_lora) and (P + 1, BS, rope), bf16 or NVFP4
        `PackedKV`, the last block the scratch block of `serve.kv_pool`;
      - block_table None: dense per-slot latents (B, max_len + 1, kv_lora)
        and (B, max_len + 1, rope), position max_len the scratch position.
    pos: (B,) first-token positions; active: (B,) write gate.
      score_h(t) = q_nope_h^T W_uk_h c_t + q_rope_h^T kr_t  (W_uk absorbed)
      out_h      = (sum_t p_t c_t)^T W_uv_h                 (W_uv after)
    Row-local, as `gqa_decode`.
    """
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

    if block_table is None:
        cap = cc.shape[1] - 1
        KV.scatter_dense(cc, positions, c_new, valid)
        KV.scatter_dense(kc, positions, kr_new[:, :, 0, :], valid)
        o_lat = latent_attend(q_abs, q_rope, cc[:, :cap], kc[:, :cap], posb,
                              qk_dim)
    else:
        rt, wt = KV.split_tables(block_table)
        KV.scatter_tokens(cc, wt, positions, c_new, valid)
        KV.scatter_tokens(kc, wt, positions, kr_new[:, :, 0, :], valid)
        cr, kr = KV.readable(cc), KV.readable(kc)  # without the scratch block
        q_rope = q_rope.contiguous()
        if isinstance(cr, KV.PackedKV):
            o_lat = ops.paged_mla_q(q_abs, q_rope, cr.codes, cr.scales,
                                    kr.codes, kr.scales, rt, posb,
                                    qk_dim=qk_dim)
        else:
            o_lat = ops.paged_mla(q_abs, q_rope, cr, kr, rt, posb,
                                  qk_dim=qk_dim)
    o = torch.einsum("bqhl,hvl->bqhv", o_lat, w_uv)
    if active is not None:
        # as in gqa_decode: inactive rows must not carry cache values into
        # the per-tensor activation absmax of wo
        o = o * active[:, None, None, None].to(o.dtype)
    out = qlinear(o.reshape(b, sq, -1).to(x.dtype), p["wo"],
                  site_seed(seed, layer, 4), scheme)
    return out, (cc, kc)
