"""Paged flash-decode attention: plain versions and kernel launches.

Replaces the TPU kernels of `repro/kernels/paged_attention.py`:
  - `paged_gqa_call`    (#5): GQA decode over the bf16 pool;
  - `paged_gqa_q_call`  (#6): the same over the NVFP4 `PackedKV` pool;
  - `paged_mla_call`    (#7): absorbed-form MLA latent decode over the
                              shared (cc, kc) pools;
  - `paged_mla_q_call`  (#8): #7 over NVFP4 latent pools.
Each plain version is the serving reference path its kernel stands in for
(`repro/kernels/ref.py`): materialize `gather_view` of the pools (packed
pools dequantize exactly to bf16) and compute over the full table capacity,
in f32.

On the card #5 and #6 are one split-KV design (`csrc/paged_attention.cu`):
`plan` cuts each row's logical blocks into fixed splits from the shapes
alone, one CTA per (row, KV head, split) writes a partial softmax, and a
second kernel merges the partials in split order; head dims up to
MAX_HEAD_DIM (256: recurrentgemma's lattn layers), with an optional window. #7 and #8 are split-KV
designs over `plan_mla`'s geometry: one CTA per (row, tile of 16 (query,
head) pairs, split) and the same merge kernel. #8 decodes the packed latent
blocks once per 16-group to bf16 in shared memory and scores on the CUDA
cores; #7 (`plan_mla(..., wave=MLA_TC_WAVE)`: as many splits as one wave of
CTAs holds) runs both products on the tensor cores, its f32 operands (q_abs,
an f32 q_rope, the probabilities) split into three bf16 terms each
(`split_bf16x3`), so that every product is exact in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30  # matches models.attention.NEG_INF
BLOCK_SIZES = (4, 8, 16, 32)  # pool block sizes the kernels are built for
MAX_HEAD_DIM = 256  # a lane of #5/#6 owns 4 dims up to 128, 8 up to 256
MAX_SQ = 16
MAX_LORA = 512   # MLA latent (value) width the kernel's lanes cover
MAX_ROPE = 64
SPLIT_KEYS = 16  # keys of one GQA split (whole blocks, at least one)
ROW_CHUNK = 4    # query rows one warp of the GQA kernel carries at once
MLA_PAIRS = 16   # (query, head) pairs of one #7 or #8 CTA (an mma's m16)
MLA_SPLIT_KEYS = 16  # keys of one #8 split below the scratch cap (whole blocks)
MLA_SCRATCH_BYTES = 32 << 20  # cap on one #8 call's f32 partials
MLA_TC_WAVE = 2 * 132  # CTAs of one wave of #7's kernel: 2 an SM, 132 SMs


class Plan(NamedTuple):
    """Geometry of one GQA call: `splits` runs of `blocks_per_split` logical
    blocks over the table's `maxb` (the last may be shorter); `row_groups`
    warp groups over the Sq x H/KV query rows of a KV head (the other
    4 / row_groups warps split the keys); `grid` CTAs of the split kernel;
    `scratch` f32 elements of the partials (0 with one split)."""
    maxb: int
    blocks_per_split: int
    splits: int
    row_groups: int
    grid: int
    scratch: int

    def blocks(self, split: int) -> range:
        """The logical blocks of split `split`, in order."""
        j0 = split * self.blocks_per_split
        return range(j0, min(j0 + self.blocks_per_split, self.maxb))


def plan(b: int, sq: int, h: int, kv: int, maxb: int, bs: int, vd: int) -> Plan:
    """The GQA kernels' geometry for q (b, sq, h, .), KV heads kv, a (b, maxb)
    table over blocks of bs tokens and value dim vd: a function of shapes
    only, so a call's bits never depend on timing."""
    bps = max(1, SPLIT_KEYS // bs)
    splits = -(-maxb // bps)
    rows = sq * (h // kv)
    row_groups = 1 if rows <= ROW_CHUNK else 2 if rows <= 2 * ROW_CHUNK else 4
    scratch = 0 if splits == 1 else b * sq * h * splits * (vd + 2)
    return Plan(maxb, bps, splits, row_groups, b * kv * splits, scratch)


class MlaPlan(NamedTuple):
    """Geometry of one #7 or #8 call: `splits` runs of `blocks_per_split`
    logical blocks over the table's `maxb` (the last may be shorter);
    `tiles` CTAs of MLA_PAIRS (query, head) pairs per row and split; `grid`
    CTAs of the split kernel; `scratch` f32 elements of the partials (0 with
    one split)."""
    maxb: int
    blocks_per_split: int
    splits: int
    tiles: int
    grid: int
    scratch: int

    def blocks(self, split: int) -> range:
        """The logical blocks of split `split`, in order."""
        j0 = split * self.blocks_per_split
        return range(j0, min(j0 + self.blocks_per_split, self.maxb))


def mla_split_cap(b: int, sq: int, h: int, lora: int) -> int:
    """Most splits a row may have: a split costs (lora + 2) f32 of partials
    per (query, head), and a call's partials stay within
    MLA_SCRATCH_BYTES."""
    return max(1, MLA_SCRATCH_BYTES // (b * sq * h * (lora + 2) * 4))


def plan_mla(b: int, sq: int, h: int, maxb: int, bs: int, lora: int,
             wave: int | None = None) -> MlaPlan:
    """The geometry of #8 (wave None) or #7 (wave = MLA_TC_WAVE) for q_abs
    (b, sq, h, lora) over a (b, maxb) table of blocks of bs tokens. #8:
    splits of MLA_SPLIT_KEYS keys, lengthened until a row has at most
    `mla_split_cap` of them. #7: the most splits (at least one, at most one
    a block) that keep the grid within one wave of `wave` CTAs, so that the
    partials written and read back stay few. A function of shapes only, so
    a call's bits never depend on timing."""
    tiles = -(-(sq * h) // MLA_PAIRS)
    if wave is None:
        bps = max(1, MLA_SPLIT_KEYS // bs)
        cap = mla_split_cap(b, sq, h, lora)
        if -(-maxb // bps) > cap:
            bps = -(-maxb // cap)
    else:
        bps = -(-maxb // max(1, min(maxb, wave // (b * tiles))))
    splits = -(-maxb // bps)
    scratch = 0 if splits == 1 else b * sq * h * splits * (lora + 2)
    return MlaPlan(maxb, bps, splits, tiles, b * tiles * splits, scratch)


def sqrt_hd(hd: int) -> float:
    """The f32 sqrt(hd) decode_sdpa divides scores by."""
    return float(np.sqrt(np.float32(hd)))


def mla_scale(qk_dim: int) -> float:
    """The f32 1/sqrt(qk_dim) the MLA scores are MULTIPLIED by (the f32
    image of mla_decode's scale, so kernel and reference use one scalar)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(qk_dim)))


def split_bf16x3(x: torch.Tensor):
    """f32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly in f32:
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each residual
    exact in f32 (8 + 8 + 8 significant bits). The split #7's kernel applies
    to q_abs, an f32 q_rope and the probabilities before the tensor cores;
    exact for every x with |x| >= 2^-110 or 0, and |x| below bf16's overflow
    (3.39e38)."""
    x = x.float()
    hi = x.bfloat16()
    r = x - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def paged_gqa_plain(q, k_pool, v_pool, table, pos, window=None):
    """q (B, Sq, H, hd) vs pools (P, BS, KV, hd/vd) -> f32 (B, Sq, H, vd).
    The pools are bf16 tensors or `serve.kv_pool.PackedKV`s."""
    from repro_torch.models.attention import decode_sdpa
    from repro_torch.serve.kv_pool import gather_view
    return decode_sdpa(q.float(), gather_view(k_pool, table),
                       gather_view(v_pool, table), pos, window=window)


def paged_gqa_q_plain(q, k_codes, k_scales, v_codes, v_scales, table, pos,
                      window=None):
    """`paged_gqa_plain` over the NVFP4 pool's unbundled leaves."""
    from repro_torch.serve.kv_pool import PackedKV
    return paged_gqa_plain(q, PackedKV(k_codes, k_scales),
                           PackedKV(v_codes, v_scales), table, pos, window)


def paged_mla_plain(q_abs, q_rope, cc_pool, kc_pool, table, pos, qk_dim):
    """Absorbed-form MLA decode over the gathered latent view
    (`models.mla.latent_attend`). q_abs (B, Sq, H, lora), q_rope (B, Sq, H,
    rope); pools (P, BS, lora) / (P, BS, rope), bf16 or PackedKV. Returns
    o_lat f32 (B, Sq, H, lora)."""
    from repro_torch.models.mla import latent_attend
    from repro_torch.serve.kv_pool import gather_view
    return latent_attend(q_abs, q_rope, gather_view(cc_pool, table),
                         gather_view(kc_pool, table), pos, qk_dim)


def paged_mla_q_plain(q_abs, q_rope, cc_codes, cc_scales, kc_codes,
                      kc_scales, table, pos, qk_dim):
    """`paged_mla_plain` over the NVFP4 latent pools' unbundled leaves."""
    from repro_torch.serve.kv_pool import PackedKV
    return paged_mla_plain(q_abs, q_rope, PackedKV(cc_codes, cc_scales),
                           PackedKV(kc_codes, kc_scales), table, pos, qk_dim)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch(q, k, v, table, pos, out, window, *, k_scales=None,
           v_scales=None) -> None:
    """Enqueue the GQA kernels on the current stream (output preallocated;
    the partials' scratch allocated here, sized by `plan`). k, v are the
    bf16 pools (#5), or with k_scales/v_scales the packed code leaves of the
    NVFP4 pool (#6)."""
    b, sq, h, hd = q.shape
    n_blocks, bs, kv = k.shape[:3]
    vd = out.shape[3]
    maxb = table.shape[1]
    p = plan(b, sq, h, kv, maxb, bs, vd)
    part = (torch.empty(p.scratch, dtype=torch.float32, device=q.device)
            if p.scratch else None)
    part_ml = (None if part is None
               else part.data_ptr() + b * sq * h * p.splits * vd * 4)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.library().paged_gqa_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), int(k_scales is not None),
        k.data_ptr(), _ptr(k_scales), v.data_ptr(), _ptr(v_scales),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), _ptr(part), part_ml,
        b, sq, h, kv, hd, vd, n_blocks, bs, maxb,
        0 if window is None else int(window), sqrt_hd(hd), p.blocks_per_split,
        p.splits, p.row_groups, stream)
    build.check(status, "paged_gqa_q" if k_scales is not None else "paged_gqa")


def _mla_partials(p: MlaPlan, rows: int, lora: int, device):
    """The f32 scratch of a #7 or #8 call's partials: the tensor (acc, then
    (m, l)) and the address of its (m, l) part; (None, None) with one
    split."""
    if not p.scratch:
        return None, None
    part = torch.empty(p.scratch, dtype=torch.float32, device=device)
    return part, part.data_ptr() + rows * p.splits * lora * 4


def launch_mla(q_abs, q_rope, cc, kc, table, pos, out, qk_dim) -> None:
    """Enqueue #7's kernels (the tensor-core split kernel over the bf16
    latent pools cc, kc, then with several splits the merge kernel) on the
    current stream (output preallocated; the partials' scratch allocated
    here, sized by `plan_mla` with wave = MLA_TC_WAVE)."""
    b, sq, h, lora = q_abs.shape
    rope = q_rope.shape[3]
    n_blocks, bs = cc.shape[:2]
    maxb = table.shape[1]
    p = plan_mla(b, sq, h, maxb, bs, lora, wave=MLA_TC_WAVE)
    part, part_ml = _mla_partials(p, b * sq * h, lora, q_abs.device)
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    status = build.library().paged_mla_launch(
        q_abs.data_ptr(), q_rope.data_ptr(), int(q_rope.dtype == torch.bfloat16),
        cc.data_ptr(), kc.data_ptr(), table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _ptr(part), part_ml, b, sq, h, lora, rope, n_blocks, bs,
        maxb, p.blocks_per_split, p.splits, p.tiles, mla_scale(qk_dim), stream)
    build.check(status, "paged_mla")


def launch_mla_q(q_abs, q_rope, cc_codes, cc_scales, kc_codes, kc_scales,
                 table, pos, out, qk_dim) -> None:
    """Enqueue #8's kernels over the NVFP4 latent pools' leaves on the
    current stream (output preallocated; the partials' scratch allocated
    here, sized by `plan_mla`)."""
    b, sq, h, lora = q_abs.shape
    rope = q_rope.shape[3]
    n_blocks, bs = cc_codes.shape[:2]
    maxb = table.shape[1]
    p = plan_mla(b, sq, h, maxb, bs, lora)
    part, part_ml = _mla_partials(p, b * sq * h, lora, q_abs.device)
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    status = build.library().paged_mla_q_launch(
        q_abs.data_ptr(), q_rope.data_ptr(), int(q_rope.dtype == torch.bfloat16),
        cc_codes.data_ptr(), cc_scales.data_ptr(), kc_codes.data_ptr(),
        kc_scales.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        _ptr(part), part_ml, b, sq, h, lora, rope, n_blocks, bs, maxb,
        p.blocks_per_split, p.splits, p.tiles, mla_scale(qk_dim), stream)
    build.check(status, "paged_mla_q")
