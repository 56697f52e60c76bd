"""The public wrappers of the port's kernels.

One wrapper per kernel. It checks device, dtype, shape and contiguity; a
tensor on the CPU goes to the plain PyTorch version, a tensor on a CUDA
device launches the hand-written kernel on the current stream, with outputs
allocated by `torch.empty`. A failed build or launch raises: nothing routes a
CUDA tensor to the plain version.

`LAUNCHES` counts, per kernel, the launches of the CUDA kernel (plain-version
calls do not count), so a run can show its main path went through them.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core import rht as R
from repro_torch.kernels import bf16_matmul as BM
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ms_eden_requant as MR
from repro_torch.kernels import nvfp4_quant as NQ
from repro_torch.kernels import paged_attention as PA

LAUNCHES = {"nvfp4_fos_quant": 0, "fp4_matmul": 0, "paged_gqa": 0,
            "ms_eden_phase1": 0, "ms_eden_phase2": 0, "paged_gqa_q": 0,
            "paged_mla": 0, "paged_mla_q": 0, "bf16_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device(name: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' when every operand lies there; raise otherwise."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"{name}: operands on several devices {kinds}")
    dev = kinds.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _need(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def nvfp4_fos_quant(x: torch.Tensor, absmax: torch.Tensor | None = None):
    """Four-over-Six NVFP4 quantization of x (M, K) f32/bf16.

    Returns (packed codes u8 (M, K/2), e4m3 scale bits u8 (M, K/16), gscale
    f32 0-dim), the operand form of `fp4_matmul`. On the card the kernel
    takes the tensor's absmax itself: a call launches nothing else, and at
    decode sizes exactly one kernel (`nvfp4_quant.plan`). `absmax` (f32,
    one element, on x's device) replaces x's own absmax: a slice of a
    weight split over devices passes the whole weight's, and the call is
    the two-pass encode kernel alone."""
    name = "nvfp4_fos_quant"
    _need(x.dim() == 2 and x.shape[1] % F.GROUP == 0 and x.shape[0] > 0,
          name, f"x must be (M>0, K % 16 == 0), got {tuple(x.shape)}")
    _need(x.dtype in (torch.float32, torch.bfloat16), name,
          f"x must be float32 or bfloat16, got {x.dtype}")
    if absmax is not None:
        _need(absmax.dtype == torch.float32 and absmax.numel() == 1, name,
              "absmax must be a one-element float32 tensor")
    if _device(name, x, *(() if absmax is None else (absmax,))) == "cpu":
        return NQ.nvfp4_fos_quant_plain(x, absmax)
    _need(x.is_contiguous(), name, "x must be contiguous")
    _need(x.data_ptr() % 16 == 0, name, "x must be 16-byte aligned")
    m, k = x.shape
    packed = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scale_bits = torch.empty((m, k // F.GROUP), dtype=torch.uint8,
                             device=x.device)
    gscale = torch.empty((), dtype=torch.float32, device=x.device)
    NQ.launch(x, packed, scale_bits, gscale,
              absmax=None if absmax is None else absmax.reshape(1).contiguous())
    LAUNCHES[name] += 1
    return packed, scale_bits, gscale


def fp4_matmul(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb,
               out_dtype=torch.float32):
    """NVFP4 GEMM: a (M, K/2) packed + (M, K/16) scale bits against b (N-major,
    likewise), per-tensor scales ga, gb (f32, one element each) -> (M, N) in
    out_dtype: f32, or bf16 rounded to nearest from the f32 result (bitwise
    the f32 result's `.to(torch.bfloat16)`). On the card M picks the kernel
    (`fp4_matmul.plan`); both count as one launch here."""
    name = "fp4_matmul"
    ops = (a_packed, a_scale_bits, b_packed, b_scale_bits)
    _need(all(t.dtype == torch.uint8 and t.dim() == 2 for t in ops), name,
          "packed codes and scale bits must be 2-D uint8")
    m, kp = a_packed.shape
    n = b_packed.shape[0]
    k = kp * 2
    _need(k % F.GROUP == 0 and b_packed.shape[1] == kp, name,
          f"inner dims differ or are not a multiple of 16: {k}, "
          f"{b_packed.shape[1] * 2}")
    _need(tuple(a_scale_bits.shape) == (m, k // F.GROUP)
          and tuple(b_scale_bits.shape) == (n, k // F.GROUP), name,
          "scale bits must be (rows, K/16)")
    _need(ga.dtype == torch.float32 and gb.dtype == torch.float32
          and ga.numel() == 1 and gb.numel() == 1, name,
          "ga, gb must be one-element float32 tensors")
    _need(out_dtype in (torch.float32, torch.bfloat16), name,
          f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if _device(name, *ops, ga, gb) == "cpu":
        return FM.fp4_matmul_plain(*ops, ga, gb, out_dtype)
    _need(all(t.is_contiguous() for t in ops), name,
          "operands must be contiguous")
    _need(m > 0 and n > 0 and k > 0, name, f"empty GEMM ({m}, {n}, {k})")
    out = torch.empty((m, n), dtype=out_dtype, device=a_packed.device)
    FM.launch(*ops, ga, gb, out)
    LAUNCHES[name] += 1
    return out


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) x b (N, K) -> (M, N) f32: both operands rounded to bf16 (f32
    or bf16 each), products summed in f32. On the card each output is one
    chain of tensor-core instructions fixed by K alone (`csrc/bf16_matmul.cu`),
    so a row's result does not depend on M nor a column's on N; the operands
    are read where they lie (unit inner stride, any row pitch), f32 weights
    with no bf16 copy. One launch a call."""
    name = "bf16_matmul"
    _need(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[1], name,
          f"a (M, K) and b (N, K) expected, got {tuple(a.shape)}, "
          f"{tuple(b.shape)}")
    _need(a.dtype in BM.DTYPES and b.dtype in BM.DTYPES, name,
          f"operands must be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if _device(name, a, b) == "cpu":
        return BM.bf16_matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[0]
    _need(m > 0 and n > 0 and k > 0, name, f"empty GEMM ({m}, {n}, {k})")
    _need(a.stride(1) == 1 and b.stride(1) == 1, name,
          "operands must have unit inner stride")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    BM.launch(a, b, out)
    LAUNCHES[name] += 1
    return out


def _check_paged(name, q, table, pos):
    """Checks common to the paged decode wrappers: table (B, MAXB) int32 and
    pos (B,) int32 for q (B, Sq, ...)."""
    b = q.shape[0]
    _need(table.dtype == torch.int32 and table.dim() == 2
          and table.shape[0] == b, name, "table must be (B, MAXB) int32")
    _need(pos.dtype == torch.int32 and tuple(pos.shape) == (b,), name,
          "pos must be (B,) int32")


def _check_packed(name, codes, scales):
    """A PackedKV leaf pair: uint8 codes (..., d/2) and scale bits (..., d/16)."""
    d = codes.shape[-1] * 2
    _need(codes.dtype == torch.uint8 and scales.dtype == torch.uint8, name,
          "packed pool leaves must be uint8")
    _need(tuple(scales.shape) == (*codes.shape[:-1], d // F.GROUP), name,
          f"packed leaves must be (..., {d}/2) codes and (..., {d}/16) scales")


def _check_gqa(name, q, k_lead, v_lead, hd, table, pos, window):
    """q (B, Sq, H, hd) against pools whose (P, BS, KV) lead dims are k_lead,
    v_lead, with key dim hd."""
    _need(q.dim() == 4 and len(k_lead) == 3, name,
          "q and the pools must be 4-D")
    qhd, h, kv = q.shape[3], q.shape[2], k_lead[2]
    _need(qhd == hd and tuple(v_lead) == tuple(k_lead), name,
          "pool shapes disagree with q")
    _need(kv > 0 and h % kv == 0, name, f"H={h} must be a multiple of KV={kv}")
    _need(q.dtype in (torch.float32, torch.bfloat16), name,
          f"q must be float32 or bfloat16, got {q.dtype}")
    _check_paged(name, q, table, pos)
    _need(window is None or window >= 1, name, "window must be None or >= 1")


def _check_gqa_card(name, q, k_lead, hd, vd, operands):
    sq = q.shape[1]
    _need(1 <= sq <= PA.MAX_SQ, name, f"Sq={sq} outside [1, {PA.MAX_SQ}]")
    _need(hd <= PA.MAX_HEAD_DIM and vd <= PA.MAX_HEAD_DIM, name,
          f"head dims above {PA.MAX_HEAD_DIM}")
    _need(hd % 8 == 0 and vd % 8 == 0, name,
          "head dims must be multiples of 8 (16-byte rows)")
    _need(k_lead[1] in PA.BLOCK_SIZES, name,
          f"block size {k_lead[1]} not in {PA.BLOCK_SIZES}")
    _need(all(t.is_contiguous() for t in operands), name,
          "operands must be contiguous")


def paged_gqa(q, k_pool, v_pool, table, pos, *, window: int | None = None):
    """Flash-decode GQA attention straight off the paged KV pool.

    q: (B, Sq, H, hd) f32/bf16; k_pool: (P, BS, KV, hd) bf16; v_pool:
    (P, BS, KV, vd) bf16; table: (B, MAXB) int32 block table (entries >= P
    are the OOB sentinel); pos: (B,) int32 absolute position of each row's
    first query token. Equals `decode_sdpa(q, gather_view(k_pool, table),
    gather_view(v_pool, table), pos, window)` in f32 without gathering.
    Returns f32 (B, Sq, H, vd)."""
    name = "paged_gqa"
    _need(k_pool.dim() == 4 and v_pool.dim() == 4, name, "pools must be 4-D")
    hd, vd = k_pool.shape[3], v_pool.shape[3]
    _check_gqa(name, q, k_pool.shape[:3], v_pool.shape[:3], hd, table, pos,
               window)
    _need(k_pool.dtype == torch.bfloat16 and v_pool.dtype == torch.bfloat16,
          name, "pools must be bfloat16")
    operands = (q, k_pool, v_pool, table, pos)
    if _device(name, *operands) == "cpu":
        return PA.paged_gqa_plain(q, k_pool, v_pool, table, pos, window=window)
    _check_gqa_card(name, q, k_pool.shape, hd, vd, operands)
    out = torch.empty((*q.shape[:3], vd), dtype=torch.float32, device=q.device)
    PA.launch(q, k_pool, v_pool, table, pos, out, window)
    LAUNCHES[name] += 1
    return out


def paged_gqa_q(q, k_codes, k_scales, v_codes, v_scales, table, pos, *,
                window: int | None = None):
    """`paged_gqa` over the NVFP4-quantized pool: K/V arrive as the
    PackedKV leaves, e2m1 code pairs (P, BS, KV, hd/2) uint8 and e4m3 scale
    bits (P, BS, KV, hd/16) uint8 per operand, and dequantize (exactly)
    inside the kernel. Equals `paged_gqa` over the dequantized pools.
    Returns f32 (B, Sq, H, vd) with vd = v_codes.shape[3] * 2."""
    name = "paged_gqa_q"
    _need(k_codes.dim() == 4 and v_codes.dim() == 4, name,
          "pool leaves must be 4-D")
    hd, vd = k_codes.shape[3] * 2, v_codes.shape[3] * 2
    _check_gqa(name, q, k_codes.shape[:3], v_codes.shape[:3], hd, table, pos,
               window)
    _check_packed(name, k_codes, k_scales)
    _check_packed(name, v_codes, v_scales)
    operands = (q, k_codes, k_scales, v_codes, v_scales, table, pos)
    if _device(name, *operands) == "cpu":
        return PA.paged_gqa_q_plain(q, k_codes, k_scales, v_codes, v_scales,
                                    table, pos, window=window)
    _check_gqa_card(name, q, k_codes.shape, hd, vd, operands)
    _need(hd % F.GROUP == 0 and vd % F.GROUP == 0, name,
          "head dims must be multiples of 16")
    out = torch.empty((*q.shape[:3], vd), dtype=torch.float32, device=q.device)
    PA.launch(q, k_codes, v_codes, table, pos, out, window, k_scales=k_scales,
              v_scales=v_scales)
    LAUNCHES[name] += 1
    return out


def _check_mla(name, q_abs, q_rope, lora, rope, cc_lead, kc_lead, table, pos):
    _need(q_abs.dim() == 4 and q_rope.dim() == 4, name,
          "q_abs and q_rope must be 4-D")
    _need(tuple(q_abs.shape[:3]) == tuple(q_rope.shape[:3])
          and q_abs.shape[3] == lora and q_rope.shape[3] == rope, name,
          "q_abs (B, Sq, H, lora) and q_rope (B, Sq, H, rope) disagree with "
          "the latent pools")
    _need(len(cc_lead) == 2 and tuple(cc_lead) == tuple(kc_lead), name,
          "latent pools must be (P, BS, dim) with the same (P, BS)")
    _need(q_abs.dtype == torch.float32, name, "q_abs must be float32")
    _need(q_rope.dtype in (torch.float32, torch.bfloat16), name,
          f"q_rope must be float32 or bfloat16, got {q_rope.dtype}")
    _check_paged(name, q_abs, table, pos)


def _check_mla_card(name, q_abs, lora, rope, bs, operands):
    sq = q_abs.shape[1]
    _need(1 <= sq <= PA.MAX_SQ, name, f"Sq={sq} outside [1, {PA.MAX_SQ}]")
    _need(lora <= PA.MAX_LORA and rope <= PA.MAX_ROPE, name,
          f"latent dims above ({PA.MAX_LORA}, {PA.MAX_ROPE})")
    _need(bs in PA.BLOCK_SIZES, name, f"block size {bs} not in {PA.BLOCK_SIZES}")
    _need(all(t.is_contiguous() for t in operands), name,
          "operands must be contiguous")


def paged_mla(q_abs, q_rope, cc_pool, kc_pool, table, pos, *, qk_dim: int):
    """Absorbed-form MLA flash-decode over the shared latent pools.

    q_abs: (B, Sq, H, lora) f32, q_nope already absorbed through W_uk;
    q_rope: (B, Sq, H, rope) f32/bf16; cc_pool: (P, BS, lora) bf16; kc_pool:
    (P, BS, rope) bf16; table, pos as for `paged_gqa`. Scores are
    (q_abs.cc + q_rope.kc) MULTIPLIED by the f32 1/sqrt(qk_dim); the value
    readout is over cc itself, so the f32 result is o_lat (B, Sq, H, lora)
    for the caller's W_uv absorption. Inactive rows (all-sentinel tables)
    give exact zeros. On the card a tensor-core split-KV kernel
    (`paged_attention.plan_mla` with wave = MLA_TC_WAVE) and, with several
    splits, the merge kernel, both counted as one launch here."""
    name = "paged_mla"
    _need(cc_pool.dim() == 3 and kc_pool.dim() == 3, name,
          "latent pools must be 3-D")
    lora, rope = cc_pool.shape[2], kc_pool.shape[2]
    _check_mla(name, q_abs, q_rope, lora, rope, cc_pool.shape[:2],
               kc_pool.shape[:2], table, pos)
    _need(cc_pool.dtype == torch.bfloat16 and kc_pool.dtype == torch.bfloat16,
          name, "latent pools must be bfloat16")
    operands = (q_abs, q_rope, cc_pool, kc_pool, table, pos)
    if _device(name, *operands) == "cpu":
        return PA.paged_mla_plain(q_abs, q_rope, cc_pool, kc_pool, table, pos,
                                  qk_dim)
    _check_mla_card(name, q_abs, lora, rope, cc_pool.shape[1], operands)
    _need(lora % 16 == 0 and rope % 16 == 0, name,
          "latent dims must be multiples of 16 (the tensor cores' k16)")
    out = torch.empty(q_abs.shape, dtype=torch.float32, device=q_abs.device)
    PA.launch_mla(q_abs, q_rope, cc_pool, kc_pool, table, pos, out, qk_dim)
    LAUNCHES[name] += 1
    return out


def paged_mla_q(q_abs, q_rope, cc_codes, cc_scales, kc_codes, kc_scales,
                table, pos, *, qk_dim: int):
    """`paged_mla` over NVFP4-quantized latent pools: the PackedKV leaves of
    cc ((P, BS, lora/2) codes, (P, BS, lora/16) scale bits) and of kc
    ((P, BS, rope/2), (P, BS, rope/16)), uint8, dequantized (exactly) inside
    the kernel, once per 16-group; on the card a split-KV kernel
    (`paged_attention.plan_mla`) and, with several splits, a merge kernel,
    both counted as one launch here. Returns o_lat f32 (B, Sq, H, lora)."""
    name = "paged_mla_q"
    _need(cc_codes.dim() == 3 and kc_codes.dim() == 3, name,
          "latent pool leaves must be 3-D")
    lora, rope = cc_codes.shape[2] * 2, kc_codes.shape[2] * 2
    _check_mla(name, q_abs, q_rope, lora, rope, cc_codes.shape[:2],
               kc_codes.shape[:2], table, pos)
    _check_packed(name, cc_codes, cc_scales)
    _check_packed(name, kc_codes, kc_scales)
    operands = (q_abs, q_rope, cc_codes, cc_scales, kc_codes, kc_scales,
                table, pos)
    if _device(name, *operands) == "cpu":
        return PA.paged_mla_q_plain(q_abs, q_rope, cc_codes, cc_scales,
                                    kc_codes, kc_scales, table, pos, qk_dim)
    _check_mla_card(name, q_abs, lora, rope, cc_codes.shape[1], operands)
    _need(lora % F.GROUP == 0 and rope % F.GROUP == 0, name,
          "latent dims must be multiples of 16")
    out = torch.empty(q_abs.shape, dtype=torch.float32, device=q_abs.device)
    PA.launch_mla_q(q_abs, q_rope, cc_codes, cc_scales, kc_codes, kc_scales,
                    table, pos, out, qk_dim)
    LAUNCHES[name] += 1
    return out


def ms_eden_phase1(x: torch.Tensor, signs: torch.Tensor):
    """MS-EDEN phase 1 of x (M, K) f32 with RHT signs (b,), b = block_size(K):
    (packed codes u8 (M, K/2), E8M3 pseudo-scales, EDEN num and den f32
    (M, K/16), absmax of the rotated x f32 (1,)), all in rotated space.
    x may be a view: on the card row-major rows at any pitch, or the
    transpose of a row-major tensor (`ms_eden_requant.layout`), read where
    it lies; on the CPU any strides."""
    name = "ms_eden_phase1"
    _need(x.dim() == 2 and x.shape[0] > 0 and x.shape[1] % F.GROUP == 0,
          name, f"x must be (M>0, K % 16 == 0), got {tuple(x.shape)}")
    _need(x.dtype == torch.float32 and signs.dtype == torch.float32, name,
          "x and signs must be float32")
    m, k = x.shape
    _need(tuple(signs.shape) == (R.block_size(k),), name,
          f"signs must be ({R.block_size(k)},) for K={k}")
    if _device(name, x, signs) == "cpu":
        return MR.phase1_plain(x, signs)
    _need(MR.layout(x) is not None, name,
          "x must be row-major or the transpose of a row-major tensor, got "
          f"strides {x.stride()}")
    _need(signs.is_contiguous() and signs.data_ptr() % 16 == 0, name,
          "signs must be contiguous and 16-byte aligned")
    dev = x.device
    packed = torch.empty((m, k // 2), dtype=torch.uint8, device=dev)
    pseudo, num, den = (torch.empty((m, k // F.GROUP), dtype=torch.float32,
                                    device=dev) for _ in range(3))
    absmax = torch.empty((1,), dtype=torch.float32, device=dev)
    MR.launch_phase1(x, signs, packed, pseudo, num, den, absmax)
    LAUNCHES[name] += 1
    return packed, pseudo, num, den, absmax


def _phase2_operand(name, absmax, pseudo, num, den, u):
    """Checks of one phase-2 operand; its tensors (for the device check)."""
    groups = (pseudo, num, den)
    _need(all(t.dtype == torch.float32 for t in (absmax, *groups)), name,
          "operands must be float32")
    _need(all(t.shape == pseudo.shape for t in groups) and pseudo.numel() > 0,
          name, "pseudo, num and den must share one non-empty shape")
    _need(absmax.numel() == 1, name, "absmax must hold one element")
    if isinstance(u, torch.Tensor):
        _need(u.dtype == torch.float32 and u.shape == pseudo.shape, name,
              f"uniforms must be float32 {tuple(pseudo.shape)}")
        return (absmax, *groups, u)
    _need(len(u) == 2 and all(isinstance(k, int) and 0 <= k < 2**32 for k in u),
          name, "u must be a uniforms tensor or a key pair of two uint32 ints")
    _need(pseudo.numel() < 2**32, name,
          f"{pseudo.numel()} groups exceed the 32-bit counter of hashed draws")
    return (absmax, *groups)


def ms_eden_phase2_batch(operands):
    """`ms_eden_phase2` of one or two operands [(absmax, pseudo, num, den,
    u)], each with its own absmax, gscale and uniforms or key pair; on the
    card one launch over all of them. Returns [(scale bits, gscale)]."""
    _need(1 <= len(operands) <= 2, "ms_eden_phase2", "one or two operands")
    name = "ms_eden_phase2"
    tensors = [t for op in operands for t in _phase2_operand(name, *op)]
    if _device(name, *tensors) == "cpu":
        return [MR.phase2_plain(*op) for op in operands]
    _need(all(t.is_contiguous() for t in tensors), name,
          "operands must be contiguous")
    outs = [(torch.empty(op[1].shape, dtype=torch.uint8, device=op[1].device),
             torch.empty((), dtype=torch.float32, device=op[1].device))
            for op in operands]
    MR.launch_phase2(operands, outs)
    LAUNCHES[name] += 1
    return outs


def ms_eden_phase2(absmax, pseudo, num, den, u):
    """MS-EDEN phase 2: align the pseudo-scales to the global absmax,
    EDEN-correct and round stochastically to e4m3 (pseudo, num, den (M,
    K/16) f32; absmax f32 (1,)). u: the SR uniforms, a (M, K/16) f32 tensor,
    or the key pair (k, k2) of a `core.rng.HashDraws` tag, whose uniforms
    the kernel hashes per group (bitwise `HashDraws.uniform`). Returns (e4m3
    scale bits u8 (M, K/16), gscale f32 0-dim)."""
    return ms_eden_phase2_batch([(absmax, pseudo, num, den, u)])[0]


def ms_eden_requant(x: torch.Tensor, signs: torch.Tensor, uniforms):
    """Two-phase MS-EDEN re-quantization of x (M, K) f32 with RHT signs (b,)
    and SR uniforms (M, K/16) or their key pair (as for `ms_eden_phase2`):
    (packed codes u8 (M, K/2), e4m3 scale bits u8 (M, K/16), gscale f32
    0-dim) in rotated space — the operand form of `fp4_matmul`. The gscale
    stays on the device (no host sync). x may be a view, as for
    `ms_eden_phase1`."""
    packed, pseudo, num, den, absmax = ms_eden_phase1(x, signs)
    scale_bits, gscale = ms_eden_phase2(absmax, pseudo, num, den, uniforms)
    return packed, scale_bits, gscale


def quartet2_backward_gemm(a, b, signs, u_a, u_b):
    """a @ b^T (a (Ma, D), b (Mb, D) f32) with MS-EDEN re-quantization of both
    operands — shared RHT signs, so the rotations cancel in the product — and
    the NVFP4 GEMM: the kernel-level composition of paper Fig. 3's backward
    box (`repro/kernels/ops.py:quartet2_backward_gemm`). f32 (Ma, Mb). a and
    b may be views, as for `ms_eden_phase1` (the backward passes E^T, W^T
    and X^T as transposed views). u_a, u_b: each operand's SR uniforms, a
    tensor or a key pair (as for `ms_eden_phase2`). On the card phase 1 runs
    once per operand and phase 2 once for both."""
    pa = ms_eden_phase1(a, signs)
    pb = ms_eden_phase1(b, signs)
    (sa, ga), (sb, gb) = ms_eden_phase2_batch([(pa[4], *pa[1:4], u_a),
                                              (pb[4], *pb[1:4], u_b)])
    return fp4_matmul(pa[0], sa, pb[0], sb, ga, gb)
