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
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import nvfp4_quant as NQ
from repro_torch.kernels import paged_attention as PA

LAUNCHES = {"nvfp4_fos_quant": 0, "fp4_matmul": 0, "paged_gqa": 0}


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


def nvfp4_fos_quant(x: torch.Tensor):
    """Four-over-Six NVFP4 quantization of x (M, K) f32/bf16.

    Returns (packed codes u8 (M, K/2), e4m3 scale bits u8 (M, K/16), gscale
    f32 0-dim), the operand form of `fp4_matmul`."""
    name = "nvfp4_fos_quant"
    _need(x.dim() == 2 and x.shape[1] % F.GROUP == 0 and x.shape[0] > 0,
          name, f"x must be (M>0, K % 16 == 0), got {tuple(x.shape)}")
    _need(x.dtype in (torch.float32, torch.bfloat16), name,
          f"x must be float32 or bfloat16, got {x.dtype}")
    if _device(name, x) == "cpu":
        return NQ.nvfp4_fos_quant_plain(x)
    _need(x.is_contiguous(), name, "x must be contiguous")
    m, k = x.shape
    packed = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scale_bits = torch.empty((m, k // F.GROUP), dtype=torch.uint8,
                             device=x.device)
    gscale = torch.empty((), dtype=torch.float32, device=x.device)
    absmax = x.abs().amax().float()
    NQ.launch(x, absmax, packed, scale_bits, gscale)
    LAUNCHES[name] += 1
    return packed, scale_bits, gscale


def fp4_matmul(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb):
    """NVFP4 GEMM: a (M, K/2) packed + (M, K/16) scale bits against b (N-major,
    likewise), per-tensor scales ga, gb (f32, one element each) -> f32 (M, N)."""
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
    if _device(name, *ops, ga, gb) == "cpu":
        return FM.fp4_matmul_plain(*ops, ga, gb)
    _need(all(t.is_contiguous() for t in ops), name,
          "operands must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=a_packed.device)
    FM.launch(*ops, ga, gb, out)
    LAUNCHES[name] += 1
    return out


def paged_gqa(q, k_pool, v_pool, table, pos, *, window: int | None = None):
    """Flash-decode GQA attention straight off the paged KV pool.

    q: (B, Sq, H, hd) f32/bf16; k_pool: (P, BS, KV, hd) bf16; v_pool:
    (P, BS, KV, vd) bf16; table: (B, MAXB) int32 block table (entries >= P
    are the OOB sentinel); pos: (B,) int32 absolute position of each row's
    first query token. Equals `decode_sdpa(q, gather_view(k_pool, table),
    gather_view(v_pool, table), pos, window)` in f32 without gathering.
    Returns f32 (B, Sq, H, vd)."""
    name = "paged_gqa"
    _need(q.dim() == 4 and k_pool.dim() == 4 and v_pool.dim() == 4, name,
          "q and the pools must be 4-D")
    b, sq, h, hd = q.shape
    _, bs, kv, khd = k_pool.shape
    _need(khd == hd and tuple(v_pool.shape[:3]) == tuple(k_pool.shape[:3]),
          name, "pool shapes disagree with q")
    _need(kv > 0 and h % kv == 0, name, f"H={h} must be a multiple of KV={kv}")
    _need(q.dtype in (torch.float32, torch.bfloat16), name,
          f"q must be float32 or bfloat16, got {q.dtype}")
    _need(k_pool.dtype == torch.bfloat16 and v_pool.dtype == torch.bfloat16,
          name, "pools must be bfloat16")
    _need(table.dtype == torch.int32 and table.dim() == 2
          and table.shape[0] == b, name, "table must be (B, MAXB) int32")
    _need(pos.dtype == torch.int32 and tuple(pos.shape) == (b,), name,
          "pos must be (B,) int32")
    _need(window is None or window >= 1, name, "window must be None or >= 1")
    if _device(name, q, k_pool, v_pool, table, pos) == "cpu":
        return PA.paged_gqa_plain(q, k_pool, v_pool, table, pos, window=window)
    _need(1 <= sq <= PA.MAX_SQ, name, f"Sq={sq} outside [1, {PA.MAX_SQ}]")
    _need(hd <= PA.MAX_HEAD_DIM and v_pool.shape[3] <= PA.MAX_HEAD_DIM, name,
          f"head dims above {PA.MAX_HEAD_DIM}")
    _need(bs in PA.BLOCK_SIZES, name, f"block size {bs} not in {PA.BLOCK_SIZES}")
    _need(all(t.is_contiguous() for t in (q, k_pool, v_pool, table, pos)),
          name, "operands must be contiguous")
    out = torch.empty((b, sq, h, v_pool.shape[3]), dtype=torch.float32,
                      device=q.device)
    PA.launch(q, k_pool, v_pool, table, pos, out, window)
    LAUNCHES[name] += 1
    return out
