"""NVFP4 GEMM from packed codes + e4m3 scale bits: plain version, launch
geometry and launch.

Replaces the TPU kernel `repro/kernels/fp4_matmul.py:fp4_matmul`, whose
oracle is the simulated NVFP4 GEMM `repro/core/linear.py:_qmm`:
C = (dec(Ac) * As) @ (dec(Bc) * Bs)^T * (ga * gb), fp32 accumulation; C is
f32, or bf16 rounded to nearest from the f32 result.

On the card two kernels of `csrc/fp4_matmul.cu` compute it, picked by M
alone (`plan`): at M <= GEMV_MAX_M a weight-streaming kernel on mma.sync
with the operands swapped and K split across blocks (partials summed in a
fixed order by a second kernel), above it a wgmma kernel on 128 x 128
output tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import build

GEMV_MAX_M = 16        # M at or below this takes the weight-streaming kernel
GEMV_ROWS = 64         # weight rows (output columns) of one block: 4 warps x 16
GEMV_CHUNK = 128       # K values of one chunk: 8 mma k16 steps
GEMV_MAX_CHUNKS = 4    # chunks of one split (the activation slice it stages)
MMA_TILE = (128, 128, 64)  # (M, N, K) of one wgmma block's tile and K step

# launches of each kernel design (ops.LAUNCHES counts both as "fp4_matmul")
REGIME_LAUNCHES = {"gemv": 0, "mma": 0}


class Plan(NamedTuple):
    """Launch geometry of one call: the kernel ("gemv" or "mma"), its grid
    (x over N, y over K splits for gemv or over M for mma), the K splits
    and the K chunks of one split (gemv; 1 and 0 for mma)."""
    regime: str
    grid: tuple[int, int]
    splits: int
    chunks_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int) -> Plan:
    """The geometry of an (M, N, K) call: the regime from M alone; for M <=
    GEMV_MAX_M as few K splits as keep each at GEMV_MAX_CHUNKS chunks or
    fewer, balanced (the last split may be shorter)."""
    if m <= GEMV_MAX_M:
        chunks = _cdiv(k, GEMV_CHUNK)
        per = _cdiv(chunks, _cdiv(chunks, GEMV_MAX_CHUNKS))
        splits = _cdiv(chunks, per)
        return Plan("gemv", (_cdiv(n, GEMV_ROWS), splits), splits, per)
    bm, bn, _ = MMA_TILE
    return Plan("mma", (_cdiv(n, bn), _cdiv(m, bm)), 1, 0)


def block_values(packed: torch.Tensor, scale_bits: torch.Tensor) -> torch.Tensor:
    """e2m1 x e4m3 block values as f32 (exact; bf16-representable)."""
    vals = F.fp4_decode(F.unpack_fp4(packed))
    scales = F.bits_to_e4m3(scale_bits)
    return vals * torch.repeat_interleave(scales, F.GROUP, dim=-1)


def fp4_matmul_plain(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb,
                     out_dtype=torch.float32):
    """(M, K/2) x (N, K/2) packed operands -> (M, N) f32, or bf16 rounded
    from the f32 result."""
    a = block_values(a_packed, a_scale_bits)
    b = block_values(b_packed, b_scale_bits)
    return ((a @ b.T) * (ga * gb)).to(out_dtype)


def launch(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb, out) -> None:
    """Enqueue the kernel `plan` picks on the current stream (output
    preallocated, f32 or bf16; split-K scratch allocated here)."""
    m, n = out.shape
    k = a_packed.shape[1] * 2
    p = plan(m, n, k)
    partial = (torch.empty((p.splits, m, n), dtype=torch.float32, device=out.device)
               if p.splits > 1 else None)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = build.library().fp4_matmul_launch(
        a_packed.data_ptr(), a_scale_bits.data_ptr(), b_packed.data_ptr(),
        b_scale_bits.data_ptr(), ga.data_ptr(), gb.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, n, k,
        int(out.dtype == torch.bfloat16), 0 if p.regime == "gemv" else 1,
        p.grid[0], p.grid[1], p.chunks_per_split, stream)
    build.check(status, f"fp4_matmul ({p.regime})")
    REGIME_LAUNCHES[p.regime] += 1
