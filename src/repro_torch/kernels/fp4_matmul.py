"""NVFP4 GEMM from packed codes + e4m3 scale bits: plain version and launch.

Replaces the TPU kernel `repro/kernels/fp4_matmul.py:fp4_matmul`, whose
oracle is the simulated NVFP4 GEMM `repro/core/linear.py:_qmm`:
C = (dec(Ac) * As) @ (dec(Bc) * Bs)^T * (ga * gb), fp32 accumulation.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import build


def block_values(packed: torch.Tensor, scale_bits: torch.Tensor) -> torch.Tensor:
    """e2m1 x e4m3 block values as f32 (exact; bf16-representable)."""
    vals = F.fp4_decode(F.unpack_fp4(packed))
    scales = F.bits_to_e4m3(scale_bits)
    return vals * torch.repeat_interleave(scales, F.GROUP, dim=-1)


def fp4_matmul_plain(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb):
    """(M, K/2) x (N, K/2) packed operands -> f32 (M, N)."""
    a = block_values(a_packed, a_scale_bits)
    b = block_values(b_packed, b_scale_bits)
    return (a @ b.T) * (ga * gb)


def launch(a_packed, a_scale_bits, b_packed, b_scale_bits, ga, gb, out) -> None:
    """Enqueue the CUDA kernel on the current stream (output preallocated)."""
    m, n = out.shape
    k = a_packed.shape[1] * 2
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = build.library().fp4_matmul_launch(
        a_packed.data_ptr(), a_scale_bits.data_ptr(), b_packed.data_ptr(),
        b_scale_bits.data_ptr(), ga.data_ptr(), gb.data_ptr(), out.data_ptr(),
        m, n, k, stream)
    build.check(status, "fp4_matmul")
