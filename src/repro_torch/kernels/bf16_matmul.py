"""bf16 GEMM with f32 accumulation in an order fixed by K: plain version
and launch.

Replaces no TPU kernel. The reference's bf16 scheme multiplies bf16 values
with f32 accumulation through XLA (`repro/core/linear.py:_mm`, the LM head's
`dense`); the port's plain version is that arithmetic, an f32 matmul of
bf16-exact values. On the card cuBLAS picks the algorithm of that matmul,
hence each output's summation order, from (M, N, K), so a serving step's
rows depended on how many rows ran beside them (a data shard's rows against
the whole batch's) and a column on which slice of N a call computed (a
model shard's half of the weight). `tools/shard_step_diff.py` found it at a
16-token prefill chunk of 4 slots: 64 rows against a data shard's 32.
`csrc/bf16_matmul.cu` sums each output in one chain of tensor-core
instructions fixed by K alone, at any M and N: `core.linear._mm` and
`dense` take it on the card for every call outside an autograd graph
(every serving step), and keep the plain matmul for training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


def bf16_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) x b (N, K) -> (M, N) f32: both rounded to bf16, products
    summed in f32 (the port's `_mm` arithmetic)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream: a (M, K), b (N, K) row-major
    (unit inner stride, any row pitch), f32 or bf16 each; out (M, N) f32
    contiguous, preallocated."""
    m, k = a.shape
    n = b.shape[0]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = build.library().bf16_matmul_launch(
        a.data_ptr(), a.stride(0), int(a.dtype == torch.bfloat16),
        b.data_ptr(), b.stride(0), int(b.dtype == torch.bfloat16),
        out.data_ptr(), m, n, k, stream)
    build.check(status, "bf16_matmul")
