"""bf16 GEMM with f32 accumulation in an order fixed by K: plain version,
geometry and launch.

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

The order: K in chunks of 32 values, 8 chains, chain j the chunks j, j + 8,
... in increasing order, the chains added in chain order. `plan(m, n, k)`
picks the kernel's geometry, which never changes that order: the
activation width a block (the wgmma N side, 8 .. 128 rows; the kernel
issues m64n128k16 at 128 and m64n8k16 below), the warpgroups a block (64
weight rows each), whether the 8 chains of a weight tile run in one block
or over the 8 blocks of a cluster, and the grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 32          # K values of one chunk (two k16 steps)
CHAINS = 8          # chain j: chunks j, j + 8, ...
WG_ROWS = 64        # weight rows of one warpgroup (wgmma's M)
WIDTHS = (8, 16, 32, 64, 128)   # activation rows a block (wgmma's N side)
SMS = 132           # the H100's streaming multiprocessors


@dataclass(frozen=True)
class Plan:
    width: int      # activation rows a block
    groups: int     # warpgroups a block: 64 weight rows each
    splits: int     # 1: a block runs the 8 chains; 8: a cluster, one chain a block
    grid: tuple     # (activation tiles, weight tiles x splits); clusters along y

    @property
    def rows(self) -> int:
        """Weight rows (output columns) of one block."""
        return WG_ROWS * self.groups


def plan(m: int, n: int, k: int) -> Plan:
    """The kernel's geometry for C (m, n) = A (m, k) B (n, k)^T.

    The activation width is the least of WIDTHS holding m (128 beyond, in
    grid rows); two warpgroups at 128, so a block's 128 x 128 tile reads
    each operand value from L2 once per 128 rows of the other, and there one
    m64n128k16 instruction a k16 step (bitwise the 16 m64n8k16 it stands
    for: the card tests hold a 128-row call against its 64-row halves,
    which take m64n8k16). Where the
    weight tiles x activation tiles cannot give every SM a block (a decode
    step's 1,280-wide weights: 20 tiles), the 8 chains of a tile go to the
    8 blocks of a cluster."""
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"bf16_matmul: empty GEMM ({m}, {n}, {k})")
    width = next((w for w in WIDTHS if w >= m), WIDTHS[-1])
    groups = 2 if width == WIDTHS[-1] else 1
    tiles = -(-n // (WG_ROWS * groups))
    rows = -(-m // width)
    splits = CHAINS if tiles * rows < SMS else 1
    return Plan(width, groups, splits, (rows, tiles * splits))


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
    p = plan(m, n, k)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = build.library().bf16_matmul_launch(
        a.data_ptr(), a.stride(0), int(a.dtype == torch.bfloat16),
        b.data_ptr(), b.stride(0), int(b.dtype == torch.bfloat16),
        out.data_ptr(), m, n, k, p.width, p.groups, p.splits, *p.grid,
        stream)
    build.check(status, "bf16_matmul")
