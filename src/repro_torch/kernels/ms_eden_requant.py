"""MS-EDEN re-quantization, phases 1 and 2: plain versions and kernel launches.

Replaces the TPU kernels of `repro/kernels/ms_eden_requant.py:ms_eden_requant`
(phase 1, `pallas_call` at :110; phase 2 at :141), whose oracle is the eager
`ms_eden_phase1` / `ms_eden_phase2` of `repro/core/ms_eden.py`. The outputs
are the operand form of `fp4_matmul`: codes packed two per byte (M, K/2),
e4m3 scales as raw bits (M, K/16), and the f32 per-tensor gscale.

Phase 2 takes its SR uniforms as a (M, K/16) f32 tensor, or as the key pair
(k, k2) of a `core.rng.HashDraws` tag: the kernel then hashes each group's
flat index itself and no uniform tensor is made; the plain version draws
the same uniforms with `rng.uniform_from_keys`. One phase-2 launch takes one
or two operands (both of a backward GEMM).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import ms_eden as ME
from repro_torch.core import quant as Q
from repro_torch.core import rht as R
from repro_torch.core import rng
from repro_torch.kernels import build

# f32 images of the constants the phases divide by, so the kernels and the
# plain versions round against identical scalars
S = float(np.float32(Q.S_EDEN))
GDIV = float(np.float32(Q.S_EDEN * 256.0))


def phase1_plain(x: torch.Tensor, signs: torch.Tensor):
    """x (M, K) f32, signs (b,) -> (packed codes u8 (M, K/2), pseudo, num,
    den f32 (M, K/16), absmax f32 (1,))."""
    p1 = ME.ms_eden_phase1(x, signs)
    return (F.pack_fp4(p1.codes), p1.pseudo_scales, p1.eden_num, p1.eden_den,
            p1.absmax.reshape(1))


def uniforms(u, shape, device) -> torch.Tensor:
    """Phase 2's SR uniforms: u itself when it is a tensor, else the
    uniforms its key pair hashes to."""
    if isinstance(u, torch.Tensor):
        return u
    return rng.uniform_from_keys(u, shape, device)


def phase2_plain(absmax, pseudo, num, den, u):
    """u: (M, K/16) f32 uniforms or a key pair (k, k2) -> (e4m3 scale bits
    u8 (M, K/16), gscale f32 0-dim)."""
    u = uniforms(u, pseudo.shape, pseudo.device)
    scales, gscale = ME.phase2_scales(absmax.reshape(()), pseudo, num, den, u)
    return F.e4m3_to_bits(scales), gscale


def layout(x: torch.Tensor):
    """How phase 1's kernel reads a 2-D x: ("rows", ld) when x[i, j] lies at
    i * ld + j, ("cols", ld) when at j * ld + i (the transpose of a row-major
    tensor, as the backward's E^T, W^T and X^T are), None otherwise."""
    m, k = x.shape
    s0, s1 = x.stride()
    if s1 == 1 and (m == 1 or s0 >= k):
        return "rows", s0 if m > 1 else k
    if s0 == 1 and s1 >= m:
        return "cols", s1
    return None


def launch_phase1(x, signs, packed, pseudo, num, den, absmax) -> None:
    """Enqueue phase 1 on the current stream (outputs preallocated; the
    launch zeroes `absmax` (1,) f32 by a memset before the kernel). x is read
    where it lies (`layout`), in 16-byte chunks when its pointer and row
    pitch allow, else in 4-byte ones."""
    m, k = x.shape
    b = signs.numel()
    kind, ld = layout(x)
    vec = 16 if x.data_ptr() % 16 == 0 and ld % 4 == 0 else 4
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.library().ms_eden_phase1_launch(
        x.data_ptr(), ld, int(kind == "cols"), vec, signs.data_ptr(),
        packed.data_ptr(), pseudo.data_ptr(), num.data_ptr(), den.data_ptr(),
        absmax.data_ptr(), m, k, b, S, R.inv_sqrt(b), stream)
    build.check(status, "ms_eden_phase1")


def launch_phase2(operands, outputs) -> None:
    """Enqueue one phase-2 launch over one or two operands on the current
    stream. operands: [(absmax, pseudo, num, den, u)], u a uniforms tensor
    or a key pair; outputs: [(scale_bits, gscale)], preallocated."""
    args = []
    for (absmax, pseudo, num, den, u), (bits, gscale) in zip(operands, outputs):
        keyed = not isinstance(u, torch.Tensor)
        k, k2 = u if keyed else (0, 0)
        args += [absmax.data_ptr(), pseudo.data_ptr(), num.data_ptr(),
                 den.data_ptr(), None if keyed else u.data_ptr(),
                 bits.data_ptr(), gscale.data_ptr(), pseudo.numel(), k, k2]
    if len(operands) == 1:
        args += [None] * 7 + [0, 0, 0]
    stream = torch.cuda.current_stream(operands[0][1].device).cuda_stream
    status = build.library().ms_eden_phase2_launch(*args, GDIV, stream)
    build.check(status, "ms_eden_phase2")
