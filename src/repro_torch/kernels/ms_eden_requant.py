"""MS-EDEN re-quantization, phases 1 and 2: plain versions and kernel launches.

Replaces the TPU kernels of `repro/kernels/ms_eden_requant.py:ms_eden_requant`
(phase 1, `pallas_call` at :110; phase 2 at :141), whose oracle is the eager
`ms_eden_phase1` / `ms_eden_phase2` of `repro/core/ms_eden.py`. The outputs
are the operand form of `fp4_matmul`: codes packed two per byte (M, K/2),
e4m3 scales as raw bits (M, K/16), and the f32 per-tensor gscale.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import ms_eden as ME
from repro_torch.core import quant as Q
from repro_torch.core import rht as R
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


def phase2_plain(absmax, pseudo, num, den, u):
    """-> (e4m3 scale bits u8 (M, K/16), gscale f32 0-dim)."""
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


def launch_phase2(absmax, pseudo, num, den, u, scale_bits, gscale) -> None:
    """Enqueue phase 2 on the current stream (outputs preallocated)."""
    stream = torch.cuda.current_stream(u.device).cuda_stream
    status = build.library().ms_eden_phase2_launch(
        absmax.data_ptr(), pseudo.data_ptr(), num.data_ptr(), den.data_ptr(),
        u.data_ptr(), scale_bits.data_ptr(), gscale.data_ptr(), u.numel(),
        GDIV, stream)
    build.check(status, "ms_eden_phase2")
