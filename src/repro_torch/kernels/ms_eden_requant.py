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


def launch_phase1(x, signs, packed, pseudo, num, den, absmax) -> None:
    """Enqueue phase 1 on the current stream; `absmax` (1,) f32 must hold 0."""
    m, k = x.shape
    b = signs.numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.library().ms_eden_phase1_launch(
        x.data_ptr(), signs.data_ptr(), packed.data_ptr(), pseudo.data_ptr(),
        num.data_ptr(), den.data_ptr(), absmax.data_ptr(), m, k, b, S,
        R.inv_sqrt(b), stream)
    build.check(status, "ms_eden_phase1")


def launch_phase2(absmax, pseudo, num, den, u, scale_bits, gscale) -> None:
    """Enqueue phase 2 on the current stream (outputs preallocated)."""
    stream = torch.cuda.current_stream(u.device).cuda_stream
    status = build.library().ms_eden_phase2_launch(
        absmax.data_ptr(), pseudo.data_ptr(), num.data_ptr(), den.data_ptr(),
        u.data_ptr(), scale_bits.data_ptr(), gscale.data_ptr(), u.numel(),
        GDIV, stream)
    build.check(status, "ms_eden_phase2")
