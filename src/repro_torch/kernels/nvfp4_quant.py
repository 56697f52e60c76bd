"""Four-over-Six NVFP4 quantization: plain version and kernel launch.

Replaces the TPU kernel `repro/kernels/nvfp4_quant.py:nvfp4_fos_quant`. The
output is the serving form: codes packed two per byte (M, K/2) uint8, e4m3
scales as raw bits (M, K/16) uint8, and the f32 per-tensor gscale.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.kernels import build

# f32 images of the constants quant_four_over_six divides by, so the kernel
# and the plain version round against identical scalars
S6 = float(np.float32(Q.S_EDEN))
S4 = float(np.float32(Q.S_EDEN * 4.0 / 6.0))
GDIV = float(np.float32((Q.S_EDEN * 4.0 / 6.0) * F.FP8_MAX))


def nvfp4_fos_quant_plain(x: torch.Tensor):
    """x (M, K) -> (packed u8 (M, K/2), scale bits u8 (M, K/16), gscale f32)."""
    qt = Q.quant_four_over_six(x)
    return F.pack_fp4(qt.codes), F.e4m3_to_bits(qt.scales), qt.gscale


def launch(x, absmax, packed, scale_bits, gscale) -> None:
    """Enqueue the CUDA kernel on the current stream (outputs preallocated)."""
    m, k = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.library().nvfp4_fos_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), absmax.data_ptr(),
        packed.data_ptr(), scale_bits.data_ptr(), gscale.data_ptr(), m, k,
        GDIV, S6, S4, stream)
    build.check(status, "nvfp4_fos_quant")
