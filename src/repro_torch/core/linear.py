"""The quantized linear layer, inference only (serving slice).

Counterpart of `repro/core/linear.py`. Simulated-NVFP4 GEMM semantics: the
GEMM consumes "block values" (fp4_code * e4m3_scale, exactly representable
in bf16 because 2 + 4 significant bits < 8), accumulates in fp32, and the two
per-tensor FP32 scales multiply the GEMM output.

On a CUDA device the 4/6 quantizer and the NVFP4 GEMM run as the port's
hand-written kernels (`kernels/ops.py`); on the CPU as their plain versions.

Left out of this slice, and so absent here: the GSPMD sharding hints of the
reference (`_hint` and friends, a no-op off-mesh) and the custom VJP with its
MS-EDEN backward GEMMs — the backward comes with the training slice. The
square-block weight quantizer comes with the schemes that use it.

fp32 matmuls here are IEEE fp32, as XLA's are on the CPU: the package turns
TF32 off when it is imported (`repro_torch/__init__.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.core import schemes as S
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ops


class PackedQWeight(NamedTuple):
    """An offline-packed NVFP4 weight: 4.5 bits/element at rest.

    `packed` holds E2M1 codes (2/byte, low nibble = even index),
    `scale_bits` the e4m3 group scales as raw bits — both produced by the
    same quantizer the per-step path runs — so the GEMM sees exactly the
    per-step operands. Stacked-layer stacks index per layer with `layer(l)`.
    """

    packed: torch.Tensor      # uint8 (..., N, K // 2)
    scale_bits: torch.Tensor  # uint8 (..., N, K // 16): raw e4m3 bits
    gscale: torch.Tensor      # float32 (...,) per-tensor scale

    @property
    def out_features(self) -> int:
        return self.packed.shape[-2]

    def layer(self, i: int) -> "PackedQWeight":
        """Layer i of a stacked (L, N, K/2) weight (views, no copy)."""
        return PackedQWeight(self.packed[i], self.scale_bits[i], self.gscale[i])


def _quant_packed(x: torch.Tensor, kind: str):
    """Forward quantizer `kind` of a 2-D tensor, in the packed operand form
    (codes, scale bits, gscale) that `fp4_matmul` consumes."""
    if kind == "fos":
        return ops.nvfp4_fos_quant(x.contiguous())
    if kind == "rtn":
        qt = Q.quant_rtn(x, s=Q.S_EDEN)
        return F.pack_fp4(qt.codes), F.e4m3_to_bits(qt.scales), qt.gscale
    raise NotImplementedError(
        f"forward quantizer '{kind}' is not ported yet (the square-block "
        "quantizer comes with the schemes that use it)")


def _dequant_packed(p, s, g, dtype=torch.bfloat16) -> torch.Tensor:
    return (FM.block_values(p, s) * g).to(dtype)


def _qmm(qa, qb) -> torch.Tensor:
    """Simulated NVFP4 GEMM: (Ma, D) x (Mb, D) -> (Ma, Mb) in fp32."""
    return ops.fp4_matmul(qa[0], qa[1], qb[0], qb[1], qa[2], qb[2])


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 GEMM (Ma, D) x (Mb, D) -> (Ma, Mb), fp32 accumulation: an fp32
    matmul of bf16-exact values (never a bf16-output matmul)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T


def pack_weight(w: torch.Tensor, kind: str) -> PackedQWeight:
    """Quantize one 2-D weight with forward quantizer `kind` and pack it."""
    return PackedQWeight(*_quant_packed(w, kind))


def _qlinear_packed(x: torch.Tensor, w: PackedQWeight, scheme: str):
    """Inference forward against a prequantized weight: bit-identical to the
    per-step path on the raw weight (activations still quantize per call)."""
    sch = S.get(scheme)
    assert sch.fwd_w != "none", \
        f"scheme {scheme} does not quantize weights; pass the raw array"
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    qw = (w.packed, w.scale_bits, w.gscale)
    if sch.fwd_x != "none":
        y = _qmm(_quant_packed(xf, sch.fwd_x), qw)
    else:
        y = _mm(xf, _dequant_packed(*qw))
    return y.to(x.dtype).reshape(*lead, -1)


def qlinear(x: torch.Tensor, w, seed=None, scheme: str = "quartet2"):
    """y = x @ w^T under the given quantization scheme (forward only).

    x: (..., K) activations; w: (N, K) weight — raw tensor (per-step
    quantization) or PackedQWeight (quantize-once serving). `seed` feeds
    only the stochastic backward of the reference and is unused here.
    """
    if isinstance(w, PackedQWeight):
        return _qlinear_packed(x, w, scheme)
    sch = S.get(scheme)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if not sch.is_quantized:
        return _mm(xf, w).to(x.dtype).reshape(*lead, -1)
    qx = _quant_packed(xf, sch.fwd_x) if sch.fwd_x != "none" else None
    qw = _quant_packed(w, sch.fwd_w) if sch.fwd_w != "none" else None
    if qx is not None and qw is not None:
        y = _qmm(qx, qw)
    elif qx is not None:
        y = _mm(_dequant_packed(*qx), w)
    elif qw is not None:
        y = _mm(xf, _dequant_packed(*qw))
    else:
        y = _mm(xf, w)
    return y.to(x.dtype).reshape(*lead, -1)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain bf16 linear (LM head): bf16 operands, fp32 accumulation, output
    in x.dtype."""
    out = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    return out.to(x.dtype)
