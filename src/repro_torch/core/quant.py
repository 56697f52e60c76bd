"""NVFP4 quantizers: Q_SR, Q_RTN(s), Four-over-Six, square-block (16x16).

Counterpart of `repro/core/quant.py`. All quantizers operate along the LAST
axis (the GEMM inner dimension) with micro-scaling groups of 16, an E4M3
scale per group, and one FP32 scale per tensor. They return a `QTensor`;
`dequant` reconstructs the represented values exactly.

Conventions follow the paper Section 3.1/3.3:
  Q_SR:   x_fp32 = absmax / (6 * 16/17 * 448)
          s_g    = RTN_FP8(absmax_g / (x_fp32 * 6 * 16/17))
          q_i    = SR_FP4(x_i / (s_g * x_fp32))            (never clips)
  Q_RTN:  x_fp32 = absmax / (s * 448)
          s_g    = RTN_FP8(absmax_g / (x_fp32 * s))
          q_i    = RTN_FP4(x_i / (s_g * x_fp32))           (may clip)
          with s* = (1/0.93) * 6 * 16/17 minimizing N(0,1) MSE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats as F

# MSE-optimal clipping grid max for Q_RTN over N(0,1) (paper Section 3.3).
S_EDEN = (1.0 / 0.93) * 6.0 * F.FP8_RTN_MARGIN
# Non-clipping grid max (classic NVFP4 RTN / SR).
S_NOCLIP = 6.0 * F.FP8_RTN_MARGIN


class QTensor(NamedTuple):
    """An NVFP4-represented tensor (values = vals * scales * gscale)."""

    vals: torch.Tensor    # f32 on the E2M1 grid, same shape as the source
    scales: torch.Tensor  # f32 on the E4M3 grid, shape (..., d // 16)
    gscale: torch.Tensor  # f32 scalar, per-tensor

    @property
    def codes(self) -> torch.Tensor:
        return F.fp4_code(self.vals)


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    s = torch.repeat_interleave(qt.scales, F.GROUP, dim=-1)
    return (qt.vals * s * qt.gscale).to(dtype)


def _group_absmax(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d // 16) group absolute maxima."""
    g = x.reshape(*x.shape[:-1], x.shape[-1] // F.GROUP, F.GROUP)
    return g.abs().amax(dim=-1)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / torch.where(b == 0, 1.0, b)


def _gscale(absmax: torch.Tensor, denom: float) -> torch.Tensor:
    g = F.div_const(absmax, denom)
    return torch.where(g == 0, 1.0, g)


def quant_sr(x: torch.Tensor, u: torch.Tensor) -> QTensor:
    """Element-wise stochastic rounding NVFP4 (unbiased; paper Section 3.1)
    against uniforms `u` of x's shape."""
    xf = x.float()
    gscale = _gscale(xf.abs().amax(), 6.0 * F.FP8_RTN_MARGIN * F.FP8_MAX)
    scales = F.fp8_rtn(_group_absmax(xf) / (gscale * 6.0 * F.FP8_RTN_MARGIN))
    denom = torch.repeat_interleave(scales, F.GROUP, dim=-1) * gscale
    q = F.fp4_sr(_safe_div(xf, denom), u)
    return QTensor(q, scales, gscale)


def quant_rtn(x: torch.Tensor, s: float = S_NOCLIP,
              fp8_cap: float = F.FP8_MAX) -> QTensor:
    """Deterministic RTN NVFP4 with grid max `s` and FP8 scale cap."""
    xf = x.float()
    gscale = _gscale(xf.abs().amax(), s * fp8_cap)
    scales = F.fp8_rtn(_group_absmax(xf) / (gscale * s))
    denom = torch.repeat_interleave(scales, F.GROUP, dim=-1) * gscale
    q = F.fp4_rtn(_safe_div(xf, denom))  # clips at +-6 when s > 6*16/17
    return QTensor(q, scales, gscale)


def four_over_six_branch(xf: torch.Tensor, s: float = S_EDEN):
    """The 4/6 branch choice of f32 x: per 16-group, the absmax->s and
    absmax->s*4/6 grid placements, keeping the one with the lower squared
    RTN error (ties go to the 6 branch). Returns (gscale, scales of the kept
    branch, x / (scale * gscale)) — the input of the final FP4 rounding."""
    # Global scale sized for the /4 branch (scales 1.5x larger than /6).
    gscale = _gscale(xf.abs().amax(), (s * 4.0 / 6.0) * F.FP8_MAX)
    gmax = _group_absmax(xf)

    def branch(div: float):
        scales = F.fp8_rtn(gmax / (gscale * div))
        denom = torch.repeat_interleave(scales, F.GROUP, dim=-1) * gscale
        xs = _safe_div(xf, denom)
        g = (F.fp4_rtn(xs) * denom - xf).reshape(
            *xf.shape[:-1], xf.shape[-1] // F.GROUP, F.GROUP)
        return scales, xs, (g * g).sum(dim=-1)

    s6, xs6, m6 = branch(s)
    s4, xs4, m4 = branch(s * 4.0 / 6.0)
    use4 = m4 < m6
    xs = torch.where(torch.repeat_interleave(use4, F.GROUP, dim=-1), xs4, xs6)
    return gscale, torch.where(use4, s4, s6), xs


def quant_four_over_six(x: torch.Tensor, s: float = S_EDEN) -> QTensor:
    """Four-over-Six (Cook et al. 2025): RTN onto the lower-MSE of the
    absmax->6 and absmax->4 grid placements per 16-group. Deterministic; a
    FORWARD-pass quantizer only."""
    gscale, scales, xs = four_over_six_branch(x.float(), s)
    return QTensor(F.fp4_rtn(xs), scales, gscale)


def quant_square_block(x: torch.Tensor) -> QTensor:
    """NVIDIA-recipe square-block quantization: one E4M3 scale per 16x16 tile
    of a 2-D (N, K) weight, both dims multiples of 16. The scales are exposed
    per row (rows of a tile share its scale), so W^T can be reused in the
    backward without re-quantization."""
    if x.dim() != 2 or x.shape[0] % F.GROUP or x.shape[1] % F.GROUP:
        raise ValueError("square-block quantization takes a 2-D weight whose "
                         f"dims are multiples of 16, got {tuple(x.shape)}")
    xf = x.float()
    n, k = xf.shape
    gscale = _gscale(xf.abs().amax(), 6.0 * F.FP8_RTN_MARGIN * F.FP8_MAX)
    tiles = xf.reshape(n // F.GROUP, F.GROUP, k // F.GROUP, F.GROUP)
    tmax = tiles.abs().amax(dim=(1, 3))  # (n // 16, k // 16)
    tscales = F.fp8_rtn(tmax / (gscale * 6.0 * F.FP8_RTN_MARGIN))
    denom = torch.repeat_interleave(
        torch.repeat_interleave(tscales, F.GROUP, 0), F.GROUP, 1) * gscale
    q = F.fp4_rtn(_safe_div(xf, denom))
    return QTensor(q, torch.repeat_interleave(tscales, F.GROUP, dim=0), gscale)


def mse(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    d = dequant(qt) - x.float()
    return (d * d).mean()
