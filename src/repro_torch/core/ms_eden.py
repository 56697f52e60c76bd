"""MS-EDEN (paper Algorithm 1): unbiased NVFP4 quantization for micro-scaled
formats, and its ER-NVFP4 "post hoc range alignment" two-phase variant
(paper Section 7), whose two phases are the port's CUDA kernels.

Counterpart of `repro/core/ms_eden.py`. Where the reference takes keys, the
port takes the RHT sign vector (b,) and the uniforms of the stochastic
rounding as tensors (`core/rng.py` draws them).

Direct path (Algorithm 1), `ms_eden`:
  1. blocked RHT (block 128),
  2. Q_RTN with grid max s* = (1/0.93)*6*16/17 and FP8 scale cap 256,
  3. EDEN factor per 16-group: S_g = <x_rht, x_rht> / <x_rht, x_rtn>,
  4. merge S_g into the E4M3 group scales by stochastic rounding.
Post-hoc path (`ms_eden_phase1`, `ms_eden_phase2`):
  phase 1 (full tensor, tile-local): RHT -> E8M3 pseudo-scales p_g (no global
    normalization) -> FP4 codes -> global absmax + EDEN dots;
  phase 2 (scales only, d/16 elements): global align p_g/fp32, EDEN-correct,
    SR to E4M3.
The two paths are not bit-identical (the post-hoc one rounds through e8m3
pseudo-scales before the alignment) but are statistically equivalent: both
unbiased, MSE within 10% (tests/test_torch_ms_eden.py). The port's quartet2
backward runs the post-hoc path, as the reference's kernel composition
`ops.quartet2_backward_gemm` does; the direct path is kept for parity and
statistics and is on no device path.

Results live in ROTATED space; unbiasedness holds after the inverse rotation,
which in a GEMM cancels against the other operand rotated with the same signs.

The EDEN sums over a 16-group run in one fixed order (`group_sum`), the order
the phase-1 kernel reduces in, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.core import rht as R


class MSEdenOut(NamedTuple):
    qt: Q.QTensor        # NVFP4 triple, values in ROTATED space
    signs: torch.Tensor  # RHT signs needed by the GEMM peer / the inverse


class Phase1Out(NamedTuple):
    codes: torch.Tensor          # uint8 FP4 codes (rotated space), (..., d)
    pseudo_scales: torch.Tensor  # E8M3 pseudo-scales (bf16-exact), (..., d/16)
    absmax: torch.Tensor         # global absmax of the ROTATED tensor (0-dim)
    eden_num: torch.Tensor       # <x_rht, x_rht> per group
    eden_den: torch.Tensor       # <x_rht, deq_pseudo> per group


def group_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d/16) sums over 16-groups in the kernel's order: each
    quarter summed left to right, then (q0 + q1) + (q2 + q3)."""
    q = v.reshape(*v.shape[:-1], -1, 4, 4)
    t = ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
    return (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])


def _eden_factors(x_rot: torch.Tensor, x_rtn: torch.Tensor) -> torch.Tensor:
    """Per-16-group EDEN correction S_g = <x,x>/<x,Q(x)> (1.0 for zero groups)."""
    num = group_sum(x_rot * x_rot)
    den = group_sum(x_rot * x_rtn)
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 1.0)


def ms_eden(x: torch.Tensor, signs: torch.Tensor, u: torch.Tensor,
            s: float = Q.S_EDEN) -> MSEdenOut:
    """Algorithm 1 with RHT signs (b,) and SR uniforms u (..., d/16)."""
    x_rot = R.rht(x, signs)
    qt = Q.quant_rtn(x_rot, s=s, fp8_cap=256.0)
    S = _eden_factors(x_rot, Q.dequant(qt))
    scales = F.fp8_sr_pos(S * qt.scales, u)
    return MSEdenOut(Q.QTensor(qt.vals, scales, qt.gscale), signs)


def ms_eden_dequant(out: MSEdenOut, rotated: bool = True) -> torch.Tensor:
    """Dequantize; rotated=False also applies the inverse rotation (tests
    only — GEMMs consume the rotated representation)."""
    v = Q.dequant(out.qt)
    return v if rotated else R.rht_inv(v, out.signs)


def ms_eden_phase1(x: torch.Tensor, signs: torch.Tensor,
                   s: float = Q.S_EDEN) -> Phase1Out:
    """Kernel-1 semantics: everything computable without the global absmax."""
    x_rot = R.rht(x, signs)
    gmax = Q._group_absmax(x_rot)
    pseudo = F.e8m3_rtn(F.div_const(gmax, s))  # extended-range scales
    denom = torch.repeat_interleave(torch.where(pseudo == 0, 1.0, pseudo),
                                    F.GROUP, dim=-1)
    q = F.fp4_rtn(x_rot / denom)
    return Phase1Out(
        codes=F.fp4_code(q),
        pseudo_scales=pseudo,
        absmax=x_rot.abs().amax(),
        eden_num=group_sum(x_rot * x_rot),
        eden_den=group_sum(x_rot * (q * denom)),
    )


def phase2_scales(absmax, pseudo, num, den, u, s: float = Q.S_EDEN):
    """Kernel-2 semantics on the phase-1 statistics: (scales on the e4m3 grid,
    gscale). Touches d/16 elements."""
    gscale = Q._gscale(absmax, s * 256.0)
    S = torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 1.0)
    return F.fp8_sr_pos(S * pseudo / gscale, u), gscale


def ms_eden_phase2(p1: Phase1Out, u: torch.Tensor,
                   s: float = Q.S_EDEN) -> Q.QTensor:
    """Scales-only global alignment + EDEN + SR->E4M3 (uniforms u (..., d/16))."""
    scales, gscale = phase2_scales(p1.absmax, p1.pseudo_scales, p1.eden_num,
                                   p1.eden_den, u, s)
    return Q.QTensor(F.fp4_decode(p1.codes), scales, gscale)
