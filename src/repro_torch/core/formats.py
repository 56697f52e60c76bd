"""Numeric formats for NVFP4 micro-scaled quantization (the serving subset).

NVFP4 represents a tensor as
  - FP4 E2M1 element codes (grid {0, .5, 1, 1.5, 2, 3, 4, 6} x sign),
  - one FP8 E4M3 scale per group of 16 contiguous inner-dim elements,
  - one FP32 scale per tensor.

Counterpart of `repro/core/formats.py`: E2M1 encode/decode (RTN), E4M3
round-to-nearest, 4-bit code (un)packing, and E4M3 raw bits to and from
float. Every function is dtype-exact, so the values produced here are
bit-for-bit the values the JAX reference produces from the same inputs.

Division by a constant always goes through `div_const`: PyTorch divides a
CUDA tensor by a Python scalar as a multiplication by the reciprocal, which
is not the IEEE quotient the reference computes.
"""

from __future__ import annotations

import numpy as np
import torch

# Non-negative representable magnitudes of E2M1, ascending.
FP4_GRID = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)
FP4_MAX = 6.0

# E4M3 (float8_e4m3fn) constants
FP8_MAX = 448.0
# Largest relative increase RTN_FP8 can apply to a positive value: x -> x *
# (1 + 1/16) at most, hence the paper's 16/17 margin.
FP8_RTN_MARGIN = 16.0 / 17.0

GROUP = 16  # NVFP4 micro-scaling group size


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE f32 quotient x / f32(c) on any device (see module docstring)."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def fp4_rtn(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even onto the E2M1 grid. Values beyond +-6 clip."""
    xf = x.float()
    m = xf.abs()
    q = torch.where(m <= 0.25, 0.0,
        torch.where(m < 0.75, 0.5,
        torch.where(m <= 1.25, 1.0,
        torch.where(m < 1.75, 1.5,
        torch.where(m <= 2.5, 2.0,
        torch.where(m < 3.5, 3.0,
        torch.where(m <= 5.0, 4.0, 6.0)))))))
    return torch.sign(xf) * q


def fp4_code(x: torch.Tensor) -> torch.Tensor:
    """Encode FP4-grid values into 4-bit codes (uint8 in [0, 15]).

    Layout: bit3 = sign, bits2..0 = grid index. Assumes x already on grid.
    """
    xf = x.float()
    m = xf.abs()
    idx = (torch.where(m < 0.25, 0,
           torch.where(m < 0.75, 1,
           torch.where(m < 1.25, 2,
           torch.where(m < 1.75, 3,
           torch.where(m < 2.5, 4,
           torch.where(m < 3.5, 5,
           torch.where(m < 5.0, 6, 7)))))))).to(torch.uint8)
    sign = (xf < 0).to(torch.uint8)
    return (sign << 3) | idx


def fp4_decode(code: torch.Tensor) -> torch.Tensor:
    """Decode 4-bit codes back to float32 grid values."""
    grid = torch.as_tensor(FP4_GRID, device=code.device)
    idx = (code & 0x7).long()
    sign = torch.where(((code >> 3) & 1).bool(), -1.0, 1.0)
    return sign * grid[idx]


def fp8_rtn(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even to float8_e4m3fn, returned as float32.

    Clips to +-448 first: PyTorch's cast to float8_e4m3fn does not saturate.
    """
    xf = x.float().clamp(-FP8_MAX, FP8_MAX)
    return xf.to(torch.float8_e4m3fn).float()


def e4m3_to_bits(x: torch.Tensor) -> torch.Tensor:
    """E4M3-grid float32 values -> raw float8_e4m3fn bits (uint8)."""
    return x.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).view(
        torch.uint8)


def bits_to_e4m3(bits: torch.Tensor) -> torch.Tensor:
    """Raw float8_e4m3fn bits (uint8) -> float32 values."""
    return bits.view(torch.float8_e4m3fn).float()


def pack_fp4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 codes in [0, 15] pairwise along the last axis (even size):
    the low nibble holds the even index."""
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_fp4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_fp4."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
