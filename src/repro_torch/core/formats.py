"""Numeric formats for NVFP4 micro-scaled quantization (the serving subset).

NVFP4 represents a tensor as
  - FP4 E2M1 element codes (grid {0, .5, 1, 1.5, 2, 3, 4, 6} x sign),
  - one FP8 E4M3 scale per group of 16 contiguous inner-dim elements,
  - one FP32 scale per tensor.

Counterpart of `repro/core/formats.py`: E2M1 encode/decode (RTN and
stochastic), E4M3 round-to-nearest and stochastic rounding, the E8M3
pseudo-scale proxy, 4-bit code (un)packing, and E4M3 raw bits to and from
float. Every function is dtype-exact, so the values produced here are
bit-for-bit the values the JAX reference produces from the same inputs. The
stochastic roundings take their uniforms as a tensor argument (the
reference draws them from a key inside): the same uniforms give the same
result.

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


def fp4_sr(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding onto the E2M1 grid against uniforms `u` (shape of
    x): P(round up) = (|x| - lo) / (hi - lo). Unbiased only for |x| <= 6;
    beyond the grid edge the value saturates to +-6 (`fp4_overflow_fraction`
    is the probe for that)."""
    xf = x.float()
    mag = xf.abs().clamp(0.0, FP4_MAX)
    grid = torch.as_tensor(FP4_GRID, device=x.device)
    idx_lo = (torch.searchsorted(grid, mag, right=True) - 1).clamp(0, 7)
    idx_hi = (idx_lo + 1).clamp(0, 7)
    lo = grid[idx_lo]
    hi = grid[idx_hi]
    span = (hi - lo).clamp_min(1e-30)
    p_up = ((mag - lo) / span).clamp(0.0, 1.0)
    q = torch.where(u < p_up, hi, lo)
    return torch.sign(xf) * q


def fp4_overflow_fraction(x: torch.Tensor) -> torch.Tensor:
    """Fraction of elements whose magnitude exceeds the E2M1 grid edge (0.0
    for every caller that normalizes with the 16/17-margin scale chain)."""
    return (x.float().abs() > FP4_MAX).float().mean()


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


def fp8_sr_pos(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of NON-NEGATIVE values to float8_e4m3fn (as f32)
    against uniforms `u` (shape of x). Walks the e4m3 lattice in the bit
    pattern (0x00 = 0 ... 0x7E = 448): the other neighbour of the RNE value
    is one step toward x; an exactly representable x is kept."""
    xf = x.float().clamp(0.0, FP8_MAX)
    near = xf.to(torch.float8_e4m3fn)
    near_f = near.float()
    bits = near.view(torch.uint8).to(torch.int32)
    up = (bits + 1).clamp(max=0x7E)
    down = (bits - 1).clamp(min=0)
    other = torch.where(near_f < xf, up, down).to(torch.uint8)
    other_f = bits_to_e4m3(other)
    lo = torch.minimum(near_f, other_f)
    hi = torch.maximum(near_f, other_f)
    span = hi - lo
    p_up = torch.where(span > 0, (xf - lo) / span.clamp_min(1e-30), 0.0)
    out = torch.where(u < p_up.clamp(0.0, 1.0), hi, lo)
    return torch.where(near_f == xf, near_f, out)


def e8m3_rtn(x: torch.Tensor) -> torch.Tensor:
    """Round positive values to 3 mantissa bits with an unbounded exponent:
    the ER-NVFP4 pseudo-scale format (bf16-exact). Half-to-even on the
    mantissa (`torch.round`, as `jnp.round`); values <= 0 give 0."""
    xf = x.float()
    m, e = torch.frexp(xf.clamp_min(1e-38))
    mq = torch.round(m * 16.0) / 16.0
    return torch.where(xf <= 0, 0.0, torch.ldexp(mq, e))


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


# --------------------------------------------------------------------------
# NVFP4 cache codec: the storage format of the quantized paged KV pool
# (`serve.kv_pool.KVPool(quantized=True)`).
#
# Per token, per 16-group along the LAST (feature) axis, deterministic RTN,
# unit per-tensor scale: a token's packed image is a pure function of its
# bf16 value, so tokens quantize independently at scatter time. Storage is
# uint8 twice: e2m1 codes two per byte (d/2 bytes) and e4m3 scales as raw
# bits (d/16 bytes), 0.5625 d bytes against 2 d for bf16 (0.28125x).
#
# Dequant is exact in bf16: an e2m1 magnitude times an e4m3 scale has at
# most 6 significant bits and magnitude <= 2688, so the gather path's bf16
# dequant and a kernel's f32 dequant see bit-identical operands.
# --------------------------------------------------------------------------

def _cache_scale_chain(x: torch.Tensor):
    """(groups (..., d/16, 16) f32, e4m3 group scales (..., d/16) f32)."""
    xf = x.float()
    g = xf.reshape(*xf.shape[:-1], -1, GROUP)
    gmax = g.abs().amax(dim=-1)
    return g, fp8_rtn(div_const(gmax, FP4_MAX * FP8_RTN_MARGIN))


def _normalize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return g / torch.where(scale > 0, scale, 1.0)[..., None]


def nvfp4_cache_encode(x: torch.Tensor):
    """Quantize cache values to NVFP4 packed bytes (deterministic RTN).

    Groups of 16 along the last axis. Returns `(codes, scale_bits)`: uint8
    packed e2m1 pairs (..., d/2) and uint8 e4m3 scale bits (..., d/16). The
    16/17 scale margin keeps normalized magnitudes within 6, so `fp4_rtn`
    never saturates here (`nvfp4_cache_overflow` is 0)."""
    g, scale = _cache_scale_chain(x)
    codes = fp4_code(fp4_rtn(_normalize(g, scale))).reshape(x.shape)
    return pack_fp4(codes), e4m3_to_bits(scale)


def nvfp4_cache_decode(codes: torch.Tensor, scale_bits: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of nvfp4_cache_encode (exact in bf16 and wider)."""
    vals = fp4_decode(unpack_fp4(codes))
    scales = bits_to_e4m3(scale_bits)
    return (vals * torch.repeat_interleave(scales, GROUP, dim=-1)).to(dtype)


def nvfp4_cache_overflow(x: torch.Tensor) -> torch.Tensor:
    """Fraction of normalized magnitudes beyond the E2M1 edge on the encode
    path: the quantity the 16/17 margin pins to zero (a debug probe)."""
    g, scale = _cache_scale_chain(x)
    return fp4_overflow_fraction(_normalize(g, scale))
