"""Seeded blocked Randomized Hadamard Transform (RHT).

Counterpart of `repro/core/rht.py`. One random sign diagonal is drawn per
(tensor, micro-batch) and shared across all rotation blocks of the tensor:

    RHT(x) = reshape(x, (..., d/b, b)) @ (diag(sign) @ H_b / sqrt(b))

The reference draws the signs from a key and multiplies by H_b as a GEMM. The
port takes the +-1 sign vector as a tensor (`core/rng.py` draws it) and
applies H_b as a fast Walsh-Hadamard butterfly in one FIXED order: log2(b)
stages at strides 1, 2, ..., b/2, each turning the pair (lo, hi) into
(lo + hi, lo - hi), then one multiply by the f32 image of 1/sqrt(b). Every
operation is a single IEEE f32 rounding, so the CPU, a CUDA device and the
`ms_eden_phase1` kernel (which runs the same butterfly) rotate bit for bit
alike. Against the reference's GEMM only the rounding order differs.

Block size: 128 when the inner dim allows, otherwise the largest power-of-two
multiple of 16 dividing d.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

RHT_BLOCK = 128  # rotation block size (paper App. A: d = 128)


@functools.lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of power-of-two size n, normalized 1/sqrt(n)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    h = np.ones((1, 1), dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(n)).astype(np.float32)


def block_size(d: int) -> int:
    """Largest power-of-two block in {16, 32, 64, 128} dividing d (prefer 128)."""
    for b in (RHT_BLOCK, 64, 32, 16):
        if d % b == 0:
            return b
    raise ValueError(f"inner dim {d} is not a multiple of 16")


def inv_sqrt(b: int) -> float:
    """The f32 entry magnitude of the normalized H_b (as the reference's
    `hadamard(b)` holds it)."""
    return float(np.float32(1.0 / np.sqrt(b)))


def _butterfly(x: torch.Tensor, b: int) -> torch.Tensor:
    """H_b (unnormalized) applied to each length-b block of the last axis."""
    shape = x.shape
    blocks = x.reshape(-1, b)
    h = 1
    while h < b:
        y = blocks.reshape(-1, b // (2 * h), 2, h)
        lo, hi = y[:, :, 0], y[:, :, 1]
        blocks = torch.stack((lo + hi, lo - hi), dim=2).reshape(-1, b)
        h *= 2
    return blocks.reshape(shape)


def _scale(x: torch.Tensor, b: int) -> torch.Tensor:
    return x * torch.tensor(inv_sqrt(b), dtype=torch.float32, device=x.device)


def rht(x: torch.Tensor, signs: torch.Tensor, b: int | None = None) -> torch.Tensor:
    """Blocked RHT along the last axis with sign vector `signs` (b,) of +-1.
    Orthogonal; the inverse is `rht_inv` with the same signs."""
    b = b or block_size(x.shape[-1])
    xf = x.float().reshape(*x.shape[:-1], -1, b) * signs.float()
    return _scale(_butterfly(xf, b), b).reshape(x.shape)


def rht_inv(x: torch.Tensor, signs: torch.Tensor, b: int | None = None) -> torch.Tensor:
    """Inverse blocked RHT (H_b^T = H_b, then undo the sign diagonal)."""
    b = b or block_size(x.shape[-1])
    xf = x.float().reshape(*x.shape[:-1], -1, b)
    return (_scale(_butterfly(xf, b), b) * signs.float()).reshape(x.shape)
