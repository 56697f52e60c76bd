"""Counter-based randomness for the stochastic backward: RHT signs and
uniforms hashed from (uint32[2] site seed, tag, element index).

The reference draws them with threefry from `_key(seed, tag)`
(`repro/core/linear.py`); the port does not re-implement threefry and keeps
no global generator. Each draw is a pure function of (seed, tag, shape), in
torch integer ops on the tensor's device: 32-bit state held in int64, every
multiplier below 2^31, so no product overflows and the CPU and a CUDA device
draw identical numbers. Tags follow the reference: `tag` for the RHT signs
(shared by both operands of a GEMM), `tag + 1` for operand a's uniforms,
`tag + 2` for operand b's.

The SR uniforms of MS-EDEN need not be drawn as a tensor at all: a tag's
key pair (`HashDraws.keys`) goes to phase 2, whose kernel hashes each
group's flat index itself, bitwise as `uniform` does (`core/linear.py`).

Tests bypass the hash: any object with the `signs` and `uniform` methods of
`HashDraws` may stand in for a seed (see `draws`), and the tests pass one
that returns JAX's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D  # odd multipliers below 2^31 (the first is lowbias32's)
_M2 = 0x2C1B3C6D
_GOLDEN = 0x9E3779B9


def _mix(h):
    """32-bit avalanche mix of non-negative ints below 2^32 (Python ints or
    int64 tensors)."""
    h = h ^ (h >> 16)
    h = (h * _M1) & _MASK
    h = h ^ (h >> 15)
    h = (h * _M2) & _MASK
    return h ^ (h >> 16)


def hash_bits(keys, n: int, device) -> torch.Tensor:
    """The 32-bit hashes of the flat indices 0 .. n-1 under a tag's key pair
    (k, k2): mix((mix(i ^ k) + k2) mod 2^32), as int64 below 2^32. The
    MS-EDEN phase-2 kernel computes the same hash of its group index in
    uint32 arithmetic (`kernels/csrc/ms_eden_requant.cu:hash_uniform`)."""
    if n >= 2**32:
        raise ValueError(f"{n} draws exceed the 32-bit counter")
    k, k2 = keys
    i = torch.arange(n, dtype=torch.int64, device=device)
    return _mix((_mix(i ^ k) + k2) & _MASK)


def uniform_from_keys(keys, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of `shape` under a key pair, 24 random bits
    each (the top 24 of the hash, times 2^-24: exact)."""
    n = int(np.prod(shape))
    return ((hash_bits(keys, n, device) >> 8).float() * 2.0**-24).reshape(shape)


class HashDraws:
    """Signs and uniforms of one site seed (uint32[2])."""

    def __init__(self, seed):
        s = np.asarray(seed, np.uint32)
        self.seed = (int(s[0]), int(s[1]))

    def keys(self, tag: int) -> tuple[int, int]:
        """The key pair (k, k2), two ints below 2^32, that every draw of
        `tag` hashes its flat index with."""
        k = _mix((self.seed[0] + _mix(tag & _MASK)) & _MASK)
        k = _mix(k ^ self.seed[1])
        return k, _mix((k + _GOLDEN) & _MASK)

    def _bits(self, tag: int, n: int, device) -> torch.Tensor:
        return hash_bits(self.keys(tag), n, device)

    def signs(self, tag: int, n: int, device) -> torch.Tensor:
        """(n,) float32 of +-1, each sign from the top bit of its hash."""
        return 1.0 - 2.0 * (self._bits(tag, n, device) >> 31).float()

    def uniform(self, tag: int, shape, device) -> torch.Tensor:
        """float32 uniforms in [0, 1) of `shape`, 24 random bits each."""
        return uniform_from_keys(self.keys(tag), shape, device)


def draws(seed):
    """The draw source of a site seed: a uint32[2] seed is hashed; an object
    that already has `signs` and `uniform` is returned as it is."""
    if hasattr(seed, "signs") and hasattr(seed, "uniform"):
        return seed
    return HashDraws(seed)
