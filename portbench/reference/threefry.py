"""A frozen copy of the Threefry-2x32 uniform draw that seeds k-means.

The program under test draws its initial centers with ``jax.random.uniform``'s
bits (Threefry-2x32, partitionable counters).  The reference works the same
centers out again from the job's seed with this copy, so it takes nothing the
program made.  float32 only:

* the key of a seed in the int32 range is the word pair ``(0, seed mod 2**32)``;
* element ``i`` (row-major) hashes the counter pair ``(hi32(i), lo32(i))`` and
  its 32 bits are the xor of the two output words;
* a float32 in ``[1, 2)`` takes the top 23 of them as its mantissa, and one
  is subtracted.
"""

from __future__ import annotations

import torch

__all__ = ["uniform_f32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def uniform_f32(seed: int, shape, device=None) -> torch.Tensor:
    """float32 uniform in ``[0, 1)`` of ``shape`` from ``seed`` (int32 range)."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(0, seed & _MASK, i >> 32, i & _MASK)
    word = ((x0 ^ x1) >> 9) | 0x3F800000
    return (word.to(torch.int32).view(torch.float32) - 1.0).reshape(tuple(shape))
