"""Threefry-2x32 random draws that give the JAX package's bits.

The reference draws its seeded numbers with ``jax.random`` (the
``threefry2x32`` generator, with ``jax_threefry_partitionable`` on, the
default of current JAX).  This module computes the same bits with torch
integer ops on the tensor's own device, so a seed gives the same k-means
centers and the same sampled tokens in both packages:

* a key is the pair of 32-bit words ``(0, seed mod 2**32)`` that
  ``jax.random.key(seed)`` holds for a seed in the int32 range;
* element ``i`` (row-major) of a draw of any shape hashes the counter pair
  ``(hi32(i), lo32(i))`` with :func:`threefry2x32`, and its 32 random bits
  are the xor of the two output words (:func:`random_bits`); a narrower
  draw keeps the low bits;
* :func:`uniform` fills a float's mantissa with the top bits of a draw of
  ``max(nbits, 8)`` bits, as ``jax.random.uniform`` does (8 bits for
  bfloat16, 16 for float16, 32 for float32);
* :func:`categorical` is the Gumbel-max draw of ``jax.random.categorical``:
  ``argmax(logits - log(-log(u)))`` with ``u`` uniform in ``[tiny, 1)`` in
  the logits' type, the first index winning a tie.

Words are int64 tensors holding values below 2**32; every sum is masked
back to 32 bits.

>>> uniform(0, (2,), torch.float32)  # jax.random.uniform(jax.random.key(0), (2,))
tensor([0.9477, 0.9786])
"""

from __future__ import annotations

import torch

__all__ = ["key", "threefry2x32", "random_bits", "uniform", "categorical"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_BITS = {torch.float32: (32, 23), torch.bfloat16: (16, 7), torch.float16: (16, 10)}
_INT_OF = {32: torch.int32, 16: torch.int16}


def key(seed: int | tuple[int, int]) -> tuple[int, int]:
    """The two key words of ``jax.random.key(seed)``; a pair passes through."""
    if isinstance(seed, tuple):
        return seed
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range that jax.random.key takes")
    return 0, seed & MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(
    k: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``x0, x1`` under key ``k``."""
    ks = (k[0] & MASK, k[1] & MASK, (k[0] ^ k[1] ^ 0x1BD11BDA) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def random_bits(
    k: int | tuple[int, int], shape, *, bits: int = 32, device=None
) -> torch.Tensor:
    """``jax.random.bits``' values (``bits`` of 8, 16 or 32), as int64 in ``[0, 2**bits)``."""
    if bits not in (8, 16, 32):
        raise ValueError(f"bits {bits} not in (8, 16, 32)")
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key(k), i >> 32, i & MASK)
    return ((x0 ^ x1) & ((1 << bits) - 1)).reshape(shape)


def uniform(
    k: int | tuple[int, int],
    shape,
    dtype: torch.dtype = torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    device=None,
) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(k), shape, dtype, minval, maxval)``, bit for bit."""
    if dtype not in _BITS:
        raise TypeError(f"uniform takes float32, bfloat16 or float16, not {dtype}")
    nbits, nmant = _BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(k, shape, bits=rng_bits, device=device)
    one = {32: 0x3F800000, 16: 0x3F80 if dtype is torch.bfloat16 else 0x3C00}[nbits]
    word = (bits >> (rng_bits - nmant)) | one  # below 2**(nbits - 1): no sign bit
    floats = word.to(_INT_OF[nbits]).view(dtype) - torch.ones((), dtype=dtype)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    if dtype is torch.bfloat16:  # XLA rounds the product and the sum to bf16
        scaled = floats * (hi - lo) + lo
    else:  # one fused multiply-add, rounded once (the product is exact in f64)
        scaled = (floats.double() * (hi - lo).double() + lo.double()).to(dtype)
    return torch.maximum(lo, scaled)


def categorical(k: int | tuple[int, int], logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(jax.random.key(k), logits)`` over the last axis (int64)."""
    dtype = logits.dtype
    u = uniform(k, logits.shape, dtype, torch.finfo(dtype).tiny, 1.0, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)
