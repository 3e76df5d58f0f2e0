"""Gradient compression for slow (cross-pod) links, with error feedback.

Port of ``repro/optim/compression.py``.  Two codecs, both shape- and
type-preserving round trips:

* :func:`int8_compress` / :func:`int8_decompress` — per-chunk symmetric
  int8 quantization (chunk = trailing-dim rows, one f32 scale per chunk),
  rounding half to even as ``jnp.round`` does: 4× over f32, 2× over bf16.
* :func:`topk_compress` / :func:`topk_decompress` — magnitude top-k
  sparsification (values + int32 indices), ties in ``lax.top_k``'s order
  (the lower index first, :func:`repro_torch._topk.top_k`).

:class:`ErrorFeedback` carries the quantization residual into the next
step (Seide et al. / EF-SGD), which keeps SGD/Adam convergence unbiased.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._pytree import register_dataclass, tree_map
from repro_torch._topk import top_k


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) → (q int8 (..., d), scale f32 (..., 1))."""
    xf = x.to(torch.float32)
    # divisors as tensors on the device: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / torch.full((), 127.0,
                                                                         device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def topk_compress(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """flat top-k by magnitude → (values (k,), indices int32 (k,))."""
    flat = x.to(torch.float32).reshape(-1)
    _, idx = top_k(torch.abs(flat), k)
    return flat[idx], idx.to(torch.int32)


def topk_decompress(values: torch.Tensor, idx: torch.Tensor, shape, dtype=torch.float32):
    flat = torch.zeros((math.prod(shape),), dtype=torch.float32, device=values.device)
    flat[idx.to(torch.int64)] = values.to(torch.float32)
    return flat.reshape(shape).to(dtype)


@register_dataclass
@dataclasses.dataclass
class ErrorFeedback:
    residual: Any  # tree like grads, f32

    @classmethod
    def init(cls, grads: Any) -> "ErrorFeedback":
        return cls(tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads
        ))


def compress_with_feedback(grads: Any, ef: ErrorFeedback) -> tuple[Any, ErrorFeedback]:
    """int8-round-trip the gradients, carrying the residual forward.

    Models the cross-pod hop: what a remote pod would receive is the
    decompressed value; the local residual is replayed next step.
    """
    residuals = []

    def one(g, r):
        target = g.to(torch.float32) + r
        if g.ndim == 0:
            residuals.append(torch.zeros_like(r))
            return g
        q, s = int8_compress(target)
        back = int8_decompress(q, s)
        residuals.append(target - back)
        return back.to(g.dtype)

    new_g = tree_map(one, grads, ef.residual)
    rs = iter(residuals)
    return new_g, ErrorFeedback(tree_map(lambda _: next(rs), grads))
