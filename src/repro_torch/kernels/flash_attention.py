"""flash_attention — causal / GQA / sliding-window attention, one kernel launch.

Hand-written CUDA C++ for Hopper (``repro_torch/csrc/flash_attention.cu``,
``sm_90a``: TMA loads through a ring of shared-memory stages, both products
on ``wgmma``), built with ``nvcc`` at first use and called through ctypes.
It replaces the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py``): an online softmax over kv tiles
with the running max, denominator and accumulator in f32, the output in
``q``'s type.  The kernel builds its TMA tensor maps on the host with
``cuTensorMapEncodeTiled``, looked up with ``cudaGetDriverEntryPoint``, so
the library needs no link against ``libcuda``.

Beside it is :func:`flash_attention_ref`, its plain PyTorch version, which
the CPU tests compare with the JAX kernel and ``chip_smoke.py`` compares
with the CUDA kernel.  Both give **0** for a query row that no key reaches
(the kernel's ``max(l, 1e-30)`` denominator), where the JAX package's
``attention_ref`` oracle averages ``v`` instead.

The wrapper launches the kernel for CUDA tensors (bf16 only, head dim 32,
64 or 128) and runs the plain version for CPU tensors; ``block_q`` and
``block_k`` are accepted for the JAX signature and change nothing.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import kernel_function

__all__ = ["flash_attention", "flash_attention_ref"]

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_VOID = ctypes.c_void_p


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,Lq,H,D), k and v (B,Lk,Hkv,D): got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: f32 scores,
    probabilities and sums, output in ``q.dtype``; a fully masked row is 0."""
    _check_shapes(q, k, v)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, lq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (1.0 / math.sqrt(d))
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m == NEG_INF, 0.0, torch.exp(s - m))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32)) / denom.permute(0, 3, 1, 2, 4)
    return o.reshape(b, lq, h, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, Hkv, D)
    v: torch.Tensor,  # (B, Lk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blocked attention; returns (B, Lq, H, D) in ``q.dtype``."""
    del block_q, block_k  # the kernel's tiles are its own; results do not depend on them
    if pallas_interpret(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_shapes(q, k, v)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bfloat16 tensor "
                             f"on {q.device}, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    fn = kernel_function(
        "flash_attention", "repro_flash_attention",
        [_VOID, _VOID, _VOID, _VOID] + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _VOID],
    )
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, h, hkv, d,
                 1.0 / math.sqrt(d), int(bool(causal)), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
