"""flash_attention — causal / GQA / sliding-window attention, one kernel launch.

Hand-written CUDA C++ for Hopper (``repro_torch/csrc/flash_attention.cu``,
``sm_90a``), built with ``nvcc`` at first use and called through ctypes, in
two routes:

* the **wgmma route** for bf16 q, k, v at head dims 32, 64 and 128: TMA
  loads through a ring of shared-memory stages, both products on ``wgmma``;
* the **SIMT route** for f32 q, k, v at any head dim that is a multiple of
  8 up to 128, and for bf16 at the other such head dims: K/V tiles staged
  through shared memory in f32 and f32 FMAs (no tensor core, whose TF32
  would miss the f32 tolerance).

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

The wrapper sends CUDA tensors to their route and raises for any other
type or head dim; it runs the plain version for CPU tensors.  ``block_q``
and ``block_k`` are accepted for the JAX signature and change nothing.
``flash_attention.launches`` counts the launches of both routes,
``flash_attention.simt_launches`` those of the SIMT route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import count_launch, kernel_function

__all__ = ["flash_attention", "flash_attention_ref"]

NEG_INF = -1e30
_WGMMA_HEAD_DIMS = (32, 64, 128)
_VOID = ctypes.c_void_p


def _route(dtype: torch.dtype, d: int) -> str:
    """``"wgmma"`` or ``"simt"`` for a CUDA call; raises for what neither takes."""
    if dtype == torch.bfloat16 and d in _WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in (torch.float32, torch.bfloat16) and d % 8 == 0 and 8 <= d <= 128:
        return "simt"
    raise ValueError(f"flash_attention: {dtype} at head dim {d} is not taken on the card "
                     f"(float32 or bfloat16, head dim a multiple of 8 up to 128)")


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q lies on {q.device}; the kernel takes CUDA tensors")
    route = _route(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous {q.dtype} tensor "
                             f"on {q.device}, got {t.dtype} on {t.device}")
        if route == "wgmma" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, h, hkv, d,
            1.0 / math.sqrt(d), int(bool(causal)), int(window)]
    types = [_VOID, _VOID, _VOID, _VOID] + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_int]
    if route == "simt":
        fn = kernel_function("flash_attention", "repro_flash_attention_simt",
                             types + [ctypes.c_int, _VOID])
        args.append(int(q.dtype == torch.bfloat16))
    else:
        fn = kernel_function("flash_attention", "repro_flash_attention", types + [_VOID])
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error {err}")
    count_launch(flash_attention)
    if route == "simt":
        count_launch(flash_attention, "simt_launches")
    return out


flash_attention.launches = 0
flash_attention.simt_launches = 0
