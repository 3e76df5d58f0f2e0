"""flash_attention — causal / GQA / sliding-window attention, one kernel launch.

Hand-written CUDA C++ for Hopper (``repro_torch/csrc/flash_attention.cu``,
``sm_90a``), built with ``nvcc`` at first use and called through ctypes, in
two routes, both on the tensor cores (``wgmma``) behind TMA loads through a
ring of shared-memory stages:

* the **wgmma route** for bf16 q, k, v at head dims 32, 64 and 128;
* the **split route** for f32 q, k, v at any head dim that is a multiple of
  8 up to 128, and for bf16 at the other such head dims.  Each f32 operand is
  three bf16 terms (hi + mid + lo, all 24 bits) and each product the six
  term products of order at most 2, so the tensor cores give f32 products to
  about 2^-24; the head dim is zero-padded to 32, 64 or 128.  For f32, K's
  and V's terms are written once per call by :func:`split_kv` (its own
  kernel, one launch), Q's by the attention kernel itself; bf16 K and V are
  read as they are, their padding filled with zeros by TMA.

It replaces the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py``): an online softmax over kv tiles
with the running max, denominator and accumulator in f32, the output in
``q``'s type.  The kernel builds its TMA tensor maps on the host with
``cuTensorMapEncodeTiled``, looked up with ``cudaGetDriverEntryPoint``, so
the library needs no link against ``libcuda``.

Beside it are :func:`flash_attention_ref`, its plain PyTorch version, which
the CPU tests compare with the JAX kernel and ``chip_smoke.py`` compares
with the CUDA kernel; :func:`flash_attention_emulated`, the kernel's own
arithmetic (its bf16 terms and key tiles) summed as f32 matrix products,
which the CPU tests also hold to the JAX kernel and ``chip_smoke.py`` sets
beside the CUDA kernel to tell the split's rounding from the tensor cores';
and :func:`split_terms_ref`, the split kernel's.  All three attention
versions give **0** for a query row that no key reaches (the
kernel's ``max(l, 1e-30)`` denominator), where the JAX package's
``attention_ref`` oracle averages ``v`` instead.

The wrapper sends CUDA tensors to their route and raises for any other
type or head dim; it runs the plain version for CPU tensors.  On either
device it raises where an operand requires a gradient under grad mode: no
backward kernel exists (nor in the JAX package), and an output filled
through ctypes would drop the gradient without a word.  ``block_q``
and ``block_k`` are accepted for the JAX signature and change nothing.
``flash_attention.launches`` counts the launches of both routes,
``flash_attention.split_launches`` those of the split route, and
``split_kv.launches`` those of the split kernel.

**Seen by an operation counter.**  Given ``meta`` tensors, both wrappers
check their operands as for the card (the same routes, the same errors) and
return outputs of the kernel's shape and type, launching nothing.  On the
card and on ``meta`` each call reports its work to the thread's cost sink
(``_build.recording_costs``), which the dry-run's counter adds: see
:func:`flash_cost` and :func:`split_kv_cost`.  The CPU route reports
nothing: a counter sees its plain PyTorch operations themselves.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import cost_sink, count_launch, kernel_function, refuse_grad

__all__ = ["attended_pairs", "flash_attention", "flash_attention_emulated", "flash_attention_ref",
           "flash_cost", "split_kv", "split_kv_cost", "split_terms_ref"]

NEG_INF = -1e30
_WGMMA_HEAD_DIMS = (32, 64, 128)
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _route(dtype: torch.dtype, d: int) -> str:
    """``"wgmma"`` or ``"split"`` for a CUDA call; raises for what neither takes."""
    if dtype == torch.bfloat16 and d in _WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in (torch.float32, torch.bfloat16) and d % 8 == 0 and 8 <= d <= 128:
        return "split"
    raise ValueError(f"flash_attention: {dtype} at head dim {d} is not taken on the card "
                     f"(float32 or bfloat16, head dim a multiple of 8 up to 128)")


def _padded_head_dim(d: int) -> int:
    """The split route's head dim: ``d`` zero-padded to 32, 64 or 128 (the
    kernels take it from here)."""
    return 32 if d <= 32 else 64 if d <= 64 else 128


def split_terms_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: ``x (..., D)`` as its bf16 terms
    stacked first, ``(terms, ..., Dp)``, zero past D (Dp: D padded to 32, 64
    or 128).  f32 takes three terms: term 0 is ``bf16(x)``, term k ``bf16``
    of what the terms before it leave; each subtraction is exact in f32, so
    the three sum back to ``x``.  bf16 is its own one term."""
    out, rest = [], x.float()
    for _ in range(3 if x.dtype == torch.float32 else 1):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    d = x.shape[-1]
    return torch.nn.functional.pad(torch.stack(out), (0, _padded_head_dim(d) - d))


def attended_pairs(lq: int, lk: int, *, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps, per batch row and head: key
    ``j`` reaches query ``i`` iff ``j <= i`` (causal) and ``j > i - window``
    (a window), positions counted from 0 on both sides."""
    i = np.arange(lq, dtype=np.int64)
    hi = np.minimum(lk, i + 1) if causal else np.full(lq, lk, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(lq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_cost(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int
               ) -> tuple[str, int, int]:
    """``("flash_attention", flops, bytes)`` of one call: two products of
    ``2·D`` operations for every pair the mask keeps (masked tiles skipped;
    the kernel's partly masked tiles are counted at their kept pairs), and
    q, k and v read once and the output written once."""
    b, lq, h, d = q.shape
    pairs = attended_pairs(lq, k.shape[1], causal=causal, window=window)
    return ("flash_attention", 4 * b * h * d * pairs,
            (2 * q.numel() + 2 * k.numel()) * q.element_size())


def split_kv_cost(k: torch.Tensor) -> tuple[str, int, int]:
    """``("split_kv", 0, bytes)`` of one call: f32 K and V read once, their
    three bf16 terms at the padded head dim written once."""
    terms = 3 * k.numel() // k.shape[-1] * _padded_head_dim(k.shape[-1])
    return "split_kv", 0, 2 * (k.numel() * 4 + terms * 2)


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous {like.dtype} tensor "
                         f"on {like.device}, got {t.dtype} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def split_kv(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 K and V as the split route reads them, each as
    :func:`split_terms_ref` gives it: one launch of the split kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if k.shape != v.shape:
        raise ValueError(f"split_kv: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.dtype != torch.float32:
        raise ValueError(f"split_kv: {k.dtype} is not taken (float32)")
    d = k.shape[-1]
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"split_kv: head dim {d} is not taken (a multiple of 8 up to 128)")
    if k.device.type != "meta" and pallas_interpret(k):
        return split_terms_ref(k), split_terms_ref(v)
    for name, t in (("k", k), ("v", v)):
        _check_operand(name, t, k)
    dp = _padded_head_dim(d)
    kt = torch.empty((3, *k.shape[:-1], dp), dtype=torch.bfloat16, device=k.device)
    vt = torch.empty_like(kt)
    sink = cost_sink()
    if sink is not None:
        sink.append(split_kv_cost(k))
    if k.device.type == "meta":
        return kt, vt
    fn = kernel_function("flash_attention", "repro_flash_split_kv",
                         [_VOID] * 4 + [ctypes.c_longlong, _INT, _INT, _VOID])
    with torch.cuda.device(k.device):
        err = fn(k.data_ptr(), v.data_ptr(), kt.data_ptr(), vt.data_ptr(), k.numel() // d, d, dp,
                 torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_kv: CUDA launch failed with error {err}")
    count_launch(split_kv)
    return kt, vt


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
    probabilities and sums (f64 for f64 inputs), output in ``q.dtype``; a
    fully masked row is 0."""
    _check_shapes(q, k, v)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(ct).reshape(b, lq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(ct)) * (1.0 / math.sqrt(d))
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
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(ct)) / denom.permute(0, 3, 1, 2, 4)
    return o.reshape(b, lq, h, d).to(q.dtype)


def flash_attention_emulated(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch, with every sum in f32
    and no tensor core: what the kernel would give if its products summed as
    an f32 matrix product does.  The head dim is zero-padded to 32, 64 or
    128; the softmax runs online in base 2 with log2(e) folded into the
    scale.  f32 inputs (the split route): 32-key tiles at a padded head dim
    of 128, else 64; S and P V each the six products of three-term bf16
    splits; the output in f32.  bf16 inputs (the wgmma route, and the split
    route at other head dims): 64-key tiles, S of bf16 values in f32, P
    split into bf16 hi + lo for P V; the output in bf16."""
    _check_shapes(q, k, v)
    f32 = q.dtype == torch.float32
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    dp = _padded_head_dim(d)
    bk = 32 if f32 and dp == 128 else 64
    # terms as (t, B, Hkv, group, Lq, Dp) and (t, B, Hkv, 1, Lk, Dp), in f32
    qt = split_terms_ref(q).float().reshape(-1, b, lq, hkv, h // hkv, dp).permute(0, 1, 3, 4, 2, 5)
    kt, vt = (split_terms_ref(t).float().permute(0, 1, 3, 2, 4)[:, :, :, None] for t in (k, v))
    scale_log2 = (1.0 / math.sqrt(d)) * 1.4426950408889634
    qpos = torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hkv, h // hkv, lq, 1), -math.inf, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, h // hkv, lq, dp), device=q.device)
    order = 2 if f32 else 1  # the term products kept: orders adding up to at most this
    for k0 in range(0, lk, bk):
        kpos = torch.arange(k0, min(lk, k0 + bk), device=q.device)[None, :]
        s = sum(qt[i] @ kt[j, ..., k0:k0 + bk, :].transpose(-1, -2)
                for i in range(len(qt)) for j in range(len(kt)) if i + j <= order)
        mask = torch.ones((lq, kpos.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, -math.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        mu = torch.where(mn == -math.inf, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * scale_log2 - mu)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        pt, rest = [], p
        for _ in range(3 if f32 else 2):
            pt.append(rest.to(torch.bfloat16).float())
            rest = rest - pt[-1]
        acc = acc * alpha + sum(pt[i] @ vt[j, ..., k0:k0 + bk, :]
                                for i in range(len(pt)) for j in range(len(vt)) if i + j <= order)
        m = mn
    out = (acc / lsum.clamp_min(1e-30))[..., :d].permute(0, 3, 1, 2, 4).reshape(b, lq, h, d)
    return out.to(q.dtype)


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
    """Blocked attention; returns (B, Lq, H, D) in ``q.dtype``.  Raises
    ``RuntimeError`` where autograd would record it: there is no backward
    kernel (``_build.refuse_grad``)."""
    del block_q, block_k  # the kernel's tiles are its own; results do not depend on them
    refuse_grad("flash_attention", q, k, v)
    meta = q.device.type == "meta"
    if not meta and pallas_interpret(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_shapes(q, k, v)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda" and not meta:
        raise ValueError(f"flash_attention: q lies on {q.device}; the kernel takes CUDA tensors")
    route = _route(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    tail = [1.0 / math.sqrt(d), int(bool(causal)), int(window)]
    tail_types = [ctypes.c_float, _INT, _INT]
    if route == "split":
        # f32 K and V as their terms; bf16 K and V as they are
        kt, vt = split_kv(k, v) if q.dtype == torch.float32 else (k, v)
        symbol = "repro_flash_attention_split"
        argtypes = [_VOID] * 4 + [_INT] * 7 + tail_types + [_INT, _VOID]
        args = [q.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(), b, lq, lk, h, hkv, d,
                _padded_head_dim(d), *tail, int(q.dtype == torch.bfloat16)]
    else:
        symbol = "repro_flash_attention"
        argtypes = [_VOID] * 4 + [_INT] * 6 + tail_types + [_VOID]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, h, hkv, d,
                *tail]
    if not meta:  # meta is shape-only: what the card route returns, nothing launched
        fn = kernel_function("flash_attention", symbol, argtypes)
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention: CUDA launch failed with error {err}")
        count_launch(flash_attention)
        if route == "split":
            count_launch(flash_attention, "split_launches")
    sink = cost_sink()
    if sink is not None:
        sink.append(flash_cost(q, k, causal=causal, window=window))
    return out


flash_attention.launches = 0
flash_attention.split_launches = 0
split_kv.launches = 0
