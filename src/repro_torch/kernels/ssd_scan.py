"""ssd_scan — Mamba2's chunked SSD over a whole sequence, one kernel launch.

Hand-written CUDA C++ for Hopper (``repro_torch/csrc/ssd_scan.cu``), built
with ``nvcc`` at first use and called through ctypes.  It replaces the JAX
package's Pallas kernel (``repro/kernels/ssd_scan.py``): one CTA per
(batch, pair of heads) walks the chunks in order, computes each chunk's
``C·Bᵀ`` once for both heads, runs the four products on the tensor cores
(``mma.sync``, f32 factors split into bf16 hi + lo) and keeps each head's
``(P, N)`` state in f32 in registers.

Beside it is :func:`ssd_chunked`, its plain PyTorch version (the paper's
Algorithm 1, as ``repro.models.ssm.ssd_chunked``), which the model's CPU
route and the CPU tests run and ``chip_smoke.py`` compares with the kernel.

The wrapper takes ``chunk`` for the JAX signature: the plain version chunks
by it, the kernel by its own 64 rows; the results do not depend on it.  On
either device it raises where an operand requires a gradient under grad
mode: no backward kernel exists (nor in the JAX package), and an output
filled through ctypes would drop the gradient without a word.

Given ``meta`` tensors the wrapper checks its operands as for the card and
returns outputs of the kernel's shapes and types, launching nothing; on the
card and on ``meta`` each call reports :func:`ssd_cost` to the thread's cost
sink (``_build.recording_costs``), which the dry-run's counter adds.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import cost_sink, count_launch, kernel_function, refuse_grad

__all__ = ["ssd_chunked", "ssd_cost", "ssd_scan"]

_VOID = ctypes.c_void_p
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128
_KERNEL_CHUNK = 64  # the kernel's rows per chunk


def ssd_cost(x: torch.Tensor, bm: torch.Tensor) -> tuple[str, int, int]:
    """``("ssd_scan", flops, bytes)`` of one call, the function's work at
    the kernel's 64-row chunks: ``C·Bᵀ`` once per batch row and chunk (every
    head shares it), then per head the decayed ``(C·Bᵀ)·x``, ``C·h`` and the
    state update, causal halves of the chunk's square only, each product
    taking an f32 factor split into bf16 hi + lo (two products); x, dt, a,
    B and C read once, y (x's type) and the f32 state written once."""
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    q = _KERNEL_CHUNK
    tri = q * (q + 1) // 2
    mac = b * math.ceil(l / q) * (tri * n + nh * 2 * (tri * p + 2 * q * p * n))
    size = x.element_size()
    nbytes = (2 * x.numel() + b * l * nh + nh + 2 * b * l * n) * size + b * nh * p * n * 4
    return "ssd_scan", 2 * mac, nbytes


def ssd_chunked(x, dt, a, bm, cm, *, chunk: int):
    """Chunked SSD (the paper's Algorithm 1) in the inputs' type.

    x (B,L,NH,P), dt (B,L,NH), a (NH,), bm/cm (B,L,N) →
    (y (B,L,NH,P), final_state (B,NH,P,N)).  Requires ``L % chunk == 0``.
    """
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    q = chunk
    if l % q:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {q}")
    nc = l // q

    xc = x.reshape(b, nc, q, nh, p)
    dtc = dt.reshape(b, nc, q, nh)
    bc = bm.reshape(b, nc, q, n)
    cc = cm.reshape(b, nc, q, n)

    da = dtc * a                                   # (B,NC,Q,NH) log-decay
    seg = torch.cumsum(da, dim=2)                  # inclusive cumsum in-chunk

    # ---- intra-chunk (quadratic attention-like form) ----
    li = seg[:, :, :, None, :]                     # (B,NC,Q,1,NH)
    lj = seg[:, :, None, :, :]                     # (B,NC,1,Q,NH)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    gam = torch.exp(torch.where(mask, li - lj, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)   # (B,NC,Q,Q)
    w = cb[..., None] * gam                        # (B,NC,Q,Q,NH)
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w, dtc, xc)

    # ---- chunk states ----
    tail = torch.exp(seg[:, :, -1:, :] - seg)      # (B,NC,Q,NH)
    st = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", tail, dtc, xc, bc)

    # ---- inter-chunk scan over chunk boundary states ----
    chunk_decay = torch.exp(torch.sum(da, dim=2))  # (B,NC,NH)
    h = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)                             # the state ENTERING chunk c
        h = h * chunk_decay[:, c, :, None, None] + st[:, c]
    h_in = torch.stack(h_in, dim=1)                # (B,NC,NH,P,N)

    # ---- inter-chunk contribution to outputs ----
    into = torch.exp(seg)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", cc, into, h_in)

    y = (y_intra + y_inter).reshape(b, l, nh, p)
    return y, h


def ssd_scan(
    x: torch.Tensor,   # (B, L, NH, P)
    dt: torch.Tensor,  # (B, L, NH)
    a: torch.Tensor,   # (NH,) negative
    bm: torch.Tensor,  # (B, L, N)
    cm: torch.Tensor,  # (B, L, N)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD; returns (y (B,L,NH,P) in ``x.dtype``, final state (B,NH,P,N) f32).
    Raises ``RuntimeError`` where autograd would record it: there is no
    backward kernel (``_build.refuse_grad``)."""
    refuse_grad("ssd_scan", x, dt, a, bm, cm)
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, l)
    if l % q:  # the JAX signature's contract, kept on both routes
        raise ValueError(f"sequence length {l} is not a multiple of chunk {q}")
    meta = x.device.type == "meta"
    if not meta and pallas_interpret(x):
        y, h = ssd_chunked(x, dt, a, bm, cm, chunk=q)
        return y, h.to(torch.float32)
    shapes = {"dt": (b, l, nh), "a": (nh,), "bm": (b, l, n), "cm": (b, l, n)}
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bm", bm), ("cm", cm)):
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)}, expected {shapes[name]}")
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous, {x.dtype}, on {x.device}; "
                             f"got {t.dtype} on {t.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    if not (1 <= p <= _MAX_P and 1 <= n <= _MAX_N):
        raise ValueError(f"ssd_scan: head dim {p} (max {_MAX_P}) or state {n} (max {_MAX_N})")
    y = torch.empty_like(x)
    h = torch.empty((b, nh, p, n), dtype=torch.float32, device=x.device)
    sink = cost_sink()
    if sink is not None:
        sink.append(ssd_cost(x, bm))
    if meta:  # shape-only: what the card route returns, nothing launched
        return y, h
    fn = kernel_function(
        "ssd_scan", "repro_ssd_scan", [_VOID] * 7 + [ctypes.c_int] * 6 + [_VOID],
    )
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                 y.data_ptr(), h.data_ptr(), b, l, nh, p, n, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err}")
    count_launch(ssd_scan)
    return y, h


ssd_scan.launches = 0
