"""Mamba2 block — SSD (state-space duality) chunked form (arXiv:2405.21060).

Recurrence (per head h, head_dim P, state N):
    H_t = exp(dt_t·A_h) · H_{t-1} + dt_t · x_t ⊗ B_t          H ∈ (P, N)
    y_t = H_t · C_t + D_h · x_t

Port of ``repro/models/ssm.py``.  The chunked algorithm (``ssd_chunked``) is
the plain version of the hand-written kernel and lives beside it in
``repro_torch.kernels.ssd_scan``; the block's chunked route calls
``repro_torch.kernels.ops.ssd_scan``, which launches the kernel for CUDA
tensors and runs ``ssd_chunked`` for CPU tensors.  Where autograd records
the block (grad mode on and an SSD operand requiring a gradient, as in
``Model.loss``), the chunked route calls ``ssd_chunked`` directly: the
kernel has no backward (nor has the JAX package's), its wrapper raises
rather than return an output without a ``grad_fn``, and the reference's
block runs the jnp ``ssd_chunked`` on every route, so its gradient is that
of the plain function, as the port's is.  :func:`ssd_reference` is
the naive sequential recurrence.  The block's cache is updated in place.

Single B/C group (n_groups=1), as in the assigned configs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import Params, draw_normal, rms_norm

__all__ = [
    "init_mamba",
    "mamba_block",
    "ssd_chunked",
    "ssd_decode_step",
    "ssd_reference",
]


# ---------------------------------------------------------------------------
# SSD core (both forms operate on per-head inputs)
#   x  (B, L, NH, P)   dt (B, L, NH)   A (NH,)  negative
#   Bm (B, L, N)       Cm (B, L, N)
# ---------------------------------------------------------------------------


def ssd_decode_step(h, x_t, dt_t, a, b_t, c_t):
    """One-token recurrence for serving.  h (B,NH,P,N) → (y_t, h)."""
    decay = torch.exp(dt_t * a)[..., None, None]
    h = h * decay + (dt_t[..., None, None] * x_t[..., None]) * b_t[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c_t)
    return y, h


def ssd_reference(x, dt, a, bm, cm):
    """Naive sequential recurrence — the oracle."""
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    h = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(l):
        y, h = ssd_decode_step(h, x[:, t], dt[:, t], a, bm[:, t], cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), h               # (B,L,NH,P), final state


# ---------------------------------------------------------------------------
# the full Mamba2 block (proj → conv → SSD → gated norm → out proj)
# ---------------------------------------------------------------------------


def init_mamba(
    cfg: ModelConfig, *, generator: torch.Generator, device, dtype: torch.dtype
) -> Params:
    """Weights from the reference's distributions; projections, conv weights
    and ``ssm_D`` in ``dtype`` (every use casts them to it), the rest in f32."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    n = cfg.ssm_state
    w = cfg.ssm_conv_width
    sd = 1.0 / math.sqrt(d)
    f32 = torch.float32

    def normal(shape, scale):
        return draw_normal(shape, scale, dtype, device, generator)

    return {
        "w_in_z": normal((d, din), sd),
        "w_in_x": normal((d, din), sd),
        "w_in_b": normal((d, n), sd),
        "w_in_c": normal((d, n), sd),
        "w_in_dt": normal((d, nh), sd),
        "conv_x": normal((w, din), 1.0 / math.sqrt(w)),
        "conv_b": normal((w, n), 1.0 / math.sqrt(w)),
        "conv_c": normal((w, n), 1.0 / math.sqrt(w)),
        "A_log": torch.zeros((nh,), dtype=f32, device=device),   # A = -exp(A_log) = -1
        "ssm_D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "ssm_norm": torch.zeros((din,), dtype=f32, device=device),
        "w_out": normal((din, d), 1.0 / math.sqrt(din)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv, width W.  x (B,L,C), w (W,C).

    With ``state`` (B,W-1,C) the conv continues a stream (decode); returns
    (out, new_state) where new_state holds the last W-1 inputs.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, L+W-1, C)
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):, :]
    return F.silu(out), new_state


def mamba_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, L, D)
    *,
    cache: Params | None = None,          # {"conv": (B,W-1,Cin), "h": (B,NH,P,N)}
    use_chunked: bool = True,
) -> tuple[torch.Tensor, Params | None]:
    dt_ = x.dtype
    d = cfg.d_model
    din = cfg.ssm_expand * d
    ph = cfg.ssm_head_dim
    nh = din // ph
    n = cfg.ssm_state
    b, l, _ = x.shape

    z = x @ p["w_in_z"].to(dt_)
    xin = x @ p["w_in_x"].to(dt_)
    bm = x @ p["w_in_b"].to(dt_)
    cm = x @ p["w_in_c"].to(dt_)
    dt = x @ p["w_in_dt"].to(dt_)

    conv_in = torch.cat([xin, bm, cm], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1).to(dt_)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    xin, bm, cm = torch.split(conv_out, [din, n, n], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"]).to(dt_)
    a = (-torch.exp(p["A_log"])).to(dt_)              # (NH,)
    xh = xin.reshape(b, l, nh, ph)

    if cache is not None and l == 1:
        y, h = ssd_decode_step(
            cache["h"].to(dt_), xh[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0]
        )
        y = y[:, None]                                # (B,1,NH,P)
    elif use_chunked and l % cfg.ssm_chunk == 0 and l > cfg.ssm_chunk:
        ssd = ssd_chunked if ops.records_grad(xh, dt, a, bm, cm) else ops.ssd_scan
        y, h = ssd(
            xh.contiguous(), dt.contiguous(), a, bm.contiguous(), cm.contiguous(),
            chunk=cfg.ssm_chunk,
        )
    else:
        y, h = ssd_reference(xh, dt, a, bm, cm)

    y = y + p["ssm_D"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(b, l, din)
    y = rms_norm(y * F.silu(z), p["ssm_norm"])
    out = y @ p["w_out"].to(dt_)

    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
    return out, cache
