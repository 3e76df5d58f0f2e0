"""partition_reduce — the paper's ``compute_partition`` as one kernel launch.

Two fused partition kernels carry the histogram and k-means apps under
``SplIter(fusion="pallas")`` (or ``"auto"`` on a card).  Each takes a
partition's stacked blocks ``(nblocks, rows, d)`` — ``Partition.stacked()``
— and returns what folding the app's block function over those blocks
would.  Each is hand-written CUDA C++ for Hopper (``repro_torch/csrc``),
built with ``nvcc`` at first use and called through ctypes:

* :func:`partition_histogramdd` — d-dimensional histogram into a
  ``(bins,)*d`` int32 grid, bit-exact against summing
  :func:`histogramdd_block`-style counts per block.
* :func:`partition_kmeans` — fused Lloyd partial step: ``(sums (k, d),
  counts (k,))`` over the nearest-center assignment, with the distance
  written as ``|c|² − 2·x·c`` (the ``|x|²`` term dropped, as in the JAX
  kernel).

Beside each wrapper is its plain PyTorch version (``*_ref``), which the CPU
tests compare with the JAX package and ``chip_smoke.py`` compares with the
kernel on the card.  A wrapper runs the kernel for a CUDA tensor and the
plain version for a CPU tensor, and raises on any other device; it casts
other float types to f32, allocates outputs and scratch, launches on the
current stream without synchronising, and adds one to its ``launches``
count per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import kernel_function

__all__ = [
    "digitize_cells",
    "partition_histogramdd",
    "partition_histogramdd_ref",
    "partition_kmeans",
    "partition_kmeans_ref",
]

_THREADS = 256
#: Dynamic shared memory one CTA may opt into on Hopper (227 KB), the only
#: architecture the sources are built for.
_SMEM_OPTIN = 232_448
#: Shared memory of one SM available to resident CTAs (228 KB, 1 KB per CTA
#: reserved by the hardware).
_SMEM_PER_SM = 233_472

_VOID = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# d-dimensional histogram
# ---------------------------------------------------------------------------


def digitize_cells(x: torch.Tensor, *, bins: int, lo: float, hi: float) -> torch.Tensor:
    """Flat row-major cell id (int64) of each row of ``x`` ``(rows, d)``.

    Per dimension, ``(x - lo) / (hi - lo) * bins`` in ``x``'s float type,
    truncated toward zero and clipped to ``[0, bins - 1]`` — the JAX
    package's digitizing, bit for bit.  Two details make it so:

    * ``hi - lo`` is rounded once from a double and divided as a tensor,
      never as a Python scalar, which PyTorch's CUDA division would turn
      into a multiply by the reciprocal;
    * the scaled value is clamped to ``[-1, bins]`` before the cast, since
      PyTorch's float→int32 cast sends large values and ``±inf`` to
      ``INT_MIN`` where XLA saturates; NaN goes to bin 0 in both.
    """
    dtype = x.dtype if x.is_floating_point() else torch.float32
    width = torch.tensor(hi - lo, dtype=dtype, device=x.device)
    scaled = (x.to(dtype) - lo) / width * bins
    scaled = scaled.clamp(-1.0, float(bins)).nan_to_num(0.0)
    idx = scaled.to(torch.int64).clamp(0, bins - 1)
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for k in range(x.shape[1]):
        flat = flat * bins + idx[:, k]
    return flat


def partition_histogramdd_ref(
    stacked: torch.Tensor, *, bins: int = 8, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`partition_histogramdd`."""
    nb, rows, d = stacked.shape
    flat = digitize_cells(stacked.to(torch.float32).reshape(nb * rows, d),
                          bins=bins, lo=lo, hi=hi)
    counts = torch.zeros(bins**d, dtype=torch.int32, device=stacked.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.reshape((bins,) * d)


def partition_histogramdd(
    stacked: torch.Tensor, *, bins: int = 8, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """d-dimensional histogram of a whole partition → ``(bins,)*d`` int32.

    Equals ``sum(histogramdd_block(b) for b in blocks)`` bit-exactly — the
    contract the kernel registry requires for fused/generic interchange.
    """
    if pallas_interpret(stacked):
        return partition_histogramdd_ref(stacked, bins=bins, lo=lo, hi=hi)
    nb, rows, d = stacked.shape
    cells = bins**d
    x = stacked.to(torch.float32).contiguous()
    out = torch.zeros(cells, dtype=torch.int32, device=x.device)
    n = nb * rows
    sms = _num_sms(x.device.index)
    hist_bytes = cells * 4
    if hist_bytes <= _SMEM_OPTIN:
        per_sm = max(1, min(8, _SMEM_PER_SM // (hist_bytes + 1024)))
        shared = hist_bytes
    else:  # too large for one CTA's shared memory: add into global memory
        per_sm, shared = 8, 0
    grid = max(1, min(math.ceil(n / _THREADS), sms * per_sm))
    fn = kernel_function(
        "partition_histogramdd",
        "repro_histogramdd",
        [_VOID, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_float, _VOID, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VOID],
    )
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), n, d, bins, lo, hi - lo, out.data_ptr(), grid,
                 _THREADS, shared, _stream(x.device))
    _check("partition_histogramdd", err)
    partition_histogramdd.launches += 1
    return out.reshape((bins,) * d)


partition_histogramdd.launches = 0


# ---------------------------------------------------------------------------
# k-means partial step
# ---------------------------------------------------------------------------


def partition_kmeans_ref(
    stacked: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`partition_kmeans`, block by block
    in the JAX kernel's order.  Its products run in f32 as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (the default)."""
    c = centers.to(torch.float32)
    k, d = c.shape
    cc = torch.sum(c * c, dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=stacked.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=stacked.device)
    for blk in stacked:
        x = blk.to(torch.float32)
        d2 = cc[None, :] - 2.0 * (x @ c.T)
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), k).to(torch.float32)
        sums += onehot.T @ x
        counts += onehot.sum(dim=0)
    return sums, counts


def partition_kmeans(
    stacked: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Lloyd partial step over a partition → (sums (k,d), counts (k,))."""
    if pallas_interpret(stacked):
        return partition_kmeans_ref(stacked, centers)
    nb, rows, d = stacked.shape
    k = centers.shape[0]
    if centers.device != stacked.device or tuple(centers.shape) != (k, d):
        raise ValueError(
            f"centers {tuple(centers.shape)} on {centers.device} do not fit "
            f"rows of width {d} on {stacked.device}"
        )
    x = stacked.to(torch.float32).contiguous()
    c = centers.to(torch.float32).contiguous()
    shared_bytes = kernel_function(
        "partition_kmeans", "repro_kmeans_shared_bytes", [ctypes.c_int, ctypes.c_int]
    )(d, k)
    if shared_bytes > _SMEM_OPTIN:
        raise ValueError(f"partition_kmeans: d={d}, k={k} needs {shared_bytes} B "
                         f"of shared memory, above the {_SMEM_OPTIN} B limit")
    n = nb * rows
    sms = _num_sms(x.device.index)
    grid = max(1, min(math.ceil(n / _THREADS), sms * 8))
    part_sums = torch.empty((grid, k, d), dtype=torch.float32, device=x.device)
    part_counts = torch.empty((grid, k), dtype=torch.int32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((k,), dtype=torch.float32, device=x.device)
    fn = kernel_function(
        "partition_kmeans",
        "repro_kmeans",
        [_VOID, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VOID, _VOID, _VOID,
         _VOID, _VOID, ctypes.c_int, _VOID],
    )
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), n, d, k, c.data_ptr(), part_sums.data_ptr(),
                 part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(), grid,
                 _stream(x.device))
    _check("partition_kmeans", err)
    partition_kmeans.launches += 1
    return sums, counts


partition_kmeans.launches = 0
