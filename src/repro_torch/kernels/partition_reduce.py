"""partition_reduce — the paper's ``compute_partition`` as one kernel launch.

Two fused partition kernels carry the histogram and k-means apps under
``SplIter(fusion="pallas")`` (or ``"auto"`` on a card).  Each takes a
partition's same-shape blocks — the sequence of ``(rows, d)`` blocks that
the fused lowering passes, or one stacked ``(nblocks, rows, d)`` tensor —
and returns what folding the app's block function over those blocks
would.  The d-dimensional histogram reads the blocks where they lie; the
k-means wrapper stacks a sequence first.  A third, the 1-D value
histogram, is reached through ``repro_torch.kernels.ops`` only, as in the
JAX package.  Each is
hand-written CUDA C++ for Hopper (``repro_torch/csrc``), built with
``nvcc`` at first use and called through ctypes:

* :func:`partition_histogram` — value histogram over every element into
  ``(bins,)`` f32, with the JAX kernel's edge comparisons and outlier
  clamps as XLA rounds them, bit-exact against its plain version.
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

import array
import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels._build import count_launch, kernel_function

__all__ = [
    "digitize_cells",
    "partition_histogram",
    "partition_histogram_ref",
    "partition_histogramdd",
    "partition_histogramdd_ref",
    "partition_kmeans",
    "partition_kmeans_ref",
]

_THREADS = 256
#: Rows per tile of the k-means kernel (two per consumer thread).
_KMEANS_TILE = 256
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
    """The current CUDA stream of ``device`` as a raw handle (a fraction of
    the host time of ``torch.cuda.current_stream(device).cuda_stream``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _on(device: torch.device):
    """A guard that makes ``device`` current, or none where it already is."""
    return contextlib.nullcontext() if device.index == torch.cuda.current_device() \
        else torch.cuda.device(device)


# ---------------------------------------------------------------------------
# 1-D value histogram
# ---------------------------------------------------------------------------


def _hist_thresholds(bins: int, lo: float, hi: float) -> tuple[float, float, float, float, float]:
    """``(lo, width, upper0, first_below, last_from)`` in f32, as XLA rounds
    the JAX kernel's scalars: ``width = (hi - lo) / bins`` in double, rounded
    once; ``upper0 = f32(f32(lo) + width)``, the constant XLA folds out of
    the upper edge ``(lo + width*j) + width`` when it reassociates it into
    ``width*j + upper0``; the two clamp thresholds ``lo + width`` and
    ``hi - width`` computed in double and rounded once."""
    if bins < 2:
        raise ValueError(f"partition_histogram needs bins >= 2, got {bins}")
    width = (hi - lo) / bins
    lo_f, width_f, first_below, last_from = torch.tensor(
        [lo, width, lo + width, hi - width], dtype=torch.float32)
    upper0 = lo_f + width_f
    return tuple(float(t) for t in (lo_f, width_f, upper0, first_below, last_from))


def _flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values as 0: XLA on the CPU (and the TPU) reads subnormal
    inputs as zero, and so do the kernels and their plain versions."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, torch.zeros_like(t), t)


#: Elements per one-hot slice of the plain value histogram (a bounded
#: ``(slice, bins)`` boolean temporary).
_REF_SLICE = 1 << 21


def partition_histogram_ref(
    stacked: torch.Tensor, *, bins: int = 128, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`partition_histogram`: the JAX kernel's
    one-hot over every bin, ``_REF_SLICE`` elements at a time.

    Edge ``j`` is ``lo + width * j`` and its upper edge ``width * j +
    upper0`` in f32 (multiply, then add; see :func:`_hist_thresholds`); a
    value counts in every bin ``j`` with ``e_j <= x < upper_j``, and also in
    bin 0 when ``x < lo + width`` and in the last bin when ``x >= hi -
    width``.  Subnormal values and edges compare as 0.  A NaN counts
    nowhere.  Counts are exact integers returned as f32.
    """
    lo_f, width_f, upper0, first_below, last_from = _hist_thresholds(bins, lo, hi)
    dev = stacked.device
    x = _flush_subnormal(stacked.to(torch.float32).reshape(-1))
    jw = torch.tensor(width_f, device=dev) * torch.arange(bins, dtype=torch.float32, device=dev)
    edges = _flush_subnormal(jw + torch.tensor(lo_f, device=dev))
    upper = _flush_subnormal(jw + torch.tensor(upper0, device=dev))
    first = torch.zeros(bins, dtype=torch.bool, device=dev)
    first[0] = True
    last = torch.zeros(bins, dtype=torch.bool, device=dev)
    last[-1] = True
    counts = torch.zeros(bins, dtype=torch.int64, device=dev)
    for xs in x.split(_REF_SLICE):
        xc = xs[:, None]
        onehot = (xc >= edges) & (xc < upper)
        onehot |= (xc < first_below) & first
        onehot |= (xc >= last_from) & last
        counts += onehot.sum(dim=0)
    return counts.to(torch.float32)


#: CTAs of the value histogram resident per SM: 6 x 256 threads x two
#: 16-byte loads keep 48 KB in flight per SM.
_HIST_CTAS_PER_SM = 6
#: Values each CTA of the value histogram loads per step (256 threads x 2 x float4).
_HIST_CHUNK = _THREADS * 8


def _histogram_plan(bins: int) -> tuple[int, int]:
    """``(sub-histograms, shared bytes)`` per CTA of the value-histogram
    kernel: two f32 bounds per bin and one int32 sub-histogram per warp (8),
    fewer where that many do not fit (up to 19,370 bins fit one)."""
    copies = min(_THREADS // 32, _SMEM_OPTIN // (4 * bins) - 2)
    if copies < 1:
        raise ValueError(f"partition_histogram: {bins} bins exceed one CTA's shared memory")
    return copies, 4 * bins * (2 + copies)


@functools.cache
def _hist_kernel_scalars(bins: int, lo: float, hi: float) -> tuple[float, ...]:
    """The kernel's f32 scalars ``(lo, width, 1 / width, upper0, first_below,
    last_from)``; ``1 / width`` (0 where width <= 0) only places the guess."""
    lo_f, width_f, upper0, first_below, last_from = _hist_thresholds(bins, lo, hi)
    inv_width = float(torch.tensor(1.0) / torch.tensor(width_f)) if width_f > 0 else 0.0
    return lo_f, width_f, inv_width, upper0, first_below, last_from


@functools.cache
def _histogram_fn():
    return kernel_function(
        "partition_histogram",
        "repro_histogram",
        [_VOID, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 6
        + [_VOID, _VOID, ctypes.c_int, ctypes.c_int, _VOID],
    )


def partition_histogram(
    stacked: torch.Tensor, *, bins: int = 128, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Value histogram over every element of a partition → ``(bins,)`` f32."""
    if pallas_interpret(stacked):
        return partition_histogram_ref(stacked, bins=bins, lo=lo, hi=hi)
    scalars = _hist_kernel_scalars(bins, lo, hi)
    copies, shared = _histogram_plan(bins)
    x = stacked.to(torch.float32).contiguous()
    # the f32 result, then the kernel's int32 counts and its ticket
    buf = torch.empty(2 * bins + 1, dtype=torch.float32, device=x.device)
    n = x.numel()
    per_sm = max(1, min(_HIST_CTAS_PER_SM, _SMEM_PER_SM // (shared + 1024)))
    grid = max(1, min(math.ceil(n / _HIST_CHUNK), _num_sms(x.device.index) * per_sm))
    with torch.cuda.device(x.device):
        err = _histogram_fn()(x.data_ptr(), n, bins, copies, *scalars,
                              buf.data_ptr() + 4 * bins, buf.data_ptr(), grid, shared,
                              _stream(x.device))
    _check("partition_histogram", err)
    count_launch(partition_histogram)
    return buf[:bins]


partition_histogram.launches = 0


# ---------------------------------------------------------------------------
# d-dimensional histogram
# ---------------------------------------------------------------------------


def _blocks_of(operand) -> tuple[torch.Tensor, list[torch.Tensor] | None]:
    """``(first block, blocks)`` of a partition kernel's operand: a stacked
    ``(nblocks, rows, *row)`` tensor (``blocks`` None) or a non-empty
    sequence of same-shape blocks."""
    if isinstance(operand, torch.Tensor):
        return operand, None
    blocks = list(operand)
    if not blocks:
        raise ValueError("a partition kernel needs at least one block")
    return blocks[0], blocks


@functools.cache
def _digitize_scalars(lo: float, hi: float, bins: int,
                      dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """``(lo, C)`` in ``dtype`` as XLA computes the reference's ``(x - lo) /
    (hi - lo) * bins``: it folds the two constants into one multiply, ``(x -
    lo) * C`` with ``C = fl(fl(1 / fl(hi - lo)) * bins)`` (``hi - lo``
    summed in double, then each step rounded to ``dtype``).  A subnormal
    ``lo`` reads as 0."""
    lo_t = _flush_subnormal(torch.tensor(lo, dtype=dtype))
    recip = torch.tensor(1.0, dtype=dtype) / torch.tensor(hi - lo, dtype=dtype)
    return float(lo_t), float(recip * torch.tensor(bins, dtype=dtype))


def digitize_cells(x: torch.Tensor, *, bins: int, lo: float, hi: float) -> torch.Tensor:
    """Flat row-major cell id (int64) of each row of ``x`` ``(rows, d)``.

    Per dimension, ``(x - lo) / (hi - lo) * bins`` in ``x``'s float type,
    truncated toward zero and clipped to ``[0, bins - 1]`` — the JAX
    package's digitizing under ``jit``, bit for bit.  Three details make it
    so:

    * XLA folds the division and the multiply into one multiply by a
      constant (:func:`_digitize_scalars`), which can round a value within
      an ulp of a bin edge to the other side of a true division;
    * the scaled value is clamped to ``[-1, bins]`` before the cast, since
      PyTorch's float→int32 cast sends large values and ``±inf`` to
      ``INT_MIN`` where XLA saturates; NaN goes to bin 0 in both;
    * subnormal inputs read as 0, as XLA reads them.
    """
    dtype = x.dtype if x.is_floating_point() else torch.float32
    lo_f, scale = _digitize_scalars(lo, hi, bins, dtype)
    scaled = (_flush_subnormal(x.to(dtype)) - lo_f) * scale
    scaled = scaled.clamp(-1.0, float(bins)).nan_to_num(0.0)
    idx = scaled.to(torch.int64).clamp(0, bins - 1)
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for k in range(x.shape[1]):
        flat = flat * bins + idx[:, k]
    return flat


def partition_histogramdd_ref(
    blocks, *, bins: int = 8, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`partition_histogramdd`: the counts of
    :func:`digitize_cells` over a stacked ``(nblocks, rows, d)`` tensor, or
    over a sequence of ``(rows, d)`` blocks one block at a time."""
    first, seq = _blocks_of(blocks)
    d = first.shape[-1]
    counts = torch.zeros(bins**d, dtype=torch.int32, device=first.device)
    for b in [first.reshape(-1, d)] if seq is None else seq:
        flat = digitize_cells(b.to(torch.float32), bins=bins, lo=lo, hi=hi)
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.reshape((bins,) * d)


#: Block pointers a launch carries in its parameters; a partition of more
#: blocks passes them in a device table.
_HISTDD_MAX_BLOCKS = 256
#: Bytes of rows per ring stage the tile size aims at, and ring stages.
_HISTDD_TILE_BYTES = 16_384
_HISTDD_STAGES = 4
#: Largest histogram slice (bytes) one CTA of a cluster holds, and CTAs per
#: SM the grid aims at.
_HISTDD_SLICE_BYTES = 65_536
_HISTDD_CTAS_PER_SM = 2


@functools.cache
def _histdd_fn():
    return kernel_function(
        "partition_histogramdd",
        "repro_histogramdd",
        [_VOID, _VOID, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 2 + [_VOID] + [ctypes.c_int] * 8 + [_VOID],
    )


@functools.cache
def _histdd_plan(d: int, bins: int, index: int) -> tuple[int, ...]:
    """``(cluster, slice_log2, tile_rows, stage_bytes, smem, grid)`` of the
    kernel for ``(d, bins)`` on device ``index``.

    Tiles of ``_HISTDD_TILE_BYTES`` (32 to 512 rows, a multiple of 32) in a
    ring of ``_HISTDD_STAGES``.  The histogram is split across the smallest
    cluster (1, 2, 4 or 8 CTAs) whose slices (a power of two of cells each)
    take at most ``_HISTDD_SLICE_BYTES``; where even 8 would not fit beside
    the ring, the counts go to global memory (``slice_log2 = -1``).  The
    grid is what the card holds at once, at most ``_HISTDD_CTAS_PER_SM``
    per SM, in whole clusters.
    """
    cells = bins**d
    tile_rows = max(32, min(512, _HISTDD_TILE_BYTES // (4 * d) // 32 * 32))
    stage_bytes = -(-(tile_rows * 4 * d + 32) // 128) * 128
    smem_bytes = kernel_function("partition_histogramdd", "repro_histogramdd_smem_bytes",
                                 [ctypes.c_int] * 3)
    max_ctas = kernel_function("partition_histogramdd", "repro_histogramdd_max_ctas",
                               [ctypes.c_int] * 2)
    cluster, slice_log2 = 1, -1
    for c in (1, 2, 4, 8):
        log2 = max(0, math.ceil(cells / c) - 1).bit_length()
        fits = smem_bytes(_HISTDD_STAGES, stage_bytes, 1 << log2) <= _SMEM_OPTIN
        if fits and (4 << log2 <= _HISTDD_SLICE_BYTES or c == 8):
            cluster, slice_log2 = c, log2
            break
    smem = smem_bytes(_HISTDD_STAGES, stage_bytes, 0 if slice_log2 < 0 else 1 << slice_log2)
    if smem > _SMEM_OPTIN:
        raise ValueError(f"partition_histogramdd: rows of {d} values need {smem} B of shared "
                         f"memory, above the {_SMEM_OPTIN} B limit")
    with torch.cuda.device(index):
        fit = max_ctas(cluster, smem)
    if fit < cluster:
        raise RuntimeError(f"partition_histogramdd: no cluster of {cluster} CTAs with {smem} B "
                           f"of shared memory fits the card (CUDA error {-fit})")
    grid = min(fit, _HISTDD_CTAS_PER_SM * _num_sms(index)) // cluster * cluster
    return cluster, slice_log2, tile_rows, stage_bytes, smem, max(grid, cluster)


def partition_histogramdd(
    blocks, *, bins: int = 8, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """d-dimensional histogram of a whole partition → ``(bins,)*d`` int32.

    ``blocks`` is the partition's same-shape ``(rows, d)`` blocks, which the
    kernel reads where they lie, or one stacked ``(nblocks, rows, d)``
    tensor.  Equals ``sum(histogramdd_block(b) for b in blocks)``
    bit-exactly — the contract the kernel registry requires for
    fused/generic interchange.  Blocks of another float type are cast to
    f32 (a copy of each), as the reference casts them.
    """
    first, seq = _blocks_of(blocks)
    if pallas_interpret(first):
        return partition_histogramdd_ref(blocks, bins=bins, lo=lo, hi=hi)
    dev = first.device
    if seq is None:  # one stacked tensor: one block of all its rows
        if first.dim() != 3:
            raise ValueError(f"a stacked partition is (nblocks, rows, d), not {tuple(first.shape)}")
        seq = [first.reshape(-1, first.shape[-1])]
    shape = seq[0].shape
    if len(shape) != 2:
        raise ValueError(f"blocks are (rows, d), not {tuple(shape)}")
    rows, d = shape
    index = dev.index
    # one pass over the blocks on the main path: the host's time per call
    if not all(b.dtype is torch.float32 and b.is_contiguous() and b.shape == shape
               and b.get_device() == index for b in seq):
        seq = [b.to(torch.float32).contiguous() for b in seq]
        if not all(b.shape == shape and b.get_device() == index for b in seq):
            raise ValueError("partition_histogramdd: the blocks differ in shape or device: "
                             f"{[(tuple(b.shape), str(b.device)) for b in seq]}")
    ptrs = array.array("Q", [b.data_ptr() for b in seq])
    lo_f, scale = _digitize_scalars(lo, hi, bins)
    cluster, slice_log2, tile_rows, stage_bytes, smem, grid = _histdd_plan(d, bins, index)
    cells = bins**d
    out = torch.empty(cells, dtype=torch.int32, device=dev)
    table = None
    if len(ptrs) > _HISTDD_MAX_BLOCKS:  # a device table, copied without a synchronise
        table = torch.frombuffer(ptrs, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    with _on(dev):
        err = _histdd_fn()(
            None if table is not None else ptrs.buffer_info()[0],
            None if table is None else table.data_ptr(), len(ptrs), rows, d, bins, lo_f, scale,
            out.data_ptr(), cells, cluster, slice_log2, tile_rows, _HISTDD_STAGES, stage_bytes,
            grid, smem, _stream(dev))
    _check("partition_histogramdd", err)
    count_launch(partition_histogramdd)
    return out.reshape((bins,) * d)


partition_histogramdd.launches = 0


# ---------------------------------------------------------------------------
# k-means partial step
# ---------------------------------------------------------------------------


def partition_kmeans_ref(
    blocks, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`partition_kmeans`, block by block
    in the JAX kernel's order, over a stacked ``(nblocks, rows, d)`` tensor
    or a sequence of ``(rows, d)`` blocks.  Its products run in f32 as long
    as ``torch.backends.cuda.matmul.allow_tf32`` stays False (the default)."""
    first, _ = _blocks_of(blocks)
    c = centers.to(torch.float32)
    k, d = c.shape
    cc = torch.sum(c * c, dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=first.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=first.device)
    for blk in blocks:
        x = blk.to(torch.float32)
        d2 = cc[None, :] - 2.0 * (x @ c.T)
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), k).to(torch.float32)
        sums += onehot.T @ x
        counts += onehot.sum(dim=0)
    return sums, counts


#: CTAs of the k-means kernel resident per SM where shared memory allows: the
#: minimum of its ``__launch_bounds__``, which caps its registers to fit them.
_KMEANS_CTAS_PER_SM = 3


@functools.cache
def _kmeans_fn():
    return kernel_function(
        "partition_kmeans",
        "repro_kmeans",
        [_VOID, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VOID, _VOID, _VOID, _VOID,
         _VOID, ctypes.c_int, ctypes.c_int, _VOID],
    )


@functools.cache
def _kmeans_plan(d: int, k: int) -> tuple[int, int]:
    """``(shared bytes, CTAs per SM)`` of the k-means kernel for ``(d, k)``."""
    smem = kernel_function("partition_kmeans", "repro_kmeans_shared_bytes",
                           [ctypes.c_int] * 2)(d, k)
    if smem > _SMEM_OPTIN:
        raise ValueError(f"partition_kmeans: d={d}, k={k} needs {smem} B of shared memory, "
                         f"above the {_SMEM_OPTIN} B limit")
    return smem, min(_KMEANS_CTAS_PER_SM, _SMEM_PER_SM // (smem + 1024))


def partition_kmeans(
    blocks, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Lloyd partial step over a partition → (sums (k,d), counts (k,)).

    ``blocks`` is a stacked ``(nblocks, rows, d)`` tensor or a sequence of
    same-shape ``(rows, d)`` blocks, which the wrapper stacks (a copy) before
    the launch.
    """
    first, seq = _blocks_of(blocks)
    if pallas_interpret(first):
        return partition_kmeans_ref(blocks, centers)
    stacked = first if seq is None else torch.stack(seq)
    nb, rows, d = stacked.shape
    k = centers.shape[0]
    if centers.device != stacked.device or tuple(centers.shape) != (k, d):
        raise ValueError(
            f"centers {tuple(centers.shape)} on {centers.device} do not fit "
            f"rows of width {d} on {stacked.device}"
        )
    x = stacked.to(torch.float32).contiguous()
    c = centers.to(torch.float32).contiguous()
    smem, per_sm = _kmeans_plan(d, k)
    n = nb * rows
    grid = max(1, min(math.ceil(n / _KMEANS_TILE), _num_sms(x.device.index) * per_sm))
    # sums (k, d) and counts (k,), then the per-CTA partials: (grid, k, d) f32
    # sums and (grid, k) int32 counts
    kd1 = k * (d + 1)
    buf = torch.empty((grid + 1) * kd1, dtype=torch.float32, device=x.device)
    base = buf.data_ptr()
    with torch.cuda.device(x.device):
        err = _kmeans_fn()(x.data_ptr(), n, d, k, c.data_ptr(), base + 4 * kd1,
                           base + 4 * (kd1 + grid * k * d), base, base + 4 * k * d, grid, smem,
                           _stream(x.device))
    _check("partition_kmeans", err)
    count_launch(partition_kmeans)
    return buf[:k * d].view(k, d), buf[k * d:kd1]


partition_kmeans.launches = 0
