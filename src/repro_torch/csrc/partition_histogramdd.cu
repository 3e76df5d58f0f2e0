// partition_histogramdd: d-dimensional histogram of one partition's rows,
// read from the partition's blocks where they lie.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_histogramdd (_histdd_kernel), which digitizes each row per
// dimension, forms a row-major flat cell id and accumulates a one-hot
// matmul into a bins**d accumulator held in VMEM across the partition's
// blocks.
//
// What bounds it on an H100: memory.  It reads n*d*4 bytes once and writes
// bins**d*4; the arithmetic is a few operations per value.  A one-hot matmul
// would spend n*bins**d operations to add n ones, so the kernel scatters
// integer adds instead, which are exact in any order: the counts are the
// same on every run.  The design:
//
// * The blocks are read in place.  The kernel takes each block's base
//   pointer (by value in the launch's parameters for up to kMaxBlocks
//   blocks, else from a device table) and the rows per block; every block
//   of a call has one shape.  No stacked copy of the partition is made.
// * Bytes in flight that do not depend on resident warps: a persistent grid
//   in which each CTA walks one contiguous range of row tiles (a tile never
//   crosses a block).  A producer warp keeps a ring of tiles in shared
//   memory filled by the copy engine (1-D bulk copies, full/empty
//   mbarriers), so several tiles per CTA are in flight while the consumer
//   warps bin the one that has arrived.  A tile is copied from the 16-byte
//   boundary at or below its first byte to the one at or above its last, so
//   a block at any 4-byte-aligned address and the ragged last tile of a
//   block take the same copy; rows then start `shift` floats into the stage.
// * Binning as XLA computes it: the reference writes (x - lo) / (hi - lo) *
//   bins, and XLA folds the two constants into one, (x - lo) * C with C =
//   f32(f32(1 / f32(hi - lo)) * bins) (the host computes C the same way).
//   So a value costs a subtract and a multiply (__fsub_rn, __fmul_rn: no
//   contraction into an FMA), a clamp to [0, bins - 1] in float (NaN -> 0,
//   +-inf and huge values to the end bins, as XLA's saturating conversion
//   and the clip give) and a truncation.  Subnormal inputs read as 0, as
//   XLA reads them.  Rows are binned two at a time with every value's
//   arithmetic before any add, so the chains of a thread overlap.
// * A histogram small enough for several CTAs per SM: a thread-block
//   cluster of `cluster` CTAs splits one histogram across its distributed
//   shared memory (CTA r holds cells [r*slice, (r+1)*slice)), so each CTA
//   keeps bins**d / cluster int32 counts and the cluster adds into its
//   peers' slices with shared-memory atomics.  The merge then adds each
//   cluster's non-zero cells into the output with one global atomic each,
//   once per cluster instead of once per CTA.  Where even a cluster's
//   slices do not fit (up to the registry's 2**20 cells), the counts go
//   straight into global memory with atomics, from the same tiles and the
//   same binning.  The wrapper (kernels/partition_reduce.py, _histdd_plan)
//   takes the smallest cluster whose slices fit 64 KiB and two CTAs per SM:
//   at the main path's 8**5 cells, clusters of 2; one CTA per SM holding
//   the whole histogram, and clusters of 4 or 8, were slower on an H100.
//
// One call is one memset of the output and one launch.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int kMaxBlocks = 256;  // block pointers passed by value
constexpr int kWarps = 8;        // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Args {
  const float* ptr[kMaxBlocks];  // block base pointers, when nblocks <= kMaxBlocks
  const float* const* table;     // device table of block pointers otherwise
  long long rows;                // rows per block
  long long tiles_per_block;
  int nblocks, d, bins, cells;
  float lo, scale;               // scale = C, the folded f32(1 / width) * bins
  int global;                    // 1: counts into global memory
  int cluster, slice_log2;       // CTAs per cluster; cells per CTA = 1 << slice_log2
  int tile_rows, stages, stage_bytes;
};

// Byte offsets of the dynamic shared memory.
struct Layout {
  int hist, ring, total;
};

__host__ __device__ inline Layout layout(int stages, int stage_bytes, int slice) {
  Layout l;
  l.hist = round_up(2 * stages * 8, 16);  // full and empty barriers first
  l.ring = round_up(l.hist + slice * 4, 128);
  l.total = l.ring + stages * stage_bytes;
  return l;
}

__device__ __forceinline__ const float* block_base(const Args& a, long long b) {
  if (a.nblocks <= kMaxBlocks) return a.ptr[b];
  return reinterpret_cast<const float*>(
      __ldg(reinterpret_cast<const unsigned long long*>(a.table) + b));
}

// The reference's bin of x: clip(trunc((x - lo) * C), 0, bins - 1).
__device__ __forceinline__ int bin_of(float x, float lo, float scale, int bins) {
  const float v = fabsf(x) < 1.17549435e-38f ? 0.0f : x;  // subnormals read as 0
  const float s = __fmul_rn(__fsub_rn(v, lo), scale);
  return __float2int_rz(fminf(fmaxf(s, 0.0f), static_cast<float>(bins - 1)));  // NaN -> 0
}

// The flat cells of two rows of D values each (D = 0: a.d values).
template <int D>
__device__ __forceinline__ void cells_of(const float* r0, const float* r1, const Args& a,
                                         int& c0, int& c1) {
  const int d = D > 0 ? D : a.d;
  c0 = c1 = 0;
#pragma unroll
  for (int k = 0; k < d; ++k) {
    const int i0 = bin_of(r0[k], a.lo, a.scale, a.bins);
    const int i1 = bin_of(r1[k], a.lo, a.scale, a.bins);
    c0 = c0 * a.bins + i0;
    c1 = c1 * a.bins + i1;
  }
}

// Adds one to a cell: in global memory, in this CTA's histogram, or in the
// cluster peer's slice that holds it.
struct Counter {
  int* out;
  int* hist;
  int mode;  // 0: global, 1: this CTA, 2: cluster
  int slice_log2;

  __device__ __forceinline__ void add(int cell) const {
    if (mode == 0) {
      atomicAdd(out + cell, 1);
    } else if (mode == 1) {
      atomicAdd(hist + cell, 1);
    } else {
      int* peer = cg::this_cluster().map_shared_rank(hist, cell >> slice_log2);
      atomicAdd(peer + (cell & ((1 << slice_log2) - 1)), 1);
    }
  }
};

// The consumer warps' loop over this CTA's tiles: rows tid and tid +
// kConsumers of each pass, two rows a thread at once.
template <int D>
__device__ __forceinline__ void consume(const Args& a, const Counter& counter, uint64_t* full,
                                       uint64_t* empty, const unsigned char* ring,
                                       long long first_tile, long long end_tile) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int d = D > 0 ? D : a.d;
  const long long row_bytes = 4LL * d;
  for (long long tile = first_tile; tile < end_tile; ++tile) {
    const int i = static_cast<int>(tile - first_tile), s = i % a.stages;
    const long long b = tile / a.tiles_per_block;
    const long long r0 = (tile - b * a.tiles_per_block) * a.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(a.tile_rows), a.rows - r0));
    const uintptr_t start = reinterpret_cast<uintptr_t>(block_base(a, b)) + r0 * row_bytes;
    const float* xt =
        reinterpret_cast<const float*>(ring + s * a.stage_bytes) + ((start & 15) >> 2);
    mbar_wait(&full[s], (i / a.stages) & 1);
    for (int r = tid; r < rows; r += 2 * kConsumers) {
      const bool two = r + kConsumers < rows;
      const float* row0 = xt + r * d;
      int c0, c1;
      cells_of<D>(row0, two ? row0 + kConsumers * d : row0, a, c0, c1);
      counter.add(c0);
      if (two) counter.add(c1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with stage s
  }
}

__global__ void __launch_bounds__(kThreads)
histdd_kernel(const __grid_constant__ Args a, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slice = a.global ? 0 : 1 << a.slice_log2;
  const Layout l = layout(a.stages, a.stage_bytes, slice);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  int* hist = reinterpret_cast<int*>(smem + l.hist);
  unsigned char* ring = smem + l.ring;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool clustered = !a.global && a.cluster > 1;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  for (int c = tid; c < slice; c += kThreads) hist[c] = 0;
  // every slice of the cluster is zeroed before any CTA adds into it
  if (clustered) cg::this_cluster().sync();
  else __syncthreads();

  const long long ntiles = a.tiles_per_block * a.nblocks;
  const long long first_tile = ntiles * blockIdx.x / gridDim.x;
  const long long end_tile = ntiles * (blockIdx.x + 1) / gridDim.x;
  if (warp == kWarps) {
    const long long row_bytes = 4LL * a.d;
    if (lane == 0) {  // producer: tile i into stage i % stages once it is free
      for (long long tile = first_tile; tile < end_tile; ++tile) {
        const int i = static_cast<int>(tile - first_tile), s = i % a.stages;
        if (i >= a.stages) mbar_wait(&empty[s], (i / a.stages - 1) & 1);
        const long long b = tile / a.tiles_per_block;
        const long long r0 = (tile - b * a.tiles_per_block) * a.tile_rows;
        const long long rows = min(static_cast<long long>(a.tile_rows), a.rows - r0);
        const uintptr_t base = reinterpret_cast<uintptr_t>(block_base(a, b));
        const uintptr_t from = (base + r0 * row_bytes) & ~uintptr_t(15);
        const uintptr_t to = (base + (r0 + rows) * row_bytes + 15) & ~uintptr_t(15);
        const uint32_t bytes = static_cast<uint32_t>(to - from);
        mbar_expect_tx(&full[s], bytes);
        bulk_load(ring + s * a.stage_bytes, reinterpret_cast<const void*>(from), bytes, &full[s]);
      }
    }
    __syncwarp();
  } else {
    const Counter counter{out, hist, a.global ? 0 : clustered ? 2 : 1, a.slice_log2};
    switch (a.d) {
#define REPRO_CONSUME(D)                                                                  \
  case D:                                                                                 \
    consume<D>(a, counter, full, empty, ring, first_tile, end_tile);                    \
    break;
      REPRO_CONSUME(1)
      REPRO_CONSUME(2)
      REPRO_CONSUME(3)
      REPRO_CONSUME(4)
      REPRO_CONSUME(5)
      REPRO_CONSUME(6)
      REPRO_CONSUME(7)
      REPRO_CONSUME(8)
#undef REPRO_CONSUME
      default:
        consume<0>(a, counter, full, empty, ring, first_tile, end_tile);
    }
  }

  if (a.global) return;
  // every add of the cluster has landed; no CTA reads a peer's slice after this
  if (clustered) cg::this_cluster().sync();
  else __syncthreads();
  const int rank = clustered ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int base_cell = rank * slice;
  for (int c = tid; c < slice && base_cell + c < a.cells; c += kThreads) {
    const int v = hist[c];
    if (v != 0) atomicAdd(out + base_cell + c, v);
  }
}

}  // namespace

// Dynamic shared memory of one CTA: `stages` ring stages of `stage_bytes`
// each and `slice` int32 counts (0 for the global-memory variant).
extern "C" int repro_histogramdd_smem_bytes(int stages, int stage_bytes, int slice) {
  return layout(stages, stage_bytes, slice).total;
}

// CTAs of the kernel the card holds at once with `smem` bytes of dynamic
// shared memory each, in clusters of `cluster` CTAs (1: no cluster); a
// negative value is a CUDA error.
extern "C" int repro_histogramdd_max_ctas(int cluster, int smem) {
  cudaError_t e = opt_in_shared_memory(histdd_kernel);
  int n = 0;
  if (e == cudaSuccess && cluster <= 1) {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, histdd_kernel, kThreads, smem);
    n *= sms;
  } else if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, histdd_kernel, &cfg);
    n *= cluster;
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The histogram of `nblocks` blocks of (rows, d) f32 rows, each contiguous
// at a 4-byte-aligned address, into out: (cells,) int32, zeroed here.
// ptrs: the blocks' base pointers (host array) when nblocks <= kMaxBlocks,
// else table: a device array of them.  lo and scale: the reference's f32
// lo (subnormal as 0) and C = f32(f32(1 / f32(hi - lo)) * bins).  slice_log2 <
// 0 selects the global-memory variant; else each CTA holds 1 << slice_log2
// cells and `cluster` CTAs (1, 2, 4 or 8) hold the histogram.  grid is a
// multiple of cluster; smem is repro_histogramdd_smem_bytes(stages,
// stage_bytes, slice).
extern "C" int repro_histogramdd(const void* const* ptrs, const void* table, int nblocks,
                                 long long rows, int d, int bins, float lo, float scale,
                                 void* out,
                                 int cells, int cluster, int slice_log2, int tile_rows,
                                 int stages, int stage_bytes, int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks < 1 || d < 1 || bins < 1 || tile_rows < 1 || stages < 1 || grid < 1 ||
      (slice_log2 >= 0 && grid % cluster != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  if (nblocks <= kMaxBlocks) {
    for (int b = 0; b < nblocks; ++b) a.ptr[b] = static_cast<const float*>(ptrs[b]);
    a.table = nullptr;
  } else {
    a.table = static_cast<const float* const*>(table);
  }
  a.rows = rows;
  a.tiles_per_block = (rows + tile_rows - 1) / tile_rows;
  a.nblocks = nblocks;
  a.d = d;
  a.bins = bins;
  a.cells = cells;
  a.lo = lo;
  a.scale = scale;
  a.global = slice_log2 < 0;
  a.cluster = a.global ? 1 : cluster;
  a.slice_log2 = a.global ? 0 : slice_log2;
  a.tile_rows = tile_rows;
  a.stages = stages;
  a.stage_bytes = stage_bytes;
  int* o = static_cast<int*>(out);

  cudaError_t e = opt_in_shared_memory(histdd_kernel);
  if (e == cudaSuccess) e = cudaMemsetAsync(o, 0, static_cast<size_t>(cells) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = a.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, histdd_kernel, a, o);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    histdd_kernel<<<grid, kThreads, smem, s>>>(a, o);
  }
  return static_cast<int>(cudaGetLastError());
}
