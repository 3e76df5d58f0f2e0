// partition_histogramdd: d-dimensional histogram of one partition's stacked rows.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_histogramdd (_histdd_kernel), which digitizes each row per
// dimension, forms a row-major flat cell id and accumulates a one-hot
// matmul into a bins**d accumulator held in VMEM across the partition's
// blocks.
//
// What bounds it on an H100: memory.  It reads n*d*4 bytes once and writes
// bins**d*4; the arithmetic is a handful of operations per value.  A one-hot
// matmul would spend n*bins**d operations to add n ones, so this kernel
// scatters instead: integer atomics into a per-CTA histogram in shared
// memory (one CTA per SM holds the main path's 8**5 = 32,768 cells, 128 KiB,
// which needs the opt-in shared-memory limit), merged into global memory
// with one atomic per non-zero cell.  Above the shared-memory limit (up to
// the registry's 2**20 cells) a second variant adds straight into global
// memory; the wrapper chooses by shape.  Integer atomics make the counts
// exact and the same on every run.
//
// Digitizing matches the JAX reference bit for bit: in f32,
// (x - lo) / (hi - lo) * bins with hi - lo rounded once from a double, then
// truncation toward zero (__float2int_rz saturates and maps NaN to 0, as
// XLA's float-to-int conversion does), then a clip to [0, bins - 1].

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int cell_of(const float* __restrict__ row, int d, int bins,
                                       float lo, float width, float fbins) {
  int flat = 0;
  for (int k = 0; k < d; ++k) {
    const float s = __fmul_rn(__fdiv_rn(__fsub_rn(row[k], lo), width), fbins);
    const int i = min(max(__float2int_rz(s), 0), bins - 1);
    flat = flat * bins + i;
  }
  return flat;
}

__global__ void histdd_shared(const float* __restrict__ x, long long n, int d, int bins,
                              float lo, float width, float fbins, int cells,
                              int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int c = threadIdx.x; c < cells; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    atomicAdd(&hist[cell_of(x + r * d, d, bins, lo, width, fbins)], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int v = hist[c];
    if (v != 0) atomicAdd(&out[c], v);
  }
}

__global__ void histdd_global(const float* __restrict__ x, long long n, int d, int bins,
                              float lo, float width, float fbins, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    atomicAdd(&out[cell_of(x + r * d, d, bins, lo, width, fbins)], 1);
  }
}

}  // namespace

// x: (n, d) f32, contiguous.  out: (bins**d,) int32, zeroed by the caller.
// shared_bytes > 0 selects the shared-memory variant with that much dynamic
// shared memory (bins**d * 4); 0 selects the global-atomic variant.
extern "C" int repro_histogramdd(const void* x, long long n, int d, int bins, float lo,
                                 float width, void* out, int grid, int threads,
                                 int shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  const float fbins = static_cast<float>(bins);
  if (shared_bytes > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        histdd_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    histdd_shared<<<grid, threads, shared_bytes, s>>>(xf, n, d, bins, lo, width, fbins,
                                                      shared_bytes / 4, o);
  } else {
    histdd_global<<<grid, threads, 0, s>>>(xf, n, d, bins, lo, width, fbins, o);
  }
  return static_cast<int>(cudaGetLastError());
}
