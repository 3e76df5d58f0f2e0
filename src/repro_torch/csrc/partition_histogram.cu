// partition_histogram: 1-D value histogram over every element of one
// partition's stacked blocks.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_histogram (_hist_kernel), which compares each value with the bin
// edges e_j = lo + width*j (a one-hot of e_j <= x < e_j + width), ORs in the
// clamps x < lo + width -> bin 0 and x >= hi - width -> last bin, and adds the
// one-hot rows with a matmul into a (bins,) f32 accumulator held in VMEM.
//
// What bounds it on an H100: memory.  It reads n*4 bytes once and writes
// bins*4; a one-hot over every bin would spend n*bins comparisons.  This
// kernel finds the bins whose edge test holds by binary search instead: the
// edges, rounded exactly as the reference rounds them (a separate multiply
// and add, __fmul_rn/__fadd_rn, so nvcc cannot contract them into an FMA),
// are non-decreasing in j, so {j : e_j <= x} is a prefix and
// {j : x < e_j + width} a suffix, and their intersection is every bin the
// one-hot marks (usually one; several where rounding makes edges meet).  A NaN
// passes no comparison and is counted nowhere, as in the reference.  Counts
// go into a per-CTA int32 histogram in shared memory and are merged with one
// global atomic per non-zero bin; int32 counts are exact and the same on
// every run (the TPU's f32 sum is exact only below 2**24 per bin).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float edge(float lo, float width, int j) {
  return __fadd_rn(lo, __fmul_rn(width, static_cast<float>(j)));
}

__global__ void hist_kernel(const float* __restrict__ x, long long n, int bins, float lo,
                            float width, float first_below, float last_from,
                            int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int c = threadIdx.x; c < bins; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const bool edges_ordered = width > 0.0f;  // else every interval is empty
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = x[i];
    int a = -1, b = bins;  // matched bins: [b, a]
    if (edges_ordered) {
      int l = 0, r = bins;  // first j with !(e_j <= v)
      while (l < r) {
        const int m = (l + r) >> 1;
        if (edge(lo, width, m) <= v) l = m + 1; else r = m;
      }
      a = l - 1;
      l = 0;
      r = bins;  // first j with v < e_j + width
      while (l < r) {
        const int m = (l + r) >> 1;
        if (v < __fadd_rn(edge(lo, width, m), width)) r = m; else l = m + 1;
      }
      b = l;
    }
    for (int j = b; j <= a; ++j) atomicAdd(&hist[j], 1);
    if (v < first_below && !(b == 0 && a >= 0)) atomicAdd(&hist[0], 1);
    if (v >= last_from && !(b <= bins - 1 && a == bins - 1)) atomicAdd(&hist[bins - 1], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < bins; c += blockDim.x) {
    const int v = hist[c];
    if (v != 0) atomicAdd(&out[c], v);
  }
}

}  // namespace

// x: (n,) f32, contiguous.  out: (bins,) int32, zeroed by the caller.
// first_below = f32(lo + width) and last_from = f32(hi - width), each summed
// in double and rounded once, as the reference's scalar thresholds are.
extern "C" int repro_histogram(const void* x, long long n, int bins, float lo, float width,
                               float first_below, float last_from, void* out, int grid,
                               int threads, void* stream) {
  const int shared_bytes = bins * static_cast<int>(sizeof(int));
  if (shared_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_kernel<<<grid, threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, bins, lo, width, first_below, last_from,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
