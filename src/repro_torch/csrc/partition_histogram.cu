// partition_histogram: 1-D value histogram over every element of one
// partition's stacked blocks.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_histogram (_hist_kernel), which compares each value with the bin
// edges e_j = lo + width*j (a one-hot of e_j <= x < e_j + width), ORs in the
// clamps x < lo + width -> bin 0 and x >= hi - width -> last bin, and adds the
// one-hot rows with a matmul into a (bins,) f32 accumulator held in VMEM.
//
// The edges are rounded as XLA rounds the reference: e_j = lo + width*j, and
// the upper edge, which the source writes (lo + width*j) + width, as XLA
// reassociates it, width*j + upper0 with upper0 = f32(lo + width) folded
// once.  Each is a separate multiply and add (__fmul_rn/__fadd_rn, so nvcc
// cannot contract them into an FMA).  XLA compares with subnormals flushed
// to zero, so values and edges below FLT_MIN in magnitude compare as 0.
//
// What bounds it on an H100: memory.  It reads n*4 bytes once and writes
// bins*4; a one-hot over every bin would spend n*bins comparisons.  This
// kernel finds the bins whose edge test holds by binary search instead, over
// both edge arrays computed once per CTA into shared memory: both edges are
// non-decreasing in j, so {j : e_j <= x} is a prefix and
// {j : x < upper_j} a suffix, and their intersection is every bin the
// one-hot marks (usually one; several where rounding makes edges meet).  A NaN
// passes no comparison and is counted nowhere, as in the reference.  Counts
// go into a per-CTA int32 histogram in shared memory and are merged with one
// global atomic per non-zero bin; int32 counts are exact and the same on
// every run (the TPU's f32 sum is exact only below 2**24 per bin).

#include <cuda_runtime.h>

namespace {

constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float flush(float v) { return fabsf(v) < kFltMin ? 0.0f : v; }

// base + width*j: the lower edge with base = lo, the upper with base = upper0
__device__ __forceinline__ float edge(float base, float width, int j) {
  return flush(__fadd_rn(__fmul_rn(width, static_cast<float>(j)), base));
}

__global__ void hist_kernel(const float* __restrict__ x, long long n, int bins, float lo,
                            float width, float upper0, float first_below, float last_from,
                            int* __restrict__ out) {
  extern __shared__ int hist[];                                 // (bins,) counts
  float* lower = reinterpret_cast<float*>(hist + bins);         // (bins,) e_j
  float* upper = lower + bins;                                  // (bins,) upper_j
  for (int c = threadIdx.x; c < bins; c += blockDim.x) {
    hist[c] = 0;
    lower[c] = edge(lo, width, c);
    upper[c] = edge(upper0, width, c);
  }
  __syncthreads();
  const bool edges_ordered = width > 0.0f;  // else every interval is empty
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = flush(x[i]);
    int a = -1, b = bins;  // matched bins: [b, a]
    if (edges_ordered) {
      int l = 0, r = bins;  // first j with !(e_j <= v)
      while (l < r) {
        const int m = (l + r) >> 1;
        if (lower[m] <= v) l = m + 1; else r = m;
      }
      a = l - 1;
      l = 0;
      r = bins;  // first j with v < upper_j
      while (l < r) {
        const int m = (l + r) >> 1;
        if (v < upper[m]) r = m; else l = m + 1;
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
// upper0 = f32(lo) + f32(width) in f32; first_below = f32(lo + width) and
// last_from = f32(hi - width), each summed in double and rounded once, as the
// reference's scalar thresholds are.
extern "C" int repro_histogram(const void* x, long long n, int bins, float lo, float width,
                               float upper0, float first_below, float last_from, void* out,
                               int grid,
                               int threads, void* stream) {
  const int shared_bytes = 3 * bins * static_cast<int>(sizeof(int));  // counts and both edges
  if (shared_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_kernel<<<grid, threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, bins, lo, width, upper0, first_below, last_from,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
