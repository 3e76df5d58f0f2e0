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
// bins*4.  The design keeps many loads in flight and spends O(1) work per
// value:
//
// * a persistent grid (the wrapper runs six CTAs per SM) in which each
//   thread issues two 16-byte loads before it bins any of their values
//   (four or eight per thread were slower in exploratory runs on an H100,
//   whose numbers were not kept).  A value
//   before the first 16-byte boundary of x or after the last one (x may be a
//   view at any offset, of any length) is binned by a thread of CTA 0 from a
//   4-byte load;
// * binning by a guess and a short walk.  The lower edges e_j and the upper
//   edges upper_j are non-decreasing in j, so {j : e_j <= v} is a prefix and
//   {j : v < upper_j} a suffix; every bin in their intersection is marked by
//   the one-hot (usually one bin; several where rounding makes edges meet).
//   The guess j = int(clamp((v - lo) / width, 0, bins - 1)), clamped in
//   float so that +-inf and huge values give a valid index, is where the
//   search starts: `a`, the last j with e_j <= v, and `b`, the first j with
//   v < upper_j.  a = b = j exactly when max(e_j, upper_{j-1}) <= v <
//   min(upper_j, e_{j+1}) (+-inf past the ends).  Shared memory holds that
//   pair for each bin (8 bytes per bin, each edge once, computed once per
//   CTA), so one load settles the common case.  Otherwise both are found by
//   stepping along the edges from j, each edge computed in registers with the
//   same two roundings.  The comparisons are the same ones a search over all
//   edges makes, so any start gives the same bins.  A NaN passes no
//   comparison and is counted nowhere; with width <= 0 every interval is
//   empty and only the clamps count; subnormal values are flushed before the
//   guess, as before the comparisons;
// * counts go into int32 sub-histograms in shared memory, one per warp (fewer
//   when many bins leave no room), added per CTA at the end, then one global
//   integer atomic per non-zero bin per CTA.  Integer adds are exact in any
//   order, so the result is the same on every run (the TPU's f32 sum is exact
//   only below 2**24 per bin).  The last CTA to finish (a ticket counter
//   after a fence) writes the counts as f32, so one launch and one memset
//   make the whole call.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 2;  // 16-byte loads in flight per thread
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float flush(float v) { return fabsf(v) < kFltMin ? 0.0f : v; }

// base + width*j: the lower edge with base = lo, the upper with base = upper0
__device__ __forceinline__ float edge(float base, float width, int j) {
  return flush(__fadd_rn(__fmul_rn(width, static_cast<float>(j)), base));
}

struct Params {
  int bins;
  float lo, width, inv_width, upper0, first_below, last_from;
};

__device__ __forceinline__ void bin_value(float x, const Params& p, const float2* alone,
                                          int* hist) {
  const float v = flush(x);
  if (v != v) return;  // NaN: no comparison holds, counted nowhere
  const int bins = p.bins;
  int a = -1, b = bins;  // matched bins: [b, a]
  if (p.width > 0.0f) {  // else every interval is empty
    float g = __fmul_rn(__fsub_rn(v, p.lo), p.inv_width);
    g = fminf(fmaxf(g, 0.0f), static_cast<float>(bins - 1));  // +-inf and huge values clamp
    const int j = __float2int_rz(g);
    const float2 e = alone[j];  // max(e_j, upper_{j-1}), min(upper_j, e_{j+1})
    if (e.x <= v && v < e.y) {  // a = b = j: the common case
      atomicAdd(&hist[j], 1);
      if (v < p.first_below && j != 0) atomicAdd(&hist[0], 1);
      if (v >= p.last_from && j != bins - 1) atomicAdd(&hist[bins - 1], 1);
      return;
    }
    if (edge(p.lo, p.width, j) <= v) {  // a: last j with e_j <= v
      a = j;
      while (a + 1 < bins && edge(p.lo, p.width, a + 1) <= v) ++a;
    } else {
      a = j - 1;
      while (a >= 0 && !(edge(p.lo, p.width, a) <= v)) --a;
    }
    if (v < edge(p.upper0, p.width, j)) {  // b: first j with v < upper_j
      b = j;
      while (b > 0 && v < edge(p.upper0, p.width, b - 1)) --b;
    } else {
      b = j + 1;
      while (b < bins && !(v < edge(p.upper0, p.width, b))) ++b;
    }
  }
  for (int c = b; c <= a; ++c) atomicAdd(&hist[c], 1);
  if (v < p.first_below && !(b == 0 && a >= 0)) atomicAdd(&hist[0], 1);
  if (v >= p.last_from && !(b <= bins - 1 && a == bins - 1)) atomicAdd(&hist[bins - 1], 1);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, long long n, int copies, Params p,
            int* __restrict__ counts, float* __restrict__ out) {
  extern __shared__ __align__(16) float2 alone[];  // (bins,) bounds of "in bin j alone"
  const int bins = p.bins;
  int* hist = reinterpret_cast<int*>(alone + bins);  // (copies, bins) counts
  const float inf = __int_as_float(0x7f800000);
  for (int c = threadIdx.x; c < bins; c += kThreads) {
    const float prev_upper = c > 0 ? edge(p.upper0, p.width, c - 1) : -inf;
    const float next_lower = c + 1 < bins ? edge(p.lo, p.width, c + 1) : inf;
    alone[c] = make_float2(fmaxf(edge(p.lo, p.width, c), prev_upper),
                           fminf(edge(p.upper0, p.width, c), next_lower));
  }
  for (int c = threadIdx.x; c < copies * bins; c += kThreads) hist[c] = 0;
  __syncthreads();
  int* hw = hist + ((threadIdx.x >> 5) % copies) * bins;

  // x = [head | body of float4 | tail]: head and tail are the < 4 values on
  // either side of the 16-byte-aligned body
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 15);
  const long long head = min(static_cast<long long>((16 - misalign) % 16 / 4), n);
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const long long nvec = (n - head) / 4;
  const long long tail = head + 4 * nvec;
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) bin_value(x[t], p, alone, hw);
    else if (t >= 4 && t - 4 < n - tail) bin_value(x[tail + t - 4], p, alone, hw);
  }
  const float nan = __int_as_float(0x7fffffff);  // fills loads past the end: counted nowhere
  const long long chunk = static_cast<long long>(kThreads) * kLoads;
  for (long long i0 = blockIdx.x * chunk + threadIdx.x; i0 < nvec; i0 += gridDim.x * chunk) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = i0 + u * kThreads;
      v[u] = i < nvec ? __ldcs(body + i) : make_float4(nan, nan, nan, nan);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      bin_value(v[u].x, p, alone, hw);
      bin_value(v[u].y, p, alone, hw);
      bin_value(v[u].z, p, alone, hw);
      bin_value(v[u].w, p, alone, hw);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < bins; c += kThreads) {
    int s = 0;
    for (int w = 0; w < copies; ++w) s += hist[w * bins + c];
    if (s != 0) atomicAdd(&counts[c], s);
  }
  __threadfence();
  __syncthreads();
  // thread 0 takes the ticket: the CTA that finishes last sees every count
  if (__syncthreads_or(threadIdx.x == 0 && atomicAdd(&counts[bins], 1) == gridDim.x - 1)) {
    __threadfence();
    for (int c = threadIdx.x; c < bins; c += kThreads)
      out[c] = static_cast<float>(__ldcg(&counts[c]));
  }
}

}  // namespace

// x: (n,) f32, contiguous, at any 4-byte-aligned address.  counts: (bins +
// 1,) int32 scratch (the counts, then the ticket), zeroed here; out: (bins,)
// f32.  copies: sub-histograms per CTA (1..8, one per
// warp at most); shared_bytes = 4 * bins * (2 + copies).  inv_width =
// f32(1 / width), used only for the guess.  upper0 = f32(lo) + f32(width) in
// f32; first_below = f32(lo + width) and last_from = f32(hi - width), each
// summed in double and rounded once, as the reference's scalar thresholds are.
extern "C" int repro_histogram(const void* x, long long n, int bins, int copies, float lo,
                               float width, float inv_width, float upper0, float first_below,
                               float last_from, void* counts, void* out, int grid,
                               int shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = hopper::opt_in_shared_memory(hist_kernel);
  if (e == cudaSuccess) e = cudaMemsetAsync(counts, 0, (bins + 1) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p{bins, lo, width, inv_width, upper0, first_below, last_from};
  hist_kernel<<<grid, kThreads, shared_bytes, s>>>(static_cast<const float*>(x), n, copies, p,
                                                  static_cast<int*>(counts),
                                                  static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
