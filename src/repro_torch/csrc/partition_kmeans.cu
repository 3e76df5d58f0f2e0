// partition_kmeans: the fused Lloyd partial step over one partition's rows.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_kmeans (_kmeans_kernel): per row, d2_j = |c_j|^2 - 2 x.c_j (the
// |x|^2 term is dropped: it does not change the argmin), the first index of
// the minimum, and one-hot sums (k, d) and counts (k,) accumulated in VMEM
// across the partition's blocks.
//
// What bounds it on an H100: memory.  It reads n*d*4 bytes once; the work
// is about 2*k*d operations per row (k*d = 160 on the main path), far
// below the card's operations-per-byte balance.  So the design keeps
// everything but the rows on chip and reads each row once:
//
// * the centers and |c|^2 live in shared memory; each CTA stages tiles of
//   256 consecutive rows in shared memory with coalesced loads (row stride
//   padded to an odd number of words, so one-row-per-thread reads do not
//   conflict on banks);
// * one thread per row computes the k distances in f32 with fmaf, no TF32,
//   and keeps the first index on ties (strict <), as jnp.argmin does;
// * the per-cluster sums are reduced without float atomics: thread o owns
//   output (j, t) and adds the tile's rows in row order into a per-CTA
//   accumulator in shared memory; counts are integers.  Each CTA writes its
//   partial (k, d) sums and counts to global scratch, and a second small
//   kernel adds the CTAs in index order.  The result is the same on every
//   run.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // rows per tile == threads per CTA

__global__ void kmeans_partial(const float* __restrict__ x, long long n, int d, int k,
                               const float* __restrict__ centers,
                               float* __restrict__ part_sums, int* __restrict__ part_counts) {
  extern __shared__ float smem[];
  const int kd = k * d;
  const int ds = d | 1;  // odd row stride: conflict-free per-row reads
  float* c_s = smem;                 // k*d centers
  float* cc_s = c_s + kd;            // k   |c|^2
  float* acc_s = cc_s + k;           // k*d per-CTA sums
  float* x_s = acc_s + kd;           // kTile*ds staged rows
  int* assign_s = reinterpret_cast<int*>(x_s + kTile * ds);  // kTile
  int* cnt_s = assign_s + kTile;                              // k per-CTA counts
  const int tid = threadIdx.x;

  for (int i = tid; i < kd; i += blockDim.x) {
    c_s[i] = centers[i];
    acc_s[i] = 0.0f;
  }
  for (int j = tid; j < k; j += blockDim.x) cnt_s[j] = 0;
  __syncthreads();
  for (int j = tid; j < k; j += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < d; ++t) s = fmaf(c_s[j * d + t], c_s[j * d + t], s);
    cc_s[j] = s;
  }
  __syncthreads();

  const long long ntiles = (n + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * kTile;
    const int rows = static_cast<int>(min(static_cast<long long>(kTile), n - r0));
    const float* xt = x + r0 * d;
    for (int i = tid; i < rows * d; i += blockDim.x) {
      const int r = i / d;
      x_s[r * ds + (i - r * d)] = xt[i];
    }
    __syncthreads();

    int best = -1;
    if (tid < rows) {
      const float* xr = x_s + tid * ds;
      float bestv = 0.0f;
      for (int j = 0; j < k; ++j) {
        float dot = 0.0f;
        for (int t = 0; t < d; ++t) dot = fmaf(xr[t], c_s[j * d + t], dot);
        const float d2 = cc_s[j] - 2.0f * dot;
        if (best < 0 || d2 < bestv) {
          best = j;
          bestv = d2;
        }
      }
    }
    assign_s[tid] = best;  // -1 past the ragged end: matches no cluster
    __syncthreads();

    for (int o = tid; o < kd; o += blockDim.x) {
      const int j = o / d;
      const int t = o - j * d;
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) {
        if (assign_s[r] == j) s += x_s[r * ds + t];
      }
      acc_s[o] += s;
    }
    for (int j = tid; j < k; j += blockDim.x) {
      int c = 0;
      for (int r = 0; r < rows; ++r) c += (assign_s[r] == j);
      cnt_s[j] += c;
    }
    __syncthreads();
  }

  for (int o = tid; o < kd; o += blockDim.x) part_sums[blockIdx.x * kd + o] = acc_s[o];
  for (int j = tid; j < k; j += blockDim.x) part_counts[blockIdx.x * k + j] = cnt_s[j];
}

// Adds the per-CTA partials in CTA order: sums (k, d) f32, counts (k,) as f32.
__global__ void kmeans_reduce(const float* __restrict__ part_sums,
                              const int* __restrict__ part_counts, int parts, int k, int d,
                              float* __restrict__ sums, float* __restrict__ counts) {
  const int kd = k * d;
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < kd + k;
       o += gridDim.x * blockDim.x) {
    if (o < kd) {
      float s = 0.0f;
      for (int p = 0; p < parts; ++p) s += part_sums[p * kd + o];
      sums[o] = s;
    } else {
      const int j = o - kd;
      long long c = 0;
      for (int p = 0; p < parts; ++p) c += part_counts[p * k + j];
      counts[j] = static_cast<float>(c);
    }
  }
}

}  // namespace

// Shared memory the partial kernel needs for (d, k); the wrapper checks it
// against the card's opt-in limit before launching.
extern "C" int repro_kmeans_shared_bytes(int d, int k) {
  return static_cast<int>((2 * k * d + k + kTile * (d | 1)) * sizeof(float) +
                          (kTile + k) * sizeof(int));
}

// x: (n, d) f32 contiguous; centers: (k, d) f32.  part_sums: (grid, k, d) f32
// and part_counts: (grid, k) int32 scratch; sums: (k, d) f32, counts: (k,) f32.
extern "C" int repro_kmeans(const void* x, long long n, int d, int k, const void* centers,
                            void* part_sums, void* part_counts, void* sums, void* counts,
                            int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = repro_kmeans_shared_bytes(d, k);
  cudaError_t e = cudaFuncSetAttribute(
      kmeans_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_partial<<<grid, kTile, smem, s>>>(
      static_cast<const float*>(x), n, d, k, static_cast<const float*>(centers),
      static_cast<float*>(part_sums), static_cast<int*>(part_counts));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int outputs = k * d + k;
  kmeans_reduce<<<(outputs + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_sums), static_cast<const int*>(part_counts), grid, k,
      d, static_cast<float*>(sums), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
