// partition_kmeans: the fused Lloyd partial step over one partition's rows.
//
// Replaces the TPU kernel src/repro/kernels/partition_reduce.py::
// partition_kmeans (_kmeans_kernel): per row, d2_j = |c_j|^2 - 2 x.c_j (the
// |x|^2 term is dropped: it does not change the argmin), the first index of
// the minimum, and one-hot sums (k, d) and counts (k,) accumulated in VMEM
// across the partition's blocks.
//
// What bounds it on an H100: memory.  It reads n*d*4 bytes once; the work
// is about 2*k*d operations per row (k*d = 160 on the main path), far below
// the card's operations-per-byte balance.  So the design keeps the bytes
// moving and spends work per row, not per row and cluster:
//
// * a persistent grid (the wrapper sizes it to the CTAs that fit on the
//   card) in which each CTA walks one contiguous range of 256-row tiles.  A
//   producer warp keeps a ring of two stages in shared memory filled by the
//   copy engine (1-D bulk copies, full/empty mbarriers), so the next tile
//   arrives while this one is computed; with three CTAs per SM that is three
//   tiles (60 KB at d = 20) in flight per SM.  A tile is R*d*4 contiguous
//   bytes of the stacked (n, d) rows, copied from the 16-byte boundary at or
//   below its first byte to the one at or above its last, so any base
//   address, any d and the ragged last tile take the same copy; rows then
//   start `shift` floats into the stage;
// * four consumer warps, two rows per thread (rows t and t + 128), compute
//   the distances on the CUDA cores in f32 with fmaf, eight centers at a
//   time in registers, each center chunk loaded once for both rows.  Lanes
//   read consecutive rows, d*4 bytes apart.  Where d % 4 == 0 and x is
//   16-byte aligned a row is read as float4; row r then starts d/4 16-byte
//   units into the tile, so when d/4 is odd (d = 20) the eight lanes of a
//   quarter warp, which share a load, hit eight different groups of four
//   banks.  Otherwise a row is read a float at a time, and lanes d words
//   apart share a bank gcd(d, 32) ways.  (This is the arithmetic of the
//   addresses; no count of bank conflicts was measured.)  The centers are
//   read as shared-memory broadcasts (kept chunk-major, so a group's eight
//   sit 16 bytes apart).  No TF32 and no tensor cores for x.c: the counts
//   are compared exactly.  Ties go to the first index (strict <), as
//   jnp.argmin does;
// * sums and counts without float atomics, in work proportional to rows *
//   d: each warp adds the product of the one-hot (clusters x its 64 rows) and
//   [rows | 1] into its own (k, d) f32 and (k,) int32 accumulators in shared
//   memory, once per tile, computed by mma.sync m16n8k16 (bf16 in, f32
//   accumulation).  The one-hot is exact in bf16; each row value is split
//   into three bf16 terms whose sum keeps all its 24 bits (as ssd_scan.cu's
//   f32 route), so every product is exact; the column of ones gives each
//   cluster's count in the tile as an exact small integer.  On the CUDA cores
//   the same sums take a shared-memory read-modify-write per row and column
//   (rows in order, to fix the order of the adds) or a sort of the rows by
//   cluster; the tensor cores take the selection out of the CUDA cores'
//   path.
//
// At the end each CTA adds its warps in warp order and writes one partial; a
// second small kernel adds the partials in CTA order (lanes take partials p =
// lane, lane + 32, ... and a fixed butterfly adds the lanes).  Every order is
// fixed, so the result is the same on every run.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 4;             // consumer warps
constexpr int kRowsPerThread = 2;     // rows t and t + 128 of a tile for consumer thread t
constexpr int kRows = kWarps * 32 * kRowsPerThread;  // rows per tile
constexpr int kThreads = kWarps * 32 + 32;           // and one producer warp
constexpr int kGroup = 8;  // clusters whose dot products sit in registers at once
constexpr int kStages = 2;  // tiles in the ring

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

constexpr int kSumSteps = 32 * kRowsPerThread / 16;  // k-steps of 16 rows per warp and tile

// Row, within a k-step of 16, of element e of lane (g, q)'s mma fragments:
// a0/b0 rows 2q and 2q + 1, a2/b1 rows 2q + 8 and 2q + 9.
__device__ __forceinline__ int frag_row(int q, int e) { return 2 * q + (e & 1) + 8 * (e >> 1); }

// bf16x2 one-hot pair: 1.0 in the low half if lo, in the high half if hi.
__device__ __forceinline__ uint32_t onehot2(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

// An f32 pair as three bf16x2 terms, each the bf16 of what the terms before
// it leave: their sum keeps all 24 bits of each value.
__device__ __forceinline__ void split3(float a, float b, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// Byte offsets of the dynamic shared memory for (d, k).  The centers
// are kept chunk-major: c_s[(t4 * kp + j) * 4 + e] = c[j][4 t4 + e], with kp =
// k rounded up to kGroup and zeros past k and d, so the kGroup centers of a
// group sit 16 bytes apart at every column.
struct Layout {
  int kp, stage_bytes, ring, centers, norms, acc, counts, total;
};

__host__ __device__ inline Layout layout(int d, int k) {
  Layout l;
  l.kp = round_up(k, kGroup);
  // a tile's copy spans at most kRows*d*4 + 30 bytes (both ends rounded to 16)
  // (and the sums read up to 32 floats past the last row)
  l.stage_bytes = round_up(kRows * d * 4 + 32 + 128, 128);
  l.ring = round_up(2 * kStages * 8, 128);  // full and empty barriers first
  l.centers = l.ring + kStages * l.stage_bytes;            // (d/4, kp, 4) centers
  l.norms = l.centers + l.kp * round_up(d, 4) * 4;        // (kp,) |c|^2
  l.acc = l.norms + l.kp * 4;                             // kWarps x (k, d) f32 sums
  l.counts = l.acc + kWarps * k * d * 4;                  // kWarps x (k,) int32 counts
  l.total = l.counts + kWarps * k * 4;
  return l;
}

__global__ void __launch_bounds__(kThreads, 3)
kmeans_partial(const float* __restrict__ x, long long n, int d, int k,
               const float* __restrict__ centers, float* __restrict__ part_sums,
               int* __restrict__ part_counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(d, k);
  const int kp = l.kp, chunks = (d + 3) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + l.ring;
  float* c_s = reinterpret_cast<float*>(smem + l.centers);
  float* cc_s = reinterpret_cast<float*>(smem + l.norms);
  float* acc_s = reinterpret_cast<float*>(smem + l.acc);
  int* cnt_s = reinterpret_cast<int*>(smem + l.counts);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kd = k * d;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < chunks * kp * 4; i += kThreads) {
    const int e = i & 3, j = (i >> 2) % kp, t = 4 * ((i >> 2) / kp) + e;
    c_s[i] = j < k && t < d ? centers[j * d + t] : 0.0f;
  }
  for (int i = tid; i < kWarps * kd; i += kThreads) acc_s[i] = 0.0f;
  for (int i = tid; i < kWarps * k; i += kThreads) cnt_s[i] = 0;
  __syncthreads();
  for (int j = tid; j < kp; j += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < d; ++t) {
      const float c = c_s[((t >> 2) * kp + j) * 4 + (t & 3)];
      s = fmaf(c, c, s);
    }
    cc_s[j] = s;
  }
  __syncthreads();

  const long long ntiles = (n + kRows - 1) / kRows;
  const long long first_tile = ntiles * blockIdx.x / gridDim.x;
  const long long end_tile = ntiles * (blockIdx.x + 1) / gridDim.x;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const int shift = static_cast<int>(base & 15) / 4;  // floats before a tile's first row
  const long long row_bytes = 4LL * d;

  if (warp == kWarps) {
    if (lane == 0) {  // producer: tile i into stage i % kStages once it is free
      for (long long tile = first_tile; tile < end_tile; ++tile) {
        const int i = static_cast<int>(tile - first_tile), s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const long long r0 = tile * kRows;
        const long long rows = min(static_cast<long long>(kRows), n - r0);
        const uintptr_t from = (base + r0 * row_bytes) & ~uintptr_t(15);
        const uintptr_t to = (base + (r0 + rows) * row_bytes + 15) & ~uintptr_t(15);
        const uint32_t bytes = static_cast<uint32_t>(to - from);
        mbar_expect_tx(&full[s], bytes);
        bulk_load(ring + s * l.stage_bytes, reinterpret_cast<const void*>(from), bytes, &full[s]);
      }
    }
    __syncwarp();  // the whole warp reaches the closing barrier together
  } else {
    float* acc_w = acc_s + warp * kd;
    int* cnt_w = cnt_s + warp * k;
    const bool vec = d % 4 == 0 && shift == 0;  // rows start on 16-byte boundaries
    const int g = lane >> 2, q = lane & 3;
    int row_off[kSumSteps][4];  // row * d of lane (g, q)'s fragment rows
#pragma unroll
    for (int ks = 0; ks < kSumSteps; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row_off[ks][e] = (warp * 32 + (ks / 2) * kWarps * 32 + 16 * (ks % 2) + frag_row(q, e)) * d;
    for (long long tile = first_tile; tile < end_tile; ++tile) {
      const int i = static_cast<int>(tile - first_tile), s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const float* xt = reinterpret_cast<const float*>(ring + s * l.stage_bytes) + shift;
      const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - tile * kRows));
      if (rows < kRows) {  // the ragged last tile: its missing rows read as 0
        for (int h = 0; h < kRowsPerThread; ++h) {
          const int r = tid + h * kWarps * 32;
          if (r >= rows)
            for (int t = 0; t < d; ++t) const_cast<float*>(xt)[r * d + t] = 0.0f;
        }
        __syncwarp();
      }

      // distances: rows tid and tid + 128, kGroup centers at a time, each
      // center chunk loaded once for both rows
      int best[kRowsPerThread];
      float bestv[kRowsPerThread];
      const float* xr[kRowsPerThread];
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h) {
        best[h] = -1;  // -1 past the ragged end: matches no cluster
        bestv[h] = 0.0f;
        xr[h] = xt + (tid + h * kWarps * 32) * d;
      }
      if (tid < rows) {
        for (int j0 = 0; j0 < k; j0 += kGroup) {
          const float* cg = c_s + j0 * 4;  // column 0 of center j0
          float dot[kRowsPerThread][kGroup];
#pragma unroll
          for (int h = 0; h < kRowsPerThread; ++h)
#pragma unroll
            for (int c = 0; c < kGroup; ++c) dot[h][c] = 0.0f;
          if (vec) {
            for (int t4 = 0; t4 < chunks; ++t4) {
              float4 xv[kRowsPerThread];
#pragma unroll
              for (int h = 0; h < kRowsPerThread; ++h)
                xv[h] = *reinterpret_cast<const float4*>(xr[h] + 4 * t4);
              const float4* cv = reinterpret_cast<const float4*>(cg + t4 * kp * 4);
#pragma unroll
              for (int c = 0; c < kGroup; ++c) {
                const float4 w = cv[c];
#pragma unroll
                for (int h = 0; h < kRowsPerThread; ++h) {
                  dot[h][c] = fmaf(xv[h].x, w.x, dot[h][c]);
                  dot[h][c] = fmaf(xv[h].y, w.y, dot[h][c]);
                  dot[h][c] = fmaf(xv[h].z, w.z, dot[h][c]);
                  dot[h][c] = fmaf(xv[h].w, w.w, dot[h][c]);
                }
              }
            }
          } else {
            for (int t = 0; t < d; ++t) {
              float xv[kRowsPerThread];
#pragma unroll
              for (int h = 0; h < kRowsPerThread; ++h) xv[h] = xr[h][t];
              const float* cv = cg + (t >> 2) * kp * 4 + (t & 3);
#pragma unroll
              for (int c = 0; c < kGroup; ++c) {
                const float w = cv[4 * c];
#pragma unroll
                for (int h = 0; h < kRowsPerThread; ++h) dot[h][c] = fmaf(xv[h], w, dot[h][c]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            const int j = j0 + c;
            const float cc = cc_s[j];
#pragma unroll
            for (int h = 0; h < kRowsPerThread; ++h) {
              const float d2 = cc - 2.0f * dot[h][c];
              if (j < k && (best[h] < 0 || d2 < bestv[h])) {
                best[h] = j;
                bestv[h] = d2;
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h)
        if (tid + h * kWarps * 32 >= rows) best[h] = -1;

      // sums and counts: the one-hot (clusters x the warp's 64 rows) times
      // [rows | 1] on the tensor cores, in k-steps of 16 rows (rows 16 ks + 2q
      // + {0, 1, 8, 9} of the warp's rows for lane (g, q)), 16 clusters by 32
      // columns at a time.  Column d is 1 for every row in the tile, so it
      // counts the rows (an exact small integer).  A column past d reads the
      // next row and lands nowhere.
      int cl[kSumSteps][4];
#pragma unroll
      for (int ks = 0; ks < kSumSteps; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cl[ks][e] = __shfl_sync(0xffffffffu, best[ks / 2], 16 * (ks % 2) + frag_row(q, e));
      for (int m0 = 0; m0 < k; m0 += 16) {
        for (int c0 = 0; c0 <= d; c0 += 32) {
          float c[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < kSumSteps; ++ks) {
            const uint32_t a[4] = {onehot2(cl[ks][0] == m0 + g, cl[ks][1] == m0 + g),
                                   onehot2(cl[ks][0] == m0 + g + 8, cl[ks][1] == m0 + g + 8),
                                   onehot2(cl[ks][2] == m0 + g, cl[ks][3] == m0 + g),
                                   onehot2(cl[ks][2] == m0 + g + 8, cl[ks][3] == m0 + g + 8)};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (c0 + 8 * nt > d) break;
              const int col = c0 + 8 * nt + g;
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = col == d ? (cl[ks][e] >= 0 ? 1.0f : 0.0f) : xt[row_off[ks][e] + col];
              uint32_t b0[3], b1[3];
              split3(v[0], v[1], b0);
              split3(v[2], v[3], b1);
#pragma unroll
              for (int term = 0; term < 3; ++term) mma_bf16(c[nt], a, b0[term], b1[term]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // clusters m0 + g (+8), columns c0 + 8nt + 2q (+1)
              const int j = m0 + g + 8 * (e >> 1), t = c0 + 8 * nt + 2 * q + (e & 1);
              if (j < k && t < d) acc_w[j * d + t] += c[nt][e];
              if (j < k && t == d) cnt_w[j] += static_cast<int>(c[nt][e]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with stage s
    }
  }

  __syncthreads();
  for (int o = tid; o < kd; o += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += acc_s[w * kd + o];
    part_sums[static_cast<long long>(blockIdx.x) * kd + o] = s;
  }
  for (int j = tid; j < k; j += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += cnt_s[w * k + j];
    part_counts[static_cast<long long>(blockIdx.x) * k + j] = c;
  }
}

// Adds the per-CTA partials in CTA order: sums (k, d) f32, counts (k,) as f32.
// One warp per output; lane l adds partials l, l + 32, ... and a fixed
// butterfly adds the lanes.
__global__ void kmeans_reduce(const float* __restrict__ part_sums,
                              const int* __restrict__ part_counts, int parts, int k, int d,
                              float* __restrict__ sums, float* __restrict__ counts) {
  const int kd = k * d, lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int o = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; o < kd + k; o += warps) {
    if (o < kd) {
      float s = 0.0f;
      for (int p = lane; p < parts; p += 32) s += part_sums[static_cast<long long>(p) * kd + o];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) sums[o] = s;
    } else {
      long long c = 0;
      for (int p = lane; p < parts; p += 32) c += part_counts[static_cast<long long>(p) * k + o - kd];
      for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
      if (lane == 0) counts[o - kd] = static_cast<float>(c);
    }
  }
}

}  // namespace

// Dynamic shared memory of the partial kernel for (d, k); the wrapper checks
// it against the card's limit and sizes the grid from it.
extern "C" int repro_kmeans_shared_bytes(int d, int k) { return layout(d, k).total; }

// x: (n, d) f32 contiguous, at any 4-byte-aligned address; centers: (k, d)
// f32.  part_sums: (grid, k, d) f32 and part_counts: (grid, k) int32
// scratch; sums: (k, d) f32, counts: (k,) f32.  smem is
// repro_kmeans_shared_bytes(d, k).
extern "C" int repro_kmeans(const void* x, long long n, int d, int k,
                            const void* centers, void* part_sums, void* part_counts, void* sums,
                            void* counts, int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = opt_in_shared_memory(kmeans_partial);
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_partial<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), n, d, k, static_cast<const float*>(centers),
      static_cast<float*>(part_sums), static_cast<int*>(part_counts));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = k * d + k;  // one per output
  kmeans_reduce<<<(warps * 32 + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_sums), static_cast<const int*>(part_counts), grid, k, d,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
