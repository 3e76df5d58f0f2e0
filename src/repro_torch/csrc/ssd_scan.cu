// ssd_scan: Mamba2's chunked SSD (state-space duality) over a whole sequence.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), whose grid walks (batch, head, chunk) with the chunk
// dimension last, so that the (P, N) state stays in VMEM across a sequence.
// Per chunk of Q rows, with seg the inclusive cumsum of dt*A:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//           + exp(seg_i) (C_i . h)                       (h entering the chunk)
//   h_out = h exp(seg_Q) + sum_j exp(seg_Q - seg_j) dt_j x_j (x) B_j
//
// On an H100 blocks run in parallel and in no order, so the sequential grid
// dimension becomes a loop: one CTA per (batch, head) walks the chunks in
// order with the state h (P x N f32, 32 KB at P=64, N=128) in shared memory.
// The TPU kernel's 0.6 MiB chunk does not fit in 227 KB, so this kernel's
// chunk is 64 rows (Q = 64): x, B, C and the 64 x 64 decay-weighted C.B^T of
// one chunk fit beside the state (about 133 KB, one CTA per SM).  The chunk
// length changes only the grouping of the same sums, and the reference's
// results do not depend on it.  A ragged last chunk is padded with dt = 0 and
// x = B = C = 0, which adds nothing to y or to the state.  Everything is
// computed in f32 on the CUDA cores; y is stored in the inputs' type, the
// final state in f32.
//
// What bounds it: this kernel's own operations, not the function's.  Per
// (batch, head) and chunk of 64 rows it does 64*64*N (C.B^T) + 64*64*P (G.x)
// + 64*P*N (C.h) + 64*P*N (state) multiply-adds on the CUDA cores in f32,
// about 1.8 M at P=64, N=128, against 64*(2N+P+1)*2 bytes of input, most of
// which (B and C) every head of a batch row shares through L2.  The function
// itself is bound by its bytes (x, y and the f32 state) once C.B^T is
// computed once per batch row and chunk and the products run on the tensor
// cores: a later kernel could do both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;         // chunk rows
constexpr int kThreads = 256;  // 16 x 16 thread grid over 64-row tiles
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x,   // (B, L, NH, P)
           const T* __restrict__ dt,  // (B, L, NH)
           const T* __restrict__ a,   // (NH,)
           const T* __restrict__ bm,  // (B, L, N)
           const T* __restrict__ cm,  // (B, L, N)
           T* __restrict__ y,         // (B, L, NH, P)
           float* __restrict__ hout,  // (B, NH, P, N)
           int L, int NH, int P, int N) {
  extern __shared__ float smem[];
  const int HS = N + 1;  // padded row strides: conflict-free column walks
  const int XS = P + 1;
  const int GS = kQ + 1;
  float* h = smem;              // (P, HS)
  float* bs = h + P * HS;       // (Q, HS)
  float* cs = bs + kQ * HS;     // (Q, HS)
  float* xs = cs + kQ * HS;     // (Q, XS)
  float* gs = xs + kQ * XS;     // (Q, GS)
  float* seg = gs + kQ * GS;    // (Q,)
  float* dts = seg + kQ;        // (Q,)

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float av = to_f32(a[head]);

  for (int e = tid; e < P * N; e += kThreads) h[(e / N) * HS + e % N] = 0.0f;

  for (int c0 = 0; c0 < L; c0 += kQ) {
    const int rows = min(kQ, L - c0);
    __syncthreads();  // the previous chunk's readers of bs/cs/xs are done
    // ---- load the chunk, upcast to f32, zero-padded past the sequence end ----
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int r = e / N, n = e % N;
      float bv = 0.0f, cv = 0.0f;
      if (r < rows) {
        const long long off = ((long long)batch * L + c0 + r) * N + n;
        bv = to_f32(bm[off]);
        cv = to_f32(cm[off]);
      }
      bs[r * HS + n] = bv;
      cs[r * HS + n] = cv;
    }
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int r = e / P, p = e % P;
      xs[r * XS + p] = r < rows
          ? to_f32(x[(((long long)batch * L + c0 + r) * NH + head) * P + p]) : 0.0f;
    }
    if (tid < kQ) {
      dts[tid] = tid < rows ? to_f32(dt[((long long)batch * L + c0 + tid) * NH + head]) : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt*A, in order
      float s = 0.0f;
      for (int r = 0; r < kQ; ++r) {
        s += dts[r] * av;
        seg[r] = s;
      }
    }
    __syncthreads();

    // ---- G = (C.B^T) * exp(seg_i - seg_j) * dt_j on j <= i, else 0 ----------
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cr[4], br[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * HS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) br[c] = bs[(tx + 16 * c) * HS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          gs[i * GS + j] = j <= i ? acc[r][c] * expf(seg[i] - seg[j]) * dts[j] : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- y = G.x + exp(seg_i) * (C.h^T) --------------------------------------
    {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < kQ; ++j) {
        float gr[4], xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gr[r] = gs[(ty + 16 * r) * GS + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xr[c] = tx + 16 * c < P ? xs[j * XS + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) intra[r][c] = fmaf(gr[r], xr[c], intra[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cr[4], hr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * HS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) hr[c] = tx + 16 * c < P ? h[(tx + 16 * c) * HS + n] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(cr[r], hr[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= rows) continue;
        const float into = expf(seg[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) {
            store(&y[(((long long)batch * L + c0 + i) * NH + head) * P + p],
                  intra[r][c] + inter[r][c] * into);
          }
        }
      }
    }
    __syncthreads();  // every read of the entering state is done

    // ---- h = h * exp(seg_Q) + sum_j (exp(seg_Q - seg_j) dt_j x_j) (x) B_j ----
    if (tid < kQ) {
      const float tail = expf(seg[kQ - 1] - seg[tid]) * dts[tid];
      for (int p = 0; p < P; ++p) xs[tid * XS + p] *= tail;
    }
    __syncthreads();
    const float decay = expf(seg[kQ - 1]);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float st = 0.0f;
      for (int j = 0; j < kQ; ++j) st = fmaf(xs[j * XS + p], bs[j * HS + n], st);
      h[p * HS + n] = h[p * HS + n] * decay + st;
    }
  }
  __syncthreads();
  float* ho = hout + ((long long)batch * NH + head) * P * N;
  for (int e = tid; e < P * N; e += kThreads) ho[e] = h[(e / N) * HS + e % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* hout, int batch, int L, int NH, int P, int N, void* stream) {
  const int shared = ((P + 2 * kQ) * (N + 1) + kQ * (P + 1) + kQ * (kQ + 1) + 2 * kQ) *
                     static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(NH, batch);
  ssd_kernel<T><<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(hout), L, NH, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All inputs contiguous and of one type: dtype_code 0 = f32, 1 = bf16.
// y has the inputs' type; hout is f32.  Requires P <= 64 and N <= 128.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* hout, int batch, int L, int NH,
                              int P, int N, int dtype_code, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(x, dt, a, bm, cm, y, hout, batch, L, NH, P, N, stream);
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, hout, batch, L, NH, P, N, stream);
}
