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
// dimension becomes a loop: one CTA per (batch, pair of heads) walks chunks of
// Q = 64 rows in order (the chunk changes only the grouping of the same sums,
// and the reference's results do not depend on it; a ragged last chunk is
// padded with dt = 0 and x = B = C = 0, which adds nothing).  8 warps: warp w
// serves head w / 4 and state rows p in [16 (w % 4), +16).
//   * Loads: x, dt, B and C of the next chunk come by cp.async into the other
//     of two stages while this chunk computes (bf16 inputs; f32 inputs take
//     twice the bytes and use one stage).
//   * C.B^T, which every head of a batch row shares, is computed once per
//     chunk for both heads of the CTA (G = 2) and kept in shared memory.
//   * The cumsum of dt*A is a warp-shuffle scan, one warp per head.
//   * All four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate).  bf16 inputs multiply exactly; each f32 factor (the
//     decay-weighted G = C.B^T exp(seg_i - seg_j) dt_j, the state h, and
//     x exp(seg_Q - seg_j) dt_j) is split into bf16 hi + lo and multiplied
//     twice.  f32 inputs are split too, into three bf16 terms as every f32
//     factor beside them (hi + mid + lo, all 24 bits), and each product takes
//     the six term products whose orders add to at most 2: two terms (16
//     bits) with three products left errors of 2.3x the reference tests'
//     3e-4 at the mamba2 prefill's shapes.
//   * The f32 state stays in registers for the whole sequence, in the
//     accumulator layout of the state update (P x N: 64 values a thread); the
//     same registers, split hi + lo, are the A operand of h . C^T (the
//     transposed inter-chunk output), which each warp computes for its own
//     state rows before it updates them, so no state is read after it is
//     written.  The outputs are computed transposed (p x i) for that reason.
// y is stored in the inputs' type, the final state in f32.
//
// What bounds it: the function is bound by its bytes (x, B, C, dt, y and the
// f32 state, 0.026 ms at the mamba2 prefill's shapes) once C.B^T is shared
// and the products run on the tensor cores; this kernel runs 8 chunks in
// sequence per CTA, so the latency of each chunk's dependent steps (scan,
// then G, then the products) is what remains.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQ = 64;          // chunk rows
constexpr int kP = 64;          // max head dim
constexpr int kN = 128;         // max state dim
constexpr int kHeads = 2;       // heads per CTA (G): C.B^T is shared by them
constexpr int kThreads = 256;   // 4 warps per head
constexpr int kCBS = kQ + 4;    // f32 row stride of C.B^T
constexpr int kGS = kQ + 8;     // bf16 row stride of each term of G

template <typename T>
struct SsdLayout {
  // terms of an input operand (bf16: 1, exact; f32: 3) and of an f32 factor
  // (2 beside bf16 inputs, 3 beside f32 ones)
  static constexpr int kTermsIn = sizeof(T) == 4 ? 3 : 1;
  static constexpr int kTermsF = sizeof(T) == 4 ? 3 : 2;
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int BS = kN + kVec;         // B, C row stride (elements)
  static constexpr int XS = kP + kVec;         // x row stride
  // one stage: B (Q x BS), C (Q x BS), x (heads x Q x XS), dt (Q x heads)
  static constexpr int kB = 0, kC = kQ * BS, kX = 2 * kQ * BS, kDt = kX + kHeads * kQ * XS;
  static constexpr int kStageBytes = ((kDt + kQ * kHeads) * sizeof(T) + 15) / 16 * 16;
  static constexpr int kCBOffset = kStages * kStageBytes;
  static constexpr int kGOffset = kCBOffset + kQ * kCBS * 4;
  static constexpr int kVecOffset = kGOffset + kHeads * kTermsF * kQ * kGS * 2;  // seg, tail, e^seg
  static constexpr int kSmemBytes = kVecOffset + (3 * kHeads * kQ + kHeads) * 4;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// An f32 pair as K bf16x2 terms: w[0] = bf16(v), w[k] = bf16 of what the
// terms before it leave; K = 2 keeps about 16 bits, K = 3 all 24.
template <int K>
__device__ __forceinline__ void split_terms(float a, float b, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// Two input values (consecutive, or at p0 and p1) as mma operand terms:
// exact in one term for bf16, three terms for f32.
__device__ __forceinline__ void words(const __nv_bfloat16* p, uint32_t* w) {
  w[0] = *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void words(const float* p, uint32_t* w) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split_terms<3>(v.x, v.y, w);
}
__device__ __forceinline__ void words(const __nv_bfloat16* p0, const __nv_bfloat16* p1,
                                      uint32_t* w) {
  __nv_bfloat162 v;
  v.x = *p0;
  v.y = *p1;
  w[0] = *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void words(const float* p0, const float* p1, uint32_t* w) {
  split_terms<3>(*p0, *p1, w);
}

// d += A . B over the term products whose orders add to at most 2: with a
// one-term (bf16) operand that is every term of the other; with two
// three-term (f32) operands, hi.hi + hi.mid + mid.hi + hi.lo + lo.hi +
// mid.mid, which is an f32 product to about 2^-24.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float* d, const uint32_t (*a)[4],
                                          const uint32_t (*b)[2]) {
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      if (i + j <= 2) mma_bf16(d, a[i], b[j][0], b[j][1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x,   // (B, L, NH, P)
           const T* __restrict__ dt,  // (B, L, NH)
           const T* __restrict__ a,   // (NH,)
           const T* __restrict__ bm,  // (B, L, N)
           const T* __restrict__ cm,  // (B, L, N)
           T* __restrict__ y,         // (B, L, NH, P)
           float* __restrict__ hout,  // (B, NH, P, N)
           int L, int NH, int P, int N, int vec) {
  using S = SsdLayout<T>;
  constexpr int TI = S::kTermsIn, TF = S::kTermsF;
  extern __shared__ __align__(16) uint8_t smem[];
  float* cb = reinterpret_cast<float*>(smem + S::kCBOffset);                  // (Q, kCBS)
  __nv_bfloat16* gpl = reinterpret_cast<__nv_bfloat16*>(smem + S::kGOffset);  // (heads, TF, Q, kGS)
  float* segs = reinterpret_cast<float*>(smem + S::kVecOffset);               // (heads, Q)
  float* tails = segs + kHeads * kQ;                                           // (heads, Q)
  float* eins = tails + kHeads * kQ;                                           // (heads, Q)
  float* decays = eins + kHeads * kQ;                                          // (heads,)

  const int h0 = blockIdx.x * kHeads;
  const int batch = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = warp / 4, wp = warp % 4;  // this warp's head (in the CTA) and state rows
  const int head = h0 + hh;
  const bool head_ok = head < NH;
  const int nchunks = (L + kQ - 1) / kQ;

  // ---- one chunk's x, dt, B, C into a stage: cp.async, zero past the ends ----
  auto load = [&](int c, int s) {
    T* st = reinterpret_cast<T*>(smem + s * S::kStageBytes);
    const int c0 = c * kQ;
    if (vec) {  // N, P and NH fit 16-byte vectors (and head pairs 4- or 8-byte ones)
      constexpr int VN = kN / S::kVec, VP = kP / S::kVec;
      for (int e = tid; e < 2 * kQ * VN; e += kThreads) {
        const int m = e / (kQ * VN), r = (e / VN) % kQ, v = e % VN;
        const bool ok = c0 + r < L && v * S::kVec < N;
        const T* src = (m ? cm : bm) + (ok ? ((long long)batch * L + c0 + r) * N + v * S::kVec : 0);
        cp_async16(st + (m ? S::kC : S::kB) + r * S::BS + v * S::kVec, src, ok);
      }
      for (int e = tid; e < kHeads * kQ * VP; e += kThreads) {
        const int k = e / (kQ * VP), r = (e / VP) % kQ, v = e % VP;
        const bool ok = c0 + r < L && h0 + k < NH && v * S::kVec < P;
        const T* src = x + (ok ? (((long long)batch * L + c0 + r) * NH + h0 + k) * P + v * S::kVec
                               : 0);
        cp_async16(st + S::kX + (k * kQ + r) * S::XS + v * S::kVec, src, ok);
      }
      if (tid < kQ) {  // dt of both heads: one 4- or 8-byte pair per row
        const bool ok = c0 + tid < L;
        const T* src = dt + (ok ? ((long long)batch * L + c0 + tid) * NH + h0 : 0);
        cp_async_small<2 * sizeof(T)>(st + S::kDt + tid * kHeads, src, ok);
      }
    } else {  // element by element
      const T zero = T(0.0f);
      for (int e = tid; e < 2 * kQ * kN; e += kThreads) {
        const int m = e / (kQ * kN), r = (e / kN) % kQ, n = e % kN;
        const bool ok = c0 + r < L && n < N;
        st[(m ? S::kC : S::kB) + r * S::BS + n] =
            ok ? (m ? cm : bm)[((long long)batch * L + c0 + r) * N + n] : zero;
      }
      for (int e = tid; e < kHeads * kQ * kP; e += kThreads) {
        const int k = e / (kQ * kP), r = (e / kP) % kQ, p = e % kP;
        const bool ok = c0 + r < L && h0 + k < NH && p < P;
        st[S::kX + (k * kQ + r) * S::XS + p] =
            ok ? x[(((long long)batch * L + c0 + r) * NH + h0 + k) * P + p] : zero;
      }
      if (tid < kQ * kHeads) {
        const int r = tid / kHeads, k = tid % kHeads;
        const bool ok = c0 + r < L && h0 + k < NH;
        st[S::kDt + tid] = ok ? dt[((long long)batch * L + c0 + r) * NH + h0 + k] : zero;
      }
    }
  };

  float hs[kN / 8][4];  // the state, rows p = 16 wp + g (+8), cols n = 8 nb + 2t (+1)
#pragma unroll
  for (int nb = 0; nb < kN / 8; ++nb) hs[nb][0] = hs[nb][1] = hs[nb][2] = hs[nb][3] = 0.0f;
  const float av = head_ok ? to_f32(a[head]) : 0.0f;
  const int p0 = 16 * wp;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int s = S::kStages == 2 ? c % 2 : 0;
    if (S::kStages == 2) {
      if (c + 1 < nchunks) load(c + 1, (c + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = reinterpret_cast<const T*>(smem + s * S::kStageBytes);
    const T* Bs = st + S::kB;
    const T* Cs = st + S::kC;
    const T* Xs = st + S::kX + hh * kQ * S::XS;
    const T* Ds = st + S::kDt;

    // ---- seg = cumsum(dt*A): warp-shuffle scan, one warp per head ----
    if (wp == 0 && head_ok) {
      const float d0 = to_f32(Ds[(2 * lane) * kHeads + hh]);
      const float d1 = to_f32(Ds[(2 * lane + 1) * kHeads + hh]);
      const float v0 = d0 * av, v1 = d1 * av;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float s0 = excl + v0, s1 = incl;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      float* seg = segs + hh * kQ;
      seg[2 * lane] = s0;
      seg[2 * lane + 1] = s1;
      tails[hh * kQ + 2 * lane] = expf(total - s0) * d0;
      tails[hh * kQ + 2 * lane + 1] = expf(total - s1) * d1;
      eins[hh * kQ + 2 * lane] = expf(s0);
      eins[hh * kQ + 2 * lane + 1] = expf(s1);
      if (lane == 0) decays[hh] = expf(total);
    }

    // ---- C.B^T once for both heads: warp w takes rows 16 (w%4), cols 32 (w/4) ----
    {
      const int i0 = 16 * (warp % 4), j0 = 32 * (warp / 4);
      if (j0 <= i0 + 15) {  // blocks above the diagonal are never read
        float acc[4][4] = {};
#pragma unroll
        for (int kn = 0; kn < kN / 16; ++kn) {
          uint32_t af[TI][4], w[TI];
          const int n = 16 * kn + 2 * t;
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // C: rows i0 + g (+8), cols n (+8)
            words(Cs + (i0 + g + 8 * (r & 1)) * S::BS + n + 8 * (r >> 1), w);
#pragma unroll
            for (int k = 0; k < TI; ++k) af[k][r] = w[k];
          }
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const T* br = Bs + (j0 + 8 * nb + g) * S::BS + n;
            uint32_t bf[TI][2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              words(br + 8 * r, w);
#pragma unroll
              for (int k = 0; k < TI; ++k) bf[k][r] = w[k];
            }
            mma_terms<TI, TI>(acc[nb], af, bf);
          }
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int j = j0 + 8 * nb + 2 * t;
          *reinterpret_cast<float2*>(cb + (i0 + g) * kCBS + j) =
              make_float2(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<float2*>(cb + (i0 + g + 8) * kCBS + j) =
              make_float2(acc[nb][2], acc[nb][3]);
        }
      }
    }
    __syncthreads();

    // ---- G = C.B^T exp(seg_i - seg_j) dt_j on j <= i, else 0, as bf16 hi + lo ----
    __nv_bfloat16* gt = gpl + hh * TF * kQ * kGS;  // term k at gt + k * kQ * kGS
    if (head_ok) {
      const float* seg = segs + hh * kQ;
      for (int e = tid % 128; e < kQ * kQ / 2; e += 128) {
        const int i = e / (kQ / 2), j = 2 * (e % (kQ / 2));
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          v[u] = j + u <= i ? cb[i * kCBS + j + u] * expf(seg[i] - seg[j + u]) *
                                  to_f32(Ds[(j + u) * kHeads + hh])
                            : 0.0f;
        }
        uint32_t w[TF];
        split_terms<TF>(v[0], v[1], w);
#pragma unroll
        for (int k = 0; k < TF; ++k)
          *reinterpret_cast<uint32_t*>(gt + k * kQ * kGS + i * kGS + j) = w[k];
      }
    }
    __syncthreads();

    if (head_ok) {
      const float* tail = tails + hh * kQ;
      const float* ein = eins + hh * kQ;
      float yacc[kQ / 8][4];  // y^T: rows p = p0 + g (+8), cols i = 8 ib + 2t (+1)
#pragma unroll
      for (int ib = 0; ib < kQ / 8; ++ib)
        yacc[ib][0] = yacc[ib][1] = yacc[ib][2] = yacc[ib][3] = 0.0f;

      // ---- inter-chunk: y^T = h . C^T, the state from registers as A ----
      if (c > 0) {
#pragma unroll
        for (int kn = 0; kn < kN / 16; ++kn) {
          uint32_t af[TF][4], w[TF > TI ? TF : TI];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // h: block 2 kn + r / 2, rows g (+8)
            split_terms<TF>(hs[2 * kn + (r >> 1)][2 * (r & 1)],
                            hs[2 * kn + (r >> 1)][2 * (r & 1) + 1], w);
#pragma unroll
            for (int k = 0; k < TF; ++k) af[k][r] = w[k];
          }
#pragma unroll
          for (int ib = 0; ib < kQ / 8; ++ib) {
            const T* cr = Cs + (8 * ib + g) * S::BS + 16 * kn + 2 * t;
            uint32_t bf[TI][2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              words(cr + 8 * r, w);
#pragma unroll
              for (int k = 0; k < TI; ++k) bf[k][r] = w[k];
            }
            mma_terms<TF, TI>(yacc[ib], af, bf);
          }
        }
#pragma unroll
        for (int ib = 0; ib < kQ / 8; ++ib) {
          const float e0 = ein[8 * ib + 2 * t], e1 = ein[8 * ib + 2 * t + 1];
          yacc[ib][0] *= e0;
          yacc[ib][1] *= e1;
          yacc[ib][2] *= e0;
          yacc[ib][3] *= e1;
        }
      }

      // ---- intra-chunk: y^T += x^T . G^T (causal blocks only) ----
#pragma unroll
      for (int kj = 0; kj < kQ / 16; ++kj) {
        const int j = 16 * kj + 2 * t;
        uint32_t af[TI][4], w[TI];  // x^T: rows p0 + g (+8), cols j (+8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = j + 8 * (r >> 1), p = p0 + g + 8 * (r & 1);
          words(Xs + jj * S::XS + p, Xs + (jj + 1) * S::XS + p, w);
#pragma unroll
          for (int k = 0; k < TI; ++k) af[k][r] = w[k];
        }
#pragma unroll
        for (int ib = 0; ib < kQ / 8; ++ib) {
          if (16 * kj > 8 * ib + 7) continue;  // G is 0 above the diagonal
          const __nv_bfloat16* gr = gt + (8 * ib + g) * kGS + j;  // G^T: rows j, col i
          uint32_t bf[TF][2];
#pragma unroll
          for (int k = 0; k < TF; ++k) {
            bf[k][0] = *reinterpret_cast<const uint32_t*>(gr + k * kQ * kGS);
            bf[k][1] = *reinterpret_cast<const uint32_t*>(gr + k * kQ * kGS + 8);
          }
          mma_terms<TI, TF>(yacc[ib], af, bf);
        }
      }

      // ---- store y (rows past L or P are padding) ----
      const int c0 = c * kQ;
#pragma unroll
      for (int ib = 0; ib < kQ / 8; ++ib) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * ib + 2 * t + (e & 1), p = p0 + g + 8 * (e >> 1);
          if (c0 + i < L && p < P)
            store(&y[(((long long)batch * L + c0 + i) * NH + head) * P + p], yacc[ib][e]);
        }
      }

      // ---- state: h = h exp(seg_Q) + (x tail)^T . B ----
      const float decay = decays[hh];
#pragma unroll
      for (int nb = 0; nb < kN / 8; ++nb) {
        hs[nb][0] *= decay;
        hs[nb][1] *= decay;
        hs[nb][2] *= decay;
        hs[nb][3] *= decay;
      }
#pragma unroll
      for (int kj = 0; kj < kQ / 16; ++kj) {
        const int j = 16 * kj + 2 * t;
        uint32_t af[TF][4], w[TF > TI ? TF : TI];  // (x tail)^T: rows p, cols j
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = j + 8 * (r >> 1), p = p0 + g + 8 * (r & 1);
          split_terms<TF>(to_f32(Xs[jj * S::XS + p]) * tail[jj],
                          to_f32(Xs[(jj + 1) * S::XS + p]) * tail[jj + 1], w);
#pragma unroll
          for (int k = 0; k < TF; ++k) af[k][r] = w[k];
        }
#pragma unroll
        for (int nb = 0; nb < kN / 8; ++nb) {
          const T* br = Bs + j * S::BS + 8 * nb + g;  // B: rows j (+1, +8, +9), col n
          uint32_t bf[TI][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            words(br + 8 * r * S::BS, br + (8 * r + 1) * S::BS, w);
#pragma unroll
            for (int k = 0; k < TI; ++k) bf[k][r] = w[k];
          }
          mma_terms<TF, TI>(hs[nb], af, bf);
        }
      }
    }
    __syncthreads();  // this stage, C.B^T and G are read; the next chunk may overwrite them
    if (S::kStages == 1 && c + 1 < nchunks) {
      load(c + 1, 0);
      cp_async_commit();
    }
  }

  if (head_ok) {
    float* ho = hout + ((long long)batch * NH + head) * P * N;
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + 8 * (e >> 1), n = 8 * nb + 2 * t + (e & 1);
        if (p < P && n < N) ho[p * N + n] = hs[nb][e];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* hout, int batch, int L, int NH, int P, int N, void* stream) {
  using S = SsdLayout<T>;
  const int shared = S::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = N % S::kVec == 0 && P % S::kVec == 0 && NH % kHeads == 0 && aligned(x) &&
                  aligned(bm) && aligned(cm) && aligned(dt);
  dim3 grid((NH + kHeads - 1) / kHeads, batch);
  ssd_kernel<T><<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(hout), L, NH, P, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All inputs contiguous and of one type: dtype_code 0 = f32, 1 = bf16.
// y has the inputs' type; hout is f32.  Requires P <= 64 and N <= 128.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* hout, int batch, int L, int NH,
                              int P, int N, int dtype_code, void* stream) {
  if (P < 1 || P > kP || N < 1 || N > kN) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(x, dt, a, bm, cm, y, hout, batch, L, NH, P, N, stream);
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, hout, batch, L, NH, P, N, stream);
}

// Dynamic shared memory one CTA requests: dtype_code 0 = f32, 1 = bf16.
extern "C" int repro_ssd_scan_smem_bytes(int dtype_code) {
  return dtype_code == 0 ? SsdLayout<float>::kSmemBytes : SsdLayout<__nv_bfloat16>::kSmemBytes;
}
