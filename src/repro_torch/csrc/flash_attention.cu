// flash_attention: causal / GQA / sliding-window attention with an online
// softmax, for bf16 q, k, v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_attn_kernel), whose grid (batch, q_head, q_block,
// kv_block) runs the kv blocks in order and carries the running max m, the
// denominator l and the accumulator acc (all f32) in VMEM between them.
//
// On an H100 blocks run in parallel and in no order, so the kv sweep is a loop
// inside one CTA per (q tile of 64 rows, q head, batch).  Four warps each own
// 16 query rows and keep their m, l and a 16 x D f32 accumulator in registers
// for the whole sweep; the CTA stages each 64-row tile of k and v (of kv head
// h // group, as in the reference) in shared memory.  Products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   * S = Q K^T: bf16 times bf16 is exact in f32, so S is the f32 dot product
//     of the reference up to the order of the sums;
//   * O += P V: P is f32, so it is split as P = P_hi + P_lo with both halves
//     in bf16 and multiplied twice, which keeps about 16 bits of P (the
//     reference keeps P in f32; the output is rounded to bf16 in both).
// Masks are the reference's: kpos <= qpos (causal) and kpos > qpos - window,
// plus kpos < Lk for a ragged last kv tile.  Tiles wholly outside the mask are
// skipped (their contribution is exactly zero).  A row that no key reaches
// keeps l = 0 and is written as 0, as the reference's max(l, 1e-30) gives.
// Query rows past Lq are computed on zeros and not stored, so Lq need not be a
// multiple of the tile.
//
// What bounds it on an H100: at the main path's shapes (Lq = Lk = 512, D =
// 128, causal) the bytes of q, k, v and o (0.045 ms at 3.35 TB/s) and the
// causal products (0.035 ms at 989 TFLOP/s) are close.  This first kernel
// uses mma.sync from registers without TMA, wgmma or a pipelined load, so it
// is neither; it is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per CTA (16 per warp)
constexpr int kBK = 64;  // keys per staged tile
constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile; a: 4 regs (16x16 bf16, row-major),
// b: 2 regs (16x8 bf16, column-major), d: 4 f32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Lq, H, D)
             const __nv_bfloat16* __restrict__ k,  // (B, Lk, Hkv, D)
             const __nv_bfloat16* __restrict__ v,  // (B, Lk, Hkv, D)
             __nv_bfloat16* __restrict__ o,        // (B, Lq, H, D)
             int Lq, int Lk, int H, int Hkv, float scale, int causal, int window) {
  constexpr int LD = D + 8;  // padded smem row (bf16): conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LD];

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int row0 = q0 + warp * 16 + g;    // this thread's two query rows:
  const int row1 = row0 + 8;              // row0 and row0 + 8

  // Q fragments for the whole head dim, straight from global memory.
  uint32_t qf[D / 16][4];
  {
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
        q + (((long long)batch * Lq + row0) * H + head) * D);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
        q + (((long long)batch * Lq + row1) * H + head) * D);
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      const int c = kb * 8 + t;  // 32-bit word of columns kb*16 + 2t, +1
      qf[kb][0] = row0 < Lq ? q0p[c] : 0u;
      qf[kb][1] = row1 < Lq ? q1p[c] : 0u;
      qf[kb][2] = row0 < Lq ? q0p[c + 4] : 0u;
      qf[kb][3] = row1 < Lq ? q1p[c + 4] : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // l: this thread's partial sums

  // kv tiles that can hold an unmasked key for some row of this q tile
  int kv_end = Lk;
  if (causal) kv_end = min(Lk, q0 + kBQ);
  int kv_begin = 0;
  if (window) kv_begin = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully read
    constexpr int kVecPerRow = D / 8;  // 16-byte vectors per row
    for (int e = threadIdx.x; e < kBK * kVecPerRow; e += kWarps * 32) {
      const int r = e / kVecPerRow, c = e % kVecPerRow;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) {
        const long long off = (((long long)batch * Lk + k0 + r) * Hkv + kv_head) * D;
        kv = reinterpret_cast<const uint4*>(k + off)[c];
        vv = reinterpret_cast<const uint4*>(v + off)[c];
      }
      reinterpret_cast<uint4*>(ks + r * LD)[c] = kv;
      reinterpret_cast<uint4*>(vs + r * LD)[c] = vv;
    }
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys ----
    float s[kBK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
#pragma unroll
      for (int nb = 0; nb < kBK / 8; ++nb) {
        const __nv_bfloat16* kr = ks + (nb * 8 + g) * LD + kb * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[nb], qf[kb], b0, b1);
      }
    }

    // ---- scale, mask, online softmax ----
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? row0 : row1;
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        bool ok = kpos < Lk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[nb][e] = ok ? s[nb][e] * scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads of a row group
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = m0 == kNegInf ? 0.0f : expf(m0 - mn0);
    const float al1 = m1 == kNegInf ? 0.0f : expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        const float p = mn == kNegInf ? 0.0f : expf(s[nb][e] - mn);
        s[nb][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= al0;
      acc[nd][1] *= al0;
      acc[nd][2] *= al1;
      acc[nd][3] *= al1;
    }

    // ---- O += P V, P split into bf16 hi + lo ----
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // r: 0 = (row0, keys 2t..), 1 = (row1, 2t..), 2 = (row0, 2t+8..), 3 = (row1, 2t+8..)
        const float* src = s[2 * kk + (r >> 1)] + 2 * (r & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
        ahi[r] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[r] = pack_bf16(src[0] - __low2float(hi), src[1] - __high2float(hi));
      }
      const __nv_bfloat16* vr0 = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vr = vr0 + nd * 8;
        const uint32_t b0 = pack_raw(vr[0], vr[LD]);
        const uint32_t b1 = pack_raw(vr[8 * LD], vr[9 * LD]);
        mma_bf16(acc[nd], ahi, b0, b1);
        mma_bf16(acc[nd], alo, b0, b1);
      }
    }
  }

  // ---- flush: acc / max(l, 1e-30), in bf16 ----
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < Lq) {
      *reinterpret_cast<uint32_t*>(o + (((long long)batch * Lq + row0) * H + head) * D + col) =
          pack_bf16(acc[nd][0] / d0, acc[nd][1] / d0);
    }
    if (row1 < Lq) {
      *reinterpret_cast<uint32_t*>(o + (((long long)batch * Lq + row1) * H + head) * D + col) =
          pack_bf16(acc[nd][2] / d1, acc[nd][3] / d1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int Lq, int Lk,
           int H, int Hkv, float scale, int causal, int window, void* stream) {
  dim3 grid((Lq + kBQ - 1) / kBQ, H, batch);
  flash_kernel<D><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Lq, Lk, H, Hkv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, H, D), k and v (B, Lk, Hkv, D), o (B, Lq, H, D): bf16, contiguous,
// 16-byte aligned.  D is one of 32, 64, 128; H a multiple of Hkv.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int Lq, int Lk, int H, int Hkv, int D,
                                     float scale, int causal, int window, void* stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
