// flash_attention: causal / GQA / sliding-window attention with an online
// softmax.  Two routes: the wgmma route below, for bf16 q, k, v at head dims
// 32, 64 and 128, and the SIMT route at the end of the file, for f32 at any
// head dim that is a multiple of 8 up to 128 and for bf16 at the others.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_attn_kernel), whose grid (batch, q_head, q_block,
// kv_block) runs the kv blocks in order and carries the running max m, the
// denominator l and the accumulator acc (all f32) in VMEM between them.
//
// On an H100 blocks run in parallel and in no order, so the kv sweep is a loop
// inside one CTA.  A CTA is one producer warp and two consumer warpgroups of
// 64 query rows each (288 threads):
//   * when the GQA group is even, the two warpgroups take the same 64 query
//     positions of two heads of one group, so each staged K/V tile serves
//     both; otherwise (group 1 or odd) they take 128 consecutive positions of
//     one head;
//   * the grid is persistent (one CTA per SM walks work items, longest causal
//     query tiles first); per item the producer warp's lane 0 loads both Q
//     blocks once and K/V tiles of 64 keys through a ring of kStages stages
//     in shared memory, running ahead into the next item, all by TMA
//     (cp.async.bulk.tensor) from 4-D tensor maps over (D, H, L, B), so the
//     strided head layout needs no repacking and TMA's zero fill covers a
//     ragged Lq or Lk.  Each stage has a full barrier (TMA bytes) and an empty
//     barrier (one arrival per consumer warp);
//   * each warpgroup computes S = Q K^T with wgmma (m64n64k16, both operands
//     in shared memory, K-major, in the tensor maps' 128-byte swizzle, 64-byte
//     at D = 32), then O += P V with wgmma in its RS form: P from registers
//     (the S accumulator's layout is the A-fragment layout) and V as an
//     MN-major B operand.
// Within a warpgroup, S of the next tile and P V of the current one are in
// flight together while the softmax of the next tile waits only for its S.
// Numbers keep the reference's f32 semantics: bf16 times bf16 is exact in f32,
// so S is the reference's f32 dot product up to the order of the sums; P (f32)
// is split into bf16 hi + lo and multiplied twice (about 16 bits of P); m, l
// and acc stay f32.  The softmax runs in base 2 with log2(e) folded into the
// scale (ex2.approx, relative error about 2^-22).  Masks are positional,
// kpos <= qpos and kpos > qpos - window, plus kpos < Lk; they are applied only
// on tiles that cross the diagonal, the window edge or Lk, and tiles wholly
// outside are never loaded.  A row that no
// key reaches keeps l = 0 and is written as 0, as the reference's max(l,
// 1e-30) gives.  Query rows past Lq are computed on TMA's zeros and not
// stored.
//
// What bounds it on an H100: at the main path's shapes (Lq = Lk = 512, D =
// 128, causal, GQA 8) the bytes of q, k, v and o (0.045 ms at 3.35 TB/s) and
// the causal products (0.035 ms at 989 TFLOP/s; the P split adds half again)
// are close.  The design overlaps the loads with the products, keeps both
// products on the tensor cores and overlaps each softmax with the previous
// tile's P V.

#include <cuda.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;      // query rows per consumer warpgroup
constexpr int kBK = 64;        // keys per staged tile
constexpr int kStages = 4;     // K/V ring depth
constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kSwizzle = D * 2 >= 128 ? 128 : 64;  // bytes per smem row
  static constexpr int kPanelCols = kSwizzle / 2;            // bf16 columns per panel
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kPanelBytes = 64 * kSwizzle;          // one 64-row box
  static constexpr int kTileBytes = kPanels * kPanelBytes;   // 64 rows x D
  static constexpr uint32_t kDescSwizzle = kSwizzle == 128 ? 1 : 2;
  // Q[2], then K[kStages], V[kStages], then the barriers
  static constexpr int kBarrierOffset = (2 + 2 * kStages) * kTileBytes;
  static constexpr int kSmemBytes = kBarrierOffset + (2 * kStages + 2) * 8 + 1024;
};

// K-major operand (rows x D, D contiguous in 64- or 128-byte swizzled panels):
// the 16 columns of k-step `k` start `k*16` columns into the tile.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  using L = Layout<D>;
  const int col = k * 16;
  const uint32_t addr = tile + (col / L::kPanelCols) * L::kPanelBytes + (col % L::kPanelCols) * 2;
  return wgmma_desc(addr, 16, 8 * L::kSwizzle, L::kDescSwizzle);
}

// V as the MN-major B operand of P V: keys 16*kk.. (K dimension, one smem row
// each), D along the rows (the N dimension, one panel per 64 columns).
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  using L = Layout<D>;
  return wgmma_desc(tile + kk * 16 * L::kSwizzle, L::kPanelBytes, 8 * L::kSwizzle,
                    L::kDescSwizzle);
}

struct Work {
  int head, r0, tb, te;  // one warpgroup's head, first query row, kv tiles [tb, te)
};

__device__ __forceinline__ Work work_of(int w, int unit, int qt, bool pair, int Lk, int causal,
                                        int window) {
  Work wk;
  wk.head = pair ? 2 * unit + w : unit;
  wk.r0 = pair ? qt * kRows : qt * 2 * kRows + w * kRows;
  const int nk = (Lk + kBK - 1) / kBK;
  wk.te = causal ? min(nk, (wk.r0 + kRows - 1) / kBK + 1) : nk;
  wk.tb = window ? max(0, wk.r0 - window + 1) / kBK : 0;
  return wk;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o,  // (B, Lq, H, D)
             int Lq, int Lk, int H, int group, int n_qt, int units, int batches,
             float scale_log2, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = smem;                           // 2 tiles
  uint8_t* k_s = smem + 2 * L::kTileBytes;       // kStages tiles
  uint8_t* v_s = k_s + kStages * L::kTileBytes;  // kStages tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarrierOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + 1;

  // Work items: (q tile, head unit, batch row), the q tile the slowest index
  // so that the longest causal tiles come first.  The grid is persistent: in
  // round k CTA b takes item k G + b, or k G + G - 1 - b in odd rounds (G the
  // grid), which evens out the CTAs' sums of item lengths; its producer loads
  // the next item's Q and K/V while the consumers finish this one.
  const bool pair = group % 2 == 0;
  const int total = n_qt * units * batches;
  const int G = gridDim.x, b = blockIdx.x;
  auto item_index = [&](int k) { return k * G + ((k & 1) ? G - 1 - b : b); };
  struct Item {
    Work w0, w1;
    int batch, kv_head, tb, te;  // kv tiles either warpgroup needs: [tb, te)
  };
  auto item_of = [&](int idx) {
    Item it;
    const int qt = n_qt - 1 - idx / (units * batches);
    const int rest = idx % (units * batches);
    const int unit = rest % units;
    it.batch = rest / units;
    it.w0 = work_of(0, unit, qt, pair, Lk, causal, window);
    it.w1 = work_of(1, unit, qt, pair, Lk, causal, window);
    it.kv_head = it.w0.head / group;  // both warpgroups share it
    // the two ranges overlap or touch, so their union is one range
    const bool e0 = it.w0.tb >= it.w0.te, e1 = it.w1.tb >= it.w1.te;
    it.tb = e0 ? it.w1.tb : (e1 ? it.w0.tb : min(it.w0.tb, it.w1.tb));
    it.te = e0 ? (e1 ? it.tb : it.w1.te) : (e1 ? it.w0.te : max(it.w0.te, it.w1.te));
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: per item Q once, then K/V tiles through the ring ----
    if (lane == 0) {
      int i = 0;  // ring slots so far
      for (int n = 0; item_index(n) < total; ++n) {
        const Item it = item_of(item_index(n));
        mbar_wait(qempty, (n & 1) ^ 1);  // the last item's Q is read
        mbar_expect_tx(qfull, 2 * L::kTileBytes);
        for (int w = 0; w < 2; ++w) {
          const Work& wk = w ? it.w1 : it.w0;
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(q_s + w * L::kTileBytes + p * L::kPanelBytes, &qmap, qfull,
                        p * L::kPanelCols, wk.head, wk.r0, it.batch);
        }
        for (int t = it.tb; t < it.te; ++t, ++i) {
          const int s = i % kStages;
          mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::kTileBytes);
          for (int p = 0; p < L::kPanels; ++p) {
            tma_load_4d(k_s + s * L::kTileBytes + p * L::kPanelBytes, &kmap, &full[s],
                        p * L::kPanelCols, it.kv_head, t * kBK, it.batch);
            tma_load_4d(v_s + s * L::kTileBytes + p * L::kPanelBytes, &vmap, &full[s],
                        p * L::kPanelCols, it.kv_head, t * kBK, it.batch);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns 64 query rows of each item ----
    const int wg = warp / 4, wwarp = warp % 4;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_tile = smem_addr(q_s + wg * L::kTileBytes);
    Work me = {0, 0, 0, 0};  // this warpgroup's part of the item
    int row0 = 0, row1 = 0;  // this thread's rows: row0 and row0 + 8

    float acc[D / 2];
    float m0, m1, l0, l1;  // l: per-thread partials
    float sc[kBK / 2];                                          // S, then P, of one tile
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];                  // P as bf16 hi + lo
    float al0 = 0.0f, al1 = 0.0f;                               // the last tile's rescale

    // S = Q K^T (64 x 64, f32) of the tile in stage s: one committed group
    auto issue_s = [&](int s) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.0f;
      const uint32_t k_tile = smem_addr(k_s + s * L::kTileBytes);
      fence_regs<kBK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss_n64(sc, kmajor_desc<D>(q_tile, k), kmajor_desc<D>(k_tile, k), k > 0);
      wgmma_commit();
    };
    // O += P V with the V tile in stage s, P in bf16 hi + lo: one committed group
    auto issue_pv = [&](int s) {
      const uint32_t v_tile = smem_addr(v_s + s * L::kTileBytes);
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = v_desc<D>(v_tile, kk);
        wgmma_rs<D>(acc, ph[kk], dv);
        wgmma_rs<D>(acc, pl[kk], dv);
      }
      wgmma_commit();
    };
    // mask (boundary tiles only) and the online softmax in base 2 of tile t:
    // S becomes P in place, m and l move on, al0/al1 rescale the old acc
    auto softmax = [&](int t) {
      const int k0 = t * kBK;
      const bool edge = (causal && k0 + kBK - 1 > me.r0) ||
                        (window && k0 <= me.r0 + kRows - 1 - window) || k0 + kBK > Lk;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) {
          const int qpos = (j & 2) ? row1 : row0;
          const int kpos = k0 + 8 * (j / 4) + 2 * t4 + (j & 1);
          bool ok = kpos < Lk;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && kpos > qpos - window;
          if (!ok) sc[j] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 2; j += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[j], sc[j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j + 2], sc[j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;  // a row with no key yet
      const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
      al0 = exp2_approx(m0 - mu0);
      al1 = exp2_approx(m1 - mu1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const float p = exp2_approx(fmaf(sc[j], scale_log2, (j & 2) ? -mu1 : -mu0));
        sc[j] = p;
        if (j & 2) ps1 += p; else ps0 += p;
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
    };
    auto make_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)  // r: (row0, keys 2t..), (row1, ..), (row0, 2t+8..), (row1, ..)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };

    // The union of both warpgroups' tiles comes through the ring in order;
    // this warpgroup computes [me.tb, me.te) of it and only releases the rest.
    // Within its own tiles, S of tile t and P V of tile t - 1 are in flight
    // together while the softmax of tile t waits only for S.
    int i = 0;  // ring slots so far, as the producer counts them
    for (int n = 0; item_index(n) < total; ++n) {
      const Item it = item_of(item_index(n));
      const int te = it.te;
      me = wg ? it.w1 : it.w0;
      row0 = me.r0 + wwarp * 16 + g;
      row1 = row0 + 8;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.0f;
      mbar_wait(qfull, n & 1);
      int t = it.tb;
      for (; t < te && t < me.tb; ++t, ++i) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        release(i % kStages);
      }
      const int mine_end = min(te, me.te);
      if (t < mine_end) {
        int prev = i % kStages;
        mbar_wait(&full[prev], (i / kStages) & 1);
        issue_s(prev);
        wgmma_wait<0>();
        fence_regs<kBK / 2>(sc);
        softmax(t);  // acc is 0: nothing to rescale
        make_p();
        for (++t, ++i; t < mine_end; ++t, ++i) {
          const int s = i % kStages;
          mbar_wait(&full[s], (i / kStages) & 1);
          issue_s(s);
          issue_pv(prev);
          wgmma_wait<1>();  // S of tile t; P V of tile t - 1 may still run
          fence_regs<kBK / 2>(sc);
          softmax(t);
          wgmma_wait<0>();
          fence_regs<D / 2>(acc);
          release(prev);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
          make_p();
          prev = s;
        }
        issue_pv(prev);
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        release(prev);
      }
      for (; t < te; ++t, ++i) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        release(i % kStages);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty);  // Q is read: the next item's may come

      // ---- flush: acc / max(l, 1e-30), in bf16 ----
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* o0 = o + (((long long)it.batch * Lq + row0) * H + me.head) * D;
      __nv_bfloat16* o1 = o + (((long long)it.batch * Lq + row1) * H + me.head) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (row0 < Lq)
          *reinterpret_cast<uint32_t*>(o0 + col) =
              pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
        if (row1 < Lq)
          *reinterpret_cast<uint32_t*>(o1 + col) =
              pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (B, L, H, D) bf16 tensor, innermost first, with boxes of
// (one panel of D, 1 head, 64 rows, 1 batch row).
template <int D>
int make_map(CUtensorMap* map, const void* base, int batch, int len, int heads) {
  using Lt = Layout<D>;
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(len) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Lt::kPanelCols), 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Lt::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int Lq, int Lk,
           int H, int Hkv, float scale, int causal, int window, void* stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_map<D>(&qmap, q, batch, Lq, H);
  if (!err) err = make_map<D>(&kmap, k, batch, Lk, Hkv);
  if (!err) err = make_map<D>(&vmap, v, batch, Lk, Hkv);
  if (err) return err;
  const int group = H / Hkv;
  const bool pair = group % 2 == 0;
  const int units = pair ? H / 2 : H;
  const int rows_per_cta = pair ? kRows : 2 * kRows;
  const int n_qt = (Lq + rows_per_cta - 1) / rows_per_cta;
  const int smem = Layout<D>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = min(n_qt * units * batch, sms);  // one persistent CTA per SM
  flash_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Lq, Lk, H, group, n_qt, units, batch,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---- the SIMT route: f32 q, k, v at any head dim, bf16 at the head dims the
// wgmma route does not take ----
//
// One CTA per (query tile of kSimtRows rows, head, batch row): four warps,
// eight query rows each.  K/V tiles of kSimtKeys keys are staged through
// shared memory in f32 (bf16 is widened on load), K with a padded row stride
// (D + 1 floats, odd for every D the route takes) so that lanes reading
// different keys hit different banks.  For each of its rows a warp computes
// the scores of the tile's keys (lane j: keys j and j + 32) with f32 FMAs,
// reduces their max and the sum of exp(s - m) across the warp, and updates the
// row's running max, denominator and accumulator (lane c holds output columns
// c, c + 32, ...) with the same online softmax as the wgmma route, all in f32
// (expf, no fast-math exponent).  Masks are positional as there; a row that no
// key reaches keeps l = 0 and is written as 0.  No tensor core: TF32 would
// break the f32 tolerance.
//
// What bounds it: its f32 FMAs (the causal products at 67 TFLOP/s) more than
// its bytes; each FMA also reads shared memory once, which holds it below
// the FMA peak.  This route is right and simple, not fast (ROADMAP Queue 2).

constexpr int kSimtRows = 32;   // query rows per CTA
constexpr int kSimtKeys = 64;   // keys per staged tile
constexpr int kSimtWarps = 4;
constexpr int kSimtRowsPerWarp = kSimtRows / kSimtWarps;

__host__ __device__ constexpr int simt_smem_floats(int D) {
  return kSimtRows * D + kSimtKeys * (D + 1) + kSimtKeys * D + kSimtWarps * kSimtKeys;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// DV = ceil(D / 32): output columns per lane.
template <typename T, int DV>
__global__ void __launch_bounds__(kSimtWarps * 32)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Lq, int Lk, int H, int Hkv, int D, float scale,
                  int causal, int window) {
  extern __shared__ float simt_smem[];
  const int ds = D + 1;
  float* sq = simt_smem;               // kSimtRows x D
  float* sk = sq + kSimtRows * D;      // kSimtKeys x (D + 1)
  float* sv = sk + kSimtKeys * ds;     // kSimtKeys x D
  float* sp = sv + kSimtKeys * D;      // kSimtWarps x kSimtKeys probabilities
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kSimtRows;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kThreadsSimt = kSimtWarps * 32;

  for (int i = tid; i < kSimtRows * D; i += kThreadsSimt) {
    const int r = i / D, c = i - r * D, qi = q0 + r;
    sq[i] = qi < Lq ? widen(q[((static_cast<long long>(b) * Lq + qi) * H + h) * D + c]) : 0.f;
  }
  // keys any row of this tile can reach
  const int kend = causal ? min(Lk, q0 + kSimtRows) : Lk;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], acc[kSimtRowsPerWarp][DV];
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[rr][i] = 0.f;
  }
  float* p_w = sp + warp * kSimtKeys;

  for (int t0 = (kbeg / kSimtKeys) * kSimtKeys; t0 < kend; t0 += kSimtKeys) {
    __syncthreads();  // the previous tile is consumed (and Q is visible)
    for (int i = tid; i < kSimtKeys * D; i += kThreadsSimt) {
      const int r = i / D, c = i - r * D, kj = t0 + r;
      const long long off = ((static_cast<long long>(b) * Lk + kj) * Hkv + hk) * D + c;
      const bool in = kj < Lk;
      sk[r * ds + c] = in ? widen(k[off]) : 0.f;
      sv[r * D + c] = in ? widen(v[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
      const int r = warp * kSimtRowsPerWarp + rr, qi = q0 + r;
      const float* qrow = sq + r * D;
      const int j0 = lane, j1 = lane + 32;
      const float* k0 = sk + j0 * ds;
      const float* k1 = sk + j1 * ds;
      float d0 = 0.f, d1 = 0.f;
      for (int c = 0; c < D; ++c) {
        const float qc = qrow[c];
        d0 = fmaf(qc, k0[c], d0);
        d1 = fmaf(qc, k1[c], d1);
      }
      const int kj0 = t0 + j0, kj1 = t0 + j1;
      const bool v0 = kj0 < Lk && (!causal || kj0 <= qi) && (window <= 0 || kj0 > qi - window);
      const bool v1 = kj1 < Lk && (!causal || kj1 <= qi) && (window <= 0 || kj1 > qi - window);
      const float s0 = v0 ? d0 * scale : -INFINITY;
      const float s1 = v1 ? d1 * scale : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (mx == -INFINITY) continue;  // no key of this tile reaches the row (warp-uniform)
      const float mn = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - mn);
      const float p0 = v0 ? expf(s0 - mn) : 0.f;
      const float p1 = v1 ? expf(s1 - mn) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mn;
      p_w[j0] = p0;
      p_w[j1] = p1;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const int c = lane + 32 * i;
        if (c < D) {
          float a = acc[rr][i] * alpha;
          for (int j = 0; j < kSimtKeys; ++j) a = fmaf(p_w[j], sv[j * D + c], a);
          acc[rr][i] = a;
        }
      }
      __syncwarp();  // p_w is read before the next row writes it
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kSimtRowsPerWarp + rr;
    if (qi >= Lq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Lq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int c = lane + 32 * i;
      if (c < D) narrow(orow + c, acc[rr][i] / den);
    }
  }
}

template <typename T, int DV>
int launch_simt(const void* q, const void* k, const void* v, void* o, int batch, int Lq, int Lk,
                int H, int Hkv, int D, float scale, int causal, int window, void* stream) {
  // Set per launch, not through opt_in_shared_memory: its once-only flag is
  // kept per kernel *type*, which every instantiation of one T shares.
  const int smem = simt_smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(flash_simt_kernel<T, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Lq + kSimtRows - 1) / kSimtRows, H, batch);
  flash_simt_kernel<T, DV><<<grid, kSimtWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lk, H, Hkv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o, int batch, int Lq,
                  int Lk, int H, int Hkv, int D, float scale, int causal, int window,
                  void* stream) {
  switch ((D + 31) / 32) {
    case 1: return launch_simt<T, 1>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
    case 2: return launch_simt<T, 2>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
    case 3: return launch_simt<T, 3>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
    default: return launch_simt<T, 4>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
  }
}

}  // namespace

// q (B, Lq, H, D), k and v (B, Lk, Hkv, D), o (B, Lq, H, D): bf16, contiguous,
// 16-byte aligned.  D is one of 32, 64, 128; H a multiple of Hkv.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int Lq, int Lk, int H, int Hkv, int D,
                                     float scale, int causal, int window, void* stream) {
  if (Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, batch, Lq, Lk, H, Hkv, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one CTA of the kernel for head dim D requests.
extern "C" int repro_flash_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return Layout<32>::kSmemBytes;
    case 64: return Layout<64>::kSmemBytes;
    case 128: return Layout<128>::kSmemBytes;
    default: return -1;
  }
}

// The SIMT route: q (B, Lq, H, D), k and v (B, Lk, Hkv, D), o (B, Lq, H, D),
// contiguous, all f32 (bf16 != 0: all bf16); D a multiple of 8 from 8 to 128;
// H a multiple of Hkv.
extern "C" int repro_flash_attention_simt(const void* q, const void* k, const void* v, void* o,
                                          int batch, int Lq, int Lk, int H, int Hkv, int D,
                                          float scale, int causal, int window, int bf16,
                                          void* stream) {
  if (Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv || D < 8 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch_simt<__nv_bfloat16>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal,
                                             window, stream)
              : dispatch_simt<float>(q, k, v, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window,
                                     stream);
}

// Dynamic shared memory one CTA of the SIMT route requests at head dim D.
extern "C" int repro_flash_attention_simt_smem_bytes(int D) {
  return simt_smem_floats(D) * static_cast<int>(sizeof(float));
}
