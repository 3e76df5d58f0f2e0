// flash_attention: causal / GQA / sliding-window attention with an online
// softmax.  Two routes, both on the tensor cores: the wgmma route below, for
// bf16 q, k, v at head dims 32, 64 and 128, and the split route after it, for
// f32 at any head dim that is a multiple of 8 up to 128 and for bf16 at the
// other such head dims.
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
  // Q[2], then K[kStages], V[kStages], then the barriers
  static constexpr int kBarrierOffset = (2 + 2 * kStages) * kTileBytes;
  static constexpr int kSmemBytes = kBarrierOffset + (2 * kStages + 2) * 8 + 1024;
};

// K-major operand (rows x D, D contiguous in Swizzle-byte swizzled panels of
// PanelBytes each): the 16 columns of k-step `k` start `k*16` columns into
// the tile.
template <int Swizzle, int PanelBytes>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  constexpr int kPanelCols = Swizzle / 2;
  const int col = k * 16;
  const uint32_t addr = tile + (col / kPanelCols) * PanelBytes + (col % kPanelCols) * 2;
  return wgmma_desc(addr, 16, 8 * Swizzle, Swizzle == 128 ? 1 : 2);
}

// V as the MN-major B operand of P V: keys 16*kk.. (K dimension, one smem row
// each), D along the rows (the N dimension, one panel per Swizzle / 2 columns).
template <int Swizzle, int PanelBytes>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  return wgmma_desc(tile + kk * 16 * Swizzle, PanelBytes, 8 * Swizzle, Swizzle == 128 ? 1 : 2);
}

struct Work {
  int head, r0, tb, te;  // one warpgroup's head, first query row, kv tiles [tb, te)
};

template <int BK>
__device__ __forceinline__ Work work_of(int w, int unit, int qt, bool pair, int Lk, int causal,
                                        int window) {
  Work wk;
  wk.head = pair ? 2 * unit + w : unit;
  wk.r0 = pair ? qt * kRows : qt * 2 * kRows + w * kRows;
  const int nk = (Lk + BK - 1) / BK;
  wk.te = causal ? min(nk, (wk.r0 + kRows - 1) / BK + 1) : nk;
  wk.tb = window ? max(0, wk.r0 - window + 1) / BK : 0;
  return wk;
}

// Work items: (q tile, head unit, batch row), the q tile the slowest index so
// that the longest causal tiles come first.  The grid is persistent: in round
// k CTA b takes item k G + b, or k G + G - 1 - b in odd rounds (G the grid),
// which evens out the CTAs' sums of item lengths.
struct Item {
  Work w0, w1;
  int batch, kv_head, tb, te;  // kv tiles either warpgroup needs: [tb, te)
};

__device__ __forceinline__ int item_index(int k) {
  const int G = gridDim.x, b = blockIdx.x;
  return k * G + ((k & 1) ? G - 1 - b : b);
}

template <int BK>
__device__ __forceinline__ Item item_of(int idx, int n_qt, int units, int batches, bool pair,
                                        int group, int Lk, int causal, int window) {
  Item it;
  const int qt = n_qt - 1 - idx / (units * batches);
  const int rest = idx % (units * batches);
  const int unit = rest % units;
  it.batch = rest / units;
  it.w0 = work_of<BK>(0, unit, qt, pair, Lk, causal, window);
  it.w1 = work_of<BK>(1, unit, qt, pair, Lk, causal, window);
  it.kv_head = it.w0.head / group;  // both warpgroups share it
  // the two ranges overlap or touch, so their union is one range
  const bool e0 = it.w0.tb >= it.w0.te, e1 = it.w1.tb >= it.w1.te;
  it.tb = e0 ? it.w1.tb : (e1 ? it.w0.tb : min(it.w0.tb, it.w1.tb));
  it.te = e0 ? (e1 ? it.tb : it.w1.te) : (e1 ? it.w0.te : max(it.w0.te, it.w1.te));
  return it;
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

  // The producer loads the next item's Q and K/V while the consumers finish
  // this one.
  const bool pair = group % 2 == 0;
  const int total = n_qt * units * batches;
  auto item = [&](int idx) {
    return item_of<kBK>(idx, n_qt, units, batches, pair, group, Lk, causal, window);
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
        const Item it = item(item_index(n));
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
        wgmma_ss_n64(sc, kmajor_desc<L::kSwizzle, L::kPanelBytes>(q_tile, k),
                     kmajor_desc<L::kSwizzle, L::kPanelBytes>(k_tile, k), k > 0);
      wgmma_commit();
    };
    // O += P V with the V tile in stage s, P in bf16 hi + lo: one committed group
    auto issue_pv = [&](int s) {
      const uint32_t v_tile = smem_addr(v_s + s * L::kTileBytes);
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = v_desc<L::kSwizzle, L::kPanelBytes>(v_tile, kk);
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
      const Item it = item(item_index(n));
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

// ---- the split route: f32 q, k, v at any head dim that is a multiple of 8
// up to 128, bf16 at the head dims the wgmma route does not take ----
//
// The wgmma route's persistent grid, work items, pipeline and consumer
// warpgroups, with every operand as bf16 terms so that the tensor cores
// compute f32 products:
//   * an f32 value x is three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid) (each subtraction exact in f32; hi + mid + lo
//     is x, all 24 bits); a bf16 value is one term;
//   * the head dim is zero-padded to Dp, the next of 32, 64 and 128 (the
//     wrapper picks it), so the wgmma route's panels and swizzles serve;
//     zeros add nothing to Q K^T, the padded output columns are not stored,
//     the scale is 1/sqrt(D);
//   * for f32, split_kv_kernel writes K's and V's terms once per call, (3,
//     B, Lk, Hkv, Dp) bf16, which the producer loads by TMA through the
//     ring; at GQA 8 each K/V tile serves 8 query heads, so splitting it in
//     every CTA would repeat the work.  For bf16 the producer loads K and V
//     themselves, in boxes Dp wide whose columns past D TMA fills with zeros;
//   * each consumer warpgroup loads the 64 query rows of each item (all
//     loads in flight together) and writes their terms into shared memory in
//     TMA's swizzle; Q's first two terms then stay in registers (ldmatrix),
//     so that their S products take the RS form and read no A operand from
//     shared memory, which the 32-key products' small N leaves the limit;
//   * S is the sum of the term products whose orders add to at most 2:
//     hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid for f32 (an f32 product
//     to about 2^-24; two terms and three products missed the reference's
//     f32 tolerance in ssd_scan.cu), one product for bf16.  P is split in
//     registers into three terms (f32; two for bf16, as the wgmma route) and
//     O takes the products of P's and V's terms of order at most 2.  The
//     small products are issued first, hi.hi last;
//   * three terms of K and V for 64 keys take 96 KB at Dp = 128, and Q's
//     terms for both warpgroups another 96 KB, so f32 at Dp = 128 stages
//     32-key tiles (two stages); every other case stages 64 keys.  K and V
//     of a stage have barriers of their own, so a K slot is loaded again as
//     soon as S has read it, a tile before P V frees the V slot;
//   * the producer is a whole warpgroup (one thread issues the loads), so
//     that it can hand its registers to the consumers (setmaxnreg): they
//     keep O, S and P's terms without spilling.
// The output is stored in the inputs' type.
//
// What bounds it: at the f32 qwen3 layer (Lq = Lk = 512, D = 128, causal,
// GQA 8) the function's least time is the f32 bytes of q, k, v and o (0.090
// ms at 3.35 TB/s); the route's own six bf16 products of the causal pairs
// take 0.209 ms at 989 TFLOP/s, and the split pass moves about 84 MB
// (0.025 ms).

constexpr int kSmemOptin = 232448;  // an H100 block's opt-in shared memory (227 KB)
// 2 consumer warpgroups + a producer warpgroup, whose registers the
// consumers take: 2 x 128 x 232 + 128 x 40 of the SM's 65,536
constexpr int kSplitThreads = 384;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

template <typename T, int Dp>
struct SplitLayout {
  static constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;   // bf16 terms of q, k and v
  static constexpr int kPTerms = sizeof(T) == 4 ? 3 : 2;  // bf16 terms of P
  static constexpr int kBK = kTerms == 3 && Dp == 128 ? 32 : 64;  // keys per staged tile
  static constexpr int kSwizzle = Layout<Dp>::kSwizzle;
  static constexpr int kPanelCols = kSwizzle / 2;
  static constexpr int kPanels = Dp / kPanelCols;
  static constexpr int kQPanelBytes = kRows * kSwizzle;
  static constexpr int kKPanelBytes = kBK * kSwizzle;
  static constexpr int kQTileBytes = kPanels * kQPanelBytes;  // one term of 64 rows
  static constexpr int kKTileBytes = kPanels * kKPanelBytes;  // one term of kBK keys
  // Q[warpgroup][term], then K[stage][term] and V[stage][term], then barriers
  static constexpr int kQBytes = 2 * kTerms * kQTileBytes;
  static constexpr int kStageBytes = 2 * kTerms * kKTileBytes;
  static constexpr int kFit = (kSmemOptin - 1024 - 4 * 4 * 8 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;  // at most 4
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr int kBarrierOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarrierOffset + 4 * kStages * 8 + 1024;  // + alignment
  static_assert(kSmemBytes <= kSmemOptin, "shared memory past the opt-in limit");
};

// An f32 pair as K bf16x2 terms: w[0] = bf16(v), w[k] = bf16 of what the
// terms before it leave.
template <int K>
__device__ __forceinline__ void pair_terms(float a, float b, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// 8 consecutive values as loaded (value-initialized: zeros), and as their
// bf16 terms, 16 bytes a term: three for f32, the values themselves for bf16.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  float4 a, b;
};
template <>
struct Chunk<__nv_bfloat16> {
  uint4 a;
};
__device__ __forceinline__ void load_chunk(const float* p, Chunk<float>& c) {
  c.a = *reinterpret_cast<const float4*>(p);
  c.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, Chunk<__nv_bfloat16>& c) {
  c.a = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void chunk_terms(const Chunk<float>& c, uint4* w) {
  uint32_t u[4][3];
  pair_terms<3>(c.a.x, c.a.y, u[0]);
  pair_terms<3>(c.a.z, c.a.w, u[1]);
  pair_terms<3>(c.b.x, c.b.y, u[2]);
  pair_terms<3>(c.b.z, c.b.w, u[3]);
#pragma unroll
  for (int t = 0; t < 3; ++t) w[t] = make_uint4(u[0][t], u[1][t], u[2][t], u[3][t]);
}
__device__ __forceinline__ void chunk_terms(const Chunk<__nv_bfloat16>& c, uint4* w) {
  w[0] = c.a;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Byte offset `off` (from a 1024-byte aligned panel) where TMA's Swizzle-byte
// swizzle puts it: the 16-byte chunk index XOR the 128-byte line index.
template <int Swizzle>
__device__ __forceinline__ int swizzled(int off) {
  return off ^ (((off >> 7) & (Swizzle / 16 - 1)) << 4);
}

// f32 k and v (rows x D each) as their three bf16 terms (3 x rows x Dp, zero
// past D); blockIdx.y picks the tensor.
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                __nv_bfloat16* __restrict__ kt, __nv_bfloat16* __restrict__ vt, long long rows,
                int D, int Dp) {
  constexpr int TT = 3;
  const float* x = blockIdx.y ? v : k;
  __nv_bfloat16* out = blockIdx.y ? vt : kt;
  const int chunks = Dp / 8;  // 16-byte chunks of a padded row
  const long long n = rows * chunks, term = rows * Dp;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / chunks;
    const int c = static_cast<int>(i - r * chunks) * 8;
    Chunk<float> raw{};
    if (c < D) load_chunk(x + r * D + c, raw);
    uint4 w[TT];
    chunk_terms(raw, w);
#pragma unroll
    for (int t = 0; t < TT; ++t) *reinterpret_cast<uint4*>(out + t * term + r * Dp + c) = w[t];
  }
}

template <typename T, int Dp>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_split_kernel(const T* __restrict__ q,  // (B, Lq, H, D)
                   const __grid_constant__ CUtensorMap kmap,  // K's terms, (terms*B, Lk, Hkv, Dp)
                   const __grid_constant__ CUtensorMap vmap,  // V's terms, the same
                   T* __restrict__ o,                         // (B, Lq, H, D)
                   int Lq, int Lk, int H, int D, int group, int n_qt, int units, int batches,
                   float scale_log2, int causal, int window) {
  using L = SplitLayout<T, Dp>;
  constexpr int BK = L::kBK, TT = L::kTerms, PT = L::kPTerms, NS = L::kStages;
  constexpr int SW = L::kSwizzle;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + L::kQBytes;
  uint8_t* v_s = k_s + NS * TT * L::kKTileBytes;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + L::kBarrierOffset);
  uint64_t* vfull = kfull + NS;
  uint64_t* kempty = vfull + NS;
  uint64_t* vempty = kempty + NS;

  const bool pair = group % 2 == 0;
  const int total = n_qt * units * batches;
  auto item = [&](int idx) {
    return item_of<BK>(idx, n_qt, units, batches, pair, group, Lk, causal, window);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 8);  // one arrival per consumer warp
      mbar_init(&vempty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer: K/V terms through the ring, running ahead into the next item ----
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      int i = 0;  // ring slots so far
      for (int n = 0; item_index(n) < total; ++n) {
        const Item it = item(item_index(n));
        for (int t = it.tb; t < it.te; ++t, ++i) {
          const int s = i % NS;
          const uint32_t parity = ((i / NS) & 1) ^ 1;
          for (int kv = 0; kv < 2; ++kv) {
            uint64_t* full = kv ? &vfull[s] : &kfull[s];
            mbar_wait(kv ? &vempty[s] : &kempty[s], parity);
            mbar_expect_tx(full, L::kStageBytes / 2);
            for (int term = 0; term < TT; ++term)
              for (int p = 0; p < L::kPanels; ++p)
                tma_load_4d((kv ? v_s : k_s) + (s * TT + term) * L::kKTileBytes +
                                p * L::kKPanelBytes,
                            kv ? &vmap : &kmap, full, p * L::kPanelCols, it.kv_head, t * BK,
                            term * batches + it.batch);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns 64 query rows of each item ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4, wwarp = warp % 4, wtid = threadIdx.x % 128;
    const int g = lane / 4, t4 = lane % 4;
    uint8_t* q_mine = q_s + wg * TT * L::kQTileBytes;
    const uint32_t q_tile = smem_addr(q_mine);
    Work me = {0, 0, 0, 0};  // this warpgroup's part of the item
    int row0 = 0, row1 = 0;  // this thread's rows: row0 and row0 + 8

    float acc[Dp / 2];
    float m0, m1, l0, l1;          // l: per-thread partials
    float sc[BK / 2];              // S, then P, of one tile
    uint32_t pt[PT][BK / 16][4];   // P as PT bf16 terms
    // Q's first QR terms stay in registers as the A operand of their S
    // products (the RS form reads no A from shared memory); a third term's
    // registers would spill
    constexpr int QR = TT < 2 ? TT : 2;
    uint32_t qreg[QR][Dp / 16][4];
    float al0 = 0.0f, al1 = 0.0f;  // the last tile's rescale

    // this warpgroup's 64 query rows of the item (zero past Lq and D), Dp / 16
    // chunks of 8 values a thread, all loads in flight together; then their
    // TT bf16 terms into shared memory, in the layout TMA's swizzle would give
    auto load_q = [&](int batch) {
      constexpr int kRowChunks = Dp / 8, kChunks = kRows * kRowChunks / 128;
      Chunk<T> raw[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int idx = wtid + 128 * j, r = idx / kRowChunks, c = (idx % kRowChunks) * 8;
        raw[j] = Chunk<T>{};
        if (me.r0 + r < Lq && c < D)
          load_chunk(q + ((static_cast<long long>(batch) * Lq + me.r0 + r) * H + me.head) * D + c,
                     raw[j]);
      }
      named_barrier_sync(1 + wg, 128);  // every warp's products of the last item are done
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int idx = wtid + 128 * j, r = idx / kRowChunks, c = (idx % kRowChunks) * 8;
        uint4 w[TT];
        chunk_terms(raw[j], w);
        const int off = (c / L::kPanelCols) * L::kQPanelBytes +
                        swizzled<SW>(r * SW + (c % L::kPanelCols) * 2);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          *reinterpret_cast<uint4*>(q_mine + t * L::kQTileBytes + off) = w[t];
      }
      fence_proxy_async();  // the stores, before wgmma reads them
      named_barrier_sync(1 + wg, 128);
      // this warp's 16 rows of the first QR terms as A fragments: lane l
      // addresses row l % 8 + 8 (l / 8 % 2), columns 8 (l / 16) of a k-step
      const int r = wwarp * 16 + lane % 8 + 8 * (lane / 8 % 2);
#pragma unroll
      for (int a = 0; a < QR; ++a)
#pragma unroll
        for (int k = 0; k < Dp / 16; ++k) {
          const int c = 16 * k + 8 * (lane / 16);
          ldmatrix_x4(qreg[a][k], q_tile + a * L::kQTileBytes +
                                      (c / L::kPanelCols) * L::kQPanelBytes +
                                      swizzled<SW>(r * SW + (c % L::kPanelCols) * 2));
        }
    };
    // S = Q K^T (64 x BK, f32) of the tile in stage s: one committed group
    auto issue_s = [&](int s) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;
      const uint32_t k_tile = smem_addr(k_s + s * TT * L::kKTileBytes);
      fence_regs<BK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int ord = 2; ord >= 0; --ord)
#pragma unroll
        for (int a = 0; a < TT; ++a)
#pragma unroll
          for (int b = 0; b < TT; ++b)
            if (a + b == ord)
#pragma unroll
              for (int k = 0; k < Dp / 16; ++k) {
                const uint64_t dk = kmajor_desc<SW, L::kKPanelBytes>(k_tile + b * L::kKTileBytes, k);
                if (a < QR)
                  wgmma_rs<BK, 0>(sc, qreg[a][k], dk);
                else
                  wgmma_ss<BK>(sc, kmajor_desc<SW, L::kQPanelBytes>(q_tile + a * L::kQTileBytes, k),
                               dk, 1);
              }
      wgmma_commit();
    };
    // O += P V with the V tile in stage s: one committed group
    auto issue_pv = [&](int s) {
      const uint32_t v_tile = smem_addr(v_s + s * TT * L::kKTileBytes);
      fence_regs<Dp / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int ord = 2; ord >= 0; --ord)
#pragma unroll
        for (int a = 0; a < PT; ++a)
#pragma unroll
          for (int b = 0; b < TT; ++b)
            if (a + b == ord)
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs<Dp>(acc, pt[a][kk],
                             v_desc<SW, L::kKPanelBytes>(v_tile + b * L::kKTileBytes, kk));
      wgmma_commit();
    };
    // mask (boundary tiles only) and the online softmax in base 2 of tile t:
    // S becomes P in place, m and l move on, al0/al1 rescale the old acc
    auto softmax = [&](int t) {
      const int k0 = t * BK;
      const bool edge = (causal && k0 + BK - 1 > me.r0) ||
                        (window && k0 <= me.r0 + kRows - 1 - window) || k0 + BK > Lk;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
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
      for (int j = 0; j < BK / 2; j += 4) {
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
      for (int j = 0; j < BK / 2; ++j) {
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
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: (row0, keys 2t..), (row1, ..), (row0, 2t+8..), (row1, ..)
          uint32_t w[PT];
          pair_terms<PT>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], w);
#pragma unroll
          for (int a = 0; a < PT; ++a) pt[a][kk][r] = w[a];
        }
    };
    // ring slot j of one of the barrier arrays: wait for its fill, or release it
    auto wait_full = [&](uint64_t* bars, int j) { mbar_wait(&bars[j % NS], (j / NS) & 1); };
    auto release = [&](uint64_t* bars, int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[j % NS]);
    };

    // The ring protocol and the pipeline of the wgmma route, with K released
    // as soon as S is computed and V once P V is.
    int i = 0;  // ring slots so far, as the producer counts them
    for (int n = 0; item_index(n) < total; ++n) {
      const Item it = item(item_index(n));
      const int te = it.te;
      me = wg ? it.w1 : it.w0;
      row0 = me.r0 + wwarp * 16 + g;
      row1 = row0 + 8;
#pragma unroll
      for (int j = 0; j < Dp / 2; ++j) acc[j] = 0.0f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.0f;
      load_q(it.batch);
      auto pass = [&]() {  // a tile only the other warpgroup computes
        wait_full(kfull, i);
        release(kempty, i);
        wait_full(vfull, i);
        release(vempty, i);
      };
      int t = it.tb;
      for (; t < te && t < me.tb; ++t, ++i) pass();
      const int mine_end = min(te, me.te);
      if (t < mine_end) {
        int prev = i;  // the ring slot whose P V comes next
        wait_full(kfull, i);
        issue_s(i % NS);
        wgmma_wait<0>();
        release(kempty, i);
        fence_regs<BK / 2>(sc);
        softmax(t);  // acc is 0: nothing to rescale
        make_p();
        for (++t, ++i; t < mine_end; ++t, ++i) {
          wait_full(kfull, i);
          issue_s(i % NS);
          wait_full(vfull, prev);
          issue_pv(prev % NS);
          wgmma_wait<1>();  // S of tile t; P V of tile t - 1 may still run
          release(kempty, i);
          fence_regs<BK / 2>(sc);
          softmax(t);
          wgmma_wait<0>();
          fence_regs<Dp / 2>(acc);
          release(vempty, prev);
#pragma unroll
          for (int j = 0; j < Dp / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
          make_p();
          prev = i;
        }
        wait_full(vfull, prev);
        issue_pv(prev % NS);
        wgmma_wait<0>();
        fence_regs<Dp / 2>(acc);
        release(vempty, prev);
      }
      for (; t < te; ++t, ++i) pass();

      // ---- flush: acc / max(l, 1e-30) in the inputs' type, columns < D ----
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      T* o0 = o + ((static_cast<long long>(it.batch) * Lq + row0) * H + me.head) * D;
      T* o1 = o + ((static_cast<long long>(it.batch) * Lq + row1) * H + me.head) * D;
#pragma unroll
      for (int j = 0; j < Dp / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (8 * j >= D) continue;  // D is a multiple of 8
        if (row0 < Lq) store2(o0 + col, acc[4 * j] / d0, acc[4 * j + 1] / d0);
        if (row1 < Lq) store2(o1 + col, acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
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

// A 4-D map over a (B, L, H, cols) bf16 tensor, innermost first, with boxes
// of (one panel of D, 1 head, `rows` rows, 1 batch row).  With cols < D the
// boxes reach past each row, and TMA fills those columns with zeros.
template <int D>
int make_map(CUtensorMap* map, const void* base, int batch, int len, int heads, int rows,
             int cols = D) {
  using Lt = Layout<D>;
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(heads) * cols * 2,
                                 static_cast<cuuint64_t>(len) * heads * cols * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Lt::kPanelCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Lt::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Work units and query tiles of both routes; returns the persistent grid
// (one CTA per SM, at most one per item) or a negative cudaError_t.
int plan_grid(int batch, int Lq, int H, int Hkv, int* units, int* n_qt) {
  const bool pair = (H / Hkv) % 2 == 0;
  *units = pair ? H / 2 : H;
  const int rows_per_cta = pair ? kRows : 2 * kRows;
  *n_qt = (Lq + rows_per_cta - 1) / rows_per_cta;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return min(*n_qt * *units * batch, sms);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int Lq, int Lk,
           int H, int Hkv, float scale, int causal, int window, void* stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_map<D>(&qmap, q, batch, Lq, H, kRows);
  if (!err) err = make_map<D>(&kmap, k, batch, Lk, Hkv, kBK);
  if (!err) err = make_map<D>(&vmap, v, batch, Lk, Hkv, kBK);
  if (err) return err;
  int units = 0, n_qt = 0;
  const int grid = plan_grid(batch, Lq, H, Hkv, &units, &n_qt);
  if (grid < 0) return -grid;
  const int smem = Layout<D>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Lq, Lk, H, H / Hkv, n_qt, units, batch,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// kt and vt: K's and V's three terms (terms x B, Lk, Hkv, Dp) for f32, K
// and V themselves (B, Lk, Hkv, D) for bf16, zero-padded to Dp by TMA.
template <typename T, int Dp>
int launch_split(const void* q, const void* kt, const void* vt, void* o, int batch, int Lq,
                 int Lk, int H, int Hkv, int D, float scale, int causal, int window,
                 void* stream) {
  using L = SplitLayout<T, Dp>;
  const int cols = L::kTerms == 1 ? D : Dp;
  CUtensorMap kmap, vmap;
  int err = make_map<Dp>(&kmap, kt, L::kTerms * batch, Lk, Hkv, L::kBK, cols);
  if (!err) err = make_map<Dp>(&vmap, vt, L::kTerms * batch, Lk, Hkv, L::kBK, cols);
  if (err) return err;
  int units = 0, n_qt = 0;
  const int grid = plan_grid(batch, Lq, H, Hkv, &units, &n_qt);
  if (grid < 0) return -grid;
  // Set per launch, not through opt_in_shared_memory: its once-only flag is
  // kept per kernel *type*, which the instantiations of one T share.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_split_kernel<T, Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_split_kernel<T, Dp><<<grid, kSplitThreads, L::kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), kmap, vmap, static_cast<T*>(o), Lq, Lk, H, D, H / Hkv, n_qt,
      units, batch, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_split(const void* q, const void* kt, const void* vt, void* o, int batch, int Lq,
                   int Lk, int H, int Hkv, int D, int Dp, float scale, int causal, int window,
                   void* stream) {
  switch (Dp) {
    case 32: return launch_split<T, 32>(q, kt, vt, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
    case 64: return launch_split<T, 64>(q, kt, vt, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
    default: return launch_split<T, 128>(q, kt, vt, o, batch, Lq, Lk, H, Hkv, D, scale, causal, window, stream);
  }
}

// The split route's head dims: D a multiple of 8, padded to Dp (32, 64 or
// 128, which the caller picks) with D <= Dp.
bool split_head_dims(int D, int Dp) {
  return D >= 8 && D % 8 == 0 && D <= Dp && (Dp == 32 || Dp == 64 || Dp == 128);
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

// The split route's first step for f32: k and v (rows x D each, f32,
// contiguous, 16-byte aligned) into kt and vt (3 x rows x Dp bf16 terms,
// zero past D).
extern "C" int repro_flash_split_kv(const void* k, const void* v, void* kt, void* vt,
                                    long long rows, int D, int Dp, void* stream) {
  if (rows < 1 || !split_head_dims(D, Dp)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows * (Dp / 8) + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 2);
  split_kv_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<__nv_bfloat16*>(kt), static_cast<__nv_bfloat16*>(vt), rows, D, Dp);
  return static_cast<int>(cudaGetLastError());
}

// The split route: q (B, Lq, H, D) and o (B, Lq, H, D), contiguous and
// 16-byte aligned, f32 (bf16 when bf16 != 0); for f32, kt and vt are K's and
// V's terms from repro_flash_split_kv, (3, B, Lk, Hkv, Dp); for bf16, K and V
// themselves, (B, Lk, Hkv, D).  D a multiple of 8 up to Dp, Dp 32, 64 or 128;
// H a multiple of Hkv.
extern "C" int repro_flash_attention_split(const void* q, const void* kt, const void* vt,
                                           void* o, int batch, int Lq, int Lk, int H, int Hkv,
                                           int D, int Dp, float scale, int causal, int window,
                                           int bf16, void* stream) {
  if (Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv || !split_head_dims(D, Dp))
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch_split<__nv_bfloat16>(q, kt, vt, o, batch, Lq, Lk, H, Hkv, D, Dp, scale,
                                              causal, window, stream)
              : dispatch_split<float>(q, kt, vt, o, batch, Lq, Lk, H, Hkv, D, Dp, scale, causal,
                                      window, stream);
}

// Dynamic shared memory one CTA of the split route requests at padded head
// dim Dp (32, 64 or 128).
extern "C" int repro_flash_attention_split_smem_bytes(int Dp, int bf16) {
  if (Dp != 32 && Dp != 64 && Dp != 128) return -1;
  if (bf16)
    return Dp == 32   ? SplitLayout<__nv_bfloat16, 32>::kSmemBytes
           : Dp == 64 ? SplitLayout<__nv_bfloat16, 64>::kSmemBytes
                      : SplitLayout<__nv_bfloat16, 128>::kSmemBytes;
  return Dp == 32   ? SplitLayout<float, 32>::kSmemBytes
         : Dp == 64 ? SplitLayout<float, 64>::kSmemBytes
                    : SplitLayout<float, 128>::kSmemBytes;
}
