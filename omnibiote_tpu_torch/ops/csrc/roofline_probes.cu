// Roofline probes for Hopper (sm_90a): the products of the flash attention
// kernels without softmax, mask or dropout. bf16 in and out, fp32
// accumulation, head dim 128.
//
// Replace the Pallas TPU probes
//   #10 tools/probes/roofline.py::_dots_kernel     (dots_only)
//   #11 tools/probes/roofline.py::_dots_n_kernel   (dots_n)
//   #12 tools/probes/roofline2.py::_dots_kernel    (dots, k (B, H*D, T) or not)
//   #13 tools/probes/roofline2.py::_sc_kernel      (scores)
// The functions (omnibiote_tpu_torch/probes/roofline*.py has them in plain
// PyTorch), with q, k, v, o (B, T, H*D) row-major and round() to bf16:
//   dots:   o_h = round(sum over kv of round(q_h k_h^T) v_h)          (#10, #12)
//   dots_n: per q tile qt (block_q rows) and kv tile kt (block_kv rows),
//           S = round(Q_qt K_kt^T + Q_qt V_kt^T) and o[qt*block_q + r] +=
//           sum_i S[i, r] (Q_qt[i] (+ V_kt[i] with 4 products)), r < block_q
//           a row local to the kv tile                                 (#11)
//   scores: o[i, c] = round(sum_h (q_h k_h^T)[i, T - block_kv + c]), c < H*D:
//           the last kv tile only, as the TPU kernel's last write      (#13)
//
// Design.
//   * dots_wgmma (#10, #12) is mh_fwd_bf16's product pipeline
//     (mh_flash_fwd.cu) without the softmax: a producer warpgroup whose
//     first thread keeps a two-stage TMA ring of 128-row K and V tiles
//     (128-byte-swizzled 64-column panels) and a double-buffered Q tile
//     full, and BQ / 64 consumer warpgroups of 64 q rows. A consumer runs
//     S = q . k^T by wgmma m64n128k16 from shared memory, rounds S to bf16
//     in registers as the A operand of O += S . V (V MN-major through the
//     transpose bit), and issues S_j behind S_(j-1) . V so that the tensor
//     cores always hold one of its products. With KT the K tile arrives as
//     [head dim][kv] rows from k (B, H*D, T) and is read MN-major through
//     the transpose bit too: the port's counterpart of the TPU probe's
//     pre-transposed k. A work item is (b, h, BQ-row q tile); the CTA is
//     persistent (one a multiprocessor, walking items b-major, then h, then
//     the q tile, with the next item's Q loaded while the current item's
//     last tiles run) or launched one a work item. o leaves through the
//     item's own Q rows in shared memory, by TMA stores.
//   * scores_wgmma (#13) is the score product summed over heads, which is
//     one GEMM a batch row: o[b] = x[b] . x[b, j0 : j0 + H*D]^T with depth
//     H*D (j0 = T - block_kv). A CTA owns BM q rows x 256 output columns and
//     walks the depth in 64-deep steps through a four-stage TMA ring; each
//     of its BM / 64 consumers accumulates a 64 x 256 fp32 tile by wgmma
//     m64n256k16, rounds it once and stores it through shared memory by
//     TMA. With KT, k's tile arrives as [depth][column] rows and is read
//     MN-major. Its CTAs are persistent, one a multiprocessor walking the
//     tiles (one CTA a tile measured slower: PERF.md §6).
//   * dots_n_bf16 (#11) is the dkv kernel's CTA (mh_flash_bwd_kernels.cuh,
//     WITH_DQ = false) on the mma.sync pipeline, cp.async and ldmatrix: a
//     block owns BR output rows r of a (b, h, q tile), keeps its
//     accumulator in fp32 registers, holds the K and V rows r of one kv tile
//     in shared memory and walks the q tile's rows i in 32-row chunks
//     through a two-stage ring: S^T and the second score product as two
//     accumulators, then S^T.Q (and S^T.V) with the transposing ldmatrix.
//     The kv tiles follow one another, each reloading its K and V rows.
// The tensor maps are 3-D (batch, row, column), so a kv tile that runs past
// T (T is a multiple of 64, the kv tile 128 rows) reads zeros, which add
// nothing to either product, and never the next batch row. BQ / BM / BR
// (the CTA's height in q rows) is a template argument, 64 or 128: the
// port's counterpart of the TPU probes' block sweep.
//
// Bound. At the probes' shape (B=8, T=1024, H=8, bf16) dots does
// 4*B*T^2*H*D = 34.4 GFLOP (34.7 us at 989 TFLOP/s) on 67 MB (20 us at
// 3.35 TB/s); dots_n 1.5x or 2x that; scores 2*B*T*(H*D)^2 = 17.2 GFLOP
// (17.4 us) on 50 MB (15 us): all bound by operations.
#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace obt;
using bf16 = __nv_bfloat16;

constexpr int D = 128;        // head dim of the probes
constexpr int RS = D + 8;     // row stride of a [row][D] tile (elements), padded
constexpr int CH = D / 8;     // 16-byte chunks of a row
constexpr int NK = D / 16;    // k-steps over the head dim
constexpr int NN = D / 8;     // n-tiles over the head dim
constexpr int T_MULTIPLE = 64;  // every probe takes T a multiple of 64
constexpr int BI = 32;        // q rows a step of dots_n (the dkv kernel's q tile)

// the dynamic shared memory of a kernel, aligned for the swizzled panels
template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>(
      raw + ((kSwizzleAtom - (shared_addr(raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1)));
}

// one arrival of each warp on `bar`, once the warp's products are done
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A consumer's fp32 accumulator (64 rows x N columns, the wgmma layout:
// rows 16 warp + g and + 8, columns 8 n + 2 t, + 1) rounded to bf16 into
// shared memory as N / 64 swizzled panels of its 64 rows, `panel` bytes
// apart: the layout a TMA store reads. Writes of a warp hit 32 banks.
template <int N>
__device__ __forceinline__ void acc_to_panels(unsigned char* tile, uint32_t panel,
                                              const float (&acc)[N / 2], int warp, int g,
                                              int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;  // r % 8 == g
      *reinterpret_cast<uint32_t*>(tile + (n / 8) * panel + r * 128 + (((n % 8) ^ g) << 4) +
                                   4 * t) =
          pack_bf16(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// #10 / #12: mh_fwd_bf16's products without the softmax
// ---------------------------------------------------------------------------
constexpr int kKv = 128, kDotsStages = 2;
constexpr uint32_t kKvPanel = kKv * 128;  // bytes of a 128-row, 64-column panel

template <int BQ>
struct DotsSmem {
  alignas(1024) bf16 q[2][BQ * D];
  alignas(1024) bf16 k[kDotsStages][kKv * D];
  alignas(1024) bf16 v[kDotsStages][kKv * D];
  uint64_t qfull[2], qempty[2], full[kDotsStages], empty[kDotsStages];
};

// Q and V (B, T, H*D) as 3-D maps with boxes of BQ and kKv rows; K the same
// or, with KT, (B, H*D, T) with boxes of kKv head-dim rows x 64 kv columns;
// o (B, T, H*D) with boxes of 64 rows
template <int BQ, bool KT>
__global__ void __launch_bounds__(128 * (BQ / 64 + 1), 1) dots_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap, int B,
    int T, int H) {
  constexpr int NC = BQ / 64;              // consumer warpgroups
  constexpr uint32_t kQPanel = BQ * 128;   // bytes of a q panel
  extern __shared__ unsigned char smem_raw[];
  DotsSmem<BQ>& sm = aligned_smem<DotsSmem<BQ>>(smem_raw);

  const int tid = threadIdx.x;
  const int n_qt = T / BQ, n_items = B * H * n_qt, n_kv = (T + kKv - 1) / kKv;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.qfull[i], 1);
      mbar_init(&sm.qempty[i], 4 * NC);
    }
    for (int st = 0; st < kDotsStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps Q and the K/V ring full ----
    if constexpr (NC == 2) setmaxnreg_dec<24>();
    if (tid == 0) {
      int g = 0, it = 0;  // kv tiles and items loaded so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int qt = item % n_qt, h = (item / n_qt) % H, b = item / (n_qt * H);
        const int qb = it & 1;
        if (it >= 2) mbar_wait(&sm.qempty[qb], ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&sm.qfull[qb], BQ * D * sizeof(bf16));
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          tma_load_3d(&sm.q[qb][pn * BQ * kPanelCols], &qmap, h * D + pn * kPanelCols,
                      qt * BQ, b, &sm.qfull[qb]);
        for (int j = 0; j < n_kv; ++j, ++g) {
          const int st = g % kDotsStages;
          if (g >= kDotsStages) mbar_wait(&sm.empty[st], ((g / kDotsStages) - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[st], 2u * kKv * D * sizeof(bf16));
          for (int pn = 0; pn < D / kPanelCols; ++pn) {
            if constexpr (KT)
              tma_load_3d(&sm.k[st][pn * kKv * kPanelCols], &kmap, j * kKv + pn * kPanelCols,
                          h * D, b, &sm.full[st]);
            else
              tma_load_3d(&sm.k[st][pn * kKv * kPanelCols], &kmap, h * D + pn * kPanelCols,
                          j * kKv, b, &sm.full[st]);
            tma_load_3d(&sm.v[st][pn * kKv * kPanelCols], &vmap, h * D + pn * kPanelCols,
                        j * kKv, b, &sm.full[st]);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    if constexpr (NC == 2) setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    float acc[D / 2], s[kKv / 2];
    uint32_t p[kKv / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // An item's o leaves through its own Q rows (read no more after its
    // last S) by a TMA store; the buffer goes back to the producer once the
    // store has read it, after the next item's first S.
    int stored_q = -1;
    auto release_stored_q = [&]() {
      if (wt == 0) bulk_wait_read<0>();
      named_bar_sync(1 + wg, 128);
      warp_arrive(&sm.qempty[stored_q], lane);
      stored_q = -1;
    };
    int g = 0, it = 0;  // kv tiles and items consumed so far
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int qt = item % n_qt, h = (item / n_qt) % H, b = item / (n_qt * H);
      const int qb = it & 1;
      const uint32_t q_addr = shared_addr(sm.q[qb]) + wg * 64 * 128;
      // S = q . k^T of ring stage st
      auto gemm_s = [&](int st) {
        const uint32_t k_addr = shared_addr(sm.k[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const uint64_t da =
              smem_desc(q_addr + (kk >> 2) * kQPanel + (kk & 3) * 32, 16, kSwizzleAtom);
          if constexpr (KT) {
            wgmma_ss_m64n128k16_tb(
                s, da, smem_desc(k_addr + kk * 16 * 128, kKvPanel, kSwizzleAtom), kk > 0);
          } else {
            wgmma_ss_m64n128k16(
                s, da, smem_desc(k_addr + (kk >> 2) * kKvPanel + (kk & 3) * 32, 16, kSwizzleAtom),
                kk > 0);
          }
        }
        wgmma_commit();
      };
      // acc (+)= S . V of ring stage st (V MN-major: 16 kv rows a k-step);
      // the item's first product overwrites acc
      auto gemm_pv = [&](int st, bool first) {
        const uint32_t v_addr = shared_addr(sm.v[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKv / 16; ++kk)
          wgmma_rs_m64n128k16_tb(acc, p[kk],
                                 smem_desc(v_addr + kk * 16 * 128, kKvPanel, kSwizzleAtom),
                                 !(first && kk == 0));
        wgmma_commit();
      };
      // S rounded to bf16: the A fragments of S . V (k-step kk is score
      // blocks 2 kk and 2 kk + 1)
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < kKv / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };

      mbar_wait(&sm.qfull[qb], (it >> 1) & 1);
      int st = g % kDotsStages;
      mbar_wait(&sm.full[st], (g / kDotsStages) & 1);
      gemm_s(st);
      wgmma_wait<0>();
      fence_regs(s);
      if (stored_q >= 0) release_stored_q();
      pack();
      for (int j = 1; j < n_kv; ++j) {
        const int prev = st;
        ++g;
        st = g % kDotsStages;
        mbar_wait(&sm.full[st], (g / kDotsStages) & 1);
        gemm_pv(prev, j == 1);
        gemm_s(st);
        wgmma_wait<1>();  // S_(j-1) . V is done
        fence_regs(acc);
        fence_regs(p);
        warp_arrive(&sm.empty[prev], lane);
        wgmma_wait<0>();
        fence_regs(s);
        pack();
      }
      gemm_pv(st, n_kv == 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      warp_arrive(&sm.empty[st], lane);
      ++g;

      unsigned char* o_tile = reinterpret_cast<unsigned char*>(sm.q[qb]) + wg * 64 * 128;
      acc_to_panels<D>(o_tile, kQPanel, acc, warp, g4, t4);
      fence_async_shared();
      named_bar_sync(1 + wg, 128);
      if (wt == 0) {
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          tma_store_3d(&omap, o_tile + pn * kQPanel, h * D + pn * kPanelCols,
                       qt * BQ + wg * 64, b);
        bulk_commit();
      }
      stored_q = qb;
    }
    if (wt == 0) bulk_wait_read<0>();  // the stores have read shared memory
  }
}

// ---------------------------------------------------------------------------
// #13: the score product summed over heads, as a GEMM a batch row
// ---------------------------------------------------------------------------
// A CTA's tile is BM rows x kScN columns of one batch row, walked in
// kScK-deep steps (one 64-column panel of q and of k) through a
// kScStages-deep ring. The output leaves through shared memory, kScOCols
// columns of a consumer at a time, by TMA stores: stored straight from the
// accumulator fragments (16-byte pieces of 8 rows a warp instruction) it
// held the consumers off the tensor cores for much of the kernel's time.
constexpr int kScN = 256, kScK = 64, kScStages = 4, kScOCols = 128;

template <int BM>
struct ScoresSmem {
  alignas(1024) bf16 a[kScStages][BM * kScK];
  alignas(1024) bf16 b[kScStages][kScN * kScK];
  alignas(1024) bf16 o[BM * kScOCols];  // a consumer's 64 rows: kScOCols / 64 panels
  uint64_t full[kScStages], empty[kScStages];
};

// q (B, T, H*D) a 3-D map with boxes of BM rows; k the same with boxes of
// kScN rows or, with KT, (B, H*D, T) with boxes of kScK depth rows x 64
// columns; o (B, T, H*D) with boxes of 64 rows. A column tile past H*D (the
// last, when H*D is not a multiple of kScN) reads whatever rows follow, or
// zeros past T, and its store is clipped at H*D.
template <int BM, bool KT>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1) scores_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap omap, int B, int T, int HD, int j0) {
  constexpr int NC = BM / 64;
  constexpr uint32_t kBtPanel = kScK * 128;  // bytes of a KT panel: kScK depth rows
  extern __shared__ unsigned char smem_raw[];
  ScoresSmem<BM>& sm = aligned_smem<ScoresSmem<BM>>(smem_raw);

  const int tid = threadIdx.x;
  const int n_m = T / BM, n_n = (HD + kScN - 1) / kScN, n_k = HD / kScK;
  const int n_tiles = B * n_m * n_n;
  if (tid == 0) {
    for (int st = 0; st < kScStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (NC == 2) setmaxnreg_dec<24>();
    if (tid == 0) {
      int g = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int nt = tile % n_n, mt = (tile / n_n) % n_m, b = tile / (n_n * n_m);
        for (int ks = 0; ks < n_k; ++ks, ++g) {
          const int st = g % kScStages;
          if (g >= kScStages) mbar_wait(&sm.empty[st], ((g / kScStages) - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[st], (BM + kScN) * kScK * sizeof(bf16));
          tma_load_3d(sm.a[st], &qmap, ks * kScK, mt * BM, b, &sm.full[st]);
          if constexpr (KT) {
            for (int pn = 0; pn < kScN / kPanelCols; ++pn)
              tma_load_3d(&sm.b[st][pn * kScK * kPanelCols], &kmap,
                          j0 + nt * kScN + pn * kPanelCols, ks * kScK, b, &sm.full[st]);
          } else {
            tma_load_3d(sm.b[st], &kmap, ks * kScK, j0 + nt * kScN, b, &sm.full[st]);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows x kScN columns each ----
    if constexpr (NC == 2) setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    unsigned char* o_tile = reinterpret_cast<unsigned char*>(sm.o) + wg * 64 * kScOCols * 2;
    float acc[kScN / 2];
#pragma unroll
    for (int i = 0; i < kScN / 2; ++i) acc[i] = 0.f;

    int g = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int nt = tile % n_n, mt = (tile / n_n) % n_m, b = tile / (n_n * n_m);
      int prev = 0;
      for (int ks = 0; ks < n_k; ++ks, ++g) {
        const int st = g % kScStages;
        mbar_wait(&sm.full[st], (g / kScStages) & 1);
        const uint32_t a_addr = shared_addr(sm.a[st]) + wg * 64 * 128;
        const uint32_t b_addr = shared_addr(sm.b[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kScK / 16; ++kk) {
          const uint64_t da = smem_desc(a_addr + kk * 32, 16, kSwizzleAtom);
          if constexpr (KT)
            wgmma_ss_m64n256k16<1>(acc, da,
                                   smem_desc(b_addr + kk * 16 * 128, kBtPanel, kSwizzleAtom),
                                   ks > 0 || kk > 0);
          else
            wgmma_ss_m64n256k16<0>(acc, da, smem_desc(b_addr + kk * 32, 16, kSwizzleAtom),
                                   ks > 0 || kk > 0);
        }
        wgmma_commit();
        if (ks > 0) {
          wgmma_wait<1>();  // the previous step's products are done
          warp_arrive(&sm.empty[prev], lane);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(&sm.empty[prev], lane);

      // o through shared memory and TMA stores, which clip columns past
      // H*D, kScOCols columns at a time; the previous store has read the
      // buffer
#pragma unroll
      for (int c = 0; c < kScN; c += kScOCols) {
        if (wt == 0) bulk_wait_read<0>();
        named_bar_sync(1 + wg, 128);
        acc_to_panels<kScOCols>(o_tile, 64 * 128,
                                *reinterpret_cast<const float(*)[kScOCols / 2]>(&acc[c / 2]),
                                warp, g4, t4);
        fence_async_shared();
        named_bar_sync(1 + wg, 128);
        if (wt == 0) {
          for (int pn = 0; pn < kScOCols / kPanelCols; ++pn)
            tma_store_3d(&omap, o_tile + pn * 64 * 128, nt * kScN + c + pn * kPanelCols,
                         mt * BM + wg * 64, b);
          bulk_commit();
        }
      }
    }
    if (wt == 0) bulk_wait_read<0>();  // the stores have read shared memory
  }
}

// ---------------------------------------------------------------------------
// #11's mma.sync helpers
// ---------------------------------------------------------------------------
// ROWS rows of D elements, src[row * rs], into dst[row * RS]: 16 bytes a
// thread a step
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t rs, int tid) {
  for (int it = tid; it < ROWS * CH; it += NT) {
    const int row = it / CH, c8 = (it % CH) * 8;
    cp_async16(dst + row * RS + c8, src + row * rs + c8);
  }
}

// A fragments of k-step kk from the fp32 accumulator of two n-tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc (16 rows x D) += a (16 x 16) . x (16 rows of [row][RS], k-step kk)
__device__ __forceinline__ void acc_rows(float (&acc)[NN][4], const uint32_t (&a)[4],
                                         const bf16* x, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, x + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + np * 16
                              + (lane >> 4) * 8);
    mma_bf16(acc[2 * np], a, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
  }
}

// rows g and g + 8 of a warp's accumulator (fp32) to bf16 at dst (row
// stride rs); fragment layout of m16n8k16 as in mh_flash_fwd.cu
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, size_t rs, const float (&acc)[N][4], int t4) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * rs + col) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// #11: the dkv kernel's product mix (3 or 4 products a tile)
// ---------------------------------------------------------------------------
template <int BR, bool V4>
constexpr size_t dots_n_smem_bytes() {
  // K and V rows r of the kv tile; two stages of Q (and V) rows i
  return (2 * BR + 2 * BI * (V4 ? 2 : 1)) * RS * sizeof(bf16);
}

template <int BR, bool V4>
__global__ void __launch_bounds__(2 * BR) dots_n_bf16(const bf16* __restrict__ q,
                                                      const bf16* __restrict__ k,
                                                      const bf16* __restrict__ v,
                                                      bf16* __restrict__ o, int T, int H,
                                                      int block_q, int block_kv) {
  constexpr int NT = 2 * BR;  // BR / 16 warps
  constexpr int NSI = BI / 8;  // n-tiles of a score step (q columns i)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kr = reinterpret_cast<bf16*>(smem);  // [BR][RS]
  bf16* Vr = Kr + BR * RS;                   // [BR][RS]
  bf16* Qs = Vr + BR * RS;                   // [2][BI][RS]
  bf16* Vi = Qs + 2 * BI * RS;               // [2][BI][RS], with V4

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const int qt = blockIdx.x * BR / block_q;      // this block's q tile
  const int rb = blockIdx.x * BR % block_q;      // and its first kv-local row
  const int kw = warp * 16;                      // the warp's rows in the block
  const int n_i = block_q / BI, n_kv = T / block_kv;

  auto load_chunk = [&](int st, int kt, int ic) {
    load_rows<BI, NT>(Qs + st * BI * RS, q + base + (size_t)(qt * block_q + ic * BI) * rs, rs, tid);
    if constexpr (V4)
      load_rows<BI, NT>(Vi + st * BI * RS, v + base + (size_t)(kt * block_kv + ic * BI) * rs, rs, tid);
  };

  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    // the previous kv tile's last step ended in a barrier: every buffer is free
    const size_t jr = (size_t)kt * block_kv + rb;
    load_rows<BR, NT>(Kr, k + base + jr * rs, rs, tid);
    load_rows<BR, NT>(Vr, v + base + jr * rs, rs, tid);
    load_chunk(0, kt, 0);
    cp_async_commit();
    for (int ic = 0; ic < n_i; ++ic) {
      const int st = ic & 1;
      if (ic + 1 < n_i) load_chunk(st ^ 1, kt, ic + 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const bf16* Qt = Qs + st * BI * RS;

      // S^T = K_r.Q_i^T and the second score product V_r.Q_i^T: 16 rows r x
      // BI columns i a warp, two fp32 accumulators added after, as the TPU
      // kernel adds its two products
      float s[NSI][4], s2[NSI][4];
#pragma unroll
      for (int n = 0; n < NSI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t ka0[4], ka1[4], va0[4], va1[4];
        const int arow = (kw + (lane & 15)) * RS + p * 32 + (lane >> 4) * 8;
        ldmatrix_x4(ka0, Kr + arow);
        ldmatrix_x4(ka1, Kr + arow + 16);
        ldmatrix_x4(va0, Vr + arow);
        ldmatrix_x4(va1, Vr + arow + 16);
#pragma unroll
        for (int n = 0; n < NSI; ++n) {
          uint32_t bq[4];
          ldmatrix_x4(bq, Qt + (n * 8 + (lane & 7)) * RS + p * 32 + (lane >> 3) * 8);
          mma_bf16(s[n], ka0, bq[0], bq[1]);
          mma_bf16(s[n], ka1, bq[2], bq[3]);
          mma_bf16(s2[n], va0, bq[0], bq[1]);
          mma_bf16(s2[n], va1, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NSI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];

      // acc += S^T (bf16, from the fragments) . Q_i (+ S^T . V_i)
#pragma unroll
      for (int kk = 0; kk < BI / 16; ++kk) {
        uint32_t sa[4];
        pack_a(sa, s[2 * kk], s[2 * kk + 1]);
        acc_rows(acc, sa, Qt, kk, lane);
        if constexpr (V4) acc_rows(acc, sa, Vi + st * BI * RS, kk, lane);
      }
      __syncthreads();  // every warp is done with this stage
    }
  }
  store_rows(o + base + (size_t)(qt * block_q + rb + kw + g) * rs, rs, acc, t4);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// The dynamic shared memory `kernel` may take, set at its first launch on
// each device (the limit belongs to the instance on a device, not to a call).
template <auto kernel>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<uint64_t> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(set_on.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    set_on.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <auto kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t st, Args... args) {
  const cudaError_t e = allow_smem<kernel>(smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// the multiprocessors of the current device
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// CTAs of a launch over n work items: one a multiprocessor (persistent) or
// one an item
cudaError_t grid_size(int n_items, bool persistent, int* ctas) {
  *ctas = n_items;
  if (!persistent) return cudaSuccess;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess && sms < n_items) *ctas = sms;
  return e;
}

// a bf16 (B, rows, cols) tensor, boxes of box_rows rows of one 64-column panel
cudaError_t map3d(CUtensorMap* map, const void* base, int B, int rows, int cols, int box_rows) {
  return encode_bf16_panels_3d(map, base, B, rows, cols, cols, (uint64_t)rows * cols, box_rows);
}

template <int BQ, bool KT>
cudaError_t dots(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H,
                 bool persistent, cudaStream_t st) {
  const int HD = H * D;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t e = map3d(&qmap, q, B, T, HD, BQ);
  if (e == cudaSuccess) e = KT ? map3d(&kmap, k, B, HD, T, D) : map3d(&kmap, k, B, T, HD, kKv);
  if (e == cudaSuccess) e = map3d(&vmap, v, B, T, HD, kKv);
  if (e == cudaSuccess) e = map3d(&omap, o, B, T, HD, 64);
  int ctas = 0;
  if (e == cudaSuccess) e = grid_size(B * H * (T / BQ), persistent, &ctas);
  if (e != cudaSuccess) return e;
  return launch<dots_wgmma<BQ, KT>>(dim3(ctas), 128 * (BQ / 64 + 1),
                                   sizeof(DotsSmem<BQ>) + kSwizzleAtom, st, qmap, kmap, vmap,
                                   omap, B, T, H);
}

template <int BR, bool V4>
cudaError_t dots_n(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H,
                   int block_q, int block_kv, cudaStream_t st) {
  return launch<dots_n_bf16<BR, V4>>(dim3(T / BR, H, B), 2 * BR, dots_n_smem_bytes<BR, V4>(),
                                    st, q, k, v, o, T, H, block_q, block_kv);
}

template <int BM, bool KT>
cudaError_t scores(const bf16* q, const bf16* k, bf16* o, int B, int T, int H, int j0,
                   cudaStream_t st) {
  const int HD = H * D;
  CUtensorMap qmap, kmap, omap;
  cudaError_t e = map3d(&qmap, q, B, T, HD, BM);
  if (e == cudaSuccess) e = KT ? map3d(&kmap, k, B, HD, T, kScK) : map3d(&kmap, k, B, T, HD, kScN);
  if (e == cudaSuccess) e = map3d(&omap, o, B, T, HD, 64);
  int ctas = 0;
  if (e == cudaSuccess) e = grid_size(B * (T / BM) * ((HD + kScN - 1) / kScN), true, &ctas);
  if (e != cudaSuccess) return e;
  return launch<scores_wgmma<BM, KT>>(dim3(ctas), 128 * (BM / 64 + 1),
                                      sizeof(ScoresSmem<BM>) + kSwizzleAtom, st, qmap, kmap,
                                      omap, B, T, HD, j0);
}

bool shape_ok(int B, int T, int H, int D_, int cta_q) {
  return D_ == D && (cta_q == 64 || cta_q == 128) && T >= cta_q && T % cta_q == 0 &&
         T % T_MULTIPLE == 0 && B >= 1 && B <= 65535 && H >= 1 && H <= 65535;
}

}  // namespace

// The C entries: q, k, v, o bf16, (B, T, H, D) row-major, except k with kt,
// (B, H*D, T); D = 128; cta_q (64 or 128) the kernel's q-tile height.
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape or argument it has no kernel for), launches on `stream`,
// allocates nothing, does not synchronise.
//
// persistent != 0 launches one CTA a multiprocessor that walks the work
// items, else one CTA an item.
extern "C" int obt_roofline_dots(const void* q, const void* k, const void* v, void* o, int B,
                                 int T, int H, int D_, int kt, int cta_q, int persistent,
                                 void* stream) {
  if (!shape_ok(B, T, H, D_, cta_q)) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pe = persistent != 0;
  if (cta_q == 64)
    return (int)(kt ? dots<64, true>(qb, kb, vb, ob, B, T, H, pe, st)
                    : dots<64, false>(qb, kb, vb, ob, B, T, H, pe, st));
  return (int)(kt ? dots<128, true>(qb, kb, vb, ob, B, T, H, pe, st)
                  : dots<128, false>(qb, kb, vb, ob, B, T, H, pe, st));
}

// block_q and block_kv divide T; block_q is a multiple of cta_q and at most
// block_kv, and equal to it with n_dots = 4.
extern "C" int obt_roofline_dots_n(const void* q, const void* k, const void* v, void* o, int B,
                                   int T, int H, int D_, int block_q, int block_kv, int n_dots,
                                   int cta_q, void* stream) {
  if (!shape_ok(B, T, H, D_, cta_q) || (n_dots != 3 && n_dots != 4) || block_q < cta_q ||
      block_q % cta_q != 0 || block_kv < 1 || T % block_q != 0 || T % block_kv != 0 ||
      block_q > block_kv || (n_dots == 4 && block_q != block_kv))
    return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = n_dots == 4;
  if (cta_q == 64)
    return (int)(v4 ? dots_n<64, true>(qb, kb, vb, ob, B, T, H, block_q, block_kv, st)
                    : dots_n<64, false>(qb, kb, vb, ob, B, T, H, block_q, block_kv, st));
  return (int)(v4 ? dots_n<128, true>(qb, kb, vb, ob, B, T, H, block_q, block_kv, st)
                  : dots_n<128, false>(qb, kb, vb, ob, B, T, H, block_q, block_kv, st));
}

// block_kv divides T, is at least H*D and a multiple of 8: the output is
// the last kv tile's first H*D score columns.
extern "C" int obt_roofline_scores(const void* q, const void* k, void* o, int B, int T, int H,
                                   int D_, int block_kv, int kt, int cta_q, void* stream) {
  if (!shape_ok(B, T, H, D_, cta_q) || block_kv < H * D || T % block_kv != 0 ||
      block_kv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int j0 = T - block_kv;
  if (cta_q == 64)
    return (int)(kt ? scores<64, true>(qb, kb, ob, B, T, H, j0, st)
                    : scores<64, false>(qb, kb, ob, B, T, H, j0, st));
  return (int)(kt ? scores<128, true>(qb, kb, ob, B, T, H, j0, st)
                  : scores<128, false>(qb, kb, ob, B, T, H, j0, st));
}

// The tiles the wrappers' Python walks mirror (probes/roofline.py
// KERNEL_KV_TILE, roofline2.py SCORES_N_TILE and SCORES_K_STEP): 0 the dots
// kernel's kv tile, 1 the score kernel's output columns, 2 its depth step;
// -1 for any other.
extern "C" int obt_roofline_tile(int which) {
  return which == 0 ? kKv : which == 1 ? kScN : which == 2 ? kScK : -1;
}

extern "C" const char* obt_cuda_error_string_roofline(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
