// Multi-head flash attention forward for Hopper (sm_90a), with dropout on P.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_fwd_kernel (launched by _mh_fwd). Same function, same rounding points:
//   * RoPE (rotate-half) on q and k in fp32 from the cos/sin half tables,
//     rounded to the input dtype before the product;
//   * s2 = (q.k^T) * (scale * log2 e) + bias in fp32, bias = 0 on equal
//     segment ids and -0.7 * FLT_MAX otherwise (finite: a fully masked row
//     attends uniformly, as the JAX package documents);
//   * online softmax in exp2 over kv tiles, P rounded to the input dtype
//     before P.V, fp32 accumulator, o = acc * (1 / l) in the input dtype;
//   * lse2 = m + log2(l), (B, T, H) fp32;
//   * dropout (training): after the running sum l has taken the undropped
//     p, p_drop = keep ? p * (1 / (1 - rate)) : 0 before the rounding for
//     P.V, with the keep-mask of philox.cuh, a pure function of (seed, b,
//     h, i, j) that the backward redraws. rate == 0 compiles the kernel
//     without any of it (a template flag), so serving runs the same code
//     as before dropout existed.
// Layout (B, T, H*D) row-major for q, k, v, o; the segment ids of the q rows
// and of the kv rows (B, T) int32, both null (dense) or both given (one
// pointer twice where q and kv share them; the ring passes its rotated kv
// block's ids); the mask is q_seg[i] == kv_seg[j]; cos/sin (T, D/2) fp32 or null (no RoPE).
//
// Design. The TPU kernel blocks full (block_q, H*D) rows and walks kv as a
// sequential grid axis; here one block owns one (batch, head, q tile) and
// loops over kv tiles itself, so the single-kv and multi-kv branches of the
// TPU kernel are one code path. Every q tile of a head reads all of that
// head's k, so k is rotated once, by a small kernel ahead of the attention
// kernel, into a scratch tensor the caller provides (the same fp32 rotation
// and rounding); q is rotated in registers where it is loaded.
//
// Bound. At the serving shape (B=32, T=1024, H=8, D=128, bf16) a call does
// 4*B*T^2*H*D = 137 GFLOP (139 us at the H100's 989 TFLOP/s bf16) and moves
// 268 MB of q, k, v and o (80 us at 3.35 TB/s): it is bound by operations,
// so the design is about feeding the tensor cores. The bf16 kernel runs
// both products as warpgroup products (wgmma) from TMA-filled,
// 128-byte-swizzled shared memory, with a producer warpgroup that keeps a
// K/V ring full and two consumer warpgroups that take turns on the tensor
// cores, so one's softmax and dropout draw overlap the other's products
// (see the kernel's own note below). S and P stay in registers: P's
// accumulator fragments are the register A operand of P.V. The fp32 kernel
// is the parity type and runs on the CUDA cores.
//
// Segment skipping (the TPU kernel's use_bounds). With kv_lo / kv_hi
// non-null, int32 (B, T / q tile) in units of kv tiles, a CTA walks only
// the kv tiles kv_lo..kv_hi of its (batch, q tile): every tile outside has
// disjoint segment-id ranges and is fully masked. A skipped tile would have
// contributed exact zeros (its p underflows to 0 against any visible
// score, and alpha wipes a leading masked tile), so the result is bit for
// bit that of the full walk. The ring's first load is kv tile kv_lo and
// its last kv_hi. tile_count, when non-null, receives the number of
// tiles walked, summed over blocks (checks only).
//
// Head dim 256. Two stages of 128-row K and V tiles are 256 KB there, past
// the 227 KB a CTA may take, and S over 128 kv columns (64 fp32 a thread)
// beside the 64 x 256 O accumulator (128) would pass a consumer's 240
// registers. So at D = 256 the bf16 kernel walks 64-row kv tiles
// (kv_tile): 64 KB of q and two 64 KB stages, S in 32 registers as
// m64n64k16 products, and O += P.V as two m64n128k16 products on the two
// halves of the accumulator (V's panels 0-1 and 2-3). The same attention
// FLOPs a token as 8 heads of 128 (4 T d), in wider, fewer heads. The fp32
// kernel walks 16-row kv tiles there (48 KB of static shared memory).
//
// Head dims past 256 (D % 128 == 0): wide_attention.cuh::mh_fwd_wide, a CTA
// a (64-row q tile, 128-lane slice of the output), S summed over streamed
// 64-column panels of q and k and recomputed by every slice; see its note.
#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "wide_attention.cuh"

namespace {

using namespace obt;

// Dropout of one call: keep iff the element's Philox word >= thresh; kept
// values are multiplied by keep_scale = 1 / (1 - rate) in fp32.
struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

// ---------------------------------------------------------------------------
// bf16 (Hopper). A CTA owns 128 query rows of one (batch, head) and three
// warpgroups: warpgroup 0 produces, 1 and 2 consume 64 rows each.
//   * The producer's first thread keeps a two-stage ring of 128-row K and V
//     tiles (TMA, 128-byte-swizzled 64-column panels) and the tiles' kv
//     segment ids (a bulk copy) full, on full / empty mbarriers.
//   * A consumer writes its q rows, rotated in fp32 and rounded, into
//     swizzled panels once, then per kv tile: S = q . k^T by wgmma
//     m64n128k16 from shared memory; the masked log2-space scores, online
//     softmax and dropout on S's registers; P, rounded to bf16 in
//     registers, as the A operand of O += P . V (wgmma m64nDk16, V read
//     through the transpose bit). The accumulator layout is the mma.sync
//     C layout: rows 16 w + g and + 8 of warp w, columns 8 n + 2 t, + 1.
//   * The two consumers take turns on the tensor cores (named barriers):
//     one issues P_(j-1) . V and S_j while the other runs its softmax.
// setmaxnreg moves registers from the producer (24) to the consumers (240).
// ---------------------------------------------------------------------------
constexpr int kBq = 128, kStages = 2;
constexpr int kThreads = 384, kConsumerWarps = 8;
constexpr uint32_t kQPanel = kBq * 128;  // bytes of a 64-column panel of the q tile
// The kv tile at head dim D: 128 rows, or 64 at D = 256, where two stages
// of 128-row K and V tiles (256 KB) pass the 227 KB a CTA may take, and a
// 128-column S beside the 64 x 256 O accumulator (128 fp32 a thread) would
// pass the consumers' 240 registers. At 64 rows: 64 KB of q and two 64 KB
// stages, S in 32 registers.
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D == 256 ? 64 : 128;
}
// named barriers (0 is __syncthreads): 1 + w, consumer w's q rows are
// written; 3 + w, consumer w's turn on the tensor cores
constexpr int kBarQ = 1, kBarTurn = 3;

template <int D>
struct FwdSmem {
  alignas(1024) __nv_bfloat16 q[kBq * D];
  alignas(1024) __nv_bfloat16 k[kStages][kv_tile<D>() * D];
  alignas(1024) __nv_bfloat16 v[kStages][kv_tile<D>() * D];
  int kseg[kStages][kv_tile<D>()];
  uint64_t full[kStages], empty[kStages];
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(FwdSmem<D>) + kSwizzleAtom;  // + room to align the base
}

// BOUNDS: the kernel reads kv_lo / kv_hi; without it the walk starts at a
// constant 0 (the dense path keeps its compile-time walk). DOTS: the
// products alone (o = round(sum_j round(q k_j^T) . v_j)), no RoPE, mask,
// softmax, dropout or lse: the yardstick of the product pipeline.
template <int D, bool DROP, bool BOUNDS, bool DOTS>
__global__ void __launch_bounds__(kThreads, 1) mh_fwd_bf16(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    int* __restrict__ tile_count, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int T, int H, float scale_log2, DropParams dp) {
  constexpr int kBkv = kv_tile<D>();
  constexpr uint32_t kKvPanel = kBkv * 128;  // bytes of a 64-column panel of a K or V tile
  constexpr int NN = D / 8;      // 8-column blocks of the output
  constexpr int NS = kBkv / 8;   // 8-column blocks of a score tile
  constexpr int NK = D / 16;     // k-steps of q . k^T
  constexpr int NP = kBkv / 16;  // k-steps of P . V
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, tid = threadIdx.x;
  // the kv tiles this CTA walks: all, or its (batch, q tile)'s range
  int jt0 = 0, jt1 = T / kBkv - 1;
  if constexpr (BOUNDS) {
    jt0 = kv_lo[b * (T / kBq) + qt];
    jt1 = kv_hi[b * (T / kBq) + qt];
  }
  const int n_tiles = jt1 - jt0 + 1;
  if (tid == 0) {
    if (tile_count != nullptr) atomicAdd(tile_count, n_tiles);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const uint32_t bytes = 2u * kBkv * D * sizeof(__nv_bfloat16) +
                             (kv_seg != nullptr ? kBkv * sizeof(int) : 0u);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[st], ((it / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
        const int row = b * T + (jt0 + it) * kBkv;
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn) {
          tma_load_2d(&sm.k[st][pn * kBkv * kPanelCols], &kmap, h * D + pn * kPanelCols,
                      row, &sm.full[st]);
          tma_load_2d(&sm.v[st][pn * kBkv * kPanelCols], &vmap, h * D + pn * kPanelCols,
                      row, &sm.full[st]);
        }
        if (kv_seg != nullptr) bulk_load(sm.kseg[st], kv_seg + row, kBkv * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const size_t base = (size_t)b * T * rs + (size_t)h * D;
    const int qrow0 = qt * kBq + wg * 64;  // this warpgroup's first q row
    const int r0 = qrow0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

    // q rows rotated in fp32, rounded, into the swizzled q panels
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.q), kBq, wg * 64,
                      q + base + (size_t)qrow0 * rs, rs, 64, DOTS ? nullptr : cos_t,
                      sin_t, qrow0, wt, 128);
    fence_async_shared();
    named_bar_sync(kBarQ + wg, 128);

    const int qs0 = q_seg ? q_seg[(size_t)b * T + r0] : 0;
    const int qs1 = q_seg ? q_seg[(size_t)b * T + r0 + 8] : 0;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float acc[D / 2], s[kBkv / 2];
    uint32_t p[NP][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t q_addr = shared_addr(sm.q) + wg * 64 * 128;
    // S = q . k^T of ring stage st (both operands K-major)
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = shared_addr(sm.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t da =
            smem_desc(q_addr + (kk >> 2) * kQPanel + (kk & 3) * 32, 16, kSwizzleAtom);
        const uint64_t db =
            smem_desc(k_addr + (kk >> 2) * kKvPanel + (kk & 3) * 32, 16, kSwizzleAtom);
        if constexpr (kBkv == 128) {
          wgmma_ss_m64n128k16(s, da, db, kk > 0);
        } else {
          wgmma_ss_m64n64k16<0, 0>(s, da, db, kk > 0);
        }
      }
      wgmma_commit();
    };
    // acc += P . V of ring stage st (V MN-major: 16 kv rows a k-step; at D
    // = 256 two 128-column products, the second from V's panels 2 and 3)
    auto gemm_pv = [&](int st) {
      const uint32_t v_addr = shared_addr(sm.v[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const uint64_t db = smem_desc(v_addr + kk * 16 * 128, kKvPanel, kSwizzleAtom);
        if constexpr (D == 256) {
          wgmma_rs_m64n128k16_tb(acc_half<0>(acc), p[kk], db, 1);
          wgmma_rs_m64n128k16_tb(
              acc_half<1>(acc), p[kk],
              smem_desc(v_addr + 2 * kKvPanel + kk * 16 * 128, kKvPanel, kSwizzleAtom), 1);
        } else if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb(acc, p[kk], db, 1);
        } else {
          wgmma_rs_m64n64k16_tb(acc, p[kk], db, 1);
        }
      }
      wgmma_commit();
    };
    // the masked log2-space scores of kv tile jt (ring stage st), online
    // softmax, dropout, acc rescaled, P rounded into p
    auto softmax = [&](int jt, int st) {
      if constexpr (!DOTS) {
        const int* sg = sm.kseg[st];
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int ks0 = kv_seg ? sg[n * 8 + 2 * t4] : 0;
          const int ks1 = kv_seg ? sg[n * 8 + 2 * t4 + 1] : 0;
          s[4 * n] = score(s[4 * n], scale_log2, qs0, ks0);
          s[4 * n + 1] = score(s[4 * n + 1], scale_log2, qs0, ks1);
          s[4 * n + 2] = score(s[4 * n + 2], scale_log2, qs1, ks0);
          s[4 * n + 3] = score(s[4 * n + 3], scale_log2, qs1, ks1);
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[4 * n] = exp2f(s[4 * n] - mn0);
          s[4 * n + 1] = exp2f(s[4 * n + 1] - mn0);
          s[4 * n + 2] = exp2f(s[4 * n + 2] - mn1);
          s[4 * n + 3] = exp2f(s[4 * n + 3] - mn1);
          rs0 += s[4 * n] + s[4 * n + 1];
          rs1 += s[4 * n + 2] + s[4 * n + 3];
        }
        l0 = alpha0 * l0 + rs0;  // per-thread partial sums, reduced at the end
        l1 = alpha1 * l1 + rs1;
        if constexpr (DROP) {
          // One Philox call covers rows 2i, 2i + 1 of a column pair. Lanes
          // g and g ^ 1 hold rows r0 and r0 ^ 1 (and + 8): the even lane
          // draws the pair block of its rows r0, r0 + 1, the odd lane that
          // of r0 + 7, r0 + 8, and each hands the partner the words of the
          // partner's row. The keep bits go into one mask (bit 4 n + e for
          // element e of score block n), so that the draw's loop need not
          // be unrolled whole and only a few calls are live at once.
          const int bh = b * H + h;
          const bool odd = g & 1;
          const int row = odd ? r0 + 8 : r0;
          uint64_t keep = 0;
#pragma unroll 4
          for (int n = 0; n < NS; ++n) {
            const Philox4 u = dropout_bits(dp.seed, bh, row, jt * kBkv + n * 8 + 2 * t4);
            const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[2], 4);
            const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[1] : u.w[3], 4);
            const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[1];  // row r0
            const uint32_t c0 = odd ? u.w[2] : y0, c1 = odd ? u.w[3] : y1;  // row r0 + 8
            const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                                (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
            keep |= (uint64_t)k4 << (4 * n);
          }
#pragma unroll
          for (int i = 0; i < 4 * NS; ++i) s[i] = (keep >> i) & 1 ? s[i] * dp.keep_scale : 0.f;
        }
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          acc[4 * n] *= alpha0;
          acc[4 * n + 1] *= alpha0;
          acc[4 * n + 2] *= alpha1;
          acc[4 * n + 3] *= alpha1;
        }
      }
      // the A fragments of P . V: k-step kk is score blocks 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // Turns: warpgroup w waits on barrier kBarTurn + w (its 128 threads and
    // the other's 128 arrivals) before it issues, and passes the turn after.
    // Each takes n_tiles + 1 turns; warpgroup 0 goes first and warpgroup 1
    // passes no turn after its last.
    auto turn_wait = [&]() { named_bar_sync(kBarTurn + wg, 256); };
    auto turn_pass = [&]() { named_bar_arrive(kBarTurn + (wg ^ 1), 256); };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    };
    if (wg == 1) turn_pass();

    mbar_wait(&sm.full[0], 0);
    turn_wait();
    gemm_s(0);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(jt0, 0);
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(&sm.full[st], (it / kStages) & 1);
      turn_wait();
      gemm_pv(prev);
      gemm_s(st);
      turn_pass();
      wgmma_wait<1>();  // P . V of the previous tile is done
      fence_regs(acc);
      fence_regs(p);
      release(prev);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(jt0 + it, st);
    }
    turn_wait();
    gemm_pv((n_tiles - 1) % kStages);
    if (wg == 0) turn_pass();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);

    __nv_bfloat16* o0 = o + base + (size_t)r0 * rs;
    __nv_bfloat16* o1 = o0 + 8 * rs;
    float inv0 = 1.f, inv1 = 1.f;
    if constexpr (!DOTS) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      inv0 = 1.0f / l0;
      inv1 = 1.0f / l1;
      if (t4 == 0) {
        lse[((size_t)b * T + r0) * H + h] = m0 + log2f(l0);
        lse[((size_t)b * T + r0 + 8) * H + h] = m1 + log2f(l1);
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(o0 + col) =
          DOTS ? pack_bf16(acc[4 * n], acc[4 * n + 1])
               : pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(o1 + col) =
          DOTS ? pack_bf16(acc[4 * n + 2], acc[4 * n + 3])
               : pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 128 threads = 32 query rows x 4 threads; thread `sub` of a row owns
// the head dims sub + 4*i, so a row's dot product is 4 partial sums joined
// by two shuffles, and its output columns stay in the thread's registers.
// k already rotated. The kv tile is f32_kv_tile<D>() rows.
// ---------------------------------------------------------------------------
constexpr int kF32Tile = 32;

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    int* __restrict__ tile_count, float* __restrict__ o,
    float* __restrict__ lse, int T, int H, float scale_log2, DropParams dp) {
  constexpr int BQ = kF32Tile, BKV = f32_kv_tile<D>(), HALF = D / 2, PER = D / 4;
  __shared__ __align__(16) float ks[BKV * D];
  __shared__ __align__(16) float vs[BKV * D];
  __shared__ int kseg[BKV];

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int sub = tid & 3, row = blockIdx.x * BQ + (tid >> 2);
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;

  float qr[PER];
  {
    const float* qrow = q + base + (size_t)row * rs;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = sub + 4 * i;
      float x = qrow[d];
      if (cos_t != nullptr) {
        const bool lo = d < HALF;
        const int td = lo ? d : d - HALF;
        const float y = qrow[lo ? d + HALF : td];
        const float c = cos_t[(size_t)row * HALF + td], s = sin_t[(size_t)row * HALF + td];
        x = lo ? rope_lo(x, y, c, s) : rope_hi(y, x, c, s);
      }
      qr[i] = x;
    }
  }
  const int qs = q_seg ? q_seg[(size_t)b * T + row] : 0;

  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  int jt0 = 0, jt1 = T / BKV - 1;
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / BQ) + blockIdx.x];
    jt1 = kv_hi[b * (T / BQ) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, jt1 - jt0 + 1);
  for (int j0 = jt0 * BKV; j0 <= jt1 * BKV; j0 += BKV) {
    __syncthreads();
    for (int it = tid; it < BKV * (D / 4); it += 128) {
      const int r = it / (D / 4), c4 = (it % (D / 4)) * 4;
      const size_t off = base + (size_t)(j0 + r) * rs + c4;
      *reinterpret_cast<float4*>(ks + r * D + c4) = *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(vs + r * D + c4) = *reinterpret_cast<const float4*>(v + off);
    }
    if (tid < BKV) kseg[tid] = kv_seg ? kv_seg[(size_t)b * T + j0 + tid] : 0;
    __syncthreads();

    float s[BKV];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part = fmaf(qr[i], ks[j * D + sub + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = score(part, scale_log2, qs, kseg[j]);
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx), alpha = exp2f(m - mn);
    m = mn;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = exp2f(s[j] - mn);
      rsum += s[j];
    }
    l = alpha * l + rsum;
    if constexpr (DROP) {
      const int bh = b * H + h;
      const bool odd = row & 1;
#pragma unroll
      for (int j = 0; j < BKV; j += 2) {
        const Philox4 u = dropout_bits(dp.seed, bh, row, j0 + j);
        s[j] = (odd ? u.w[2] : u.w[0]) >= dp.thresh ? s[j] * dp.keep_scale : 0.f;
        s[j + 1] = (odd ? u.w[3] : u.w[1]) >= dp.thresh ? s[j + 1] * dp.keep_scale : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < BKV; ++j) a = fmaf(s[j], vs[j * D + sub + 4 * i], a);
      acc[i] = a;
    }
  }

  const float inv = 1.0f / l;
  float* orow = o + base + (size_t)row * rs;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[sub + 4 * i] = acc[i] * inv;
  if (sub == 0) lse[((size_t)b * T + row) * H + h] = m + log2f(l);
}

template <int D, bool DROP, bool BOUNDS, bool DOTS>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const int* q_seg, const int* kv_seg, const float* cos_t,
                        const float* sin_t, const int* kv_lo, const int* kv_hi,
                        int* tile_count, __nv_bfloat16* o, float* lse, int B, int T,
                        int H, float scale_log2, DropParams dp, cudaStream_t st) {
  // K and V as (B * T, H * D) row-major matrices, loaded as kv-tile boxes
  // of one head's 64-column panels
  CUtensorMap kmap, vmap;
  const uint64_t rows = (uint64_t)B * T, cols = (uint64_t)H * D;
  cudaError_t e = encode_bf16_panels(&kmap, k, rows, cols, cols, kv_tile<D>());
  if (e == cudaSuccess) e = encode_bf16_panels(&vmap, v, rows, cols, cols, kv_tile<D>());
  if (e != cudaSuccess) return e;
  // the shared-memory limit belongs to the instance on a device, not to the
  // call: set it at the first launch on each device
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = bf16_smem_bytes<D>();
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t dev_bit = 1ull << (dev & 63);
  if (!(smem_set.load(std::memory_order_acquire) & dev_bit)) {
    e = cudaFuncSetAttribute(mh_fwd_bf16<D, DROP, BOUNDS, DOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(dev_bit, std::memory_order_release);
  }
  mh_fwd_bf16<D, DROP, BOUNDS, DOTS><<<dim3(T / kBq, H, B), kThreads, smem, st>>>(
      kmap, vmap, q, q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, o, lse, T, H, scale_log2,
      dp);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_seg, const int* kv_seg,
                   const float* cos_t, const float* sin_t, void* k_rot,
                   const int* kv_lo, const int* kv_hi, int* tile_count, void* o,
                   float* lse, int B, int T, int H, float scale_log2, bool bf16,
                   DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, bf16, st);
    k = k_rot;
  }
  if (bf16) {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
    return kv_lo != nullptr
               ? launch_bf16<D, DROP, true, false>(qb, kb, vb, q_seg, kv_seg, cos_t, sin_t, kv_lo,
                                                   kv_hi, tile_count, ob, lse, B, T, H,
                                                   scale_log2, dp, st)
               : launch_bf16<D, DROP, false, false>(qb, kb, vb, q_seg, kv_seg, cos_t, sin_t, kv_lo,
                                                    kv_hi, tile_count, ob, lse, B, T, H,
                                                    scale_log2, dp, st);
  }
  mh_fwd_f32<D, DROP><<<dim3(T / kF32Tile, H, B), 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi,
      tile_count, static_cast<float*>(o), lse, T, H, scale_log2, dp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* k_rot,
                     const int* kv_lo, const int* kv_hi, int* tile_count, void* o,
                     float* lse, int B, int T, int H, float scale_log2, bool bf16,
                     bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, q_seg, kv_seg, cos_t, sin_t, k_rot, kv_lo, kv_hi,
                                tile_count, o, lse, B, T, H, scale_log2, bf16, dp, st)
              : launch<D, false>(q, k, v, q_seg, kv_seg, cos_t, sin_t, k_rot, kv_lo, kv_hi,
                                 tile_count, o, lse, B, T, H, scale_log2, bf16, dp, st);
}

// T multiple of each dtype's kernel: the bf16 CTA's 128 rows; the fp32
// kernel's 32-row tile, held to the backward kernels' 64
constexpr int kBf16TMultiple = kBq, kF32TMultiple = 64;

bool shape_ok(int B, int T, int H) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; T a multiple of 64 (fp32) or 128
// (bf16). D 64, 128, 256 or a multiple of 128 past 256. With RoPE (cos_t
// and sin_t non-null), k_rot is a scratch tensor of k's shape and type that
// receives the rotated k, and so is q_rot past 256 (else it may be null).
// kv_lo and kv_hi, both null or both int32 (B, T / q tile) with the q and
// kv tiles of the dtype's kernel (bf16: q tile 128 and kv tile 128, 64 at
// D = 256; fp32: 32 and 32, 16 at D = 256; both 64 and 64 past 256), bound
// the kv tiles each q tile walks;
// tile_count is null or one int32 that the walked tiles are added to. drop
// != 0 applies dropout with keep threshold `thresh` (bits >= thresh keep),
// scale `keep_scale` and the 64-bit `seed` (philox.cuh). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a shape
// or type this file has no kernel for). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int obt_mh_flash_fwd(const void* q, const void* k, const void* v,
                                const void* q_seg, const void* kv_seg, const void* cos_t,
                                const void* sin_t, void* q_rot, void* k_rot,
                                const void* kv_lo, const void* kv_hi,
                                void* tile_count, void* o,
                                void* lse, int B, int T, int H, int D,
                                float scale_log2, int dtype, int drop,
                                uint32_t thresh, float keep_scale,
                                uint64_t seed, void* stream) {
  const int t_multiple = dtype == 1 ? kBf16TMultiple : kF32TMultiple;
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, T, H) || T % t_multiple != 0 ||
      (cos_t != nullptr && (sin_t == nullptr || k_rot == nullptr)) ||
      ((kv_lo == nullptr) != (kv_hi == nullptr)) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* qsg = static_cast<const int*>(q_seg);
  const int* kvsg = static_cast<const int*>(kv_seg);
  const int* lo = static_cast<const int*>(kv_lo);
  const int* hi = static_cast<const int*>(kv_hi);
  int* tc = static_cast<int*>(tile_count);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropParams dp{seed, thresh, keep_scale};
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, qsg, kvsg, c, s, k_rot, lo, hi, tc, o, l, B, T, H, scale_log2, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, qsg, kvsg, c, s, k_rot, lo, hi, tc, o, l, B, T, H, scale_log2, dtype == 1, drop != 0, dp, st);
    case 256: return (int)launch_d<256>(q, k, v, qsg, kvsg, c, s, k_rot, lo, hi, tc, o, l, B, T, H, scale_log2, dtype == 1, drop != 0, dp, st);
    default:
      if (!obt::wide::head_dim_ok(D)) return (int)cudaErrorInvalidValue;
      return (int)obt::wide::forward(q, k, v, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, o, l, B, T,
                                H, D, scale_log2, dtype == 1, drop != 0,
                                obt::wide::Drop{seed, thresh, keep_scale}, st);
  }
}

// The bf16 kernel's products alone (its DOTS instance), bf16 (B, T, H, 128)
// q, k, v -> o, T a multiple of 128: o = round(sum over 128-row kv tiles of
// fp32(round(q k^T) . v)), no scale, RoPE, mask, softmax or lse. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int obt_mh_flash_fwd_dots(const void* q, const void* k, const void* v, void* o,
                                     int B, int T, int H, int D, void* stream) {
  if (!shape_ok(B, T, H) || T % kBf16TMultiple != 0 || D != 128)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<128, false, false, true>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, static_cast<__nv_bfloat16*>(o), nullptr, B, T, H, 0.f, DropParams{0, 0, 1.f},
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of the bf16 kernel takes at head dim D (-1
// for a head dim it is not built for).
extern "C" int obt_mh_flash_fwd_smem_bytes(int D) {
  return D == 64                 ? (int)bf16_smem_bytes<64>()
         : D == 128              ? (int)bf16_smem_bytes<128>()
         : D == 256              ? (int)bf16_smem_bytes<256>()
         : obt::wide::head_dim_ok(D) ? obt::wide::fwd_smem_bytes()
                                 : -1;
}

extern "C" const char* obt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
