// Kernels of the multi-head flash attention backward shared by the fused
// entry (mh_flash_bwd.cu: dq, dk and dv in one pass) and the dk/dv half of
// the split pair (mh_flash_bwd_dkv.cu); see those files for what each
// replaces. The bf16 kernel is Hopper's (TMA, wgmma, warp specialisation)
// and serves both: with WITH_DQ it also forms dq, without it it is the dkv
// kernel; at D = 256 its place is taken by mh_bwd_d256_bf16 (a 64-row kv
// tile, the consumers split by output, see its note). The fp32 kernel is
// the parity type and runs on the CUDA cores.
//
// Segment skipping. With q_lo / q_hi non-null, int32 (B, T / kv tile) in
// units of q tiles, a block walks only the q tiles q_lo..q_hi of its
// (batch, kv tile): every tile outside has disjoint segment-id ranges, its
// p = exp2(mask - lse2) is exactly 0, and it adds exact zeros to dq, dk
// and dv. tile_count, when non-null, receives the tiles walked, summed
// over blocks (checks only).
#pragma once
#include <atomic>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace obt {
namespace bwd {
// internal linkage: every library that includes this header keeps its own
// kernels and its own launch state (the shared-memory attribute's flag)
namespace {

struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

__device__ __forceinline__ uint32_t pick(const Philox4& u, int w) {
  return w == 0 ? u.w[0] : w == 1 ? u.w[1] : w == 2 ? u.w[2] : u.w[3];
}

// ---------------------------------------------------------------------------
// bf16 (Hopper). A CTA owns 128 kv rows of one (batch, head) and three
// warpgroups: warpgroup 0 produces, 1 and 2 consume 64 kv rows each.
//   * The producer's first thread keeps a ring of 64-row Q and dO tiles
//     (TMA, 128-byte-swizzled 64-column panels; two stages, three without
//     the dq tiles) and the tile's lse2, di and q segment ids (bulk copies)
//     full, on full / empty mbarriers.
//   * A consumer writes its K rows, rotated in fp32 and rounded, and its V
//     rows into swizzled panels once, then per q tile: S^T = K_w.Q^T and
//     dP^T = V_w.dO^T by wgmma m64n64k16 from shared memory (both operands
//     K-major); p, dropout and ds on their registers; dV += P_drop^T.dO and
//     dK += dS^T.Q by wgmma m64nDk16 with A from registers and B (dO, Q)
//     through the transpose bit. The accumulator layout is the mma.sync C
//     layout: rows 16 w + g and + 8 of warp w, columns 8 n + 2 t, + 1.
//   * WITH_DQ: dS^T (128 kv x 64 q, bf16) goes to a double-buffered
//     swizzled tile; after a named barrier of both consumers, consumer w
//     forms columns 64 w..64 w + 63 of the tile's dQ = dS.K by wgmma
//     m64n64k16 with both operands through the transpose bit (at D = 64,
//     consumer 0 alone), and hands it to the TMA unit through its staging
//     tile. Without WITH_DQ none of that exists: no dS^T tile, no staging,
//     no barrier between the consumers, no dq scratch or epilogue.
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// a consumer thread holds dk and dv (D fp32) and one block of 64 for S^T
// and dP^T, whose first half takes the dQ slice once both are packed to
// bf16 (wgmma accumulators take contiguous registers: with separate
// arrays, ptxas spilled dk around every tile).
// ---------------------------------------------------------------------------
constexpr int kBkv = 128, kBq = 64;
// ring stages: two with the dq tiles, three in the smem they leave free
template <bool WITH_DQ>
constexpr int kStagesOf = WITH_DQ ? 2 : 3;
constexpr int kThreads = 384, kConsumerWarps = 8;
constexpr uint32_t kKPanel = kBkv * 128, kQPanel = kBq * 128;  // panel bytes
constexpr int kDqSlice = kBq * 64;  // floats of one consumer's dQ slice
// named barriers (0 is __syncthreads): 1 + w, consumer w's K and V rows are
// in; 3, both consumers' dS^T rows are in; 4 + w, consumer w's dQ staging
constexpr int kBarKV = 1, kBarDs = 3, kBarStage = 4;

// what only the dq sums need: the dS^T tiles and a dQ staging tile a
// consumer
template <int D>
struct DqTiles {
  alignas(1024) __nv_bfloat16 ds[2][kBkv * kBq];  // dS^T, one panel
  alignas(16) float dq[D / 64][kDqSlice];
};
struct NoDqTiles {};

template <int D, bool WITH_DQ>
struct BwdSmem {
  static constexpr int STAGES = kStagesOf<WITH_DQ>;
  alignas(1024) __nv_bfloat16 k[kBkv * D];
  alignas(1024) __nv_bfloat16 v[kBkv * D];
  alignas(1024) __nv_bfloat16 q[STAGES][kBq * D];
  alignas(1024) __nv_bfloat16 dout[STAGES][kBq * D];
  alignas(16) float lse[STAGES][kBq];
  alignas(16) float di[STAGES][kBq];
  alignas(16) int qseg[STAGES][kBq];
  uint64_t full[STAGES], empty[STAGES];
  typename std::conditional<WITH_DQ, DqTiles<D>, NoDqTiles>::type x;
};

template <int D, bool WITH_DQ>
constexpr size_t bf16_smem_bytes() {
  return sizeof(BwdSmem<D, WITH_DQ>) + kSwizzleAtom;  // + room to align the base
}

// dq_acc of the bf16 kernel: per (batch, head, 64-row q tile) a chunk of
// 64 * D floats in D / 8 slots of 128 float4; slot s of consumer thread t
// holds dQ(r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) of the q tile with
// r = 16 (t / 32) + (t % 32) / 4 and c = 8 s + 2 (t % 4): the accumulator
// fragment of the consumer whose slice holds column c, slot by slot.
template <int D>
__device__ __forceinline__ size_t dq_chunk(int b, int h, int qt, int T, int H) {
  return (((size_t)b * H + h) * (T / kBq) + qt) * (size_t)(kBq * D);
}

// DOTS: the products alone (the yardstick of the product pipeline): P^T :=
// round(S^T) and dS^T := round(dP^T), no RoPE, scale, mask, softmax or
// dropout; lse_t, di_t and the ids are not read.
template <int D, bool DROP, bool DOTS, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_fused_bf16(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ lse_t, const float* __restrict__ di_t,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int HALF = D / 2;
  constexpr int NK = D / 16;     // k-steps of S^T and dP^T over the head dim
  constexpr int NS = kBq / 8;    // 8-column blocks of a score tile (q rows)
  constexpr int NP = kBq / 16;   // k-steps of dV and dK over the q tile
  constexpr int NN = D / 8;      // 8-column blocks of dk and dv
  constexpr int NJ = kBkv / 16;  // k-steps of dQ over the kv tile
  constexpr int NDQ = D / 64;    // consumers that form a dQ slice
  constexpr int kStages = kStagesOf<WITH_DQ>;
  extern __shared__ unsigned char smem_raw[];
  BwdSmem<D, WITH_DQ>& sm = *reinterpret_cast<BwdSmem<D, WITH_DQ>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, kvt = blockIdx.x, tid = threadIdx.x;
  // the q tiles this CTA walks: all, or its (batch, kv tile)'s range
  int qt0 = 0, qt1 = T / kBq - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / kBkv) + kvt];
    qt1 = q_hi[b * (T / kBkv) + kvt];
  }
  const int n_tiles = qt1 - qt0 + 1;
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
      const bool rows = !DOTS, ids = !DOTS && q_seg != nullptr;
      const uint32_t bytes = 2u * kBq * D * sizeof(__nv_bfloat16) +
                             (rows ? 2u * kBq * sizeof(float) : 0u) +
                             (ids ? kBq * sizeof(int) : 0u);
      const size_t bh_row = ((size_t)b * H + h) * T;  // (b, h) row of lse_t, di_t
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[st], ((it / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
        const int i0 = (qt0 + it) * kBq;
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn) {
          tma_load_2d(&sm.q[st][pn * kBq * kPanelCols], &qmap, h * D + pn * kPanelCols,
                      b * T + i0, &sm.full[st]);
          tma_load_2d(&sm.dout[st][pn * kBq * kPanelCols], &omap, h * D + pn * kPanelCols,
                      b * T + i0, &sm.full[st]);
        }
        if (rows) {
          bulk_load(sm.lse[st], lse_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
          bulk_load(sm.di[st], di_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
        }
        if (ids) bulk_load(sm.qseg[st], q_seg + (size_t)b * T + i0, kBq * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const size_t base = (size_t)b * T * rs + (size_t)h * D;
    const int kv0 = kvt * kBkv + wg * 64;  // this warpgroup's first kv row
    const int j0 = kv0 + warp * 16 + g;    // this thread's rows j0 and j0 + 8

    // K rows rotated in fp32 and rounded, V rows as they are, into the
    // swizzled panels
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.k), kBkv, wg * 64,
                      k + base + (size_t)kv0 * rs, rs, 64, DOTS ? nullptr : cos_t, sin_t,
                      kv0, wt, 128);
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.v), kBkv, wg * 64,
                      v + base + (size_t)kv0 * rs, rs, 64, nullptr, nullptr, 0, wt, 128);
    fence_async_shared();
    named_bar_sync(kBarKV + wg, 128);

    const int ks0 = (!DOTS && kv_seg != nullptr) ? kv_seg[(size_t)b * T + j0] : 0;
    const int ks1 = (!DOTS && kv_seg != nullptr) ? kv_seg[(size_t)b * T + j0 + 8] : 0;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    const int bh = b * H + h;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, qt = qt0 + it, i0 = qt * kBq;
      const uint32_t k_addr = shared_addr(sm.k), v_addr = shared_addr(sm.v);
      const uint32_t kw_addr = k_addr + wg * 64 * 128, vw_addr = v_addr + wg * 64 * 128;
      const uint32_t q_addr = shared_addr(sm.q[st]), o_addr = shared_addr(sm.dout[st]);
      mbar_wait(&sm.full[st], (it / kStages) & 1);

      // S^T = K_w.Q^T and dP^T = V_w.dO^T (64 kv x 64 q each), in one
      // array with the dQ slice, which takes S^T's half once S^T is packed:
      // so the three share one block of registers
      float sd[64];
      float(&s)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
      float(&dpt)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ko = (kk >> 2) * kKPanel + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
        wgmma_ss_m64n64k16<0, 0>(s, smem_desc(kw_addr + ko, 16, kSwizzleAtom),
                                 smem_desc(q_addr + qo, 16, kSwizzleAtom), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ko = (kk >> 2) * kKPanel + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
        wgmma_ss_m64n64k16<0, 0>(dpt, smem_desc(vw_addr + ko, 16, kSwizzleAtom),
                                 smem_desc(o_addr + qo, 16, kSwizzleAtom), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dpt);

      // s[] becomes P_drop^T and dpt[] dS^T. Element e of block n is (kv row
      // j0 + 8 (e >> 1), q row i0 + c + (e & 1)) with c = 8 n + 2 t4.
      if constexpr (!DOTS) {
        uint32_t keep = ~0u;  // bit 4 n + e: element e of block n is kept
        if constexpr (DROP) {
          // One Philox call covers q rows (i, i + 1) of kv rows 2m, 2m + 1.
          // Lanes g and g ^ 1 hold kv rows j0 and j0 ^ 1 (and + 8): the even
          // lane draws the pair block of its rows j0, j0 + 1, the odd lane
          // that of j0 + 7, j0 + 8, and each hands the partner the words of
          // the partner's row (word 2 (i & 1) + (j & 1)).
          const bool odd = g & 1;
          const int jd = odd ? j0 + 8 : j0;
          keep = 0;
#pragma unroll 4
          for (int n = 0; n < NS; ++n) {
            const Philox4 u = dropout_bits(dp.seed, bh, i0 + n * 8 + 2 * t4, jd);
            const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[1], 4);
            const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[2] : u.w[3], 4);
            const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[2];  // row j0
            const uint32_t c0 = odd ? u.w[1] : y0, c1 = odd ? u.w[3] : y1;  // row j0 + 8
            const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                                (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
            keep |= k4 << (4 * n);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int c = n * 8 + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][c]);
          const float2 d2 = *reinterpret_cast<const float2*>(&sm.di[st][c]);
          const int2 q2 = q_seg != nullptr ? *reinterpret_cast<const int2*>(&sm.qseg[st][c])
                                         : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lc = (e & 1) ? l2.y : l2.x, dc = (e & 1) ? d2.y : d2.x;
            const int qs = (e & 1) ? q2.y : q2.x;
            const float p = exp2f(score(s[4 * n + e], scale_log2, qs, (e >> 1) ? ks1 : ks0) - lc);
            float pd = p, d = dpt[4 * n + e];
            if constexpr (DROP) {
              const bool kp = (keep >> (4 * n + e)) & 1;
              pd = kp ? p * dp.keep_scale : 0.f;
              d = kp ? d * dp.keep_scale : 0.f;
            }
            s[4 * n + e] = pd;
            dpt[4 * n + e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, dc)), scale);
          }
        }
      }
      // the A fragments of dV and dK: k-step kk is score blocks 2 kk, 2 kk + 1
      uint32_t pa[NP][4], sa[NP][4];
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          sa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
      if constexpr (WITH_DQ) {
        // dS^T into this iteration's buffer: fragment r of k-step kk is kv
        // row j (+ 8 for r odd), q columns 16 kk + 2 t4 (+ 8 for r >= 2)
        unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.x.ds[it & 1]);
        const int jr = wg * 64 + warp * 16 + g;
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                dsb + swizzled_offset(kBkv, jr + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t4)) =
                sa[kk][r];
        }
        fence_async_shared();
      }

      // dV += P_drop^T.dO and dK += dS^T.Q (dO and Q MN-major: 16 q rows a
      // k-step)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const uint64_t db = smem_desc(o_addr + kk * 16 * 128, kQPanel, kSwizzleAtom);
        if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb(dva, pa[kk], db, 1);
        } else {
          wgmma_rs_m64n64k16_tb(dva, pa[kk], db, 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const uint64_t db = smem_desc(q_addr + kk * 16 * 128, kQPanel, kSwizzleAtom);
        if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb(dka, sa[kk], db, 1);
        } else {
          wgmma_rs_m64n64k16_tb(dka, sa[kk], db, 1);
        }
      }
      wgmma_commit();
      // the other consumer's dS^T rows (and, the first time, its K rows)
      if constexpr (WITH_DQ) named_bar_sync(kBarDs, 256);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(sa);
      // this stage's Q and dO are read
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);

      // dQ slice = dS.K_slice: A = dS^T through the transpose bit (q along
      // the panel row), B = K's panel wg (head dim along the row); 16 kv
      // rows a k-step
      if constexpr (WITH_DQ) {
        if (wg < NDQ) {
          float(&dqa)[32] = s;
          const uint32_t ds_addr = shared_addr(sm.x.ds[it & 1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NJ; ++kk)
            wgmma_ss_m64n64k16<1, 1>(
                dqa, smem_desc(ds_addr + kk * 16 * 128, kKPanel, kSwizzleAtom),
                smem_desc(k_addr + wg * kKPanel + kk * 16 * 128, kKPanel, kSwizzleAtom), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dqa);
          // the staging tile is free once the previous reduce has read it
          if (wt == 0) bulk_wait_read<0>();
          named_bar_sync(kBarStage + wg, 128);
          float4* stg = reinterpret_cast<float4*>(sm.x.dq[wg]);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            stg[n * 128 + wt] =
                make_float4(dqa[4 * n], dqa[4 * n + 1], dqa[4 * n + 2], dqa[4 * n + 3]);
          fence_async_shared();
          named_bar_sync(kBarStage + wg, 128);
          if (wt == 0) {
            // the chunk's offset formed here (hoisted, it would spill)
            bulk_reduce_add_f32(dq_acc + dq_chunk<D>(opaque(b), h, qt, T, H) + wg * kDqSlice,
                                sm.x.dq[wg], kDqSlice * sizeof(float));
            bulk_commit();
          }
        }
      }
    }
    if constexpr (WITH_DQ) {
      if (wg < NDQ && wt == 0) bulk_wait<0>();
    }

    // dv, and dk rotated back by -angle in fp32 (columns d and d + D/2 sit in
    // blocks n and n + NN/2 of the same thread); the row's offset is formed
    // here (held across the loop, it would spill)
    const size_t row0 = ((size_t)b * T + opaque(j0)) * rs + (size_t)h * D;
    __nv_bfloat16* v0 = dv + row0;
    __nv_bfloat16* k0p = dk + row0;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(v0 + col) = pack_bf16(dva[4 * n], dva[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(v0 + 8 * rs + col) = pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
    }
    if (!DOTS && cos_t != nullptr) {
#pragma unroll
      for (int n = 0; n < NN / 2; ++n) {
        const int col = n * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + 8 * r;
          const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)j * HALF + col);
          const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)j * HALF + col);
          const float x1a = dka[4 * n + 2 * r], x1b = dka[4 * n + 2 * r + 1];
          const float x2a = dka[4 * (n + NN / 2) + 2 * r], x2b = dka[4 * (n + NN / 2) + 2 * r + 1];
          __nv_bfloat16* dst = k0p + 8 * r * rs;
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(rope_inv_lo(x1a, x2a, c.x, sn.x), rope_inv_lo(x1b, x2b, c.y, sn.y));
          *reinterpret_cast<uint32_t*>(dst + col + HALF) =
              pack_bf16(rope_inv_hi(x1a, x2a, c.x, sn.x), rope_inv_hi(x1b, x2b, c.y, sn.y));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(k0p + col) = pack_bf16(dka[4 * n], dka[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(k0p + 8 * rs + col) =
            pack_bf16(dka[4 * n + 2], dka[4 * n + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 256. dK and dV of 64 kv rows at D = 256 are 256 fp32 a thread
// of one warpgroup, past the 240 registers setmaxnreg gives a consumer. So
// a CTA owns 64 kv rows (kBkv256) and its two consumers split the work by
// output, not by rows: consumer 0 holds dV and consumer 1 dK (128 fp32 a
// thread each, as m64n256 accumulators made of two m64n128 halves).
//   * Both write half of the K rows (rotated in fp32, rounded) and of the V
//     rows into swizzled panels once.
//   * Per 64-row q tile both form S^T = K.Q^T (the one product done twice):
//     consumer 0 takes p and the keep-mask into P_drop^T and dV +=
//     P_drop^T.dO; consumer 1 also forms dP^T = V.dO^T, dS^T from the
//     undropped p, and dK += dS^T.Q. B (dO, Q) is read through the
//     transpose bit in two 128-column halves.
//   * WITH_DQ: consumer 1 writes dS^T to a double-buffered tile; after a
//     named barrier consumer w forms columns 128 w..128 w + 127 of the q
//     tile's dQ = dS.K (both operands through the transpose bit, as two
//     64-column products) and adds them into the fp32 scratch by 16-byte
//     atomics from its registers, in dq_chunk's layout: the D <= 128
//     kernel's 64 KB staging tile does not fit beside the two 64 KB stages.
// The ring has two stages of Q and dO (32 KB each at 64 rows); with the K
// and V rows and the dS^T tiles a CTA takes 210 KB of shared memory.
// ---------------------------------------------------------------------------
constexpr int kBkv256 = 64, kStages256 = 2;

struct BwdSmem256 {
  alignas(1024) __nv_bfloat16 k[kBkv256 * 256];
  alignas(1024) __nv_bfloat16 v[kBkv256 * 256];
  alignas(1024) __nv_bfloat16 q[kStages256][kBq * 256];
  alignas(1024) __nv_bfloat16 dout[kStages256][kBq * 256];
  alignas(1024) __nv_bfloat16 ds[2][kBkv256 * kBq];  // dS^T, one panel
  alignas(16) float lse[kStages256][kBq];
  alignas(16) float di[kStages256][kBq];
  alignas(16) int qseg[kStages256][kBq];
  uint64_t full[kStages256], empty[kStages256];
};

constexpr size_t bf16_smem_bytes_256() {
  return sizeof(BwdSmem256) + kSwizzleAtom;  // + room to align the base
}

template <int D, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_d256_bf16(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ lse_t, const float* __restrict__ di_t,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  static_assert(D == 256, "the D = 256 kernel");
  constexpr int HALF = D / 2;
  constexpr int NK = D / 16;        // k-steps of S^T and dP^T over the head dim
  constexpr int NS = kBq / 8;       // 8-column blocks of a score tile (q rows)
  constexpr int NP = kBq / 16;      // k-steps of dV and dK over the q tile
  constexpr int NN = D / 8;         // 8-column blocks of dk and dv
  constexpr int NJ = kBkv256 / 16;  // k-steps of dQ over the kv tile
  constexpr uint32_t kKvP = kBkv256 * 128;  // panel bytes of the K, V and dS^T tiles
  extern __shared__ unsigned char smem_raw[];
  BwdSmem256& sm = *reinterpret_cast<BwdSmem256*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, kvt = blockIdx.x, tid = threadIdx.x;
  int qt0 = 0, qt1 = T / kBq - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / kBkv256) + kvt];
    qt1 = q_hi[b * (T / kBkv256) + kvt];
  }
  const int n_tiles = qt1 - qt0 + 1;
  if (tid == 0) {
    if (tile_count != nullptr) atomicAdd(tile_count, n_tiles);
#pragma unroll
    for (int st = 0; st < kStages256; ++st) {
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
      const bool ids = q_seg != nullptr;
      const uint32_t bytes = 2u * kBq * D * sizeof(__nv_bfloat16) + 2u * kBq * sizeof(float) +
                             (ids ? kBq * sizeof(int) : 0u);
      const size_t bh_row = ((size_t)b * H + h) * T;  // (b, h) row of lse_t, di_t
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages256;
        if (it >= kStages256) mbar_wait(&sm.empty[st], ((it / kStages256) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
        const int i0 = (qt0 + it) * kBq;
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn) {
          tma_load_2d(&sm.q[st][pn * kBq * kPanelCols], &qmap, h * D + pn * kPanelCols,
                      b * T + i0, &sm.full[st]);
          tma_load_2d(&sm.dout[st][pn * kBq * kPanelCols], &omap, h * D + pn * kPanelCols,
                      b * T + i0, &sm.full[st]);
        }
        bulk_load(sm.lse[st], lse_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
        bulk_load(sm.di[st], di_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
        if (ids) bulk_load(sm.qseg[st], q_seg + (size_t)b * T + i0, kBq * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 0 forms dV, 1 forms dK, both over the CTA's 64 kv rows ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool is_dk = wg == 1;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const size_t base = (size_t)b * T * rs + (size_t)h * D;
    const int kv0 = kvt * kBkv256;       // the CTA's first kv row
    const int j0 = kv0 + warp * 16 + g;  // this thread's rows j0 and j0 + 8

    // K rows rotated in fp32 and rounded, V rows as they are, into the
    // swizzled panels: each consumer writes 32 rows of each
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.k), kBkv256, wg * 32,
                      k + base + (size_t)(kv0 + wg * 32) * rs, rs, 32, cos_t, sin_t,
                      kv0 + wg * 32, wt, 128);
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.v), kBkv256, wg * 32,
                      v + base + (size_t)(kv0 + wg * 32) * rs, rs, 32, nullptr, nullptr, 0, wt,
                      128);
    fence_async_shared();
    named_bar_sync(kBarKV, 256);

    const int ks0 = kv_seg != nullptr ? kv_seg[(size_t)b * T + j0] : 0;
    const int ks1 = kv_seg != nullptr ? kv_seg[(size_t)b * T + j0 + 8] : 0;
    float acc[D / 2];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const int bh = b * H + h;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages256, qt = qt0 + it, i0 = qt * kBq;
      // K's and V's addresses formed here: hoisted, the 32 loop-invariant
      // descriptors of their k-steps would be held across the loop and spill
      const uint32_t k_addr = opaque(shared_addr(sm.k)), v_addr = opaque(shared_addr(sm.v));
      const uint32_t q_addr = shared_addr(sm.q[st]), o_addr = shared_addr(sm.dout[st]);
      mbar_wait(&sm.full[st], (it / kStages256) & 1);

      // S^T = K.Q^T and (consumer 1) dP^T = V.dO^T, 64 kv x 64 q each, in
      // one array that the dQ slice takes over once both are packed
      float sd[64];
      float(&s)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
      float(&dpt)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ko = (kk >> 2) * kKvP + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * (kBq * 128) + (kk & 3) * 32;
        wgmma_ss_m64n64k16<0, 0>(s, smem_desc(k_addr + ko, 16, kSwizzleAtom),
                                 smem_desc(q_addr + qo, 16, kSwizzleAtom), kk > 0);
      }
      if (is_dk) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const uint32_t ko = (kk >> 2) * kKvP + (kk & 3) * 32;
          const uint32_t qo = (kk >> 2) * (kBq * 128) + (kk & 3) * 32;
          wgmma_ss_m64n64k16<0, 0>(dpt, smem_desc(v_addr + ko, 16, kSwizzleAtom),
                                   smem_desc(o_addr + qo, 16, kSwizzleAtom), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sd);

      // consumer 0: s[] becomes P_drop^T; consumer 1: dpt[] becomes dS^T.
      // Element e of block n is (kv row j0 + 8 (e >> 1), q row i0 + c + (e &
      // 1)) with c = 8 n + 2 t4.
      uint32_t keep = ~0u;  // bit 4 n + e: element e of block n is kept
      if constexpr (DROP) {
        // the fused kernel's draw (mh_bwd_fused_bf16): lanes g and g ^ 1
        // share one Philox call per q-row pair
        const bool odd = g & 1;
        const int jd = odd ? j0 + 8 : j0;
        keep = 0;
#pragma unroll 4
        for (int n = 0; n < NS; ++n) {
          const Philox4 u = dropout_bits(dp.seed, bh, i0 + n * 8 + 2 * t4, jd);
          const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[1], 4);
          const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[2] : u.w[3], 4);
          const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[2];  // row j0
          const uint32_t c0 = odd ? u.w[1] : y0, c1 = odd ? u.w[3] : y1;  // row j0 + 8
          const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                              (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
          keep |= k4 << (4 * n);
        }
      }
      // p of element e of block n
      auto prob = [&](int n, int e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        const int qs = q_seg != nullptr ? sm.qseg[st][c] : 0;
        return exp2f(score(s[4 * n + e], scale_log2, qs, (e >> 1) ? ks1 : ks0) -
                     sm.lse[st][c]);
      };
      // the A fragments of dV (P_drop^T) or dK (dS^T): k-step kk is score
      // blocks 2 kk, 2 kk + 1. Each consumer runs its own loop: a role
      // chosen per element is predicated, both roles' values live at once
      // and spill.
      uint32_t fa[NP][4];
      if (is_dk) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d = dpt[4 * n + e];
            if constexpr (DROP) d = (keep >> (4 * n + e)) & 1 ? d * dp.keep_scale : 0.f;
            dpt[4 * n + e] = __fmul_rn(
                __fmul_rn(prob(n, e), __fsub_rn(d, sm.di[st][n * 8 + 2 * t4 + (e & 1)])), scale);
          }
        }
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            fa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = prob(n, e);
            s[4 * n + e] = DROP ? ((keep >> (4 * n + e)) & 1 ? p * dp.keep_scale : 0.f) : p;
          }
        }
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            fa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
      }
      if constexpr (WITH_DQ) {
        if (is_dk) {
          // dS^T into this iteration's buffer: fragment r of k-step kk is
          // kv row j (+ 8 for r odd), q columns 16 kk + 2 t4 (+ 8 for r >= 2)
          unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[it & 1]);
          const int jr = warp * 16 + g;
#pragma unroll
          for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              *reinterpret_cast<uint32_t*>(dsb + swizzled_offset(kBkv256, jr + 8 * (r & 1),
                                                                 16 * kk + 8 * (r >> 1) + 2 * t4)) =
                  fa[kk][r];
          }
          fence_async_shared();
        }
      }

      // dV += P_drop^T.dO (consumer 0) or dK += dS^T.Q (consumer 1): dO and
      // Q MN-major, 16 q rows a k-step, the head dim in two 128-column
      // halves (panels 0-1 and 2-3)
      const uint32_t b_addr = is_dk ? q_addr : o_addr;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        wgmma_rs_m64n128k16_tb(acc_half<0>(acc), fa[kk],
                               smem_desc(b_addr + kk * 16 * 128, kBq * 128, kSwizzleAtom), 1);
        wgmma_rs_m64n128k16_tb(
            acc_half<1>(acc), fa[kk],
            smem_desc(b_addr + 2 * kBq * 128 + kk * 16 * 128, kBq * 128, kSwizzleAtom), 1);
      }
      wgmma_commit();
      // consumer 1's dS^T rows are in
      if constexpr (WITH_DQ) named_bar_sync(kBarDs, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(fa);
      // this stage's Q and dO are read
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);

      // dQ columns 128 wg + 64 hf.. of the q tile = dS.K: A = dS^T through
      // the transpose bit (q along the panel row), B = K's panel 2 wg + hf
      // (head dim along the row); 16 kv rows a k-step
      if constexpr (WITH_DQ) {
        float(&dq0)[32] = s;
        float(&dq1)[32] = dpt;
        const uint32_t ds_addr = shared_addr(sm.ds[it & 1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          const uint64_t da = smem_desc(ds_addr + kk * 16 * 128, kKvP, kSwizzleAtom);
          wgmma_ss_m64n64k16<1, 1>(
              dq0, da, smem_desc(k_addr + (2 * wg) * kKvP + kk * 16 * 128, kKvP, kSwizzleAtom),
              kk > 0);
          wgmma_ss_m64n64k16<1, 1>(
              dq1, da,
              smem_desc(k_addr + (2 * wg + 1) * kKvP + kk * 16 * 128, kKvP, kSwizzleAtom),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sd);
        // slot 16 wg + 8 hf + n of the chunk holds this thread's block n of
        // half hf; the chunk's offset formed here (hoisted, it would spill)
        float4* dst = reinterpret_cast<float4*>(dq_acc + dq_chunk<D>(opaque(b), h, qt, T, H)) +
                      (size_t)(16 * wg) * 128 + wt;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            atomicAdd(dst + (8 * hf + n) * 128,
                      make_float4(sd[32 * hf + 4 * n], sd[32 * hf + 4 * n + 1],
                                  sd[32 * hf + 4 * n + 2], sd[32 * hf + 4 * n + 3]));
      }
    }

    // dv (consumer 0), or dk rotated back by -angle in fp32 (consumer 1;
    // columns d and d + D/2 sit in blocks n and n + NN/2 of the same
    // thread); the row's offset is formed here (held across the loop, it
    // would spill)
    const size_t row0 = ((size_t)b * T + opaque(j0)) * rs + (size_t)h * D;
    __nv_bfloat16* out = (is_dk ? dk : dv) + row0;
    if (is_dk && cos_t != nullptr) {
#pragma unroll
      for (int n = 0; n < NN / 2; ++n) {
        const int col = n * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + 8 * r;
          const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)j * HALF + col);
          const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)j * HALF + col);
          const float x1a = acc[4 * n + 2 * r], x1b = acc[4 * n + 2 * r + 1];
          const float x2a = acc[4 * (n + NN / 2) + 2 * r], x2b = acc[4 * (n + NN / 2) + 2 * r + 1];
          __nv_bfloat16* dst = out + 8 * r * rs;
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(rope_inv_lo(x1a, x2a, c.x, sn.x), rope_inv_lo(x1b, x2b, c.y, sn.y));
          *reinterpret_cast<uint32_t*>(dst + col + HALF) =
              pack_bf16(rope_inv_hi(x1a, x2a, c.x, sn.x), rope_inv_hi(x1b, x2b, c.y, sn.y));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(out + 8 * rs + col) =
            pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
  }
}

// dq = inverse-RoPE(dq_acc) in fp32, cast to bf16, from the bf16 kernel's
// dq_acc layout (dq_chunk). One thread per (chunk, slot s < D / 16, thread
// t): slots s and s + D / 16 hold columns c, c + 1 and c + D / 2, c + D / 2
// + 1 of rows r and r + 8.
template <int D>
__global__ void dq_epilogue_bf16(const float4* __restrict__ acc,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t,
                                 __nv_bfloat16* __restrict__ out, int T, int H,
                                 long long n_items) {
  constexpr int HALF = D / 2, NSL = D / 16;
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const int t = (int)(it % 128), s = (int)((it / 128) % NSL);
  const long long chunk = it / (128 * NSL);
  const int qt = (int)(chunk % (T / kBq));
  const long long bh = chunk / (T / kBq);
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const float4 x1 = acc[(chunk * (D / 8) + s) * 128 + t];
  const float4 x2 = acc[(chunk * (D / 8) + s + NSL) * 128 + t];
  const float lo[4] = {x1.x, x1.y, x1.z, x1.w}, hi[4] = {x2.x, x2.y, x2.z, x2.w};
  const int i = qt * kBq + 16 * (t >> 5) + ((t & 31) >> 2), c = 8 * s + 2 * (t & 3);
  float yl[4], yh[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    yl[e] = lo[e];
    yh[e] = hi[e];
    if (cos_t != nullptr) {
      const size_t tab = (size_t)(i + 8 * (e >> 1)) * HALF + c + (e & 1);
      yl[e] = rope_inv_lo(lo[e], hi[e], cos_t[tab], sin_t[tab]);
      yh[e] = rope_inv_hi(lo[e], hi[e], cos_t[tab], sin_t[tab]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* row = out + (((size_t)b * T + i + 8 * r) * H + h) * D;
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(yl[2 * r], yl[2 * r + 1]);
    *reinterpret_cast<uint32_t*>(row + c + HALF) = pack_bf16(yh[2 * r], yh[2 * r + 1]);
  }
}

// The bf16 kernel on q already rotated (or not rotated at all); k rotated
// by the kernel. WITH_DQ: dq_acc (fp32, q's size) is zeroed, summed into
// and turned into dq by dq_epilogue_bf16; else dq_acc and dq are not read.
template <int D, bool DROP, bool DOTS, bool WITH_DQ>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                        const float* lse_t, const float* di_t, const int* q_seg, const int* kv_seg,
                        const float* cos_t, const float* sin_t, const int* q_lo,
                        const int* q_hi, int* tile_count, float* dq_acc,
                        __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
                        int T, int H, float scale_log2, float scale, DropParams dp,
                        cudaStream_t st) {
  // Q and dO as (B * T, H * D) row-major matrices, loaded as 64-row boxes
  // of one head's 64-column panels
  CUtensorMap qmap, omap;
  const uint64_t rows = (uint64_t)B * T, cols = (uint64_t)H * D;
  cudaError_t e = encode_bf16_panels(&qmap, q, rows, cols, cols, kBq);
  if (e == cudaSuccess) e = encode_bf16_panels(&omap, dout, rows, cols, cols, kBq);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * T * H * D;
  if constexpr (WITH_DQ) {
    e = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
    if (e != cudaSuccess) return e;
  }
  // the D = 256 kernel at D = 256 (no DOTS instance), else the general one;
  // the shared-memory limit belongs to the instance on a device, not to
  // the call: set it at the first launch on each device
  static_assert(D != 256 || !DOTS, "no products-alone instance at D = 256");
  static std::atomic<uint64_t> smem_set{0};
  auto run = [&](auto kernel, int kv_rows, size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t dev_bit = 1ull << (dev & 63);
    if (!(smem_set.load(std::memory_order_acquire) & dev_bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      smem_set.fetch_or(dev_bit, std::memory_order_release);
    }
    kernel<<<dim3(T / kv_rows, H, B), kThreads, smem, st>>>(
        qmap, omap, k, v, lse_t, di_t, q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count,
        dq_acc, dk, dv, T, H, scale_log2, scale, dp);
    return cudaSuccess;
  };
  if constexpr (D == 256) {
    e = run(mh_bwd_d256_bf16<D, DROP, WITH_DQ>, kBkv256, bf16_smem_bytes_256());
  } else {
    e = run(mh_bwd_fused_bf16<D, DROP, DOTS, WITH_DQ>, kBkv, bf16_smem_bytes<D, WITH_DQ>());
  }
  if (e != cudaSuccess) return e;
  if constexpr (WITH_DQ) {
    const long long n_items = n / 8;
    dq_epilogue_bf16<D><<<(unsigned)((n_items + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(dq_acc), DOTS ? nullptr : cos_t, sin_t, dq, T, H,
        n_items);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: 32 kv rows x TPR threads (4, or 8 at D = 256); thread `sub` of a
// row owns the head dims sub + TPR*i (its k, v, dk and dv in registers, 128
// fp32 at D = 256 either way), so a dot product is TPR partial sums joined
// by shuffles. 16-row q tiles. The K, Q and dO tiles live in dynamic shared
// memory (66 KB at D = 256).
// ---------------------------------------------------------------------------
constexpr int kF32Kv = 32;
constexpr int kF32Q = 16;
template <int D>
__host__ __device__ constexpr int f32_tpr() {
  return D == 256 ? 8 : 4;
}

template <int D>
struct F32Smem {
  alignas(16) float k[kF32Kv * D];
  alignas(16) float q[kF32Q * D];
  alignas(16) float dout[kF32Q * D];
  float ds[kF32Q * kF32Kv];
  float lse[kF32Q], di[kF32Q];
  int qseg[kF32Q];
};

template <int D, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(32 * f32_tpr<D>()) mh_bwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, float* __restrict__ dk,
    float* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int BKV = kF32Kv, BQ = kF32Q, HALF = D / 2, TPR = f32_tpr<D>();
  constexpr int NT = 32 * TPR, PER = D / TPR;
  extern __shared__ unsigned char smem_raw[];
  F32Smem<D>& sm = *reinterpret_cast<F32Smem<D>*>(smem_raw);
  float* Ks = sm.k;
  float* Qs = sm.q;
  float* Os = sm.dout;
  float* dSs = sm.ds;
  float* lse_s = sm.lse;
  float* di_s = sm.di;
  int* qseg_s = sm.qseg;

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int sub = tid & (TPR - 1), rl = tid / TPR, j = blockIdx.x * BKV + rl;
  const int bh = b * H + h;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;

  for (int it = tid; it < BKV * (D / 4); it += NT) {
    const int r = it / (D / 4), c4 = (it % (D / 4)) * 4;
    *reinterpret_cast<float4*>(Ks + r * D + c4) = *reinterpret_cast<const float4*>(
        k + base + (size_t)(blockIdx.x * BKV + r) * rs + c4);
  }
  float kr[PER], vr[PER], dka[PER], dva[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    kr[i] = k[base + (size_t)j * rs + sub + TPR * i];
    vr[i] = v[base + (size_t)j * rs + sub + TPR * i];
    dka[i] = dva[i] = 0.f;
  }
  const int ks = kv_seg ? kv_seg[(size_t)b * T + j] : 0;

  int qt0 = 0, qt1 = T / BQ - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / BKV) + blockIdx.x];
    qt1 = q_hi[b * (T / BKV) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, qt1 - qt0 + 1);
  for (int i0 = qt0 * BQ; i0 <= qt1 * BQ; i0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int it = tid; it < BQ * (D / 4); it += NT) {
      const int r = it / (D / 4), c4 = (it % (D / 4)) * 4;
      const size_t off = base + (size_t)(i0 + r) * rs + c4;
      *reinterpret_cast<float4*>(Qs + r * D + c4) = *reinterpret_cast<const float4*>(q + off);
      *reinterpret_cast<float4*>(Os + r * D + c4) = *reinterpret_cast<const float4*>(dout + off);
    }
    if (tid < BQ) {
      const size_t r = ((size_t)b * T + i0 + tid) * H + h;
      lse_s[tid] = lse[r];
      di_s[tid] = di[r];
      qseg_s[tid] = q_seg ? q_seg[(size_t)b * T + i0 + tid] : 0;
    }
    __syncthreads();

    for (int qi = 0; qi < BQ; ++qi) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        sp = fmaf(kr[i], Qs[qi * D + sub + TPR * i], sp);
        dpp = fmaf(vr[i], Os[qi * D + sub + TPR * i], dpp);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        sp += __shfl_xor_sync(0xffffffffu, sp, off);
        dpp += __shfl_xor_sync(0xffffffffu, dpp, off);
      }
      const float p = exp2f(score(sp, scale_log2, qseg_s[qi], ks) - lse_s[qi]);
      float pd = p;
      if constexpr (DROP) {
        const int i = i0 + qi;
        const bool keep = pick(dropout_bits(dp.seed, bh, i, j), dropout_word(i, j)) >= dp.thresh;
        pd = keep ? p * dp.keep_scale : 0.f;
        dpp = keep ? dpp * dp.keep_scale : 0.f;
      }
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dpp, di_s[qi])), scale);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dva[i] = fmaf(pd, Os[qi * D + sub + TPR * i], dva[i]);
        dka[i] = fmaf(ds, Qs[qi * D + sub + TPR * i], dka[i]);
      }
      if (WITH_DQ && sub == 0) dSs[qi * BKV + rl] = ds;
    }
    __syncthreads();

    // dQ share of this kv tile: thread takes q row tid / CPR, columns
    // (tid % CPR) + CPR m
    if constexpr (WITH_DQ) {
      constexpr int CPR = NT / BQ;
      const int qi = tid / CPR, c0 = tid % CPR;
      float* dst = dq_acc + base + (size_t)(i0 + qi) * rs;
      for (int m = 0; m < D / CPR; ++m) {
        const int d = c0 + CPR * m;
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < BKV; ++r) a = fmaf(dSs[qi * BKV + r], Ks[r * D + d], a);
        atomicAdd(dst + d, a);
      }
    }
  }

  float* dkr = dk + base + (size_t)j * rs;
  float* dvr = dv + base + (size_t)j * rs;
#pragma unroll
  for (int i = 0; i < PER; ++i) dvr[sub + TPR * i] = dva[i];
  if (cos_t != nullptr) {
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const int d = sub + TPR * i;  // < HALF; its partner d + HALF is i + PER/2
      const float c = cos_t[(size_t)j * HALF + d], s = sin_t[(size_t)j * HALF + d];
      dkr[d] = rope_inv_lo(dka[i], dka[i + PER / 2], c, s);
      dkr[d + HALF] = rope_inv_hi(dka[i], dka[i + PER / 2], c, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) dkr[sub + TPR * i] = dka[i];
  }
}

// The fp32 kernel's launch: a block per (32-row kv tile, head, batch row),
// 32 * TPR threads, its tiles in dynamic shared memory (the attribute set
// once a device where they pass the 48 KB default).
template <int D, bool DROP, bool WITH_DQ>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                       const float* cos_t, const float* sin_t, const int* q_lo,
                       const int* q_hi, int* tile_count, float* dq_acc, float* dk, float* dv,
                       int B, int T, int H, float scale_log2, float scale, DropParams dp,
                       cudaStream_t st) {
  constexpr size_t smem = sizeof(F32Smem<D>);
  if constexpr (smem > 48 * 1024) {
    static std::atomic<uint64_t> smem_set{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t dev_bit = 1ull << (dev & 63);
    if (!(smem_set.load(std::memory_order_acquire) & dev_bit)) {
      e = cudaFuncSetAttribute(mh_bwd_f32<D, DROP, WITH_DQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      smem_set.fetch_or(dev_bit, std::memory_order_release);
    }
  }
  mh_bwd_f32<D, DROP, WITH_DQ><<<dim3(T / kF32Kv, H, B), 32 * f32_tpr<D>(), smem, st>>>(
      q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, dk, dv,
      T, H, scale_log2, scale, dp);
  return cudaGetLastError();
}


}  // namespace
}  // namespace bwd
}  // namespace obt
