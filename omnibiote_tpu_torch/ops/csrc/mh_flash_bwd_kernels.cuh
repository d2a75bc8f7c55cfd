// Kernels of the multi-head flash attention backward shared by the fused
// entry (mh_flash_bwd.cu: dq, dk and dv in one pass) and the dk/dv half of
// the split pair (mh_flash_bwd_dkv.cu); see those files for what each
// replaces. The bf16 kernel is Hopper's (TMA, wgmma, warp specialisation)
// and serves both: with WITH_DQ it also forms dq, without it it is the dkv
// kernel; at D = 256 its place is taken by mh_bwd_d256_bf16 (a 64-row kv
// tile, the consumers split by output, see its note). The fp32 kernel is
// the parity type and runs all five products on the tensor cores in 3xTF32
// (mh_bwd_f32's note).
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
#include "tf32x3.cuh"

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
// fp32, the parity type: all five products on the tensor cores in 3xTF32
// (tf32x3.cuh: each operand split into two tf32 parts, three mma.sync
// m16n8k8 products a step, fp32 accumulators), the bf16 kernel's kv-row design on
// mma.sync. A CTA owns a (batch, head, 64-row kv tile): warp w the kv rows
// 16 (w % 4) .. + 15, the rows of its A and C fragments, and past D = 64
// (eight warps) head-dim part c = w / 4, the lanes [D/4 c, D/4 (c + 1))
// and D/2 + the same (closed under rotate-half): dK and dV of a part are
// D/2 fp32 a thread, and two warps a scheduler hide the products' latency
// (four warps of all D lanes ran at 249-255 registers at D = 128). At D =
// 64 a part's 4 k-steps do not pay for the exchange (the fused kernel took
// 6.36 ms against 5.15 over every tile at B=16, T=1024), so four warps own
// all lanes there, two CTAs an SM.
//   * K and V rows (rotated ahead) stay in shared memory; BQ-row Q and dO
//     tiles, with the rows' lse2, di and q ids, arrive by cp.async in a
//     two-stage ring, the next tile's copies in flight while the CTA works
//     on this one (every thread issues its share; no producer warp).
//   * S^T = K.Q^T and dP^T = V.dO^T: A fragments from the resident K / V
//     rows, split once a k-step and used on the tile's BQ / 8 column blocks;
//     B fragments are Q's / dO's rows (both operands K-major); the small
//     terms in accumulators of their own (tf32x3.cuh::mma3_apart). Past D
//     = 64 each part forms them over its own lanes and the two partial sums
//     are added through shared memory (fp32 addition commutes: both parts
//     hold the same bits).
//   * p, the keep bits and ds on the C fragments, as the bf16 kernel runs
//     them; dV += P_drop^T.dO and dK += dS^T.Q on the part's lanes, the C
//     fragments as A operands in tf32x3.cuh's permuted k order, dO's and
//     Q's B fragments read down their columns.
//   * WITH_DQ: dS^T goes to shared memory; after a barrier each warp forms
//     a 16-row by (D / warps-a-row-tile)-lane block of the q tile's dQ =
//     dS.K (B from K's columns), writes it to a staging tile, and one
//     thread adds the whole tile into the fp32 scratch dq_acc, laid out
//     (B, H, T, D) so that a q tile is one span, by one TMA bulk reduce-add
//     (cp.reduce.async.bulk .add.f32): one reduce a q tile and CTA in place
//     of an atomic an element; the sums' order changes from run to run.
//     The staging tile is read by the TMA unit while the next q tile's
//     scores run (past D = 64 it shares its memory with the partial-score
//     exchange, so its read is awaited before the exchange).
// Why mma.sync and not wgmma: wgmma takes tf32 operands K-major only;
// dV, dK and dQ read dO, Q and K MN-major, so each would need a transposed
// copy, and every operand a split copy (hi and lo) in shared memory.
// mma.sync reads both kinds of fragment from one padded row-major copy,
// split in registers as it is loaded. Rows are padded by 4 floats (D + 4 =
// 4 mod 32, BQ + 4 = 4 mod 16): the row reads (rows g, columns t) and the
// column reads (rows 2 t, columns g) of a warp fall in 32 distinct banks.
// Bound: three tensor-core products for each of the function's: at 8 x
// 128, B=16, T=1024 the fused backward's 171.8 GFLOP take at least 1.04 ms
// at 495 TFLOP/s TF32 (2.56 ms at the FP32 FFMA rate).
// ---------------------------------------------------------------------------
template <int D>
struct F32Bwd {
  static constexpr int NP = D == 64 ? 1 : 2;      // head-dim parts
  static constexpr int DP = D / NP, HW = DP / 2;  // a part's lanes, and of each half
  static constexpr int BKV = 64, BQ = D == 256 ? 16 : 32;
  static constexpr int WARPS = 4 * NP, THREADS = 32 * WARPS;
  static constexpr int LD = D + 4, DS_LD = BQ + 4;
  static constexpr int NQ = BQ / 8;               // 8-column blocks of S^T
  // floats: K and V; Q and dO (two stages each); lse2 and di (two stages
  // each); dS^T; the partial scores' exchange (two parts) and the dQ
  // staging tile, one region; then the q ids (two stages, int)
  static constexpr size_t KV = (size_t)2 * BKV * LD;
  static constexpr size_t RING = (size_t)4 * BQ * LD;
  static constexpr size_t ROWS = 4 * BQ;
  static constexpr size_t DST = (size_t)BKV * DS_LD;
  static constexpr size_t XCH = NP > 1 ? (size_t)WARPS * 2 * NQ * 4 * 32 : 0;
  static constexpr size_t STG = (size_t)BQ * D;
  template <bool WITH_DQ>
  __host__ __device__ static constexpr size_t floats() {
    return KV + RING + ROWS + (WITH_DQ ? DST + (STG > XCH ? STG : XCH) : XCH);
  }
  template <bool WITH_DQ>
  __host__ __device__ static constexpr size_t smem() {
    return floats<WITH_DQ>() * 4 + 2 * BQ * 4;
  }
};

template <int D, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(F32Bwd<D>::THREADS, 1) mh_bwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, float* __restrict__ dk,
    float* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  using G = F32Bwd<D>;
  constexpr int BKV = G::BKV, BQ = G::BQ, LD = G::LD, DS_LD = G::DS_LD, NP = G::NP;
  constexpr int HW = G::HW, NQ = G::NQ, NDP = G::DP / 8, HALF = D / 2;
  extern __shared__ __align__(16) float f32_smem[];
  float* ksm = f32_smem;
  float* vsm = ksm + BKV * LD;
  float* qsm = vsm + BKV * LD;
  float* osm = qsm + 2 * BQ * LD;
  float* lsm = osm + 2 * BQ * LD;
  float* dism = lsm + 2 * BQ;
  float* dst = dism + 2 * BQ;                      // dS^T (WITH_DQ)
  float* xch = dst + (WITH_DQ ? G::DST : 0);       // exchange / dQ staging
  int* qsegs = reinterpret_cast<int*>(f32_smem + G::template floats<WITH_DQ>());

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int part = warp >> 2;
  const int j0 = blockIdx.x * BKV;
  const int jr = (warp & 3) * 16 + g;  // this thread's kv rows jr and jr + 8 of the tile
  const int bh = b * H + h;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const bool seg = q_seg != nullptr;
  // the head-dim column of 8-lane block kb of this warp's part
  auto pcol = [&](int kb) {
    return kb * 8 < HW ? HW * part + kb * 8 : HALF + HW * part + kb * 8 - HW;
  };

  int qt0 = 0, qt1 = T / BQ - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / BKV) + blockIdx.x];
    qt1 = q_hi[b * (T / BKV) + blockIdx.x];
  }
  const int n_tiles = qt1 - qt0 + 1;
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, n_tiles);

  // Q and dO rows of q tile qt, their lse2, di and q ids into ring stage
  // `stage`
  auto load_q = [&](int stage, int qt) {
    const int i0 = qt * BQ;
    float* qd = qsm + stage * BQ * LD;
    float* od = osm + stage * BQ * LD;
    for (int it = tid; it < BQ * (D / 4); it += G::THREADS) {
      const int r = it / (D / 4), c = (it % (D / 4)) * 4;
      const size_t off = base + (size_t)(i0 + r) * rs + c;
      cp_async16(qd + r * LD + c, q + off);
      cp_async16(od + r * LD + c, dout + off);
    }
    if (tid < BQ) {
      const size_t r = ((size_t)b * T + i0 + tid) * H + h;
      cp_async4(lsm + stage * BQ + tid, lse + r);
      cp_async4(dism + stage * BQ + tid, di + r);
    } else if (seg && tid < BQ + BQ / 4) {
      const int c = 4 * (tid - BQ);
      cp_async16(qsegs + stage * BQ + c, q_seg + (size_t)b * T + i0 + c);
    }
  };
  // the CTA's K and V rows, with the first q tile
  for (int it = tid; it < BKV * (D / 4); it += G::THREADS) {
    const int r = it / (D / 4), c = (it % (D / 4)) * 4;
    const size_t off = base + (size_t)(j0 + r) * rs + c;
    cp_async16(ksm + r * LD + c, k + off);
    cp_async16(vsm + r * LD + c, v + off);
  }
  load_q(0, qt0);
  cp_async_commit();
  const int ks0 = kv_seg ? kv_seg[(size_t)b * T + j0 + jr] : 0;
  const int ks1 = kv_seg ? kv_seg[(size_t)b * T + j0 + jr + 8] : 0;

  float dka[NDP][4], dva[NDP][4];
#pragma unroll
  for (int n = 0; n < NDP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, i0 = (qt0 + it) * BQ;
    if (it + 1 < n_tiles) load_q(st ^ 1, qt0 + it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // q tile it (and, the first time, K and V) is in
    const float* qtile = qsm + st * BQ * LD;
    const float* otile = osm + st * BQ * LD;

    // S^T and dP^T over this part's lanes: element e of block n is (kv row
    // jr + 8 (e >> 1), q row i0 + 8 n + 2 t4 + (e & 1))
    // (the small terms apart until the k-steps are done)
    float s[NQ][4], dpt[NQ][4], ssm[NQ][4], dsm[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpt[n][e] = ssm[n][e] = dsm[n][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NDP; ++kb) {
      const int c = pcol(kb) + t4;
      const float* ka = ksm + jr * LD + c;
      const float* va = vsm + jr * LD + c;
      const x3::AFrag kf = x3::split_a(ka[0], ka[8 * LD], ka[4], ka[8 * LD + 4]);
      const x3::AFrag vf = x3::split_a(va[0], va[8 * LD], va[4], va[8 * LD + 4]);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float* qb = qtile + (n * 8 + g) * LD + c;
        const float* ob = otile + (n * 8 + g) * LD + c;
        x3::mma3_apart(s[n], ssm[n], kf, qb[0], qb[4]);
        x3::mma3_apart(dpt[n], dsm[n], vf, ob[0], ob[4]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] += ssm[n][e];
        dpt[n][e] += dsm[n][e];
      }
    if constexpr (NP > 1) {
      // the other part's partial sums, through shared memory in fragment
      // order (conflict-free); the dQ staging tile shares this memory, so
      // its bulk read must be done first
      if constexpr (WITH_DQ) {
        if (tid == 0) bulk_wait_read<0>();
        __syncthreads();
      }
      float* mine = xch + warp * (2 * NQ * 4 * 32) + lane;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(n * 4 + e) * 32] = s[n][e];
          mine[((NQ + n) * 4 + e) * 32] = dpt[n][e];
        }
      __syncthreads();
      const float* other = xch + (warp ^ 4) * (2 * NQ * 4 * 32) + lane;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] += other[(n * 4 + e) * 32];
          dpt[n][e] += other[((NQ + n) * 4 + e) * 32];
        }
    }

    // s[] becomes P_drop^T and dpt[] dS^T
    uint32_t keep = ~0u;  // bit 4 n + e: element e of block n is kept
    if constexpr (DROP) {
      // One Philox call covers q rows (i, i + 1) of kv rows 2m, 2m + 1:
      // the even lane of g, g ^ 1 draws the pair block of its rows jr, jr +
      // 1, the odd lane that of jr + 7, jr + 8, and each hands the partner
      // the words of the partner's row (word 2 (i & 1) + (j & 1)).
      const bool odd = g & 1;
      const int jd = j0 + (odd ? jr + 8 : jr);
      keep = 0;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const Philox4 u = dropout_bits(dp.seed, bh, i0 + n * 8 + 2 * t4, jd);
        const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[1], 4);
        const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[2] : u.w[3], 4);
        const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[2];  // row jr
        const uint32_t c0 = odd ? u.w[1] : y0, c1 = odd ? u.w[3] : y1;  // row jr + 8
        const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                            (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
        keep |= k4 << (4 * n);
      }
    }
    const float* lt = lsm + st * BQ;
    const float* dt = dism + st * BQ;
    const int* qg = qsegs + st * BQ;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int c = n * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
      const int2 q2 = seg ? *reinterpret_cast<const int2*>(qg + c) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? l2.y : l2.x, dc = (e & 1) ? d2.y : d2.x;
        const int qs = (e & 1) ? q2.y : q2.x;
        const float p = exp2f(score(s[n][e], scale_log2, qs, (e >> 1) ? ks1 : ks0) - lc);
        float pd = p, d = dpt[n][e];
        if constexpr (DROP) {
          const bool kp = (keep >> (4 * n + e)) & 1;
          pd = kp ? p * dp.keep_scale : 0.f;
          d = kp ? d * dp.keep_scale : 0.f;
        }
        s[n][e] = pd;
        dpt[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, dc)), scale);
      }
    }

    // dV += P_drop^T.dO and dK += dS^T.Q on the part's lanes: k-step kk is
    // score block kk, its q rows in the permuted order (A fragment c0, c2,
    // c1, c3; B rows 2 t4 and 2 t4 + 1)
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const x3::AFrag pf = x3::split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const x3::AFrag sf = x3::split_a(dpt[kk][0], dpt[kk][2], dpt[kk][1], dpt[kk][3]);
      const float* ob = otile + (kk * 8 + 2 * t4) * LD + g;
      const float* qb = qtile + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NDP; ++n) {
        const int c = pcol(n);
        x3::mma3(dva[n], pf, ob[c], ob[LD + c]);
        x3::mma3(dka[n], sf, qb[c], qb[LD + c]);
      }
    }

    if constexpr (WITH_DQ) {
      // dS^T (kv rows by q rows), from part 0's warps
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int c = n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(dst + jr * DS_LD + c) = make_float2(dpt[n][0], dpt[n][1]);
          *reinterpret_cast<float2*>(dst + (jr + 8) * DS_LD + c) =
              make_float2(dpt[n][2], dpt[n][3]);
        }
      }
      if constexpr (NP == 1) {
        if (tid == 0) bulk_wait_read<0>();  // the last tile's staging is read
      }
      __syncthreads();  // dS^T is in; every read of this ring stage is done

      // dQ = dS.K: warp w a 16-row m-tile mt of the q tile by NC 8-lane
      // blocks of range cr (A from dS^T's columns, B from K's; the small
      // terms apart)
      constexpr int MT = BQ / 16, NC = (D / 8) / (G::WARPS / MT);
      const int mt = warp % MT, cr = warp / MT;
      float dqa[NC][4], dqs[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = dqs[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        const float* a = dst + (kk * 8 + 2 * t4) * DS_LD + mt * 16 + g;
        const x3::AFrag af = x3::split_a(a[0], a[8], a[DS_LD], a[DS_LD + 8]);
        const float* kb = ksm + (kk * 8 + 2 * t4) * LD + cr * NC * 8 + g;
#pragma unroll
        for (int n = 0; n < NC; ++n)
          x3::mma3_apart(dqa[n], dqs[n], af, kb[n * 8], kb[LD + n * 8]);
      }
      // the q tile's dQ, BQ x D in dq_acc's (B, H, T, D) order
      float* stg = xch + (mt * 16 + g) * D + cr * NC * 8 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        *reinterpret_cast<float2*>(stg + n * 8) =
            make_float2(dqa[n][0] + dqs[n][0], dqa[n][1] + dqs[n][1]);
        *reinterpret_cast<float2*>(stg + 8 * D + n * 8) =
            make_float2(dqa[n][2] + dqs[n][2], dqa[n][3] + dqs[n][3]);
      }
      fence_async_shared();
      __syncthreads();  // the staging tile is in
      if (tid == 0) {
        bulk_reduce_add_f32(dq_acc + ((size_t)bh * T + i0) * D, xch, BQ * D * sizeof(float));
        bulk_commit();
      }
    } else {
      __syncthreads();  // every read of this ring stage is done
    }
  }
  if constexpr (WITH_DQ) {
    if (tid == 0) bulk_wait<0>();
  }

  // dv, and dk rotated back by -angle in fp32: lanes c and c + D/2 are
  // blocks n and n + NDP / 2 of the same thread
  const size_t r0 = base + (size_t)(j0 + jr) * rs + 2 * t4;
#pragma unroll
  for (int n = 0; n < NDP; ++n) {
    float* p0 = dv + r0 + pcol(n);
    *reinterpret_cast<float2*>(p0) = make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(p0 + 8 * rs) = make_float2(dva[n][2], dva[n][3]);
  }
  if (cos_t != nullptr) {
#pragma unroll
    for (int n = 0; n < NDP / 2; ++n) {
      const int c = pcol(n) + 2 * t4;  // < D/2; its partner c + D/2 is block n + NDP / 2
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + jr + 8 * (e >> 1);
        const float cs = cos_t[(size_t)j * HALF + c + (e & 1)];
        const float sn = sin_t[(size_t)j * HALF + c + (e & 1)];
        lo[e] = rope_inv_lo(dka[n][e], dka[n + NDP / 2][e], cs, sn);
        hi[e] = rope_inv_hi(dka[n][e], dka[n + NDP / 2][e], cs, sn);
      }
      float* p0 = dk + r0 + pcol(n);
      *reinterpret_cast<float2*>(p0) = make_float2(lo[0], lo[1]);
      *reinterpret_cast<float2*>(p0 + 8 * rs) = make_float2(lo[2], lo[3]);
      *reinterpret_cast<float2*>(p0 + HALF) = make_float2(hi[0], hi[1]);
      *reinterpret_cast<float2*>(p0 + HALF + 8 * rs) = make_float2(hi[2], hi[3]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NDP; ++n) {
      float* p0 = dk + r0 + pcol(n);
      *reinterpret_cast<float2*>(p0) = make_float2(dka[n][0], dka[n][1]);
      *reinterpret_cast<float2*>(p0 + 8 * rs) = make_float2(dka[n][2], dka[n][3]);
    }
  }
}

// The fp32 kernel's launch: a block per (64-row kv tile, head, batch row),
// 128 threads at D = 64, else 256, its tiles in dynamic shared memory (the
// attribute set once a device).
template <int D, bool DROP, bool WITH_DQ>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                       const float* cos_t, const float* sin_t, const int* q_lo,
                       const int* q_hi, int* tile_count, float* dq_acc, float* dk, float* dv,
                       int B, int T, int H, float scale_log2, float scale, DropParams dp,
                       cudaStream_t st) {
  using G = F32Bwd<D>;
  constexpr size_t smem = G::template smem<WITH_DQ>();
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
  mh_bwd_f32<D, DROP, WITH_DQ><<<dim3(T / G::BKV, H, B), G::THREADS, smem, st>>>(
      q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, dk, dv,
      T, H, scale_log2, scale, dp);
  return cudaGetLastError();
}


}  // namespace
}  // namespace bwd
}  // namespace obt
