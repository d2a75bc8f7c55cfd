// Multi-head flash attention backward for Hopper (sm_90a): dq, dk and dv in
// one pass over the (q, kv) plane, with RoPE and dropout.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_fused_kernel (launched by _mh_bwd_fused, the single-kv fused
// backward that _mh_bwd takes at T <= 1024) and ::_mh_bwd_fusedmk_kernel
// (launched by _mh_bwd_fusedmk, the fused multi-kv backward of longer T with
// per-block segment bounds). One kernel serves both: it walks tiles at any
// T that is a multiple of 128 (bf16) or 64 (fp32). Same function, same
// rounding points:
//   * q and k rotated (rotate-half RoPE) in fp32 and rounded to the input
//     dtype before the products;
//   * s2 = (q.k^T) * (scale * log2 e) + bias in fp32, the finite mask bias
//     added after the multiply, and p = exp2(s2 - lse2) from the forward's
//     log2-space residual (a fully masked row comes out uniform, never NaN);
//   * dp = do.v^T in fp32; with dropout, p_drop and dp are both masked and
//     scaled by 1 / (1 - rate) with the forward's keep-mask (philox.cuh),
//     and ds = p * (dp - di) * scale is built from the undropped p;
//   * p_drop and ds are rounded to the input dtype as product operands,
//     every accumulator is fp32, and the inverse rotation is applied to the
//     fp32 dq and dk before the final cast.
// di = rowsum(o * do) comes from the caller, as in JAX.
//
// Bound. At the training shape (B=16, T=1024, H=8, D=128, bf16) the five
// products are 10*B*T^2*H*D = 171.8 GFLOP over all (q, k) pairs (0.174 ms at
// 989 TFLOP/s bf16), less in proportion to the visible tiles on packed rows;
// q, k, v, do, dq, dk, dv, lse2 and di are 235 MB (0.07 ms at 3.35 TB/s):
// bound by operations, so the design is about feeding the tensor cores.
//
// Design (bf16). The TPU kernel carries full-length dk/dv accumulators in
// VMEM over a sequential q grid; Hopper blocks run in no order. Here a CTA
// owns (batch, head, 128-row kv tile) and walks 64-row q tiles, with three
// warpgroups (see the kernel's own note): a producer that keeps a TMA ring
// of Q and dO tiles full, and two consumers of 64 kv rows each that hold
// their K and V rows in shared memory and their dk and dv in fp32 registers
// and run all five products as wgmma. They compute the transposed scores
// S^T = K.Q^T and dP^T = V.dO^T, so that P_drop^T and dS^T come out of the
// accumulators already in the register A-operand layout of dV += P_drop^T.dO
// and dK += dS^T.Q. dQ = dS.K needs a sum over every kv tile: the consumers
// write dS^T to shared memory, each forms a 64-column slice of the q tile's
// dQ, and one thread adds it into an fp32 dq scratch by a TMA bulk
// reduce-add (cp.reduce.async.bulk .add.f32) from a shared-memory staging
// tile, so no thread waits on L2 atomics. The order of those sums changes
// from run to run (dq is not bitwise deterministic; dk and dv are). The
// scratch is laid out as the consumers' accumulator fragments (dq_epilogue_
// bf16), so the staging writes are 16-byte stores without bank conflicts
// and the epilogue, which applies the inverse RoPE and casts, reads whole
// 16-byte vectors. q is rotated once ahead of the kernel (every kv tile
// reads all of it); k is rotated where a consumer loads its rows. The fp32
// kernel (mh_flash_bwd_kernels.cuh) is the parity type and runs on the CUDA
// cores, with q and k both rotated ahead.
//
// Segment skipping. The TPU kernel's grid is (q block, kv block) with the kv
// range per q block; this kernel's CTA owns a kv tile, so it takes the same
// tiles from the other side: the q-tile range per (batch, kv tile)
// (mh_flash_bwd_kernels.cuh). The TPU kernel's kv chunking (kv0, n_kv_tot)
// exists for its VMEM accumulators and has no counterpart here. dq_acc is
// zeroed before the kernel, so dq rows that some kv tile never visits still
// hold a defined sum.
#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "mh_flash_bwd_kernels.cuh"
#include "philox.cuh"

namespace {

using namespace obt;
using bwd::DropParams;

// ---------------------------------------------------------------------------
// bf16 (Hopper). A CTA owns 128 kv rows of one (batch, head) and three
// warpgroups: warpgroup 0 produces, 1 and 2 consume 64 kv rows each.
//   * The producer's first thread keeps a two-stage ring of 64-row Q and dO
//     tiles (TMA, 128-byte-swizzled 64-column panels) and the tile's lse2,
//     di and q segment ids (bulk copies) full, on full / empty mbarriers.
//   * A consumer writes its K rows, rotated in fp32 and rounded, and its V
//     rows into swizzled panels once, then per q tile: S^T = K_w.Q^T and
//     dP^T = V_w.dO^T by wgmma m64n64k16 from shared memory (both operands
//     K-major); p, dropout and ds on their registers; dV += P_drop^T.dO and
//     dK += dS^T.Q by wgmma m64nDk16 with A from registers and B (dO, Q)
//     through the transpose bit. The accumulator layout is the mma.sync C
//     layout: rows 16 w + g and + 8 of warp w, columns 8 n + 2 t, + 1.
//   * dS^T (128 kv x 64 q, bf16) goes to a double-buffered swizzled tile;
//     after a named barrier of both consumers, consumer w forms columns
//     64 w..64 w + 63 of the tile's dQ = dS.K by wgmma m64n64k16 with both
//     operands through the transpose bit (at D = 64, consumer 0 alone), and
//     hands it to the TMA unit through its staging tile.
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// a consumer thread holds dk and dv (D fp32) and one block of 64 for S^T
// and dP^T, whose first half takes the dQ slice once both are packed to
// bf16 (wgmma accumulators take contiguous registers: with separate
// arrays, ptxas spilled dk around every tile).
// ---------------------------------------------------------------------------
constexpr int kBkv = 128, kBq = 64, kStages = 2;
constexpr int kThreads = 384, kConsumerWarps = 8;
constexpr uint32_t kKPanel = kBkv * 128, kQPanel = kBq * 128;  // panel bytes
constexpr int kDqSlice = kBq * 64;  // floats of one consumer's dQ slice
// named barriers (0 is __syncthreads): 1 + w, consumer w's K and V rows are
// in; 3, both consumers' dS^T rows are in; 4 + w, consumer w's dQ staging
constexpr int kBarKV = 1, kBarDs = 3, kBarStage = 4;

template <int D>
struct BwdSmem {
  alignas(1024) __nv_bfloat16 k[kBkv * D];
  alignas(1024) __nv_bfloat16 v[kBkv * D];
  alignas(1024) __nv_bfloat16 q[kStages][kBq * D];
  alignas(1024) __nv_bfloat16 dout[kStages][kBq * D];
  alignas(1024) __nv_bfloat16 ds[2][kBkv * kBq];  // dS^T, one panel
  alignas(16) float dq[D / 64][kDqSlice];         // dQ staging a consumer
  alignas(16) float lse[kStages][kBq];
  alignas(16) float di[kStages][kBq];
  alignas(16) int qseg[kStages][kBq];
  uint64_t full[kStages], empty[kStages];
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(BwdSmem<D>) + kSwizzleAtom;  // + room to align the base
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
// dropout; lse_t, di_t and seg are not read.
template <int D, bool DROP, bool DOTS>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_fused_bf16(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ lse_t, const float* __restrict__ di_t,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
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
  extern __shared__ unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(
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
      const bool rows = !DOTS, ids = !DOTS && seg != nullptr;
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
        if (ids) bulk_load(sm.qseg[st], seg + (size_t)b * T + i0, kBq * sizeof(int), &sm.full[st]);
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

    const int ks0 = (!DOTS && seg != nullptr) ? seg[(size_t)b * T + j0] : 0;
    const int ks1 = (!DOTS && seg != nullptr) ? seg[(size_t)b * T + j0 + 8] : 0;
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
          const int2 q2 = seg != nullptr ? *reinterpret_cast<const int2*>(&sm.qseg[st][c])
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
      // dS^T into this iteration's buffer: fragment r of k-step kk is kv row
      // j (+ 8 for r odd), q columns 16 kk + 2 t4 (+ 8 for r >= 2)
      unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[it & 1]);
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
      named_bar_sync(kBarDs, 256);
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
      if (wg < NDQ) {
        float(&dqa)[32] = s;
        const uint32_t ds_addr = shared_addr(sm.ds[it & 1]);
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
        float4* stg = reinterpret_cast<float4*>(sm.dq[wg]);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          stg[n * 128 + wt] = make_float4(dqa[4 * n], dqa[4 * n + 1], dqa[4 * n + 2], dqa[4 * n + 3]);
        fence_async_shared();
        named_bar_sync(kBarStage + wg, 128);
        if (wt == 0) {
          // the chunk's offset formed here (hoisted, it would spill)
          bulk_reduce_add_f32(dq_acc + dq_chunk<D>(opaque(b), h, qt, T, H) + wg * kDqSlice,
                              sm.dq[wg], kDqSlice * sizeof(float));
          bulk_commit();
        }
      }
    }
    if (wg < NDQ && wt == 0) bulk_wait<0>();

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

// q already rotated (or not rotated at all); k rotated by the kernel.
template <int D, bool DROP, bool DOTS>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                        const float* lse_t, const float* di_t, const int* seg,
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
  e = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
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
    e = cudaFuncSetAttribute(mh_bwd_fused_bf16<D, DROP, DOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(dev_bit, std::memory_order_release);
  }
  mh_bwd_fused_bf16<D, DROP, DOTS><<<dim3(T / kBkv, H, B), kThreads, smem, st>>>(
      qmap, omap, k, v, lse_t, di_t, seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, dk,
      dv, T, H, scale_log2, scale, dp);
  const long long n_items = n / 8;
  dq_epilogue_bf16<D><<<(unsigned)((n_items + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(dq_acc), DOTS ? nullptr : cos_t, sin_t, dq, T, H,
      n_items);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* seg,
                   const float* cos_t, const float* sin_t, void* q_rot,
                   void* k_rot, const int* q_lo, const int* q_hi,
                   int* tile_count, float* dq_acc, void* dq, void* dk, void* dv,
                   int B, int T, int H, float scale_log2, float scale,
                   bool bf16, DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows<D>(q, cos_t, sin_t, q_rot, B, T, H, bf16, st);
    q = q_rot;
  }
  if (bf16)
    return launch_bf16<D, DROP, false>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, di,
        seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, scale_log2,
        scale, dp, st);
  if (cos_t != nullptr) {
    launch_rope_rows<D>(k, cos_t, sin_t, k_rot, B, T, H, false, st);
    k = k_rot;
  }
  const long long n_rows = (long long)B * T * H;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, (size_t)n_rows * D * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const long long n_pairs = n_rows * (D / 2);
  bwd::mh_bwd_f32<D, DROP, true><<<dim3(T / bwd::kF32Kv, H, B), 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc,
      static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale_log2,
      scale, dp);
  bwd::dq_epilogue<D, float><<<(unsigned)((n_pairs + 255) / 256), 256, 0, st>>>(
      dq_acc, cos_t, sin_t, static_cast<float*>(dq), T, H, n_pairs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* seg,
                     const float* cos_t, const float* sin_t, void* q_rot,
                     void* k_rot, const int* q_lo, const int* q_hi,
                     int* tile_count, float* dq_acc, void* dq, void* dk, void* dv,
                     int B, int T, int H, float scale_log2, float scale,
                     bool bf16, bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                k_rot, q_lo, q_hi, tile_count, dq_acc, dq, dk, dv,
                                B, T, H, scale_log2, scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                 k_rot, q_lo, q_hi, tile_count, dq_acc, dq, dk, dv,
                                 B, T, H, scale_log2, scale, bf16, dp, st);
}

// T multiple of each dtype's kernel: the bf16 CTA's 128 kv rows; the fp32
// kernel's 32-row kv tile, held to the dkv kernel's 64
constexpr int kBf16TMultiple = kBkv, kF32TMultiple = 64;

bool shape_ok(int B, int T, int H, int t_multiple) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= t_multiple &&
         T % t_multiple == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv (B, T, H, D)
// of that type, T a multiple of 64 (fp32) or 128 (bf16); lse2 and di fp32,
// (B, T, H) for fp32 and (B, H, T) for bf16 (its producer bulk-copies a q
// tile's 64 values of one head); seg (B, T) int32 or null. With RoPE (cos_t
// and sin_t non-null), q_rot is a scratch tensor of q's shape and type, and
// so is k_rot for fp32 (bf16 rotates k in the kernel; k_rot may be null).
// dq_acc is an fp32 scratch of q's size (zeroed here). q_lo and q_hi, both
// null or both int32 (B, T / kv tile) in units of the dtype's q tile (kv
// tile 128 and q tile 64 for bf16, 32 and 16 for fp32), bound the q tiles
// each kv tile walks; tile_count is null or one int32 that the walked tiles
// are added to. drop != 0 applies the forward's dropout (thresh,
// keep_scale, seed as in obt_mh_flash_fwd). Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a shape or type this file
// has no kernel for). Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int obt_mh_flash_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, const void* seg,
                                const void* cos_t, const void* sin_t,
                                void* q_rot, void* k_rot, const void* q_lo,
                                const void* q_hi, void* tile_count,
                                void* dq_acc,
                                void* dq, void* dk, void* dv, int B, int T,
                                int H, int D, float scale_log2, float scale,
                                int dtype, int drop, uint32_t thresh,
                                float keep_scale, uint64_t seed, void* stream) {
  if ((dtype != 0 && dtype != 1) ||
      !shape_ok(B, T, H, dtype == 1 ? kBf16TMultiple : kF32TMultiple) || dq_acc == nullptr ||
      (cos_t != nullptr &&
       (sin_t == nullptr || q_rot == nullptr || (dtype == 0 && k_rot == nullptr))) ||
      ((q_lo == nullptr) != (q_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* lo = static_cast<const int*>(q_lo);
  const int* hi = static_cast<const int*>(q_hi);
  int* tc = static_cast<int*>(tile_count);
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* sg = static_cast<const int*>(seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, lo, hi, tc, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, lo, hi, tc, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernel's products alone (its DOTS instance), bf16 (B, T, H, 128)
// q, k, v, dout -> dq, dk, dv, T a multiple of 128, dq_acc an fp32 scratch
// of q's size: with P = round(k.q^T) and dS = round(v.do^T) per head (kv
// rows by q rows, fp32 products rounded to bf16), dv = round(P.do), dk =
// round(dS.q), dq = round(dS^T.k), each summed in fp32 over 64-row q tiles
// (dv, dk) or 128-row kv tiles (dq). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int obt_mh_flash_bwd_dots(const void* q, const void* k, const void* v,
                                     const void* dout, void* dq_acc, void* dq, void* dk,
                                     void* dv, int B, int T, int H, int D, void* stream) {
  if (!shape_ok(B, T, H, kBf16TMultiple) || D != 128 || dq_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<128, false, true>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, 0.f, 0.f,
      DropParams{0, 0, 1.f}, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of the bf16 kernel takes at head dim D (-1
// for a head dim it is not built for).
extern "C" int obt_mh_flash_bwd_smem_bytes(int D) {
  return D == 64 ? (int)bf16_smem_bytes<64>() : D == 128 ? (int)bf16_smem_bytes<128>() : -1;
}

extern "C" const char* obt_cuda_error_string_bwd(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
