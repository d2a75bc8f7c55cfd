// Multi-head flash attention backward for Hopper (sm_90a), the dq half of
// the split pair: dq of one q tile, summed over the kv tiles.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_dq_kernel (launched by _mh_bwd when the fused backward is switched
// off or cannot run) and, through the same source, ::_bwd_dq_kernel (the
// per-head entry's, without RoPE or bounds). Same function, same rounding
// points:
//   * q and k rotated (rotate-half RoPE) in fp32 and rounded to the input
//     dtype before the products;
//   * s2 = (q.k^T) * (scale * log2 e) + bias in fp32 with the finite mask
//     bias, p = exp2(s2 - lse2) from the forward's log2-space residual;
//   * dp = do.v^T in fp32, masked and scaled by 1 / (1 - rate) with the
//     forward's keep-mask (philox.cuh); ds = p * (dp - di) * scale from the
//     undropped p, rounded to the input dtype as the operand of ds.k;
//   * dq accumulates in fp32 and is rotated back by -angle before the cast.
// di = rowsum(o * do) (B, T, H) fp32 comes from the caller (with any lse
// cotangent already subtracted).
//
// Design. The TPU kernel's grid is (batch, q block, kv block) with kv as
// the sequential axis and a dq accumulator in VMEM scratch. Here a CTA owns
// (batch, head, 128-row q tile) and walks 64-row kv tiles itself: the
// forward kernel's shape (mh_flash_fwd.cu), with a producer warpgroup that
// keeps a TMA ring of K and V tiles full and two consumer warpgroups of 64
// q rows each (see the kernel's own note). All three products are wgmma:
// S = Q.K^T and dP = dO.V^T from shared memory, dQ += dS.K with dS rounded
// in registers as the A operand and K read through the transpose bit, as
// #1's P.V reads V. Every dq row has one owner: no atomics, no scratch, and
// dq is the same bits from launch to launch, which the fused kernel's
// reduce-adds are not. k is rotated once per call into a scratch tensor by
// the small kernel of flash_common.cuh (every q tile reads all of it); q is
// rotated where a consumer loads its rows. With kv_lo / kv_hi the CTA walks
// only the kv tiles whose segment-id range meets its q tile's (the TPU
// kernel's use_bounds); a skipped tile would have added exact zeros, so dq
// is bit for bit that of the full walk.
//
// Bound. At B=8, T=2048, H=8, D=128 in bf16 the three products are
// 6*B*T^2*H*D = 206 GFLOP over all (q, k) pairs (0.208 ms at 989 TFLOP/s),
// less in proportion to the visible tiles on packed rows; q, k, v, do, dq,
// lse2 and di are 169 MB (0.05 ms at 3.35 TB/s): bound by operations. The
// fp32 kernel is the parity type and runs on the CUDA cores: the same
// products over all pairs are 3.08 ms at the FP32 FFMA rate (67 TFLOP/s),
// 338 MB of fp32 tensors 0.10 ms, so it too is bound by operations; its
// design (mh_bwd_dq_f32's note) reads each shared operand once for 4 to 16
// FFMA of register tiles.
//
// Head dim 256. The q and dO tiles alone are 128 KB there, so the ring has
// two stages of 32-row K and V tiles (64 KB), S and dP are m64n32k16
// products (16 fp32 a thread each) beside dq's 128, and dQ += dS.K is two
// m64n128k16 products on the halves of the accumulator. The q and dO
// descriptors are formed inside the walk (hoisted, their 32 loop-invariant
// descriptors spilled). The fp32 kernel walks 16-row kv tiles there (Q and
// dO alone are 128 KB).
//
// Head dims past 256 (D % 128 == 0). In bf16 at D = 384 and 512,
// mh_flash_bwd_pair.cuh::mh_bwd_dq_cta: a CTA owns a 64-row q tile with all
// D lanes and walks 32-row (16-row at 512) kv tiles from a TMA ring, its
// consumers forming the partial S and dP over halves of the head dim,
// adding each other's, and dQ on lanes of their own closed under
// rotate-half; each product done once, no atomics; see its note. In fp32,
// and in bf16 past 512,
// wide_attention.cuh::mh_bwd_dq_wide: a CTA a (64-row q tile, 128-lane
// slice of dq), S and dP summed over streamed 64-column panels and
// recomputed by every slice. The route is by head dim and dtype (dq_route).
#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "mh_flash_bwd_pair.cuh"
#include "philox.cuh"
#include "wide_attention.cuh"

namespace {

using namespace obt;

struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

// ---------------------------------------------------------------------------
// bf16 (Hopper). A CTA owns 128 q rows of one (batch, head) and three
// warpgroups: warpgroup 0 produces, 1 and 2 consume 64 q rows each.
//   * The producer's first thread loads the q tile's dO rows once (TMA,
//     128-byte-swizzled 64-column panels), then keeps a four-stage ring of
//     64-row K and V tiles and their kv segment ids (a bulk copy) full, on
//     full / empty mbarriers. The tensor maps are 3-D (batch, row, column):
//     rows past T arrive as zeros, never as the next batch row's.
//   * A consumer writes its q rows, rotated in fp32 and rounded, into
//     swizzled panels once, then per kv tile: S = Q_w.K^T and dP = dO_w.V^T
//     by wgmma m64n64k16 from shared memory (both operands K-major); p,
//     the keep-mask on dp and ds on their registers; ds rounded to bf16 as
//     the A fragments of dQ += dS.K (wgmma m64nDk16, K through the
//     transpose bit). The next tile's S and dP are issued before the wait
//     on this tile's dQ product, so the tensor cores hold both while the
//     ring's stage is released. Without dropout the two consumers take
//     turns on the tensor cores (#1's scheme). The accumulator layout is
//     the mma.sync C layout: rows 16 w + g and + 8 of warp w, columns
//     8 n + 2 t, + 1.
//   * After the last tile a consumer rotates its fp32 dq back, casts it
//     into its own q rows' panels (free by then) and hands them to the TMA
//     unit as 64-row boxes of the dq map.
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// a consumer thread holds dq (D / 2 fp32), S and dP (32 fp32 each) and dS's
// fragments (16); a 128-wide kv tile would double S and dP to 192 live
// accumulators at D = 128, past what keeps ptxas from spilling.
// ---------------------------------------------------------------------------
constexpr int kBq = 128;
constexpr int kThreads = 384, kConsumerWarps = 8;
constexpr uint32_t kQPanel = kBq * 128;  // panel bytes of the q tile
// The kv tile and the ring's depth at head dim D: 64 rows in four stages;
// at D = 256 the q and dO tiles alone are 128 KB, so 32 rows in two stages
// (64 KB), and S and dP 16 fp32 a thread each beside dq's 128.
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D == 256 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 256 ? 2 : 4;
}
// named barriers (0 is __syncthreads): 1 + w, consumer w's q rows are
// written; 3 + w, consumer w's dq rows are staged; 5 + w, consumer w's turn
// on the tensor cores
constexpr int kBarQ = 1, kBarOut = 3, kBarTurn = 5;

template <int D>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[kBq * D];  // the q tile, then its dq
  alignas(1024) __nv_bfloat16 dout[kBq * D];
  alignas(1024) __nv_bfloat16 k[stages<D>()][kv_tile<D>() * D];
  alignas(1024) __nv_bfloat16 v[stages<D>()][kv_tile<D>() * D];
  alignas(16) int kseg[stages<D>()][kv_tile<D>()];
  uint64_t full[stages<D>()], empty[stages<D>()], obar;
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(DqSmem<D>) + kSwizzleAtom;  // + room to align the base
}

// DOTS: the products alone (the yardstick of the product pipeline): dS :=
// round(S + dP), no RoPE, scale, mask, softmax or dropout; lse, di and seg
// are not read.
template <int D, bool DROP, bool DOTS>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap dqmap,
    const __nv_bfloat16* __restrict__ q, const float* __restrict__ lse,
    const float* __restrict__ di, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    int* __restrict__ tile_count, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int kBkv = kv_tile<D>(), kStages = stages<D>();
  constexpr uint32_t kKvPanel = kBkv * 128;  // panel bytes of a K or V tile
  constexpr int HALF = D / 2;
  constexpr int NK = D / 16;     // k-steps of S and dP over the head dim
  constexpr int NS = kBkv / 8;   // 8-column blocks of a score tile (kv columns)
  constexpr int NP = kBkv / 16;  // k-steps of dQ over the kv tile
  constexpr int NN = D / 8;      // 8-column blocks of dq
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, tid = threadIdx.x;
  // the kv tiles this CTA walks: all, or its (batch, q tile)'s range
  int jt0 = 0, jt1 = T / kBkv - 1;
  if (kv_lo != nullptr) {
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
    mbar_init(&sm.obar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread loads dO and keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.obar, kBq * D * sizeof(__nv_bfloat16));
#pragma unroll
      for (int pn = 0; pn < D / kPanelCols; ++pn)
#pragma unroll
        for (int half = 0; half < kBq / kBkv; ++half)
          tma_load_3d(&sm.dout[pn * kBq * kPanelCols + half * kBkv * kPanelCols], &omap,
                      h * D + pn * kPanelCols, qt * kBq + half * kBkv, b, &sm.obar);
      const bool ids = !DOTS && kv_seg != nullptr;
      const uint32_t bytes =
          2u * kBkv * D * sizeof(__nv_bfloat16) + (ids ? kBkv * sizeof(int) : 0u);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[st], ((it / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
        const int j0 = (jt0 + it) * kBkv;
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn) {
          tma_load_3d(&sm.k[st][pn * kBkv * kPanelCols], &kmap, h * D + pn * kPanelCols, j0, b,
                      &sm.full[st]);
          tma_load_3d(&sm.v[st][pn * kBkv * kPanelCols], &vmap, h * D + pn * kPanelCols, j0, b,
                      &sm.full[st]);
        }
        if (ids) bulk_load(sm.kseg[st], kv_seg + (size_t)b * T + j0, kBkv * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const int qrow0 = qt * kBq + wg * 64;  // this warpgroup's first q row
    const int r0 = qrow0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

    // q rows rotated in fp32, rounded, into the swizzled q panels
    rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.q), kBq, wg * 64,
                      q + (size_t)b * T * rs + (size_t)h * D + (size_t)qrow0 * rs, rs, 64,
                      DOTS ? nullptr : cos_t, sin_t, qrow0, wt, 128);
    fence_async_shared();
    named_bar_sync(kBarQ + wg, 128);

    int qs0 = 0, qs1 = 0;
    float lse0 = 0.f, lse1 = 0.f, di0 = 0.f, di1 = 0.f;
    if constexpr (!DOTS) {
      if (q_seg != nullptr) {
        qs0 = q_seg[(size_t)b * T + r0];
        qs1 = q_seg[(size_t)b * T + r0 + 8];
      }
      const size_t sr0 = ((size_t)b * T + r0) * H + h, sr1 = sr0 + (size_t)8 * H;
      lse0 = lse[sr0];
      lse1 = lse[sr1];
      di0 = di[sr0];
      di1 = di[sr1];
    }
    float acc[D / 2], s[kBkv / 2], dpv[kBkv / 2];
    uint32_t f[NP][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t q_addr_w = shared_addr(sm.q) + wg * 64 * 128;
    const uint32_t o_addr_w = shared_addr(sm.dout) + wg * 64 * 128;
    // S = Q_w.K^T and dP = dO_w.V^T of ring stage st (both operands K-major)
    auto gemm_sdp = [&](int st) {
      const uint32_t k_addr = shared_addr(sm.k[st]), v_addr = shared_addr(sm.v[st]);
      // at D = 256 the q and dO addresses are formed here: hoisted, their 32
      // loop-invariant descriptors would be held across the walk and spill
      const uint32_t q_addr = D == 256 ? opaque(q_addr_w) : q_addr_w;
      const uint32_t o_addr = D == 256 ? opaque(o_addr_w) : o_addr_w;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ao = (kk >> 2) * kQPanel + (kk & 3) * 32;
        const uint32_t bo = (kk >> 2) * kKvPanel + (kk & 3) * 32;
        if constexpr (kBkv == 64) {
          wgmma_ss_m64n64k16<0, 0>(s, smem_desc(q_addr + ao, 16, kSwizzleAtom),
                                   smem_desc(k_addr + bo, 16, kSwizzleAtom), kk > 0);
        } else {
          wgmma_ss_m64n32k16<0, 0>(s, smem_desc(q_addr + ao, 16, kSwizzleAtom),
                                   smem_desc(k_addr + bo, 16, kSwizzleAtom), kk > 0);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ao = (kk >> 2) * kQPanel + (kk & 3) * 32;
        const uint32_t bo = (kk >> 2) * kKvPanel + (kk & 3) * 32;
        if constexpr (kBkv == 64) {
          wgmma_ss_m64n64k16<0, 0>(dpv, smem_desc(o_addr + ao, 16, kSwizzleAtom),
                                   smem_desc(v_addr + bo, 16, kSwizzleAtom), kk > 0);
        } else {
          wgmma_ss_m64n32k16<0, 0>(dpv, smem_desc(o_addr + ao, 16, kSwizzleAtom),
                                   smem_desc(v_addr + bo, 16, kSwizzleAtom), kk > 0);
        }
      }
      wgmma_commit();
    };
    // acc += dS . K of ring stage st (K MN-major: 16 kv rows a k-step; at D
    // = 256 two 128-column products, the second from K's panels 2 and 3)
    auto gemm_dq = [&](int st) {
      const uint32_t k_addr = shared_addr(sm.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const uint64_t db = smem_desc(k_addr + kk * 16 * 128, kKvPanel, kSwizzleAtom);
        if constexpr (D == 256) {
          wgmma_rs_m64n128k16_tb(acc_half<0>(acc), f[kk], db, 1);
          wgmma_rs_m64n128k16_tb(
              acc_half<1>(acc), f[kk],
              smem_desc(k_addr + 2 * kKvPanel + kk * 16 * 128, kKvPanel, kSwizzleAtom), 1);
        } else if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb(acc, f[kk], db, 1);
        } else {
          wgmma_rs_m64n64k16_tb(acc, f[kk], db, 1);
        }
      }
      wgmma_commit();
    };
    // dS of kv tile jt (ring stage st) from S and dP, rounded into the A
    // fragments f. Element e of block n is (q row r0 + 8 (e >> 1), kv
    // column jt * kBkv + 8 n + 2 t4 + (e & 1)).
    auto ds_of = [&](int jt, int st) {
      if constexpr (DOTS) {
#pragma unroll
        for (int i = 0; i < kBkv / 2; ++i) s[i] += dpv[i];
      } else {
        uint32_t keep = ~0u;  // bit 4 n + e: element e of block n is kept
        if constexpr (DROP) {
          // One Philox call covers rows 2i, 2i + 1 of a column pair. Lanes
          // g and g ^ 1 hold rows r0 and r0 ^ 1 (and + 8): the even lane
          // draws the pair block of its rows r0, r0 + 1, the odd lane that
          // of r0 + 7, r0 + 8, and each hands the partner the words of the
          // partner's row (as the forward kernel draws them).
          const int bh = b * H + h;
          const bool odd = g & 1;
          const int row = odd ? r0 + 8 : r0;
          keep = 0;
#pragma unroll 4
          for (int n = 0; n < NS; ++n) {
            const Philox4 u = dropout_bits(dp.seed, bh, row, jt * kBkv + n * 8 + 2 * t4);
            const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[2], 4);
            const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[1] : u.w[3], 4);
            const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[1];  // row r0
            const uint32_t c0 = odd ? u.w[2] : y0, c1 = odd ? u.w[3] : y1;  // row r0 + 8
            const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                                (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
            keep |= k4 << (4 * n);
          }
        }
        const int* sg = sm.kseg[st];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int2 k2 = kv_seg != nullptr ? *reinterpret_cast<const int2*>(&sg[n * 8 + 2 * t4])
                                         : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ks = (e & 1) ? k2.y : k2.x, qs = (e >> 1) ? qs1 : qs0;
            const float lr = (e >> 1) ? lse1 : lse0, dr = (e >> 1) ? di1 : di0;
            const float p = exp2f(score(s[4 * n + e], scale_log2, qs, ks) - lr);
            float d = dpv[4 * n + e];
            if constexpr (DROP) d = (keep >> (4 * n + e)) & 1 ? d * dp.keep_scale : 0.f;
            s[4 * n + e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, dr)), scale);
          }
        }
      }
      // the A fragments of dS . K: k-step kk is score blocks 2 kk, 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    };

    // Turns without dropout: warpgroup w waits on barrier kBarTurn + w (its
    // 128 threads and the other's 128 arrivals) before it issues, and passes
    // the turn after, so one's products overlap the other's elementwise
    // pass. Each takes n_tiles + 1 turns; warpgroup 0 goes first and
    // warpgroup 1 passes no turn after its last. With dropout the Philox
    // draw makes the elementwise pass the longer one, and free-running
    // consumers measured faster (PERF.md §6).
    constexpr bool kTurns = !DROP;
    auto turn_wait = [&]() {
      if constexpr (kTurns) named_bar_sync(kBarTurn + wg, 256);
    };
    auto turn_pass = [&]() {
      if constexpr (kTurns) named_bar_arrive(kBarTurn + (wg ^ 1), 256);
    };
    if (wg == 1) turn_pass();
    mbar_wait(&sm.obar, 0);
    mbar_wait(&sm.full[0], 0);
    turn_wait();
    gemm_sdp(0);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dpv);
    ds_of(jt0, 0);
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(&sm.full[st], (it / kStages) & 1);
      turn_wait();
      gemm_dq(prev);
      gemm_sdp(st);
      turn_pass();
      wgmma_wait<1>();  // dS . K of the previous tile is done
      fence_regs(acc);
      fence_regs(f);
      release(prev);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dpv);
      ds_of(jt0 + it, st);
    }
    turn_wait();
    gemm_dq((n_tiles - 1) % kStages);
    if (wg == 0) turn_pass();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(f);

    // dq rotated back by -angle in fp32 (columns d and d + D/2 sit in
    // blocks n and n + NN/2 of the same thread), cast, into this consumer's
    // q rows of the panels
    unsigned char* stg = reinterpret_cast<unsigned char*>(sm.q);
    const int rl = wg * 64 + warp * 16 + g;  // tile row of r0
    if (!DOTS && cos_t != nullptr) {
#pragma unroll
      for (int n = 0; n < NN / 2; ++n) {
        const int col = n * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)row * HALF + col);
          const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)row * HALF + col);
          const float x1a = acc[4 * n + 2 * r], x1b = acc[4 * n + 2 * r + 1];
          const float x2a = acc[4 * (n + NN / 2) + 2 * r], x2b = acc[4 * (n + NN / 2) + 2 * r + 1];
          *reinterpret_cast<uint32_t*>(stg + swizzled_offset(kBq, rl + 8 * r, col)) =
              pack_bf16(rope_inv_lo(x1a, x2a, c.x, sn.x), rope_inv_lo(x1b, x2b, c.y, sn.y));
          *reinterpret_cast<uint32_t*>(stg + swizzled_offset(kBq, rl + 8 * r, col + HALF)) =
              pack_bf16(rope_inv_hi(x1a, x2a, c.x, sn.x), rope_inv_hi(x1b, x2b, c.y, sn.y));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(stg + swizzled_offset(kBq, rl, col)) =
            pack_bf16(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(stg + swizzled_offset(kBq, rl + 8, col)) =
            pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
    fence_async_shared();
    named_bar_sync(kBarOut + wg, 128);
    if (wt == 0) {
#pragma unroll
      for (int pn = 0; pn < D / kPanelCols; ++pn)
        tma_store_3d(&dqmap, stg + pn * kQPanel + wg * 64 * 128, h * D + pn * kPanelCols,
                     qrow0, b);
      bulk_commit();
      bulk_wait_read<0>();  // the panels stay until the TMA unit has read them
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, the parity type: FP32 FFMA on the CUDA cores (no TF32: its 10-bit
// mantissa would miss the fp32 tolerances). A CTA of 256 threads owns a
// (batch, head, 64-row q tile): Q (rotated) and dO stay resident in shared
// memory; K and V tiles of kF32Dq<D>::BKV rows (64, 16 at D = 256) arrive
// by cp.async into a two-stage ring, the next tile's copies in flight while
// the CTA works on this one. Per kv tile, two register-tiled SIMT passes:
//   * S and dP: thread (rg, cg) owns NRP pairs of q rows {2 rg, 2 rg + 1}
//     and NCP pairs of kv columns {2 cg, 2 cg + 1} (4 x 4 elements at BKV =
//     64, 2 x 2 at 16) of both products; each 16-byte shared read of a q,
//     dO, k or v row feeds 4 FFMA to every element of that row or column
//     the thread holds; a row pair by a column pair is one Philox call of
//     the keep-mask (philox.cuh); p, ds as the plain version rounds them;
//     ds goes to shared memory, transposed (dS^T, kv-major);
//   * dQ += dS.K: thread (rg, cg) owns RQ = D / 32 consecutive q rows by 4
//     lanes d and their rotate-half partners d + D/2 (D / 4 fp32 sums), so
//     the inverse RoPE is formed in registers and dq is written once, with
//     no atomics: two launches give the same bits.
// Every sum runs in ascending d or kv order, one FFMA a term, as a plain
// fp32 matrix product sums. Shared rows are padded by 4 floats, and K / V
// rows are kept even rows first (smem row (j & 1) * BKV/2 + j/2), so a
// warp's 8 column pairs read 8 consecutive padded rows: no bank conflicts
// in either pass.
// ---------------------------------------------------------------------------
constexpr int kF32Bq = 64, kF32Threads = 256;

template <int D>
struct kF32Dq {
  static constexpr int BKV = D == 256 ? 16 : 64;      // kv tile rows
  static constexpr int LD = D + 4;                    // padded row stride (floats)
  static constexpr int DS_LD = kF32Bq + 4;            // dS^T row stride (floats)
  static constexpr int NRP = BKV >= 32 ? 2 : 1;       // q-row pairs a thread (S, dP)
  static constexpr int NCP = BKV / 16 / NRP;          // kv-column pairs a thread
  static constexpr int ROW_STEP = kF32Bq / NRP;       // between a thread's row pairs
  static constexpr int COL_STEP = BKV / NCP;          // between its column pairs
  static constexpr int N_CG = BKV / (2 * NCP);        // column-pair groups
  static constexpr int RQ = D / 32;                   // dQ rows a thread
  static constexpr int N_CGQ = D / 8;                 // dQ 4-lane groups of the low half
  static_assert((kF32Bq / 2 / NRP) * N_CG == kF32Threads, "S tiling");
  static_assert((kF32Bq / RQ) * N_CGQ == kF32Threads, "dQ tiling");
  static_assert(N_CG % 8 == 0 && N_CGQ % 8 == 0, "8 column lanes a warp");
  // floats: Q, dO (64 rows each), K and V (two stages each), dS^T; then the
  // kv tiles' segment ids (two stages, int)
  static constexpr size_t FLOATS = (size_t)(2 * kF32Bq + 4 * BKV) * LD + BKV * DS_LD;
  static constexpr size_t SMEM = FLOATS * 4 + 2 * BKV * 4;
  // the shared row of kv row j of a tile: even rows first
  __host__ __device__ static constexpr int kv_row(int j) { return (j & 1) * (BKV / 2) + (j >> 1); }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kF32Threads, 1) mh_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, int* __restrict__ tile_count,
    float* __restrict__ dq, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  using G = kF32Dq<D>;
  constexpr int BKV = G::BKV, LD = G::LD, HALF = D / 2, NR = 2 * G::NRP, NC = 2 * G::NCP;
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;
  float* os = qs + kF32Bq * LD;
  float* ks = os + kF32Bq * LD;
  float* vs = ks + 2 * BKV * LD;
  float* ds_t = vs + 2 * BKV * LD;
  int* ksegs = reinterpret_cast<int*>(f32_smem + G::FLOATS);

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kF32Bq;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const bool seg = q_seg != nullptr;

  int jt0 = 0, jt1 = T / BKV - 1;
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / kF32Bq) + blockIdx.x];
    jt1 = kv_hi[b * (T / kF32Bq) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, jt1 - jt0 + 1);

  // K and V rows of kv tile jt (and its segment ids) into ring stage `stage`
  auto load_kv = [&](int stage, int jt) {
    const int j0 = jt * BKV;
    float* kd = ks + stage * BKV * LD;
    float* vd = vs + stage * BKV * LD;
    for (int it = tid; it < BKV * (D / 4); it += kF32Threads) {
      const int r = it / (D / 4), c = (it % (D / 4)) * 4;
      const size_t off = base + (size_t)(j0 + r) * rs + c;
      cp_async16(kd + G::kv_row(r) * LD + c, k + off);
      cp_async16(vd + G::kv_row(r) * LD + c, v + off);
    }
    if (seg && tid < BKV / 4)
      cp_async16(ksegs + stage * BKV + 4 * tid, kv_seg + (size_t)b * T + j0 + 4 * tid);
  };

  if (jt0 <= jt1) load_kv(0, jt0);
  for (int it = tid; it < kF32Bq * (D / 4); it += kF32Threads) {
    const int r = it / (D / 4), c = (it % (D / 4)) * 4;
    cp_async16(os + r * LD + c, dout + base + (size_t)(q0 + r) * rs + c);
  }
  cp_async_commit();
  rows_rotated_f32<D>(qs, LD, q + base + (size_t)q0 * rs, rs, kF32Bq, cos_t, sin_t, q0, tid,
                      kF32Threads);

  // S / dP ownership: 8 column-pair lanes by 4 row-pair lanes a warp
  const int s_wc = warp % (G::N_CG / 8), s_wr = warp / (G::N_CG / 8);
  const int cg = 8 * s_wc + (lane & 7), rg = 4 * s_wr + (lane >> 3);
  int srow[NR];
  float lse_r[NR], di_r[NR];
  int qs_r[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    srow[r] = 2 * rg + (r & 1) + G::ROW_STEP * (r >> 1);
    const size_t row = (size_t)b * T + q0 + srow[r];
    lse_r[r] = lse[row * H + h];
    di_r[r] = di[row * H + h];
    qs_r[r] = seg ? q_seg[row] : 0;
  }
  int scol[NC], skrow[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    scol[c] = 2 * cg + (c & 1) + G::COL_STEP * (c >> 1);
    skrow[c] = G::kv_row(scol[c]);
  }
  // dQ ownership: 8 lane groups by 4 row groups a warp
  const int q_wc = warp % (G::N_CGQ / 8), q_wr = warp / (G::N_CGQ / 8);
  const int cgq = 8 * q_wc + (lane & 7), rgq = 4 * q_wr + (lane >> 3);
  float acc[G::RQ][8];
#pragma unroll
  for (int r = 0; r < G::RQ; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  const uint32_t bh = (uint32_t)(b * H + h);
  int stage = 0;
  for (int jt = jt0; jt <= jt1; ++jt, stage ^= 1) {
    if (jt < jt1) load_kv(stage ^ 1, jt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + stage * BKV * LD;
    const float* vt = vs + stage * BKV * LD;

    // S = Q.K^T and dP = dO.V^T on this thread's NR x NC elements
    float s[NR][NC], dpv[NR][NC];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] = dpv[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[NR], ka[NC];
#pragma unroll
      for (int r = 0; r < NR; ++r) qa[r] = lds4(qs + srow[r] * LD + d);
#pragma unroll
      for (int c = 0; c < NC; ++c) ka[c] = lds4(kt + skrow[c] * LD + d);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) fma4(s[r][c], qa[r], ka[c]);
#pragma unroll
      for (int r = 0; r < NR; ++r) qa[r] = lds4(os + srow[r] * LD + d);
#pragma unroll
      for (int c = 0; c < NC; ++c) ka[c] = lds4(vt + skrow[c] * LD + d);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) fma4(dpv[r][c], qa[r], ka[c]);
    }
    // p = exp2(s2 - lse2), the keep-mask on dP, ds = p (dP - di) scale;
    // dS^T[j][i] as pairs of q rows
    const int j0 = jt * BKV;
#pragma unroll
    for (int rp = 0; rp < G::NRP; ++rp) {
#pragma unroll
      for (int cp = 0; cp < G::NCP; ++cp) {
        Philox4 u;
        if constexpr (DROP)
          u = dropout_bits(dp.seed, bh, q0 + srow[2 * rp], j0 + scol[2 * cp]);
#pragma unroll
        for (int c = 2 * cp; c < 2 * cp + 2; ++c) {
          const int kseg_c = seg ? ksegs[stage * BKV + scol[c]] : 0;
          float ds2[2];
#pragma unroll
          for (int r = 2 * rp; r < 2 * rp + 2; ++r) {
            const float p = exp2f(score(s[r][c], scale_log2, qs_r[r], kseg_c) - lse_r[r]);
            float dpp = dpv[r][c];
            if constexpr (DROP) {
              const uint32_t bits = u.w[2 * (r & 1) + (c & 1)];
              dpp = bits >= dp.thresh ? dpp * dp.keep_scale : 0.f;
            }
            ds2[r & 1] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpp, di_r[r])), scale);
          }
          *reinterpret_cast<float2*>(ds_t + scol[c] * G::DS_LD + srow[2 * rp]) =
              make_float2(ds2[0], ds2[1]);
        }
      }
    }
    __syncthreads();

    // dQ += dS.K on this thread's RQ rows x (4 lanes d, their d + D/2)
#pragma unroll 8
    for (int j = 0; j < BKV; ++j) {
      float dsv[G::RQ];
      const float* dsr = ds_t + j * G::DS_LD + G::RQ * rgq;
      if constexpr (G::RQ == 2) {
        const float2 x = *reinterpret_cast<const float2*>(dsr);
        dsv[0] = x.x;
        dsv[1] = x.y;
      } else {
#pragma unroll
        for (int r4 = 0; r4 < G::RQ; r4 += 4) {
          const float4 x = lds4(dsr + r4);
          dsv[r4] = x.x;
          dsv[r4 + 1] = x.y;
          dsv[r4 + 2] = x.z;
          dsv[r4 + 3] = x.w;
        }
      }
      const float* kr = kt + G::kv_row(j) * LD + 4 * cgq;
      const float4 klo = lds4(kr), khi = lds4(kr + HALF);
#pragma unroll
      for (int r = 0; r < G::RQ; ++r) {
        acc[r][0] = fmaf(dsv[r], klo.x, acc[r][0]);
        acc[r][1] = fmaf(dsv[r], klo.y, acc[r][1]);
        acc[r][2] = fmaf(dsv[r], klo.z, acc[r][2]);
        acc[r][3] = fmaf(dsv[r], klo.w, acc[r][3]);
        acc[r][4] = fmaf(dsv[r], khi.x, acc[r][4]);
        acc[r][5] = fmaf(dsv[r], khi.y, acc[r][5]);
        acc[r][6] = fmaf(dsv[r], khi.z, acc[r][6]);
        acc[r][7] = fmaf(dsv[r], khi.w, acc[r][7]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // dq rotated back by -angle in fp32, one write of each element
#pragma unroll
  for (int r = 0; r < G::RQ; ++r) {
    const int t = q0 + G::RQ * rgq + r;
    float* out = dq + base + (size_t)t * rs + 4 * cgq;
    float lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = acc[r][e];
      hi[e] = acc[r][4 + e];
    }
    if (cos_t != nullptr) {
      const float4 cs = *reinterpret_cast<const float4*>(cos_t + (size_t)t * HALF + 4 * cgq);
      const float4 sn = *reinterpret_cast<const float4*>(sin_t + (size_t)t * HALF + 4 * cgq);
      const float c4[4] = {cs.x, cs.y, cs.z, cs.w}, s4[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = rope_inv_lo(acc[r][e], acc[r][4 + e], c4[e], s4[e]);
        hi[e] = rope_inv_hi(acc[r][e], acc[r][4 + e], c4[e], s4[e]);
      }
    }
    *reinterpret_cast<float4*>(out) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<float4*>(out + HALF) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
}

template <int D, bool DROP>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                       const float* cos_t, const float* sin_t, const int* kv_lo,
                       const int* kv_hi, int* tile_count, float* dq, int B, int T, int H,
                       float scale_log2, float scale, DropParams dp, cudaStream_t st) {
  // the shared-memory limit belongs to the instance on a device: set it at
  // the first launch on each device
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = kF32Dq<D>::SMEM;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t dev_bit = 1ull << (dev & 63);
  if (!(smem_set.load(std::memory_order_acquire) & dev_bit)) {
    e = cudaFuncSetAttribute(mh_bwd_dq_f32<D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(dev_bit, std::memory_order_release);
  }
  mh_bwd_dq_f32<D, DROP><<<dim3(T / kF32Bq, H, B), kF32Threads, smem, st>>>(
      q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, dq, T, H,
      scale_log2, scale, dp);
  return cudaGetLastError();
}

// k already rotated (or not rotated at all); q rotated by the kernel. q, k,
// v, dout and dq as (B, T, H * D) row-major matrices, read and written as
// 64-row boxes of one head's 64-column panels.
template <int D, bool DROP, bool DOTS>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                        const float* di, const int* q_seg, const int* kv_seg, const float* cos_t,
                        const float* sin_t, const int* kv_lo, const int* kv_hi,
                        int* tile_count, __nv_bfloat16* dq, int B, int T, int H,
                        float scale_log2, float scale, DropParams dp, cudaStream_t st) {
  // K, V and dO in kv-tile boxes; dq in a consumer's 64-row boxes
  CUtensorMap kmap, vmap, omap, dqmap;
  const uint64_t cols = (uint64_t)H * D, slab = (uint64_t)T * cols;
  constexpr int kBkv = kv_tile<D>();
  cudaError_t e = encode_bf16_panels_3d(&kmap, k, B, T, cols, cols, slab, kBkv);
  if (e == cudaSuccess) e = encode_bf16_panels_3d(&vmap, v, B, T, cols, cols, slab, kBkv);
  if (e == cudaSuccess) e = encode_bf16_panels_3d(&omap, dout, B, T, cols, cols, slab, kBkv);
  if (e == cudaSuccess) e = encode_bf16_panels_3d(&dqmap, dq, B, T, cols, cols, slab, 64);
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
    e = cudaFuncSetAttribute(mh_bwd_dq_wgmma<D, DROP, DOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(dev_bit, std::memory_order_release);
  }
  mh_bwd_dq_wgmma<D, DROP, DOTS><<<dim3(T / kBq, H, B), kThreads, smem, st>>>(
      kmap, vmap, omap, dqmap, q, lse, di, q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, T, H,
      scale_log2, scale, dp);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                   const float* cos_t, const float* sin_t, void* k_rot,
                   const int* kv_lo, const int* kv_hi, int* tile_count, void* dq,
                   int B, int T, int H, float scale_log2, float scale, bool bf16,
                   DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, bf16, st);
    k = k_rot;
  }
  if (bf16)
    return launch_bf16<D, DROP, false>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, di,
        q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, static_cast<__nv_bfloat16*>(dq), B, T, H,
        scale_log2, scale, dp, st);
  return launch_f32<D, DROP>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, static_cast<float*>(dq), B, T,
      H, scale_log2, scale, dp, st);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* k_rot,
                     const int* kv_lo, const int* kv_hi, int* tile_count,
                     void* dq, int B, int T, int H, float scale_log2, float scale,
                     bool bf16, bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, k_rot,
                                kv_lo, kv_hi, tile_count, dq, B, T, H, scale_log2,
                                scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, k_rot,
                                 kv_lo, kv_hi, tile_count, dq, B, T, H, scale_log2,
                                 scale, bf16, dp, st);
}

// T multiple of each dtype's kernel: the bf16 CTA's 128 q rows; the fp32
// CTA's 64
constexpr int kBf16TMultiple = kBq, kF32TMultiple = kF32Bq;

bool shape_ok(int B, int T, int H, int t_multiple) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= t_multiple &&
         T % t_multiple == 0;
}

// The kernel obt_mh_flash_bwd_dq launches at head dim D and dtype (0
// float32, 1 bfloat16), by name.
const char* dq_route(int D, int dtype) {
  if (dtype == 1 && (D == 64 || D == 128 || D == 256)) return "mh_bwd_dq_wgmma";
  if (dtype == 1 && obt::bwd::pair_head_dim(D)) return "mh_bwd_dq_cta";
  if (dtype == 0 && (D == 64 || D == 128 || D == 256)) return "mh_bwd_dq_f32";
  if ((dtype == 0 || dtype == 1) && obt::wide::head_dim_ok(D)) return "mh_bwd_dq_wide";
  return "none";
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dq (B, T, H, D) of that
// type, T a multiple of 64 (fp32) or 128 (bf16); lse2 and di (B, T, H)
// fp32; q_seg and kv_seg (B, T) int32, both null or both given (as in
// obt_mh_flash_fwd); D 64, 128, 256 or a multiple of 128 past 256; with
// RoPE (cos_t and sin_t non-null), k_rot is a scratch tensor of k's shape
// and type, and so is q_rot past 256 but for bf16 at 384 and 512 (where
// the kernel rotates q itself; else it may be null). kv_lo and
// kv_hi, both null or both int32 (B, T / q tile) in units of the dtype's kv
// tile (q tile 128 and kv tile 64 (32 at D = 256) for bf16, 64 and 64 (16
// at D = 256) for fp32, 64 and 64 past 256), bound the kv tiles
// each q tile walks; tile_count is null or one int32 that the walked tiles
// are added to. drop != 0 applies the forward's dropout (thresh,
// keep_scale, seed as in obt_mh_flash_fwd). Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a shape or type this file
// has no kernel for). Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int obt_mh_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* di, const void* q_seg, const void* kv_seg,
                                   const void* cos_t, const void* sin_t,
                                   void* q_rot, void* k_rot, const void* kv_lo,
                                   const void* kv_hi, void* tile_count,
                                   void* dq, int B, int T, int H, int D,
                                   float scale_log2, float scale, int dtype,
                                   int drop, uint32_t thresh, float keep_scale,
                                   uint64_t seed, void* stream) {
  if ((dtype != 0 && dtype != 1) ||
      !shape_ok(B, T, H, dtype == 1 ? kBf16TMultiple : kF32TMultiple) ||
      (cos_t != nullptr && (sin_t == nullptr || k_rot == nullptr)) ||
      ((kv_lo == nullptr) != (kv_hi == nullptr)) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* qsg = static_cast<const int*>(q_seg);
  const int* kvsg = static_cast<const int*>(kv_seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* lo = static_cast<const int*>(kv_lo);
  const int* hi = static_cast<const int*>(kv_hi);
  int* tc = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, qsg, kvsg, c, s, k_rot, lo, hi, tc, dq, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, qsg, kvsg, c, s, k_rot, lo, hi, tc, dq, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 256: return (int)launch_d<256>(q, k, v, dout, l, dd, qsg, kvsg, c, s, k_rot, lo, hi, tc, dq, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default:
      if (!obt::wide::head_dim_ok(D)) return (int)cudaErrorInvalidValue;
      if (dtype == 1 && obt::bwd::pair_head_dim(D))
        return (int)obt::bwd::dq_cta_d(q, k, v, dout, l, dd, qsg, kvsg, c, s, k_rot, lo, hi, tc,
                                       dq, B, T, H, D, scale_log2, scale, drop != 0,
                                       obt::bwd::DropParams{seed, thresh, keep_scale}, st);
      return (int)obt::wide::dq_only(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc,
                                dq, B, T, H, D, scale_log2, scale, dtype == 1, drop != 0,
                                obt::wide::Drop{seed, thresh, keep_scale}, st);
  }
}

// The bf16 kernel's products alone (its DOTS instance), bf16 (B, T, H, 128)
// q, k, v, dout -> dq, T a multiple of 128: with dS = round(q.k^T +
// do.v^T) per head (fp32 products and sum, rounded to bf16), dq =
// round(dS.k), summed in fp32 over 64-row kv tiles. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int obt_mh_flash_bwd_dq_dots(const void* q, const void* k, const void* v,
                                        const void* dout, void* dq, int B, int T, int H,
                                        int D, void* stream) {
  if (!shape_ok(B, T, H, kBf16TMultiple) || D != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<128, false, true>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(dq), B, T, H, 0.f, 0.f, DropParams{0, 0, 1.f},
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of the bf16 kernel takes at head dim D (-1
// for a head dim it is not built for).
extern "C" int obt_mh_flash_bwd_dq_smem_bytes(int D) {
  return D == 64    ? (int)bf16_smem_bytes<64>()
         : D == 128 ? (int)bf16_smem_bytes<128>()
         : D == 256 ? (int)bf16_smem_bytes<256>()
         : D == 384 ? (int)obt::bwd::dq_cta_smem_bytes<384>()
         : D == 512 ? (int)obt::bwd::dq_cta_smem_bytes<512>()
         : obt::wide::head_dim_ok(D) ? obt::wide::dq_smem_bytes()
                    : -1;
}

// The name of the kernel obt_mh_flash_bwd_dq launches at head dim D and
// dtype (0 = float32, 1 = bfloat16): "mh_bwd_dq_wgmma", "mh_bwd_dq_cta",
// "mh_bwd_dq_f32", "mh_bwd_dq_wide", or "none".
extern "C" const char* obt_mh_flash_bwd_dq_route(int D, int dtype) { return dq_route(D, dtype); }

extern "C" const char* obt_cuda_error_string_bwd_dq(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
