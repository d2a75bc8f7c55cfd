// The multi-head flash attention backward kernels at head dims 384 and 512
// in bf16 (sm_90a), shared by the three backward libraries:
//   * mh_bwd_pair<D, DROP, WITH_DQ>: a thread-block cluster owns a 64-row kv
//     tile and walks q tiles, each CTA a part of the head dim closed under
//     rotate-half, the parts' partial S^T and dP^T summed in rank order
//     through distributed shared memory. With WITH_DQ it is the fused
//     backward (mh_flash_bwd.cu: dq, dk and dv in one pass); without, the
//     split pair's dk/dv half (mh_flash_bwd_dkv.cu).
//   * mh_bwd_dq_cta<D, DROP>: one CTA owns a 64-row q tile with all D lanes
//     and walks kv tiles, its two consumers splitting the score products'
//     reduction and dQ's lanes: the split pair's dq half
//     (mh_flash_bwd_dq.cu).
// See the source files for the TPU kernels they replace and the rounding
// points, which are the D <= 256 kernels'. In fp32, and in bf16 past 512,
// the libraries keep wide_attention.cuh's slice kernels (routed by head dim
// and dtype in each C entry).
#pragma once
#include <atomic>
#include <type_traits>

#include "mh_flash_bwd_kernels.cuh"
#include "wide_attention.cuh"

// The kernels live beside the kernels they share their types with (their
// namespace), so that nvcc's launch stubs name one unnamed namespace.
namespace obt {
namespace bwd {
namespace {

// ---------------------------------------------------------------------------
// mh_bwd_pair. It replaces at D = 384 and 512 the fused TPU kernels
// (omnibiote_tpu/ops/flash_attention.py:965 _mh_bwd_fused_kernel, :1128
// _mh_bwd_fusedmk_kernel) and, without its dQ, the dkv kernels (:773
// _mh_bwd_dkv_kernel, :240 _bwd_dkv_kernel).
//
// Why not one CTA. dK and dV of 64 kv rows at D = 512 are 2 x 64 x 512 fp32,
// the whole register file of an SM, and one 64-row Q and dO tile is 128 KB.
// So a thread-block cluster of NC CTAs owns one (batch, head, 64-row kv
// tile), each CTA a part of W lanes of the head dim closed under
// rotate-half: part c holds lanes [WQ c, WQ c + WQ) and D/2 + the same
// (WQ = W / 2), so the inverse RoPE of dK and dQ stays inside the CTA.
//   * D = 512: NC = 2, W = 256, a pair; each CTA is the D = 256 kernel
//     (mh_flash_bwd_kernels.cuh::mh_bwd_d256_bf16) on its part.
//   * D = 384: NC = 3, W = 128 (wide_attention.cuh's slices). Halves of 192
//     lanes would be 96 + 96, which does not sit on the 64-column
//     128-byte-swizzled panels that the TMA boxes and wgmma descriptors
//     take; 32-column panels would need a second swizzle mode for every
//     operand, while the sum in rank order below takes any NC.
// A CTA has 384 threads: a producer warpgroup and two consumers (setmaxnreg
// 24 / 240).
//   * The producer's first thread keeps a ring of three 64-row slots full by
//     TMA: the part's Q tile (with the tile's lse2, di and q ids, bulk
//     copies), then its dO tile, alternately. The next tile's Q arrives
//     during a tile; its dO in the slot the tile frees after dV and dK.
//   * The consumers write the part's K rows (rotated in fp32, rounded) and V
//     rows into swizzled panels once.
//   * Per q tile, consumer 0 forms the partial S^T_c = K_c.Q_c^T and
//     consumer 1 the partial dP^T_c = V_c.dO_c^T, and S^T_c again, over the
//     part's lanes (wgmma m64n64k16 from shared memory). Consumer 0 writes
//     its S^T_c, consumer 1 its dP^T_c (fp32, in fragment order) to the
//     CTA's exchange buffers and arrive on the peers' mbarriers; then each
//     reads the peers' partials it needs through distributed shared memory
//     (mapa: plain loads, which the compiler schedules within the register
//     budget) and sums every part's in rank order: every CTA has the same
//     bits of S^T and dP^T, so the same p, keep bits (keyed on (seed, b, h,
//     i, j)) and dS. A reader arrives on the owner's "empty" mbarrier, and
//     an owner overwrites its partial only after every reader has arrived:
//     mbarriers, no cluster barrier a tile.
//   * Consumer 0: p, dropout, dV_c += P_drop^T.dO_c; consumer 1: dS^T from
//     the undropped p, dK_c += dS^T.Q_c (A from registers, B through the
//     transpose bit).
//   * WITH_DQ: consumer 1 also writes dS^T to a double-buffered tile; then
//     consumer w forms the part's w-th half of the q tile's dQ = dS.K_c and
//     adds it into the fp32 scratch by 16-byte atomics (dq_chunk's layout;
//     dq_epilogue_bf16 applies the inverse RoPE and casts). Without it there
//     is no dS^T tile, no barrier between the consumers, no dq scratch and
//     no epilogue: the split pair's dkv kernel.
// So S^T is formed twice a CTA, as in the D = 256 kernel, and every other
// product once: 6 / 5 = 1.2 x the function's products with dQ, 5 / 4 =
// 1.25 x without (the slice kernels 2.2 x and 2.5 x at D = 512). Consumer 1
// reading its own CTA's S^T partial instead of forming it had 24 loads of
// 16 bytes in flight a thread and spilled.
// The CTAs of a cluster walk the same q tiles: the skip bounds are per
// (batch, kv tile); rank 0 adds to tile_count. No CTA exits while a peer may
// still read its shared memory or arrive on its barriers: both warp roles
// end at a cluster barrier, on an empty walk too. The registers (240 a
// consumer thread) are spent to the last: what the loop does not need at
// every step (the walk, the kv ids, the part, the batch row and head, the
// ring slots) is read where used.
// Shared memory at D = 512: K and V 64 KB, three 32 KB slots, 32 KB of
// exchange, 16 KB of dS^T with dQ (pair_smem_bytes, with room to align the
// base: 216,064 B a CTA with dQ, 199,680 B without); at D = 384 134,144 B
// and 117,760 B.
// Bound: the function's 10 flops (8 without dQ) a visible (q, k) pair,
// head and head dim, as at every D; at the training shape (B 16, T 1024,
// 2 heads of 512, 3 EOS a row) 0.0724 ms at the bf16 peak with dQ, bound
// by operations.
// ---------------------------------------------------------------------------
constexpr bool pair_head_dim(int D) { return D == 384 || D == 512; }

// head-dim lanes a CTA of the cluster owns at D (D / pair_width CTAs)
template <int D>
__host__ __device__ constexpr int pair_width() {
  return D == 512 ? 256 : 128;
}

constexpr int kPairBkv = 64, kPairSlots = 3;

// what only the dQ sums need: the dS^T tiles
struct PairDsTiles {
  alignas(1024) __nv_bfloat16 ds[2][kPairBkv * kBq];  // dS^T, one panel
};
struct NoPairDs {};

template <int W, bool WITH_DQ>
struct PairSmem {
  alignas(1024) __nv_bfloat16 k[kPairBkv * W];
  alignas(1024) __nv_bfloat16 v[kPairBkv * W];
  alignas(1024) __nv_bfloat16 slot[kPairSlots][kBq * W];  // Q_t, dO_t, Q_t+1, ...
  typename std::conditional<WITH_DQ, PairDsTiles, NoPairDs>::type x;
  float4 xs[8][128];   // consumer 0's partial S^T: thread t's elements 4j.. at [j][t]
  float4 xdp[8][128];  // consumer 1's partial dP^T
  alignas(16) float lse[2][kBq];
  alignas(16) float di[2][kBq];
  alignas(16) int qseg[2][kBq];
  int kseg[kPairBkv];  // the kv tile's segment ids
  int walk[2];         // the cluster's first q tile and the number it walks
  uint64_t full[kPairSlots], empty[kPairSlots];
  uint64_t xfull_s, xfull_dp, xempty;
};

template <int D, bool WITH_DQ>
constexpr size_t pair_smem_bytes() {
  return sizeof(PairSmem<pair_width<D>(), WITH_DQ>) + kSwizzleAtom;  // + room to align the base
}
static_assert(pair_smem_bytes<512, true>() <= 232448, "a CTA takes at most 227 KB");

// head-dim column of lane l of part c (halves of WQ lanes)
template <int D, int WQ>
__device__ __forceinline__ int part_col(int c, int l) {
  return l < WQ ? WQ * c + l : D / 2 + WQ * c + (l - WQ);
}

// the CTA's batch row and head, read where used (held in registers across
// the consumers' loop, they spilled)
__device__ __forceinline__ int cta_b() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cta_h() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(r));
  return (int)r;
}

// an int in this CTA's shared memory, read where used through its 32-bit
// shared address (a generic pointer to it held across the consumers' loop
// spilled)
__device__ __forceinline__ int ld_shared_int(const int* p) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(shared_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int D, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_pair(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ lse_t, const float* __restrict__ di_t,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int W = pair_width<D>(), NC = D / W, WQ = W / 2, HALF = D / 2;
  constexpr int NK = W / 16;         // k-steps of the partial products over the part
  constexpr int NS = kBq / 8;        // 8-column blocks of a score tile (q rows)
  constexpr int NP = kBq / 16;       // k-steps of dV and dK over the q tile
  constexpr int NN = W / 8;          // 8-column blocks of dk and dv
  constexpr int NJ = kPairBkv / 16;  // k-steps of dQ over the kv tile
  constexpr int NQ = WQ / 64;        // 64-column products of a consumer's dQ columns
  constexpr uint32_t kKvP = kPairBkv * 128, kQP = kBq * 128;  // panel bytes
  static_assert(W == 128 || W == 256, "a part is one or two 128-lane products");
  extern __shared__ unsigned char smem_raw[];
  PairSmem<W, WITH_DQ>& sm = *reinterpret_cast<PairSmem<W, WITH_DQ>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int rank = (int)cluster_ctarank();  // the part
  const int b = blockIdx.z, h = blockIdx.y, kvt = blockIdx.x / NC, tid = threadIdx.x;
  if (tid == 0) {
    // the q tiles the cluster walks: all, or its (batch, kv tile)'s range;
    // in shared memory, read where used (held in registers across the warp
    // roles' split and the consumers' loop, they spilled)
    int qt0 = 0, qt1 = T / kBq - 1;
    if (q_lo != nullptr) {
      qt0 = q_lo[b * (T / kPairBkv) + kvt];
      qt1 = q_hi[b * (T / kPairBkv) + kvt];
    }
    sm.walk[0] = qt0;
    sm.walk[1] = qt1 - qt0 + 1;
    if (tile_count != nullptr && rank == 0) atomicAdd(tile_count, qt1 - qt0 + 1);
#pragma unroll
    for (int st = 0; st < kPairSlots; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    // one arrival a consumer warp a tile: the peers' consumer-0 warps (their
    // S^T partials are in) and consumer-1 warps (dP^T); the readers of this
    // CTA's partials, both consumers of every peer
    mbar_init(&sm.xfull_s, 4 * (NC - 1));
    mbar_init(&sm.xfull_dp, 4 * (NC - 1));
    mbar_init(&sm.xempty, 8 * (NC - 1));
    mbar_init_fence();
  }
  // every CTA's barriers are initialised before a peer arrives on them
  cluster_sync();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const int qt0 = sm.walk[0], n_items = 2 * sm.walk[1];
      constexpr uint32_t tile_bytes = kBq * W * sizeof(__nv_bfloat16);
      const uint32_t row_bytes =
          2u * kBq * sizeof(float) + (q_seg != nullptr ? kBq * sizeof(int) : 0u);
      // the (b, h) row of lse_t and di_t; the part's first head-dim column
      // of the head (no row pointers held: the producer has 24 registers)
      const size_t bh_row = ((size_t)b * H + h) * T;
      const int col0 = h * D + WQ * rank;
      // item i: slot i % kPairSlots, whose previous item's release is its
      // empty barrier's phase i / kPairSlots - 1 (parity ph)
      int st = 0;
      uint32_t ph = 1;
      for (int i = 0; i < n_items; ++i) {
        const int t = i >> 1, i0 = (qt0 + t) * kBq;
        if (i >= kPairSlots) mbar_wait(&sm.empty[st], ph);
        __nv_bfloat16* dst = sm.slot[st];
        if ((i & 1) == 0) {
          // the Q tile, with the tile's lse2, di and q ids
          mbar_arrive_expect_tx(&sm.full[st], tile_bytes + row_bytes);
#pragma unroll
          for (int pn = 0; pn < W / kPanelCols; ++pn)
            tma_load_2d(dst + pn * kBq * kPanelCols, &qmap,
                        col0 + part_col<D, WQ>(0, pn * kPanelCols), b * T + i0, &sm.full[st]);
          bulk_load(sm.lse[t & 1], lse_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
          bulk_load(sm.di[t & 1], di_t + bh_row + i0, kBq * sizeof(float), &sm.full[st]);
          if (q_seg != nullptr)
            bulk_load(sm.qseg[t & 1], q_seg + (size_t)b * T + i0, kBq * sizeof(int),
                      &sm.full[st]);
        } else {
          // the dO tile
          mbar_arrive_expect_tx(&sm.full[st], tile_bytes);
#pragma unroll
          for (int pn = 0; pn < W / kPanelCols; ++pn)
            tma_load_2d(dst + pn * kBq * kPanelCols, &omap,
                        col0 + part_col<D, WQ>(0, pn * kPanelCols), b * T + i0, &sm.full[st]);
        }
        if (++st == kPairSlots) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();  // thread 0's warp reconverges first
    cluster_sync();
  } else {
    // ---- consumers: 0 forms S^T and dV, 1 dP^T, dS and dK, over the part ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool is_dk = wg == 1;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const size_t base = (size_t)b * T * rs + (size_t)h * D;
    const int kv0 = kvt * kPairBkv;      // the cluster's first kv row
    const int j0 = kv0 + warp * 16 + g;  // this thread's rows j0 and j0 + 8

    // the part's K rows rotated in fp32 and rounded, V rows as they are,
    // into the swizzled panels: each consumer writes 32 rows of each
    rows_to_panels<D, WQ>(reinterpret_cast<unsigned char*>(sm.k), kPairBkv, wg * 32,
                          k + base + (size_t)(kv0 + wg * 32) * rs, rs, 32, cos_t, sin_t,
                          kv0 + wg * 32, wt, 128, WQ * rank);
    rows_to_panels<D, WQ>(reinterpret_cast<unsigned char*>(sm.v), kPairBkv, wg * 32,
                          v + base + (size_t)(kv0 + wg * 32) * rs, rs, 32, nullptr, nullptr, 0,
                          wt, 128, WQ * rank);
    // the kv rows' segment ids (read where used: two registers fewer in the
    // loop)
    if (wg == 0 && wt < kPairBkv)
      sm.kseg[wt] = kv_seg != nullptr ? kv_seg[(size_t)b * T + kv0 + wt] : 0;
    fence_async_shared();
    named_bar_sync(kBarKV, 256);

    float acc[W / 2];  // dV_c (consumer 0) or dK_c (consumer 1)
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

    // Each role runs a loop of its own over the walk's q tiles (one loop
    // with the roles as branches spilled). Tile `it`: q tile walk0() + it,
    // its Q in ring item 2 it and its dO in item 2 it + 1, its rows in
    // buffer it & 1. The part (the CTA's rank) is read where used (held
    // across the loop, it spilled).
    auto walk0 = [&]() { return ld_shared_int(&sm.walk[0]); };
    auto walk1 = [&]() { return ld_shared_int(&sm.walk[1]); };
    auto slot = [](int item) { return item % kPairSlots; };
    auto parity = [](int item) { return (uint32_t)(item / kPairSlots) & 1; };
    // the part's partial x = A.B^T over its lanes (64 kv x 64 q; A = K or V,
    // B = Q or dO of ring slot b_slot, both K-major), issued (the caller
    // commits and waits)
    auto partial = [&](float(&x)[32], uint32_t a_addr, int b_slot) {
      const uint32_t b_addr = shared_addr(sm.slot[b_slot]);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t ko = (kk >> 2) * kKvP + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * kQP + (kk & 3) * 32;
        wgmma_ss_m64n64k16<0, 0>(x, smem_desc(a_addr + ko, 16, kSwizzleAtom),
                                 smem_desc(b_addr + qo, 16, kSwizzleAtom), kk > 0);
      }
    };
    // x into this CTA's exchange buffer `buf` (thread t's elements 4 j.. at
    // [j][t]), once every reader has taken tile it - 1's
    auto publish = [&](const float(&x)[32], float4 (*buf)[128], int it) {
      if (it > 0) mbar_wait_cluster(&sm.xempty, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        buf[j][wt] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    };
    // one arrival a warp on the mbarrier `bar` of every peer
    auto announce = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) {
        const int part = (int)cluster_ctarank();
#pragma unroll
        for (int r = 0; r < NC; ++r)
          if (r != part) mbar_arrive_remote(cluster_addr(shared_addr(bar), r));
      }
    };
    // x = the sum of every part's partial in rank order (the same bits in
    // every CTA): this CTA's from registers, the peers' from their buffers
    // `buf` through distributed shared memory
    auto complete = [&](float(&x)[32], float4 (*buf)[128]) {
      const int part = (int)cluster_ctarank();
      const float4* src[NC];  // thread wt's column of each part's buffer
#pragma unroll
      for (int r = 0; r < NC; ++r) src[r] = cluster_ptr(&buf[0][wt], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 mine = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        auto part_r = [&](int r) { return r == part ? mine : src[r][128 * j]; };
        float4 a = part_r(0);
#pragma unroll
        for (int r = 1; r < NC; ++r) a = add4(a, part_r(r));
        x[4 * j] = a.x;
        x[4 * j + 1] = a.y;
        x[4 * j + 2] = a.z;
        x[4 * j + 3] = a.w;
      }
    };
    // bit 4 n + e: element e of score block n is kept. Element e of block n
    // is (kv row j0 + 8 (e >> 1), q row i0 + c + (e & 1)) with c = 8 n + 2
    // t4. The fused kernel's draw (mh_bwd_fused_bf16): lanes g and g ^ 1
    // share one Philox call per q-row pair.
    auto keep_bits = [&](int i0) {
      uint32_t keep = 0;
      const bool odd = g & 1;
      const int jd = odd ? j0 + 8 : j0;
#pragma unroll 4
      for (int n = 0; n < NS; ++n) {
        const Philox4 u = dropout_bits(dp.seed, cta_b() * H + cta_h(), i0 + n * 8 + 2 * t4, jd);
        const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[1], 4);
        const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[2] : u.w[3], 4);
        const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[2];  // row j0
        const uint32_t c0 = odd ? u.w[1] : y0, c1 = odd ? u.w[3] : y1;  // row j0 + 8
        const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                            (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
        keep |= k4 << (4 * n);
      }
      return keep;
    };
    // p of element e of block n of the scores s (rows buffer rw)
    auto prob = [&](const float(&s)[32], int rw, int n, int e) {
      const int c = n * 8 + 2 * t4 + (e & 1);
      const int qs = q_seg != nullptr ? sm.qseg[rw][c] : 0;
      const int ks = sm.kseg[warp * 16 + g + 8 * (e >> 1)];
      return exp2f(score(s[4 * n + e], scale_log2, qs, ks) - sm.lse[rw][c]);
    };
    // acc += A.B with A (P_drop^T or dS^T) from registers, B (dO or Q of
    // ring slot b_slot) MN-major: 16 q rows a k-step, the part in 128-lane
    // products (panels 0-1, 2-3); then (with dQ: once consumer 1's dS^T
    // rows are in, kBarDs) the slots of the tile's Q and dO are released
    auto accumulate = [&](const uint32_t(&fa)[NP][4], int b_slot, int sq, int so) {
      const uint32_t b_addr = shared_addr(sm.slot[b_slot]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const uint32_t rows = kk * 16 * 128;
        if constexpr (W == 256) {
          wgmma_rs_m64n128k16_tb(acc_half<0>(acc), fa[kk],
                                 smem_desc(b_addr + rows, kQP, kSwizzleAtom), 1);
          wgmma_rs_m64n128k16_tb(acc_half<1>(acc), fa[kk],
                                 smem_desc(b_addr + 2 * kQP + rows, kQP, kSwizzleAtom), 1);
        } else {
          wgmma_rs_m64n128k16_tb(acc, fa[kk], smem_desc(b_addr + rows, kQP, kSwizzleAtom), 1);
        }
      }
      wgmma_commit();
      if constexpr (WITH_DQ) named_bar_sync(kBarDs, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sm.empty[sq]);
        mbar_arrive(&sm.empty[so]);
      }
    };
    // the part's dQ columns of this consumer (its lanes WQ wg..) = dS.K_c:
    // A = dS^T through the transpose bit (q along the panel row), B = K's
    // panels NQ wg.. (head dim along the row), 16 kv rows a k-step; added
    // into the fp32 scratch by 16-byte atomics (slot gc / 8 of q tile qt's
    // chunk holds head-dim columns gc.., dq_chunk)
    // (generic, the dS^T tiles `tiles` (sm.x) a parameter: its body exists
    // only where it is called, with dQ)
    auto dq_add = [&](auto& sd, int qt, int rw, const auto& tiles) {
      float(&dq0)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
      float(&dq1)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
      // K's address formed here (hoisted, the k-steps' descriptors would be
      // held across the loop and spill)
      const uint32_t k_addr = opaque(shared_addr(sm.k)), ds_addr = shared_addr(tiles.ds[rw]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        const uint64_t da = smem_desc(ds_addr + kk * 16 * 128, kKvP, kSwizzleAtom);
        wgmma_ss_m64n64k16<1, 1>(
            dq0, da, smem_desc(k_addr + (NQ * wg) * kKvP + kk * 16 * 128, kKvP, kSwizzleAtom),
            kk > 0);
        if constexpr (NQ == 2)
          wgmma_ss_m64n64k16<1, 1>(
              dq1, da,
              smem_desc(k_addr + (NQ * wg + 1) * kKvP + kk * 16 * 128, kKvP, kSwizzleAtom),
              kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sd);
      // the chunk's offset formed here (hoisted, it would spill)
      const int slot0 = (wg * HALF + WQ * (int)cluster_ctarank()) / 8;
      float4* dst = reinterpret_cast<float4*>(
                        dq_acc + dq_chunk<D>(cta_b(), cta_h(), qt, (int)opaque(T), H)) +
                    wt;
#pragma unroll
      for (int hf = 0; hf < NQ; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          atomicAdd(dst + (size_t)(slot0 + 8 * hf + n) * 128,
                    make_float4(sd[32 * hf + 4 * n], sd[32 * hf + 4 * n + 1],
                                sd[32 * hf + 4 * n + 2], sd[32 * hf + 4 * n + 3]));
    };

    if (!is_dk) {
      // ---- consumer 0: S^T, P_drop^T and dV ----
      for (int it = 0; it < walk1(); ++it) {
        const int qt = walk0() + it, rw = it & 1, sq = slot(2 * it), so = slot(2 * it + 1);
        // s[] is S^T_c, then S^T, then P_drop^T; then (with dQ) sd[] holds
        // the dQ columns
        float sd[WITH_DQ ? 64 : 32];
        float(&s)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
        mbar_wait(&sm.full[sq], parity(2 * it));
        wgmma_fence();
        partial(s, opaque(shared_addr(sm.k)), sq);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        publish(s, sm.xs, it);
        announce(&sm.xfull_s);
        // the keep bits, drawn while the peers' partials are on their way
        const uint32_t keep = DROP ? keep_bits(qt * kBq) : ~0u;
        mbar_wait_cluster(&sm.xfull_s, it & 1);
        complete(s, sm.xs);
        announce(&sm.xempty);  // the peers may overwrite their partials
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = prob(s, rw, n, e);
            s[4 * n + e] = DROP ? ((keep >> (4 * n + e)) & 1 ? p * dp.keep_scale : 0.f) : p;
          }
        }
        // the A fragments of dV: k-step kk is score blocks 2 kk, 2 kk + 1
        uint32_t fa[NP][4];
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            fa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
        mbar_wait(&sm.full[so], parity(2 * it + 1));  // the tile's dO
        accumulate(fa, so, sq, so);
        fence_regs(fa);
        if constexpr (WITH_DQ) dq_add(sd, qt, rw, sm.x);
      }
    } else {
      // ---- consumer 1: dP^T, dS^T and dK ----
      for (int it = 0; it < walk1(); ++it) {
        // (the tile's q tile and slots are formed where used: held across
        // the tile, one spilled)
        const int rw = it & 1;
        // dpt[] is dP^T_c, then dP^T, then dS^T; s[] the tile's S^T; then
        // (with dQ) sd[] holds the dQ columns
        float sd[64];
        float(&s)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
        float(&dpt)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
        // the keep bits: at W = 256 first (drawn beside the S^T and dP^T
        // accumulators, they spilled), at W = 128 while the partials are on
        // their way with dQ (drawn first, the three parts' loads in flight
        // spilled) and first without (drawn later, that instance spilled)
        uint32_t keep = ~0u;
        if (DROP && (W == 256 || !WITH_DQ)) keep = keep_bits((walk0() + it) * kBq);
        // S^T_c too (the one product done twice, as in the D = 256 kernel:
        // reading this CTA's partial as well, the loads in flight spilled)
        mbar_wait(&sm.full[slot(2 * it)], parity(2 * it));  // Q and the tile's rows
        mbar_wait(&sm.full[slot(2 * it + 1)], parity(2 * it + 1));  // dO
        wgmma_fence();
        partial(dpt, opaque(shared_addr(sm.v)), slot(2 * it + 1));
        partial(s, opaque(shared_addr(sm.k)), slot(2 * it));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sd);
        publish(dpt, sm.xdp, it);
        announce(&sm.xfull_dp);
        if (DROP && W == 128 && WITH_DQ) keep = keep_bits((walk0() + it) * kBq);
        mbar_wait_cluster(&sm.xfull_s, it & 1);
        mbar_wait_cluster(&sm.xfull_dp, it & 1);
        complete(s, sm.xs);
        complete(dpt, sm.xdp);
        announce(&sm.xempty);  // the peers may overwrite their partials
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d = dpt[4 * n + e];
            if constexpr (DROP) d = (keep >> (4 * n + e)) & 1 ? d * dp.keep_scale : 0.f;
            dpt[4 * n + e] = __fmul_rn(
                __fmul_rn(prob(s, rw, n, e), __fsub_rn(d, sm.di[rw][n * 8 + 2 * t4 + (e & 1)])),
                scale);
          }
        }
        // the A fragments of dK, and (with dQ) dS^T into this iteration's
        // tile: fragment r of k-step kk is kv row j (+ 8 for r odd), q
        // columns 16 kk + 2 t4 (+ 8 for r >= 2)
        uint32_t fa[NP][4];
        const int jr = warp * 16 + g;
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            fa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
            if constexpr (WITH_DQ)
              *reinterpret_cast<uint32_t*>(
                  reinterpret_cast<unsigned char*>(sm.x.ds[rw]) +
                  swizzled_offset(kPairBkv, jr + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t4)) =
                  fa[kk][r];
          }
        }
        if constexpr (WITH_DQ) fence_async_shared();
        const int at = (int)opaque(it);
        accumulate(fa, slot(2 * at), slot(2 * at), slot(2 * at + 1));
        fence_regs(fa);
        if constexpr (WITH_DQ) dq_add(sd, walk0() + at, rw, sm.x);
      }
    }

    // dv (consumer 0), or dk rotated back by -angle in fp32 (consumer 1;
    // part lanes l and WQ + l, head-dim lanes c_lo + l and D/2 + c_lo + l,
    // sit in blocks n and n + NN/2 of the same thread); the row's offset is
    // formed here (held across the loop, it would spill)
    const size_t row0 = ((size_t)cta_b() * T + opaque(j0)) * rs + (size_t)cta_h() * D;
    const int part = (int)cluster_ctarank(), c_lo = WQ * part;
    __nv_bfloat16* out = (is_dk ? dk : dv) + row0;
    if (is_dk && cos_t != nullptr) {
#pragma unroll
      for (int n = 0; n < NN / 2; ++n) {
        const int col = c_lo + n * 8 + 2 * t4;
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
        const int col = part_col<D, WQ>(part, n * 8 + 2 * t4);
        *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(out + 8 * rs + col) =
            pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
    cluster_sync();
  }
}

// mh_bwd_pair on q already rotated (or not rotated at all); k rotated by the
// kernel; lse_t and di_t (B, H, T). WITH_DQ: dq_acc (fp32, q's size) is
// zeroed, summed into and turned into dq by dq_epilogue_bf16; else dq_acc
// and dq are not read. A cluster of D / W CTAs a kv tile.
template <int D, bool DROP, bool WITH_DQ>
cudaError_t launch_pair(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const __nv_bfloat16* dout, const float* lse_t, const float* di_t,
                        const int* q_seg, const int* kv_seg, const float* cos_t,
                        const float* sin_t, const int* q_lo, const int* q_hi, int* tile_count,
                        float* dq_acc, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                        int B, int T, int H, float scale_log2, float scale, DropParams dp,
                        cudaStream_t st) {
  // Q and dO as (B * T, H * D) row-major matrices, loaded as 64-row boxes
  // of 64-column panels
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
  constexpr int NC = D / pair_width<D>();
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = pair_smem_bytes<D, WITH_DQ>();
  e = obt::wide::allow_smem(mh_bwd_pair<D, DROP, WITH_DQ>, smem, smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = NC;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC * (T / kPairBkv), H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mh_bwd_pair<D, DROP, WITH_DQ>, qmap, omap, k, v, lse_t, di_t,
                         q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, dk, dv, T,
                         H, scale_log2, scale, dp);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || !WITH_DQ) return e;
  const long long n_items = n / 8;
  dq_epilogue_bf16<D><<<(unsigned)((n_items + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(dq_acc), cos_t, sin_t, dq, T, H, n_items);
  return cudaGetLastError();
}

// The bf16 fused backward (WITH_DQ) or dkv kernel at D = 384 or 512: q
// rotated into q_rot (with RoPE), then mh_bwd_pair.
template <bool WITH_DQ>
cudaError_t pair_backward(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, const int* q_seg,
                          const int* kv_seg, const float* cos_t, const float* sin_t,
                          void* q_rot, const int* q_lo, const int* q_hi, int* tile_count,
                          float* dq_acc, void* dq, void* dk, void* dv, int B, int T, int H,
                          int D, float scale_log2, float scale, bool drop, DropParams dp,
                          cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows(q, cos_t, sin_t, q_rot, B, T, H, D, true, st);
    q = q_rot;
  }
  using bf = __nv_bfloat16;
  auto run = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const bf*>(q), static_cast<const bf*>(k),
                         static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di, q_seg,
                         kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc,
                         static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), B, T,
                         H, scale_log2, scale, dp, st);
  };
  if (D == 384)
    return drop ? run(launch_pair<384, true, WITH_DQ>) : run(launch_pair<384, false, WITH_DQ>);
  return drop ? run(launch_pair<512, true, WITH_DQ>) : run(launch_pair<512, false, WITH_DQ>);
}

// ---------------------------------------------------------------------------
// mh_bwd_dq_cta: the split pair's dq at D = 384 and 512 in bf16, one CTA a
// 64-row q tile with all D lanes. It replaces there omnibiote_tpu/ops/
// flash_attention.py:866 _mh_bwd_dq_kernel and :301 _bwd_dq_kernel.
// Why not a cluster as mh_bwd_pair: dQ of 64 q rows is 64 x D, which two
// consumers hold in registers (dK and dV of 64 kv rows are twice that), and
// every CTA of a cluster would pay the whole exchange, elementwise pass and
// Philox draw of a tile for its part of the products (measured 1.1-3.5 x
// slower; PERF.md §6). 384 threads: a producer warpgroup and two consumers
// (setmaxnreg 24 / 240).
//   * The consumers write the q tile's Q rows (rotated in fp32, rounded) and
//     dO rows into swizzled panels once (64 x D each); the producer's first
//     thread keeps a two-stage ring of BKV-row K (rotated ahead) and V tiles
//     and their kv ids full by TMA: 32-row tiles at 384, 16-row at 512
//     (dq_cta_bkv), so Q, dO and the ring fit the 227 KB.
//   * Consumer w forms the partial S_w = Q.K^T and dP_w = dO.V^T of the
//     whole 64 x BKV tile over its half of the head dim (panels NH w..NH w
//     + NH - 1, NH = D / 128; wgmma m64nBKVk16), writes them (fp32, fragment
//     order) to shared memory; after a named barrier each adds the other's
//     (consumer 0's + consumer 1's, the same bits in both), so both have S
//     and dP; then p, the keep bits and dS of the tile on their registers
//     (the pass done by both), rounded into the A fragments of dQ += dS.K on
//     the consumer's own lanes (K through the transpose bit), closed under
//     rotate-half: panel p pairs with p + NH; consumer 0 owns pairs 0 and 1
//     (two m64n128 products, 128 fp32 a thread), consumer 1 the rest (pairs
//     2 and 3 at 512, two m64n128; pair 2 at 384, two m64n64, 64 fp32).
//   * After the walk each applies the inverse RoPE to its lanes and stores
//     them.
// Each product once, no atomics, one owner a dq element: dq is the same bits
// from launch to launch. Shared memory (dq_cta_smem_bytes, with room to
// align the base): 231,424 B at 384 (Q and dO 96 KB, two 48 KB stages, 32
// KB of partials), 215,040 B at 512 (128 KB, two 32 KB stages, 16 KB).
// Tiles (64, BKV) (ops/flash_attention.py::kernel_tiles).
// Bound: the function's 6 flops a visible (q, k) pair, head and head dim;
// bound by operations.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int dq_cta_bkv() {
  return D == 384 ? 32 : 16;
}
constexpr int kDqCtaStages = 2;
// named barriers: both consumers' partials are written; both have read them
constexpr int kBarXs = 4, kBarXr = 5;

template <int D>
struct DqCtaSmem {
  static constexpr int BKV = dq_cta_bkv<D>();
  alignas(1024) __nv_bfloat16 q[kBq * D];  // the tile's Q rows, rotated
  alignas(1024) __nv_bfloat16 dout[kBq * D];
  alignas(1024) __nv_bfloat16 k[kDqCtaStages][BKV * D];
  alignas(1024) __nv_bfloat16 v[kDqCtaStages][BKV * D];
  // consumer w's partial S (dP) over its half of the head dim: thread t's
  // elements 4 j.. at [w][j][t]
  float4 xs[2][BKV / 8][128];
  float4 xdp[2][BKV / 8][128];
  alignas(16) int kseg[kDqCtaStages][BKV];
  uint64_t full[kDqCtaStages], empty[kDqCtaStages];
};

template <int D>
constexpr size_t dq_cta_smem_bytes() {
  return sizeof(DqCtaSmem<D>) + kSwizzleAtom;  // + room to align the base
}
static_assert(dq_cta_smem_bytes<384>() <= 232448 && dq_cta_smem_bytes<512>() <= 232448,
              "a CTA takes at most 227 KB");

template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) mh_bwd_dq_cta(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, int* __restrict__ tile_count, __nv_bfloat16* __restrict__ dq,
    int T, int H, float scale_log2, float scale, DropParams dp) {
  static_assert(D == 384 || D == 512, "three or four rotate-half pairs of 64-column panels");
  constexpr int BKV = dq_cta_bkv<D>();
  constexpr int NH = D / 128;   // panels of a consumer's half of the head dim
  constexpr int NK = NH * 4;    // k-steps of a partial product over it
  constexpr int NS = BKV / 8;   // 8-column blocks of a score tile (kv columns)
  constexpr int NP = BKV / 16;  // k-steps of dQ over the kv tile
  constexpr int HALF = D / 2;
  constexpr uint32_t kKvP = BKV * 128, kQP = kBq * 128;  // panel bytes
  extern __shared__ unsigned char smem_raw[];
  DqCtaSmem<D>& sm = *reinterpret_cast<DqCtaSmem<D>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, tid = threadIdx.x;
  // the kv tiles this CTA walks: all, or its (batch, q tile)'s range
  int jt0 = 0, jt1 = T / BKV - 1;
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / kBq) + qt];
    jt1 = kv_hi[b * (T / kBq) + qt];
  }
  const int n_tiles = jt1 - jt0 + 1;
  if (tid == 0) {
    if (tile_count != nullptr) atomicAdd(tile_count, n_tiles);
#pragma unroll
    for (int st = 0; st < kDqCtaStages; ++st) {
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
      const uint32_t bytes = 2u * BKV * D * sizeof(__nv_bfloat16) +
                             (kv_seg != nullptr ? BKV * sizeof(int) : 0u);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kDqCtaStages, j0 = (jt0 + it) * BKV;
        if (it >= kDqCtaStages) mbar_wait(&sm.empty[st], ((it / kDqCtaStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn) {
          tma_load_2d(&sm.k[st][pn * BKV * kPanelCols], &kmap, h * D + pn * kPanelCols,
                      b * T + j0, &sm.full[st]);
          tma_load_2d(&sm.v[st][pn * BKV * kPanelCols], &vmap, h * D + pn * kPanelCols,
                      b * T + j0, &sm.full[st]);
        }
        if (kv_seg != nullptr)
          bulk_load(sm.kseg[st], kv_seg + (size_t)b * T + j0, BKV * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: the partial scores over half the head dim, dQ on
    // their own lanes ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    const int q0 = qt * kBq;
    const int r0 = q0 + warp * 16 + g;  // this thread's q rows r0 and r0 + 8
    {
      const size_t src = ((size_t)b * T + q0 + wg * 32) * rs + (size_t)h * D;
      rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.q), kBq, wg * 32, q + src, rs, 32,
                        cos_t, sin_t, q0 + wg * 32, wt, 128);
      rows_to_panels<D>(reinterpret_cast<unsigned char*>(sm.dout), kBq, wg * 32, dout + src,
                        rs, 32, nullptr, nullptr, 0, wt, 128);
    }
    fence_async_shared();
    named_bar_sync(kBarKV, 256);

    int qs0 = 0, qs1 = 0;
    if (q_seg != nullptr) {
      qs0 = q_seg[(size_t)b * T + r0];
      qs1 = q_seg[(size_t)b * T + r0 + 8];
    }
    const size_t sr0 = ((size_t)b * T + r0) * H + h, sr1 = sr0 + (size_t)8 * H;
    const float lse0 = lse[sr0], lse1 = lse[sr1], di0 = di[sr0], di1 = di[sr1];

    // Each role runs the walk with its own accumulator (register indices
    // fixed at compile time): consumer 0 pairs 0 and 1, consumer 1 the rest.
    auto walk = [&](auto role) {
      constexpr int w = decltype(role)::value;
      constexpr bool WIDE_ACC = w == 0 || D == 512;  // two m64n128 products
      constexpr int NACC = WIDE_ACC ? 128 : 64;
      constexpr int P0 = w == 0 ? 0 : 2;  // the first panel of its low lanes
      float acc[NACC], s[BKV / 2], dpv[BKV / 2];
      uint32_t f[NP][4];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      // the partial S_w and dP_w of ring stage st over panels NH w.. (both
      // operands K-major), issued and committed
      auto gemm_sdp = [&](int st) {
        const uint32_t k_addr = shared_addr(sm.k[st]) + w * NH * kKvP;
        const uint32_t v_addr = shared_addr(sm.v[st]) + w * NH * kKvP;
        const uint32_t q_addr = opaque(shared_addr(sm.q)) + w * NH * kQP;
        const uint32_t o_addr = opaque(shared_addr(sm.dout)) + w * NH * kQP;
        auto product = [&](float(&x)[BKV / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            const uint64_t da = smem_desc(a_addr + (kk >> 2) * kQP + (kk & 3) * 32, 16,
                                          kSwizzleAtom);
            const uint64_t db = smem_desc(b_addr + (kk >> 2) * kKvP + (kk & 3) * 32, 16,
                                          kSwizzleAtom);
            if constexpr (BKV == 32)
              wgmma_ss_m64n32k16<0, 0>(x, da, db, kk > 0);
            else
              wgmma_ss_m64n16k16<0, 0>(x, da, db, kk > 0);
          }
        };
        wgmma_fence();
        product(s, q_addr, k_addr);
        product(dpv, o_addr, v_addr);
        wgmma_commit();
      };
      // acc += dS.K of ring stage st on this consumer's lanes (K MN-major: 16
      // kv rows a k-step), issued and committed
      auto gemm_dq = [&](int st) {
        const uint32_t k_addr = shared_addr(sm.k[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          const uint32_t lo = k_addr + P0 * kKvP + kk * 16 * 128;
          const uint32_t hi = lo + NH * kKvP;  // the partners' panels
          if constexpr (WIDE_ACC) {
            wgmma_rs_m64n128k16_tb(acc_half<0>(acc), f[kk], smem_desc(lo, kKvP, kSwizzleAtom), 1);
            wgmma_rs_m64n128k16_tb(acc_half<1>(acc), f[kk], smem_desc(hi, kKvP, kSwizzleAtom), 1);
          } else {
            wgmma_rs_m64n64k16_tb(acc_at<0, 32>(acc), f[kk], smem_desc(lo, kKvP, kSwizzleAtom), 1);
            wgmma_rs_m64n64k16_tb(acc_at<32, 32>(acc), f[kk], smem_desc(hi, kKvP, kSwizzleAtom),
                                  1);
          }
        }
        wgmma_commit();
      };
      // tile it's S and dP (issued by the caller) waited for and completed
      // with the other consumer's halves, then dS of kv tile jt (ring stage
      // st) rounded into the A fragments f. Element e of block n is (q row
      // r0 + 8 (e >> 1), kv column jt * BKV + 8 n + 2 t4 + (e & 1)).
      auto scores_ds = [&](int jt, int st) {
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dpv);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          sm.xs[w][j][wt] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
          sm.xdp[w][j][wt] = make_float4(dpv[4 * j], dpv[4 * j + 1], dpv[4 * j + 2], dpv[4 * j + 3]);
        }
        named_bar_sync(kBarXs, 256);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 os = sm.xs[1 - w][j][wt], od = sm.xdp[1 - w][j][wt];
          const float4 ms = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
          const float4 md = make_float4(dpv[4 * j], dpv[4 * j + 1], dpv[4 * j + 2], dpv[4 * j + 3]);
          const float4 ts = w == 0 ? add4(ms, os) : add4(os, ms);
          const float4 td = w == 0 ? add4(md, od) : add4(od, md);
          s[4 * j] = ts.x;
          s[4 * j + 1] = ts.y;
          s[4 * j + 2] = ts.z;
          s[4 * j + 3] = ts.w;
          dpv[4 * j] = td.x;
          dpv[4 * j + 1] = td.y;
          dpv[4 * j + 2] = td.z;
          dpv[4 * j + 3] = td.w;
        }
        named_bar_sync(kBarXr, 256);  // both have read: the next tile may overwrite
        [[maybe_unused]] uint32_t keep = ~0u;  // bit 4 n + e: element e of block n is kept
        if constexpr (DROP) {
          // the D <= 256 dq kernel's draw: lanes g and g ^ 1 share one
          // Philox call a column pair
          const bool odd = g & 1;
          const int row = odd ? r0 + 8 : r0;
          keep = 0;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const Philox4 u = dropout_bits(dp.seed, b * H + h, row, jt * BKV + n * 8 + 2 * t4);
            const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[2], 4);
            const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[1] : u.w[3], 4);
            const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[1];  // row r0
            const uint32_t b0 = odd ? u.w[2] : y0, b1 = odd ? u.w[3] : y1;  // row r0 + 8
            const uint32_t k4 = (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
                                (uint32_t)(b0 >= dp.thresh) << 2 | (uint32_t)(b1 >= dp.thresh) << 3;
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
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            f[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
      };
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);
      };

      mbar_wait(&sm.full[0], 0);
      gemm_sdp(0);
      scores_ds(jt0, 0);
      for (int it = 1; it < n_tiles; ++it) {
        const int st = it % kDqCtaStages, prev = (it - 1) % kDqCtaStages;
        mbar_wait(&sm.full[st], (uint32_t)(it / kDqCtaStages) & 1);
        gemm_dq(prev);
        gemm_sdp(st);
        wgmma_wait<1>();  // dS.K of the previous tile is done
        fence_regs(acc);
        fence_regs(f);
        release(prev);
        scores_ds(jt0 + it, st);
      }
      gemm_dq((n_tiles - 1) % kDqCtaStages);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(f);

      // dq rotated back by -angle in fp32 and stored: lanes 64 P0 + 8 n..
      // (block n) and their partners + D/2 (block n + NL) of one thread
      constexpr int NL = NACC / 8;  // blocks of the low lanes
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        const int col = 64 * P0 + n * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          __nv_bfloat16* dst = dq + ((size_t)b * T + row) * rs + (size_t)h * D;
          float x1a = acc[4 * n + 2 * r], x1b = acc[4 * n + 2 * r + 1];
          float x2a = acc[4 * (n + NL) + 2 * r], x2b = acc[4 * (n + NL) + 2 * r + 1];
          if (cos_t != nullptr) {
            const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)row * HALF + col);
            const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)row * HALF + col);
            const float ya = rope_inv_lo(x1a, x2a, c.x, sn.x), yb = rope_inv_lo(x1b, x2b, c.y, sn.y);
            x2a = rope_inv_hi(x1a, x2a, c.x, sn.x);
            x2b = rope_inv_hi(x1b, x2b, c.y, sn.y);
            x1a = ya;
            x1b = yb;
          }
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(x1a, x1b);
          *reinterpret_cast<uint32_t*>(dst + col + HALF) = pack_bf16(x2a, x2b);
        }
      }
    };
    if (wg == 0)
      walk(std::integral_constant<int, 0>());
    else
      walk(std::integral_constant<int, 1>());
  }
}

// mh_bwd_dq_cta on k already rotated (or not rotated at all); q rotated by
// the kernel; lse and di (B, T, H). One CTA a q tile.
template <int D, bool DROP>
cudaError_t launch_dq_cta(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                          const float* di, const int* q_seg, const int* kv_seg,
                          const float* cos_t, const float* sin_t, const int* kv_lo,
                          const int* kv_hi, int* tile_count, __nv_bfloat16* dq, int B, int T,
                          int H, float scale_log2, float scale, DropParams dp,
                          cudaStream_t st) {
  // K and V as (B * T, H * D) row-major matrices, loaded as kv-tile boxes of
  // 64-column panels
  CUtensorMap kmap, vmap;
  const uint64_t rows = (uint64_t)B * T, cols = (uint64_t)H * D;
  cudaError_t e = encode_bf16_panels(&kmap, k, rows, cols, cols, dq_cta_bkv<D>());
  if (e == cudaSuccess) e = encode_bf16_panels(&vmap, v, rows, cols, cols, dq_cta_bkv<D>());
  if (e != cudaSuccess) return e;
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = dq_cta_smem_bytes<D>();
  e = obt::wide::allow_smem(mh_bwd_dq_cta<D, DROP>, smem, smem_set);
  if (e != cudaSuccess) return e;
  mh_bwd_dq_cta<D, DROP><<<dim3(T / kBq, H, B), kThreads, smem, st>>>(
      kmap, vmap, q, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, dq, T,
      H, scale_log2, scale, dp);
  return cudaGetLastError();
}

// The bf16 split pair's dq at D = 384 or 512: k rotated into k_rot (with
// RoPE), then mh_bwd_dq_cta.
template <typename = void>
cudaError_t dq_cta_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* k_rot, const int* kv_lo,
                     const int* kv_hi, int* tile_count, void* dq, int B, int T, int H, int D,
                     float scale_log2, float scale, bool drop, DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, true, st);
    k = k_rot;
  }
  using bf = __nv_bfloat16;
  auto run = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const bf*>(q), static_cast<const bf*>(k),
                         static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di, q_seg,
                         kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, static_cast<bf*>(dq), B,
                         T, H, scale_log2, scale, dp, st);
  };
  if (D == 384) return drop ? run(launch_dq_cta<384, true>) : run(launch_dq_cta<384, false>);
  return drop ? run(launch_dq_cta<512, true>) : run(launch_dq_cta<512, false>);
}

// The kernel the fused backward's or the dkv library's C entry launches at
// head dim D and dtype (0 float32, 1 bfloat16), by name (the dkv kernel is
// the fused one without its dq).
const char* fused_route(int D, int dtype) {
  if (dtype == 1 && (D == 64 || D == 128)) return "mh_bwd_fused_bf16";
  if (dtype == 1 && D == 256) return "mh_bwd_d256_bf16";
  if (dtype == 1 && pair_head_dim(D)) return "mh_bwd_pair";
  if (dtype == 0 && (D == 64 || D == 128 || D == 256)) return "mh_bwd_f32";
  if ((dtype == 0 || dtype == 1) && obt::wide::head_dim_ok(D)) return "mh_bwd_wide";
  return "none";
}

}  // namespace
}  // namespace bwd
}  // namespace obt
