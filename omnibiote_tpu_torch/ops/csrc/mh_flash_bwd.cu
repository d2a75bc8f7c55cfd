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
// reads all of it); k is rotated where a consumer loads its rows. The
// kernel (mh_flash_bwd_kernels.cuh::mh_bwd_fused_bf16 with WITH_DQ) is also
// the split pair's dkv kernel without its dq (mh_flash_bwd_dkv.cu). The
// fp32 kernel is the parity type and runs on the CUDA cores, with q and k
// both rotated ahead.
//
// Head dim 256. dK and dV of a consumer's 64 kv rows would be 256 fp32 a
// thread, past its 240 registers, and the 64 KB dQ staging tile does not
// fit beside 64 KB Q and dO stages. So at D = 256 a CTA owns 64 kv rows
// and its two consumers split the work by output
// (mh_flash_bwd_kernels.cuh::mh_bwd_d256_bf16): consumer 0 forms S^T,
// P_drop^T and dV, consumer 1 S^T (again), dP^T, dS^T and dK, each 128
// fp32 a thread; each then forms 128 columns of the q tile's dQ and adds
// them into the fp32 scratch (the same fragment layout) by 16-byte atomics
// from its registers. The fp32 kernel gives a kv row 8 threads there.
//
// Head dims past 256 (D % 128 == 0). In bf16 at D = 384 and 512,
// mh_bwd_pair (below): a thread-block cluster of two CTAs (three at D =
// 384) owns a 64-row kv tile, each CTA the D = 256 kernel's work on its part
// of the head dim, the partial scores completed through distributed shared
// memory, each product done once. In fp32, and in bf16 past 512,
// wide_attention.cuh::mh_bwd_wide: a CTA a (64-row kv tile, 128-lane slice
// of the outputs), S^T and dP^T summed over streamed 64-column panels and
// recomputed by every slice, dq by atomics into the fp32 scratch; see its
// note. The route is by head dim and dtype (fused_route).
//
// Segment skipping. The TPU kernel's grid is (q block, kv block) with the kv
// range per q block; this kernel's CTA owns a kv tile, so it takes the same
// tiles from the other side: the q-tile range per (batch, kv tile)
// (mh_flash_bwd_kernels.cuh). The TPU kernel's kv chunking (kv0, n_kv_tot)
// exists for its VMEM accumulators and has no counterpart here. dq_acc is
// zeroed before the kernel, so dq rows that some kv tile never visits still
// hold a defined sum.
#include "mh_flash_bwd_kernels.cuh"
#include "wide_attention.cuh"

// The kernel lives beside the kernels it shares its types with (their
// namespace), so that nvcc's launch stubs name one unnamed namespace.
namespace obt {
namespace bwd {
namespace {

// ---------------------------------------------------------------------------
// bf16 at D = 384 and 512: mh_bwd_pair. It replaces the file's two TPU
// kernels there (omnibiote_tpu/ops/flash_attention.py:965
// _mh_bwd_fused_kernel, :1128 _mh_bwd_fusedmk_kernel).
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
//     transpose bit), dS^T to a double-buffered tile. Then consumer w forms
//     the part's w-th half of the q tile's dQ = dS.K_c and adds it into the
//     fp32 scratch by 16-byte atomics (dq_chunk's layout; dq_epilogue_bf16
//     applies the inverse RoPE and casts).
// So S^T is formed twice a CTA, as in the D = 256 kernel, and every other
// product once: 6 / 5 = 1.2 x the function's products (the slice kernels
// 2.2 x at D = 512). Consumer 1 reading its own CTA's S^T partial instead
// of forming it had 24 loads of 16 bytes in flight a thread and spilled.
// The CTAs of a cluster walk the same q tiles: the skip bounds are per
// (batch, kv tile); rank 0 adds to tile_count. No CTA exits while a peer may
// still read its shared memory or arrive on its barriers: both warp roles
// end at a cluster barrier, on an empty walk too. The registers (240 a
// consumer thread) are spent to the last: what the loop does not need at
// every step (the walk, the kv ids, the part, the batch row and head, the
// ring slots) is read where used.
// Shared memory at D = 512: K and V 64 KB, three 32 KB slots, 32 KB of
// exchange, 16 KB of dS^T (pair_smem_bytes: 216,064 B a CTA, with room to
// align the base); at D = 384 134,144 B.
// Bound: the function's 10 flops a visible (q, k) pair, head and head dim,
// as at every D; at the training shape (B 16, T 1024, 2 heads of 512, 3 EOS
// a row) 0.0724 ms at the bf16 peak, bound by operations.
// ---------------------------------------------------------------------------
constexpr bool pair_head_dim(int D) { return D == 384 || D == 512; }

// head-dim lanes a CTA of the cluster owns at D (D / pair_width CTAs)
template <int D>
__host__ __device__ constexpr int pair_width() {
  return D == 512 ? 256 : 128;
}

constexpr int kPairBkv = 64, kPairSlots = 3;

template <int W>
struct PairSmem {
  alignas(1024) __nv_bfloat16 k[kPairBkv * W];
  alignas(1024) __nv_bfloat16 v[kPairBkv * W];
  alignas(1024) __nv_bfloat16 slot[kPairSlots][kBq * W];  // Q_t, dO_t, Q_t+1, ...
  alignas(1024) __nv_bfloat16 ds[2][kPairBkv * kBq];      // dS^T, one panel
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

template <int D>
constexpr size_t pair_smem_bytes() {
  return sizeof(PairSmem<pair_width<D>()>) + kSwizzleAtom;  // + room to align the base
}
static_assert(pair_smem_bytes<512>() <= 232448, "a CTA takes at most 227 KB");

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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int D, bool DROP>
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
  PairSmem<W>& sm = *reinterpret_cast<PairSmem<W>*>(
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
    // with the roles as branches spilled). Tile `it`: q tile walk[0] + it,
    // its Q in ring item 2 it and its dO in item 2 it + 1, its rows in
    // buffer it & 1. The part (the CTA's rank) is read where used (held
    // across the loop, it spilled).
    const volatile int* walk = sm.walk;
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
    // products (panels 0-1, 2-3); then, once consumer 1's dS^T rows are in
    // (kBarDs), the slots of the tile's Q and dO are released
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
      named_bar_sync(kBarDs, 256);
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
    auto dq_add = [&](float(&sd)[64], int qt, int rw) {
      float(&dq0)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
      float(&dq1)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
      // K's address formed here (hoisted, the k-steps' descriptors would be
      // held across the loop and spill)
      const uint32_t k_addr = opaque(shared_addr(sm.k)), ds_addr = shared_addr(sm.ds[rw]);
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
      for (int it = 0; it < walk[1]; ++it) {
        const int qt = walk[0] + it, rw = it & 1, sq = slot(2 * it), so = slot(2 * it + 1);
        // s[] is S^T_c, then S^T, then P_drop^T; then sd[] holds the dQ
        // columns
        float sd[64];
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
        dq_add(sd, qt, rw);
      }
    } else {
      // ---- consumer 1: dP^T, dS^T and dK ----
      for (int it = 0; it < walk[1]; ++it) {
        // (the tile's q tile and slots are formed where used: held across
        // the tile, one spilled)
        const int rw = it & 1;
        // dpt[] is dP^T_c, then dP^T, then dS^T; s[] the tile's S^T; then
        // sd[] holds the dQ columns
        float sd[64];
        float(&s)[32] = *reinterpret_cast<float(*)[32]>(&sd[0]);
        float(&dpt)[32] = *reinterpret_cast<float(*)[32]>(&sd[32]);
        // the keep bits: at W = 256 first (drawn beside the S^T and dP^T
        // accumulators, they spilled), at W = 128 while the partials are on
        // their way (drawn first, the three parts' loads in flight spilled)
        uint32_t keep = ~0u;
        if (DROP && W == 256) keep = keep_bits((walk[0] + it) * kBq);
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
        if (DROP && W == 128) keep = keep_bits((walk[0] + it) * kBq);
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
        // the A fragments of dK, and dS^T into this iteration's tile:
        // fragment r of k-step kk is kv row j (+ 8 for r odd), q columns
        // 16 kk + 2 t4 (+ 8 for r >= 2)
        uint32_t fa[NP][4];
        unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[rw]);
        const int jr = warp * 16 + g;
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            fa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dsb + swizzled_offset(kPairBkv, jr + 8 * (r & 1),
                                                               16 * kk + 8 * (r >> 1) + 2 * t4)) =
                fa[kk][r];
          }
        }
        fence_async_shared();
        const int at = (int)opaque(it);
        accumulate(fa, slot(2 * at), slot(2 * at), slot(2 * at + 1));
        fence_regs(fa);
        dq_add(sd, walk[0] + at, rw);
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
// kernel; lse_t and di_t (B, H, T). dq_acc (fp32, q's size) is zeroed,
// summed into and turned into dq by dq_epilogue_bf16. A cluster of D / W
// CTAs (cudaLaunchKernelEx with a cluster dimension) a kv tile.
template <int D, bool DROP>
cudaError_t launch_pair(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const __nv_bfloat16* dout, const float* lse_t, const float* di_t,
                        const int* q_seg, const int* kv_seg, const float* cos_t,
                        const float* sin_t, const int* q_lo, const int* q_hi, int* tile_count,
                        float* dq_acc, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                        int B, int T, int H, float scale_log2, float scale, DropParams dp,
                        cudaStream_t st) {
  constexpr int NC = D / pair_width<D>();
  // Q and dO as (B * T, H * D) row-major matrices, loaded as 64-row boxes
  // of 64-column panels
  CUtensorMap qmap, omap;
  const uint64_t rows = (uint64_t)B * T, cols = (uint64_t)H * D;
  cudaError_t e = encode_bf16_panels(&qmap, q, rows, cols, cols, kBq);
  if (e == cudaSuccess) e = encode_bf16_panels(&omap, dout, rows, cols, cols, kBq);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * T * H * D;
  e = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
  if (e != cudaSuccess) return e;
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = pair_smem_bytes<D>();
  e = obt::wide::allow_smem(mh_bwd_pair<D, DROP>, smem, smem_set);
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
  e = cudaLaunchKernelEx(&cfg, mh_bwd_pair<D, DROP>, qmap, omap, k, v, lse_t, di_t, q_seg,
                         kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, dk, dv, T, H,
                         scale_log2, scale, dp);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n_items = n / 8;
  dq_epilogue_bf16<D><<<(unsigned)((n_items + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(dq_acc), cos_t, sin_t, dq, T, H, n_items);
  return cudaGetLastError();
}

// The bf16 fused backward at D = 384 or 512: q rotated into q_rot (with
// RoPE), then mh_bwd_pair.
cudaError_t launch_pair_d(const void* q, const void* k, const void* v, const void* dout,
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
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* ob = static_cast<const bf*>(dout);
  bf* dqb = static_cast<bf*>(dq);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  auto run = [&](auto kernel_launch) {
    return kernel_launch(qb, kb, vb, ob, lse, di, q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi,
                         tile_count, dq_acc, dqb, dkb, dvb, B, T, H, scale_log2, scale, dp, st);
  };
  if (D == 384) return drop ? run(launch_pair<384, true>) : run(launch_pair<384, false>);
  return drop ? run(launch_pair<512, true>) : run(launch_pair<512, false>);
}

// The kernel obt_mh_flash_bwd launches at head dim D and dtype (0 float32,
// 1 bfloat16), by name.
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

namespace {

using namespace obt;
using namespace obt::bwd;

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                   const float* cos_t, const float* sin_t, void* q_rot,
                   void* k_rot, const int* q_lo, const int* q_hi,
                   int* tile_count, float* dq_acc, void* dq, void* dk, void* dv,
                   int B, int T, int H, float scale_log2, float scale,
                   bool bf16, DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows(q, cos_t, sin_t, q_rot, B, T, H, D, bf16, st);
    q = q_rot;
  }
  if (bf16)
    return launch_bf16<D, DROP, false, true>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, di,
        q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, scale_log2,
        scale, dp, st);
  if (cos_t != nullptr) {
    launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, false, st);
    k = k_rot;
  }
  const long long n_rows = (long long)B * T * H;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, (size_t)n_rows * D * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const long long n_pairs = n_rows * (D / 2);
  e = launch_f32<D, DROP, true>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc,
      static_cast<float*>(dk), static_cast<float*>(dv), B, T, H, scale_log2,
      scale, dp, st);
  if (e != cudaSuccess) return e;
  dq_epilogue<float><<<(unsigned)((n_pairs + 255) / 256), 256, 0, st>>>(
      dq_acc, cos_t, sin_t, static_cast<float*>(dq), T, H, D, n_pairs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* q_rot,
                     void* k_rot, const int* q_lo, const int* q_hi,
                     int* tile_count, float* dq_acc, void* dq, void* dk, void* dv,
                     int B, int T, int H, float scale_log2, float scale,
                     bool bf16, bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_rot,
                                k_rot, q_lo, q_hi, tile_count, dq_acc, dq, dk, dv,
                                B, T, H, scale_log2, scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_rot,
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
// of that type, D 64, 128, 256 or a multiple of 128 past 256, T a multiple
// of 64 (fp32) or 128 (bf16); lse2 and di fp32, (B, H, T) for bf16 up to
// 256 and at 384 and 512 (the producer bulk-copies a q tile's 64 values of
// one head), else (B, T, H); q_seg and kv_seg (B, T) int32, both
// null or both given (as in obt_mh_flash_fwd). With RoPE (cos_t
// and sin_t non-null), q_rot is a scratch tensor of q's shape and type, and
// so is k_rot where lse2 is (B, T, H) (the other kernels rotate k in the
// kernel; k_rot may be null there).
// dq_acc is an fp32 scratch of q's size (zeroed here). q_lo and q_hi, both
// null or both int32 (B, T / kv tile) in units of the dtype's q tile (kv
// tile 128 (64 at D = 256) and q tile 64 for bf16, 32 and 16 for fp32, 64
// and 64 past 256), bound the q tiles
// each kv tile walks; tile_count is null or one int32 that the walked tiles
// are added to. drop != 0 applies the forward's dropout (thresh,
// keep_scale, seed as in obt_mh_flash_fwd). Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a shape or type this file
// has no kernel for). Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int obt_mh_flash_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, const void* q_seg, const void* kv_seg,
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
      ((q_lo == nullptr) != (q_hi == nullptr)) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* lo = static_cast<const int*>(q_lo);
  const int* hi = static_cast<const int*>(q_hi);
  int* tc = static_cast<int*>(tile_count);
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* qsg = static_cast<const int*>(q_seg);
  const int* kvsg = static_cast<const int*>(kv_seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 256: return (int)launch_d<256>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default:
      if (!obt::wide::head_dim_ok(D)) return (int)cudaErrorInvalidValue;
      if (dtype == 1 && pair_head_dim(D))
        return (int)launch_pair_d(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, lo, hi, tc, acc,
                                  dq, dk, dv, B, T, H, D, scale_log2, scale, drop != 0, dp, st);
      return (int)obt::wide::backward<true>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo,
                                       hi, tc, acc, dq, dk, dv, B, T, H, D, scale_log2, scale,
                                       dtype == 1, drop != 0,
                                       obt::wide::Drop{seed, thresh, keep_scale}, st);
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
  return (int)launch_bf16<128, false, true, true>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, 0.f, 0.f,
      DropParams{0, 0, 1.f}, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of the bf16 kernel takes at head dim D (-1
// for a head dim it is not built for).
extern "C" int obt_mh_flash_bwd_smem_bytes(int D) {
  return D == 64    ? (int)bf16_smem_bytes<64, true>()
         : D == 128 ? (int)bf16_smem_bytes<128, true>()
         : D == 256 ? (int)bf16_smem_bytes_256()
         : D == 384 ? (int)pair_smem_bytes<384>()
         : D == 512 ? (int)pair_smem_bytes<512>()
         : obt::wide::head_dim_ok(D) ? obt::wide::bwd_smem_bytes()
                    : -1;
}

// The name of the kernel obt_mh_flash_bwd launches at head dim D and dtype
// (0 = float32, 1 = bfloat16): "mh_bwd_fused_bf16", "mh_bwd_d256_bf16",
// "mh_bwd_pair", "mh_bwd_f32", "mh_bwd_wide", or "none".
extern "C" const char* obt_mh_flash_bwd_route(int D, int dtype) { return fused_route(D, dtype); }

extern "C" const char* obt_cuda_error_string_bwd(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
