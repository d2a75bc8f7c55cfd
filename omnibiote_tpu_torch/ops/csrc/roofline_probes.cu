// Roofline probes for Hopper (sm_90a): the products of the flash attention
// kernels with the same CTA tiles, cp.async ring and ldmatrix / mma.sync
// fragments as the kernels they measure, but without softmax, mask or
// dropout. bf16 in and out, fp32 accumulation, head dim 128.
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
// Design: each probe copies the CTA of its flash counterpart, so its time
// is what the products reach under that kernel's tiling and data movement.
//   * dots_bf16 is mh_fwd_bf16 (mh_flash_fwd.cu) without the softmax: one
//     block of BQ / 16 warps per (b, h, BQ-row q tile), q fragments
//     resident in registers, 64-wide K and V tiles through a two-stage
//     cp.async ring, S kept in registers and, rounded to bf16, reused as
//     the A operand of S.V (ldmatrix.trans for V). With KT the K tile
//     arrives as [head dim][kv] rows, so the score operand takes the
//     transposing ldmatrix and V's roles swap: the port's counterpart of
//     the TPU probe's pre-transposed k.
//   * dots_n_bf16 is the dkv kernel (mh_flash_bwd_kernels.cuh, WITH_DQ =
//     false): a block owns BR output rows r of a (b, h, q tile), keeps its
//     accumulator in fp32 registers, holds the K and V rows r of one kv tile
//     in shared memory and walks the q tile's rows i in 32-row chunks
//     through the ring: S^T and the second score product as two
//     accumulators, then S^T.Q (and S^T.V) with the transposing ldmatrix.
//     The kv tiles follow one another, each reloading its K and V rows.
//   * scores_bf16 is mh_fwd_bf16's score product summed over heads: a block
//     owns (b, BQ-row q tile, 64 output columns) and walks the heads, the Q
//     tile and the K tile of each head through the ring.
// BQ / BR (the CTA's q-tile height) is a template argument, 64 (#1's tile)
// or 128: the port's counterpart of the TPU probes' block sweep.
//
// Bound. At the probes' shape (B=8, T=1024, H=8, bf16) dots does
// 4*B*T^2*H*D = 34.4 GFLOP (34.7 us at 989 TFLOP/s) on 67 MB (20 us at
// 3.35 TB/s); dots_n 1.5x or 2x that; scores 2*B*T*(H*D)^2 = 17.2 GFLOP
// (17.4 us) on 50 MB (15 us): all bound by operations. mma.sync, not
// wgmma: making these fast is the work the probes are here to measure.
#include "flash_common.cuh"

namespace {

using namespace obt;
using bf16 = __nv_bfloat16;

constexpr int D = 128;        // head dim of the probes
constexpr int RS = D + 8;     // row stride of a [row][D] tile (elements), padded
constexpr int CH = D / 8;     // 16-byte chunks of a row
constexpr int NK = D / 16;    // k-steps over the head dim
constexpr int NN = D / 8;     // n-tiles over the head dim
constexpr int KV = 64;        // kv tile (mh_fwd_bf16's)
constexpr int KTS = KV + 8;   // row stride of a [D][KV] (pre-transposed k) tile
constexpr int NS = KV / 8;    // n-tiles of a score tile
constexpr int BI = 32;        // q rows a step of dots_n (the dkv kernel's q tile)

// elements of a K tile: [KV][RS], or [D][KTS] pre-transposed
template <bool KT>
constexpr int kTileElems = KT ? D * KTS : KV * RS;

// ROWS rows of D elements, src[row * rs], into dst[row * RS]: 16 bytes a
// thread a step
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t rs, int tid) {
  for (int it = tid; it < ROWS * CH; it += NT) {
    const int row = it / CH, c8 = (it % CH) * 8;
    cp_async16(dst + row * RS + c8, src + row * rs + c8);
  }
}

// the K tile of head h, kv rows j0 .. j0 + KV - 1: [KV][RS] from k
// (B, T, H*D), or with KT [D][KTS] from k (B, H*D, T)
template <bool KT, int NT>
__device__ __forceinline__ void load_k_tile(bf16* dst, const bf16* k, int b, int h, int j0,
                                            int T, int H, int tid) {
  if constexpr (KT) {
    const bf16* src = k + ((size_t)b * H * D + (size_t)h * D) * T + j0;
    for (int it = tid; it < D * (KV / 8); it += NT) {
      const int row = it / (KV / 8), c8 = (it % (KV / 8)) * 8;
      cp_async16(dst + row * KTS + c8, src + (size_t)row * T + c8);
    }
  } else {
    const size_t rs = (size_t)H * D;
    load_rows<KV, NT>(dst, k + ((size_t)b * T + j0) * rs + (size_t)h * D, rs, tid);
  }
}

// s (a warp's 16 rows x KV columns, fp32) += q . k^T, q as A fragments
template <bool KT>
__device__ __forceinline__ void score_tile(float (&s)[NS][4], const uint32_t (&qa)[NK][4],
                                           const bf16* kt, int lane) {
  if constexpr (KT) {
    // [d][j] rows: one ldmatrix.x4.trans gives the B fragments of two
    // n-tiles of one k-step
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KTS
                                  + np * 16 + (lane >> 4) * 8);
        mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
  } else {
    // [j][d] rows: one ldmatrix.x4 gives the B fragments of two k-steps of
    // one n-tile
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (j * 8 + (lane & 7)) * RS + p * 32 + (lane >> 3) * 8);
        mma_bf16(s[j], qa[2 * p], bf[0], bf[1]);
        mma_bf16(s[j], qa[2 * p + 1], bf[2], bf[3]);
      }
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
// #10 / #12: mh_fwd_bf16 without the softmax
// ---------------------------------------------------------------------------
template <bool KT>
constexpr size_t dots_smem_bytes() {
  return 2 * (kTileElems<KT> + KV * RS) * sizeof(bf16);
}

template <int BQ, bool KT>
__global__ void __launch_bounds__(2 * BQ) dots_bf16(const bf16* __restrict__ q,
                                                    const bf16* __restrict__ k,
                                                    const bf16* __restrict__ v,
                                                    bf16* __restrict__ o, int T, int H) {
  constexpr int NT = 2 * BQ;  // BQ / 16 warps
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][K tile]
  bf16* vs = ks + 2 * kTileElems<KT>;    // [2][KV][RS]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8

  auto load_tile = [&](int st, int j0) {
    load_k_tile<KT, NT>(ks + st * kTileElems<KT>, k, b, h, j0, T, H, tid);
    load_rows<KV, NT>(vs + st * KV * RS, v + base + (size_t)j0 * rs, rs, tid);
  };
  const int n_kv = T / KV;
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + ((r & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t4 + ((r & 2) ? 8 : 0);
      qa[kk][r] = *reinterpret_cast<const uint32_t*>(q + base + (size_t)row * rs + col);
    }
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int jt = 0; jt < n_kv; ++jt) {
    const int st = jt & 1;
    // the other stage was last read in the previous iteration, which ended
    // in a barrier: refill it with the next tile while this one is used
    if (jt + 1 < n_kv) load_tile(st ^ 1, (jt + 1) * KV);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    score_tile<KT>(s, qa, ks + st * kTileElems<KT>, lane);
    // acc += S (bf16, straight from the score fragments) . V
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_rows(acc, pa, vs + st * KV * RS, kk, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }
  store_rows(o + base + (size_t)r0 * rs, rs, acc, t4);
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
// #13: mh_fwd_bf16's score product, summed over heads
// ---------------------------------------------------------------------------
template <int BQ, bool KT>
constexpr size_t scores_smem_bytes() {
  return 2 * (BQ * RS + kTileElems<KT>) * sizeof(bf16);
}

template <int BQ, bool KT>
__global__ void __launch_bounds__(2 * BQ) scores_bf16(const bf16* __restrict__ q,
                                                      const bf16* __restrict__ k,
                                                      bf16* __restrict__ o, int T, int H,
                                                      int j_last) {
  constexpr int NT = 2 * BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [2][BQ][RS]
  bf16* Ks = Qs + 2 * BQ * RS;               // [2][K tile]

  const int c0 = blockIdx.x * KV, i0 = blockIdx.y * BQ, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;

  auto load_head = [&](int st, int h) {
    load_rows<BQ, NT>(Qs + st * BQ * RS, q + ((size_t)b * T + i0) * rs + (size_t)h * D, rs, tid);
    load_k_tile<KT, NT>(Ks + st * kTileElems<KT>, k, b, h, j_last + c0, T, H, tid);
  };
  load_head(0, 0);
  cp_async_commit();

  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int h = 0; h < H; ++h) {
    const int st = h & 1;
    if (h + 1 < H) load_head(st ^ 1, h + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    uint32_t qa[NK][4];
    const bf16* Qt = Qs + st * BQ * RS;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldmatrix_x4(qa[kk], Qt + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
    score_tile<KT>(s, qa, Ks + st * kTileElems<KT>, lane);
    __syncthreads();
  }
  store_rows(o + ((size_t)b * T + i0 + warp * 16 + g) * rs + c0, rs, s, t4);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int BQ, bool KT>
cudaError_t dots(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H,
                 cudaStream_t st) {
  return launch(dots_bf16<BQ, KT>, dim3(T / BQ, H, B), 2 * BQ, dots_smem_bytes<KT>(), st,
                q, k, v, o, T, H);
}

template <int BR, bool V4>
cudaError_t dots_n(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H,
                   int block_q, int block_kv, cudaStream_t st) {
  return launch(dots_n_bf16<BR, V4>, dim3(T / BR, H, B), 2 * BR, dots_n_smem_bytes<BR, V4>(),
                st, q, k, v, o, T, H, block_q, block_kv);
}

template <int BQ, bool KT>
cudaError_t scores(const bf16* q, const bf16* k, bf16* o, int B, int T, int H, int j_last,
                   cudaStream_t st) {
  return launch(scores_bf16<BQ, KT>, dim3(H * D / KV, T / BQ, B), 2 * BQ,
                scores_smem_bytes<BQ, KT>(), st, q, k, o, T, H, j_last);
}

bool shape_ok(int B, int T, int H, int D_, int cta_q) {
  return D_ == D && (cta_q == 64 || cta_q == 128) && T >= cta_q && T % cta_q == 0 &&
         T % KV == 0 && B >= 1 && B <= 65535 && H >= 1 && H <= 65535;
}

}  // namespace

// The C entries: q, k, v, o bf16, (B, T, H, D) row-major, except k with kt,
// (B, H*D, T); D = 128; cta_q (64 or 128) the kernel's q-tile height. Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or argument it has no kernel for), launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int obt_roofline_dots(const void* q, const void* k, const void* v, void* o, int B,
                                 int T, int H, int D_, int kt, int cta_q, void* stream) {
  if (!shape_ok(B, T, H, D_, cta_q)) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cta_q == 64)
    return (int)(kt ? dots<64, true>(qb, kb, vb, ob, B, T, H, st)
                    : dots<64, false>(qb, kb, vb, ob, B, T, H, st));
  return (int)(kt ? dots<128, true>(qb, kb, vb, ob, B, T, H, st)
                  : dots<128, false>(qb, kb, vb, ob, B, T, H, st));
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

// block_kv divides T, is at least H*D and a multiple of 8 (16-byte rows of
// a pre-transposed k): the output is the last kv tile's first H*D score
// columns.
extern "C" int obt_roofline_scores(const void* q, const void* k, void* o, int B, int T, int H,
                                   int D_, int block_kv, int kt, int cta_q, void* stream) {
  if (!shape_ok(B, T, H, D_, cta_q) || block_kv < H * D || T % block_kv != 0 ||
      block_kv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int j_last = T - block_kv;
  if (cta_q == 64)
    return (int)(kt ? scores<64, true>(qb, kb, ob, B, T, H, j_last, st)
                    : scores<64, false>(qb, kb, ob, B, T, H, j_last, st));
  return (int)(kt ? scores<128, true>(qb, kb, ob, B, T, H, j_last, st)
                  : scores<128, false>(qb, kb, ob, B, T, H, j_last, st));
}

extern "C" const char* obt_cuda_error_string_roofline(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
