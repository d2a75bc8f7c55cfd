// Multi-head flash attention at head dims past 256 (D % 128 == 0, D > 256)
// for Hopper (sm_90a): the forward, the fused backward (single-kv and
// multi-kv), the split pair's dkv and dq kernels, in bf16 and fp32. Each
// computes what the kernel of its library computes at D <= 256 (see
// mh_flash_fwd.cu, mh_flash_bwd.cu, mh_flash_bwd_dkv.cu and
// mh_flash_bwd_dq.cu for the TPU kernels they replace and the rounding
// points), and the libraries take these kernels at such a D, but for the
// Hopper kernels at D = 384 and 512 in bf16: the forward
// (mh_flash_fwd.cu::mh_fwd_wide_wgmma, the scores' reduction split between
// two consumer warpgroups) and the backwards (mh_flash_bwd_pair.cuh: the
// fused kernel and the split pair's dkv kernel mh_bwd_pair, a thread-block
// cluster a kv tile, each CTA a part of the head dim, the partial scores
// summed through distributed shared memory; the dq kernel mh_bwd_dq_cta, a
// CTA a q tile with all D lanes), all wgmma from TMA rings. So the kernels here serve fp32
// at every D past 256 and bf16 past 512.
//
// Why a design of its own. The D <= 256 kernels hold whole-D tiles in shared
// memory and a 64-row output accumulator of D fp32 a thread beside the
// scores. At D = 512 a 128-row q tile is 128 KB alone, and a 64 x 512 fp32
// accumulator is 256 registers a thread, past the 255 a thread may hold.
//
// Design: the output's head dim is sliced. A CTA owns one slice of 128
// output lanes, the lanes [64 c, 64 c + 64) and [D/2 + 64 c, D/2 + 64 c + 64)
// of slice c (D / 128 slices), and the grid has a slice axis. Rotate-half
// pairs lane i with i + D/2, so each slice is closed under the rotation:
// the inverse RoPE of dq and dk stays inside the CTA (lanes L and L ^ 64 of
// a slice are one thread's accumulators 8 columns blocks apart). The
// products that sum over the whole head dim, S = q.k^T and (backward)
// dP = do.v^T, stream 64-column panels of their operands through a
// cp.async ring of shared-memory tiles and are recomputed by every slice
// CTA; P.V, dV, dK and dQ touch only the CTA's slice. A slice CTA does the
// same products in the same order as every other, so m, l and lse2 are the
// same bits in all of them (slice 0 writes lse2), and every slice redraws
// the same Philox keep bits from (seed, b, h, i, j). Skip bounds are per
// (q tile, kv tile), not per slice; tile_count counts slice 0's walk, the
// tiles of the (q, kv) plane. The recompute: at D = 512 the forward does
// (4 + 1) / 2 = 2.5x the function's products, the backward (2 * 4 + 3) / 5
// = 2.2x.
//
// Products: bf16 by mma.sync m16n8k16 (fp32 accumulators) on fragments
// loaded by ldmatrix from padded shared-memory rows (no bank conflicts);
// fp32, the parity type, by the CUDA cores on the same fragment layout
// (g = lane / 4, t = lane % 4: rows g and g + 8 of a warp's 16, columns
// 8 n + 2 t and + 1 of each 8-column block n). q and k are rotated once a
// call, ahead of the kernels, into scratch tensors (flash_common.cuh::
// rope_rows), and the fused kernel's dq is cast from its fp32 sums by
// flash_common.cuh::dq_epilogue.
//
// Tiles: 64 q rows and 64 kv rows in every kernel and dtype
// (ops/flash_attention.py::kernel_tiles at D > 256: KERNEL_TILES_SLICED,
// and KERNEL_TILES_WIDE but for the bf16 forward). These are first-cut
// kernels, right before fast: no TMA, no wgmma, no warp specialisation.
#pragma once
#include <atomic>

#include "flash_common.cuh"
#include "philox.cuh"

namespace obt {
namespace wide {
// internal linkage: every library that includes this header keeps its own
// kernels and its own launch state (the shared-memory attribute's flag)
namespace {

constexpr int kTile = 64;    // q tile and kv tile rows
constexpr int kSlice = 128;  // output lanes a CTA owns
constexpr int kPanel = 64;   // columns of a streamed panel of q, k, v or do

// A head dim these kernels take.
__host__ __device__ constexpr bool head_dim_ok(int D) { return D > 256 && D % kSlice == 0; }

struct Drop {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

// Shared-memory geometry of element type E: rows padded by 16 bytes, so the
// eight 16-byte rows an ldmatrix reads (and the fp32 products' column
// reads) fall in distinct banks.
template <typename E>
struct Geo {
  static constexpr int V = 16 / sizeof(E);                 // elements of a 16-byte copy
  static constexpr int LD = kPanel + V;                    // a 64-column tile's row stride
  static constexpr int LDS = kSlice + V;                   // a 128-lane slice tile's row stride
  static constexpr int TILE = kTile * LD;                  // elements of a 64 x 64 tile
  static constexpr int STILE = kTile * LDS;                // elements of a 64 x 128 slice tile
};

// head-dim index of lane L of slice c
__device__ __forceinline__ int slice_dim(int c, int D, int L) {
  return L < 64 ? 64 * c + L : D / 2 + 64 * c + (L - 64);
}

// ---------------------------------------------------------------------------
// ldmatrix, mma.sync (cp.async: hopper.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r of a (rows x C) tile at dst (row stride ld elements) from src +
// r * src_ld, as 16-byte cp.async copies spread over n_threads threads.
template <typename E, int ROWS, int C>
__device__ __forceinline__ void load_tile(E* dst, int ld, const E* src, size_t src_ld, int tid,
                                          int n_threads) {
  constexpr int V = 16 / sizeof(E), PER_ROW = C / V;
  for (int it = tid; it < ROWS * PER_ROW; it += n_threads) {
    const int r = it / PER_ROW, c = (it % PER_ROW) * V;
    cp_async16(dst + r * ld + c, src + (size_t)r * src_ld + c);
  }
}

// The 128 lanes of slice c of 64 rows (row stride rs) into a slice tile.
template <typename E>
__device__ __forceinline__ void load_slice(E* dst, const E* rows, size_t rs, int c, int D,
                                           int tid, int n_threads) {
  load_tile<E, kTile, 64>(dst, Geo<E>::LDS, rows + 64 * c, rs, tid, n_threads);
  load_tile<E, kTile, 64>(dst + 64, Geo<E>::LDS, rows + D / 2 + 64 * c, rs, tid, n_threads);
}

// One warp: C[16 x 8 NB] += A[16 x K] . B[K x 8 NB], both in shared memory.
// A_T: element (m, k) of A at a[k * lda + m], else a[m * lda + k]; B_T:
// element (k, n) of B at b[k * ldb + n], else b[n * ldb + k]. c holds the
// mma.sync C fragments of the 8-column blocks.
template <int NB, int K, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (*c)[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int lane) {
  static_assert(NB % 2 == 0 && K % 16 == 0, "whole fragments");
  const int l8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if constexpr (!A_T) {
      ldsm_x4(af, a + (lane & 15) * lda + k0 + (lane >> 4) * 8);
    } else {
      ldsm_x4_t(af, a + (k0 + (mi >> 1) * 8 + l8) * lda + (mi & 1) * 8);
    }
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      if constexpr (!B_T) {
        ldsm_x4(bf, b + (nb * 8 + (mi >> 1) * 8 + l8) * ldb + k0 + (mi & 1) * 8);
      } else {
        ldsm_x4_t(bf, b + (k0 + (mi & 1) * 8 + l8) * ldb + nb * 8 + (mi >> 1) * 8);
      }
      mma_bf16(c[nb], af, bf[0], bf[1]);
      mma_bf16(c[nb + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NB, int K, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (*c)[4], const float* a, int lda, const float* b,
                                         int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A_T ? a[k * lda + g] : a[g * lda + k];
    const float a1 = A_T ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = nb * 8 + 2 * t;
      const float b0 = B_T ? b[k * ldb + n] : b[n * ldb + k];
      const float b1 = B_T ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
      c[nb][0] = fmaf(a0, b0, c[nb][0]);
      c[nb][1] = fmaf(a0, b1, c[nb][1]);
      c[nb][2] = fmaf(a1, b0, c[nb][2]);
      c[nb][3] = fmaf(a1, b1, c[nb][3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Keep bits of a thread's fragment elements, bit e for element e (rows r0
// and r0 + 8 of the fragment, columns j and j + 1, j even): rows are q
// rows and columns kv columns (the forward and the dq kernel). One Philox
// call covers a 2 x 2 block; lanes g and g ^ 1 hold rows r0 and r0 ^ 1, so
// the even lane draws the block of r0, r0 + 1, the odd one that of
// r0 + 7, r0 + 8, and each hands the partner its words.
__device__ __forceinline__ uint32_t keep_rows(const Drop& dp, int bh, int r0, int j, bool odd) {
  const Philox4 u = dropout_bits(dp.seed, bh, odd ? r0 + 8 : r0, j);
  const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[2], 4);
  const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[1] : u.w[3], 4);
  const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[1];  // row r0
  const uint32_t c0 = odd ? u.w[2] : y0, c1 = odd ? u.w[3] : y1;  // row r0 + 8
  return (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
         (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
}

// The same where the fragment's rows are kv rows r0, r0 + 8 and its
// columns q rows i, i + 1 (the backward's transposed scores).
__device__ __forceinline__ uint32_t keep_cols(const Drop& dp, int bh, int i, int r0, bool odd) {
  const Philox4 u = dropout_bits(dp.seed, bh, i, odd ? r0 + 8 : r0);
  const uint32_t y0 = __shfl_xor_sync(0xffffffffu, odd ? u.w[0] : u.w[1], 4);
  const uint32_t y1 = __shfl_xor_sync(0xffffffffu, odd ? u.w[2] : u.w[3], 4);
  const uint32_t a0 = odd ? y0 : u.w[0], a1 = odd ? y1 : u.w[2];  // kv row r0
  const uint32_t c0 = odd ? u.w[1] : y0, c1 = odd ? u.w[3] : y1;  // kv row r0 + 8
  return (uint32_t)(a0 >= dp.thresh) | (uint32_t)(a1 >= dp.thresh) << 1 |
         (uint32_t)(c0 >= dp.thresh) << 2 | (uint32_t)(c1 >= dp.thresh) << 3;
}

// Sets the instance's dynamic shared-memory limit at its first launch on
// each device (the limit belongs to the instance on a device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// ---------------------------------------------------------------------------
// Forward. A CTA owns 64 q rows of one (batch, head) and one slice; 4 warps
// of 16 q rows. Per kv tile: S (16 x 64 a warp) summed over D / 64 panels
// of q and k (a two-stage cp.async ring), the masked scores, online softmax
// and dropout on S's registers, P rounded into the warp's rows of a
// shared tile, acc (16 x 128) += P . V_slice.
// ---------------------------------------------------------------------------
constexpr int kFwdThreads = 128;

template <typename E>
struct FwdSmem {
  E qp[2][Geo<E>::TILE];
  E kp[2][Geo<E>::TILE];
  E vs[Geo<E>::STILE];
  E ps[Geo<E>::TILE];
  int kseg[kTile];
};

template <typename E, bool DROP>
__global__ void __launch_bounds__(kFwdThreads) mh_fwd_wide(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi, int* __restrict__ tile_count,
    E* __restrict__ o, float* __restrict__ lse, int T, int H, int D, float scale_log2, Drop dp) {
  using G = Geo<E>;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  FwdSmem<E>& sm = *reinterpret_cast<FwdSmem<E>*>(wide_smem);
  const int n_slices = D / kSlice, n_panels = D / kPanel;
  const int c = blockIdx.x % n_slices, qt = blockIdx.x / n_slices, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const E* qrows = q + base + (size_t)qt * kTile * rs;
  int jt0 = 0, jt1 = T / kTile - 1;
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / kTile) + qt];
    jt1 = kv_hi[b * (T / kTile) + qt];
  }
  const int n_tiles = jt1 - jt0 + 1, n_steps = n_tiles * n_panels;
  if (tile_count != nullptr && c == 0 && tid == 0) atomicAdd(tile_count, n_tiles);
  const int r0 = qt * kTile + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int qs0 = q_seg ? q_seg[(size_t)b * T + r0] : 0;
  const int qs1 = q_seg ? q_seg[(size_t)b * T + r0 + 8] : 0;
  const bool odd = g & 1;
  const int bh = b * H + h;

  // panel p of kv tile it: step s = it * n_panels + p, ring stage s % 2
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int it = s / n_panels, p = s % n_panels;
      load_tile<E, kTile, kPanel>(sm.qp[s & 1], G::LD, qrows + p * kPanel, rs, tid, kFwdThreads);
      load_tile<E, kTile, kPanel>(sm.kp[s & 1], G::LD,
                                  k + base + (size_t)(jt0 + it) * kTile * rs + p * kPanel, rs,
                                  tid, kFwdThreads);
    }
    cp_async_commit();
  };

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[16][4], s[8][4];
  zero<16>(acc);
  issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int jt = jt0 + it;
    const size_t kvrow = (size_t)jt * kTile;
    load_slice(sm.vs, v + base + kvrow * rs, rs, c, D, tid, kFwdThreads);
    if (kv_seg != nullptr && tid < kTile / 4)
      cp_async16(sm.kseg + 4 * tid, kv_seg + (size_t)b * T + kvrow + 4 * tid);
    cp_async_commit();
    zero<8>(s);
    for (int p = 0; p < n_panels; ++p) {
      const int st = it * n_panels + p;
      issue(st + 1);
      cp_async_wait<1>();
      __syncthreads();
      warp_mma<8, kPanel, false, false>(s, sm.qp[st & 1] + warp * 16 * G::LD, G::LD,
                                        sm.kp[st & 1], G::LD, lane);
      __syncthreads();
    }
    // masked log2-space scores, online softmax, dropout
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t4;
      const int ks0 = kv_seg ? sm.kseg[col] : 0, ks1 = kv_seg ? sm.kseg[col + 1] : 0;
      s[n][0] = score(s[n][0], scale_log2, qs0, ks0);
      s[n][1] = score(s[n][1], scale_log2, qs0, ks1);
      s[n][2] = score(s[n][2], scale_log2, qs1, ks0);
      s[n][3] = score(s[n][3], scale_log2, qs1, ks1);
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
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
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = alpha0 * l0 + rs0;  // per-thread partial sums, reduced at the end
    l1 = alpha1 * l1 + rs1;
    E* prow = sm.ps + (warp * 16 + g) * G::LD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if constexpr (DROP) {
        const uint32_t kp = keep_rows(dp, bh, r0, (int)kvrow + col, odd);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = (kp >> e) & 1 ? s[n][e] * dp.keep_scale : 0.f;
      }
      store2(prow + col, s[n][0], s[n][1]);
      store2(prow + 8 * G::LD + col, s[n][2], s[n][3]);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    __syncwarp();
    warp_mma<16, kTile, false, true>(acc, sm.ps + warp * 16 * G::LD, G::LD, sm.vs, G::LDS, lane);
    __syncthreads();  // vs, kseg and ps are refilled for the next tile
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  if (c == 0 && t4 == 0) {
    lse[((size_t)b * T + r0) * H + h] = m0 + log2f(l0);
    lse[((size_t)b * T + r0 + 8) * H + h] = m1 + log2f(l1);
  }
  E* o0 = o + base + (size_t)r0 * rs;
  E* o1 = o0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int d = slice_dim(c, D, n * 8 + 2 * t4);
    store2(o0 + d, acc[n][0] * inv0, acc[n][1] * inv0);
    store2(o1 + d, acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// q and k already rotated; lse (B, T, H); kv_lo / kv_hi per (b, 64-row q
// tile) in 64-row kv tiles, or null.
template <typename E, bool DROP>
cudaError_t launch_fwd_wide(const E* q, const E* k, const E* v, const int* q_seg,
                            const int* kv_seg, const int* kv_lo, const int* kv_hi,
                            int* tile_count, E* o, float* lse, int B, int T, int H, int D,
                            float scale_log2, Drop dp, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = sizeof(FwdSmem<E>);
  cudaError_t e = allow_smem(mh_fwd_wide<E, DROP>, smem, smem_set);
  if (e != cudaSuccess) return e;
  mh_fwd_wide<E, DROP><<<dim3((T / kTile) * (D / kSlice), H, B), kFwdThreads, smem, st>>>(
      q, k, v, q_seg, kv_seg, kv_lo, kv_hi, tile_count, o, lse, T, H, D, scale_log2, dp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, fused (WITH_DQ) or the split pair's dkv kernel. A CTA owns 64
// kv rows of one (batch, head) and one slice and walks 64-row q tiles; 8
// warps. Warps 0-3 form S^T (16 kv rows x 64 q a warp) summed over D / 64
// panels of k and q, warps 4-7 dP^T over panels of v and do, from one
// cp.async ring of four panels a step (two stages in bf16, one in fp32,
// whose stages pass the 227 KB). Warp w + 4 hands its dP^T to warp w
// through shared memory in its own fragment order; warp w forms p, the
// keep bits, p_drop and ds, and writes P_drop^T and dS^T rounded into
// shared tiles. Then warps 0-3 add P_drop^T . dO_slice into dV and warps
// 4-7 dS^T . Q_slice into dK (16 kv rows x 128 lanes each, in registers),
// and with WITH_DQ all 8 warps form the q tile's dQ_slice = dS . K_slice
// (16 q rows x 64 lanes a warp) and add it into the fp32 scratch by
// atomics (the order of those sums changes from run to run).
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;

template <typename E>
struct BwdSmem {
  static constexpr int S = sizeof(E) == 2 ? 2 : 1;  // ring stages
  E kp[S][Geo<E>::TILE];
  E qp[S][Geo<E>::TILE];
  E vp[S][Geo<E>::TILE];
  E dop[S][Geo<E>::TILE];
  E ks[Geo<E>::STILE];   // K_slice of the CTA's kv rows (dQ's B)
  E qs[Geo<E>::STILE];   // Q_slice of the q tile (dK's B)
  E dos[Geo<E>::STILE];  // dO_slice of the q tile (dV's B)
  E pt[Geo<E>::TILE];    // P_drop^T (kv rows x q columns)
  E dst[Geo<E>::TILE];   // dS^T
  float xch[4][32][32];  // dP^T from warp w + 4 to warp w, in fragment order
  float lse_s[kTile], di_s[kTile];
  int qseg_s[kTile];
};

template <typename E, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(kBwdThreads) mh_bwd_wide(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ q_lo, const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, E* __restrict__ dk, E* __restrict__ dv, int T, int H, int D,
    float scale_log2, float scale, Drop dp) {
  using G = Geo<E>;
  using Smem = BwdSmem<E>;
  constexpr int S = Smem::S;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(wide_smem);
  const int n_slices = D / kSlice, n_panels = D / kPanel;
  const int c = blockIdx.x % n_slices, kt = blockIdx.x / n_slices, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int w4 = warp & 3;
  const bool s_warp = warp < 4;  // S^T and dV; else dP^T and dK
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const size_t kvrow0 = (size_t)kt * kTile;
  int qt0 = 0, qt1 = T / kTile - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / kTile) + kt];
    qt1 = q_hi[b * (T / kTile) + kt];
  }
  const int n_tiles = qt1 - qt0 + 1, n_steps = n_tiles * n_panels;
  if (tile_count != nullptr && c == 0 && tid == 0) atomicAdd(tile_count, n_tiles);
  const int r0 = (int)kvrow0 + w4 * 16 + g;  // this thread's kv rows r0 and r0 + 8
  const int ks0 = kv_seg ? kv_seg[(size_t)b * T + r0] : 0;
  const int ks1 = kv_seg ? kv_seg[(size_t)b * T + r0 + 8] : 0;
  const bool odd = g & 1;
  const int bh = b * H + h;

  auto issue = [&](int s) {
    if (s < n_steps) {
      const int it = s / n_panels, p = s % n_panels, st = s % S;
      const size_t qrow = (size_t)(qt0 + it) * kTile;
      const size_t col = p * kPanel;
      load_tile<E, kTile, kPanel>(sm.kp[st], G::LD, k + base + kvrow0 * rs + col, rs, tid,
                                  kBwdThreads);
      load_tile<E, kTile, kPanel>(sm.qp[st], G::LD, q + base + qrow * rs + col, rs, tid,
                                  kBwdThreads);
      load_tile<E, kTile, kPanel>(sm.vp[st], G::LD, v + base + kvrow0 * rs + col, rs, tid,
                                  kBwdThreads);
      load_tile<E, kTile, kPanel>(sm.dop[st], G::LD, dout + base + qrow * rs + col, rs, tid,
                                  kBwdThreads);
    }
    cp_async_commit();
  };

  float acc[16][4], x[8][4];  // dV (warps 0-3) or dK (warps 4-7); S^T or dP^T
  zero<16>(acc);
  if constexpr (WITH_DQ) load_slice(sm.ks, k + base + kvrow0 * rs, rs, c, D, tid, kBwdThreads);
  issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    const size_t qrow = (size_t)(qt0 + it) * kTile;
    load_slice(sm.qs, q + base + qrow * rs, rs, c, D, tid, kBwdThreads);
    load_slice(sm.dos, dout + base + qrow * rs, rs, c, D, tid, kBwdThreads);
    cp_async_commit();
    if (tid < kTile) {
      const size_t row = (size_t)b * T + qrow + tid;
      sm.lse_s[tid] = lse[row * H + h];
      sm.di_s[tid] = di[row * H + h];
      sm.qseg_s[tid] = q_seg ? q_seg[row] : 0;
    }
    zero<8>(x);
    for (int p = 0; p < n_panels; ++p) {
      const int st = it * n_panels + p;
      if constexpr (S == 2) {
        issue(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (s_warp) {
        warp_mma<8, kPanel, false, false>(x, sm.kp[st % S] + w4 * 16 * G::LD, G::LD,
                                          sm.qp[st % S], G::LD, lane);
      } else {
        warp_mma<8, kPanel, false, false>(x, sm.vp[st % S] + w4 * 16 * G::LD, G::LD,
                                          sm.dop[st % S], G::LD, lane);
      }
      __syncthreads();
      if constexpr (S == 1) issue(st + 1);
    }
    if (!s_warp) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.xch[w4][4 * n + e][lane] = x[n][e];
    }
    __syncthreads();
    if (s_warp) {
      E* prow = sm.pt + (w4 * 16 + g) * G::LD;
      E* drow = sm.dst + (w4 * 16 + g) * G::LD;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t4;
        uint32_t kp = 0xfu;
        if constexpr (DROP) kp = keep_cols(dp, bh, (int)qrow + col, r0, odd);
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + (e & 1);
          const float pv = exp2f(score(x[n][e], scale_log2, sm.qseg_s[cc], e < 2 ? ks0 : ks1) -
                                 sm.lse_s[cc]);
          float dpv = sm.xch[w4][4 * n + e][lane];
          if constexpr (DROP) {
            const bool keep = (kp >> e) & 1;
            pd[e] = keep ? pv * dp.keep_scale : 0.f;
            dpv = keep ? dpv * dp.keep_scale : 0.f;
          } else {
            pd[e] = pv;
          }
          ds[e] = pv * (dpv - sm.di_s[cc]) * scale;
        }
        store2(prow + col, pd[0], pd[1]);
        store2(prow + 8 * G::LD + col, pd[2], pd[3]);
        store2(drow + col, ds[0], ds[1]);
        store2(drow + 8 * G::LD + col, ds[2], ds[3]);
      }
    }
    __syncthreads();
    if (s_warp) {
      warp_mma<16, kTile, false, true>(acc, sm.pt + w4 * 16 * G::LD, G::LD, sm.dos, G::LDS, lane);
    } else {
      warp_mma<16, kTile, false, true>(acc, sm.dst + w4 * 16 * G::LD, G::LD, sm.qs, G::LDS, lane);
    }
    if constexpr (WITH_DQ) {
      // dQ_slice rows 16 w4.., lanes 64 (warp / 4).. of the q tile
      float dq[8][4];
      zero<8>(dq);
      const int half = warp >> 2;
      warp_mma<8, kTile, true, true>(dq, sm.dst + w4 * 16, G::LD, sm.ks + half * 64, G::LDS,
                                     lane);
      float* row0 = dq_acc + base + (qrow + w4 * 16 + g) * rs;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = slice_dim(c, D, half * 64 + n * 8 + 2 * t4);
        atomicAdd(row0 + d, dq[n][0]);
        atomicAdd(row0 + d + 1, dq[n][1]);
        atomicAdd(row0 + 8 * rs + d, dq[n][2]);
        atomicAdd(row0 + 8 * rs + d + 1, dq[n][3]);
      }
    }
    __syncthreads();  // qs, dos, pt, dst and the q tile's rows are refilled
  }
  cp_async_wait<0>();

  // dV as it is; dK through the inverse rotation (lanes L and L + 64 of the
  // slice are blocks n and n + 8 of this thread) before the cast
  E* out = s_warp ? dv : dk;
  const int rows[2] = {r0, r0 + 8};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    E* orow = out + base + (size_t)rows[hf] * rs;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int L = n * 8 + 2 * t4;
      float lo0 = acc[n][2 * hf], lo1 = acc[n][2 * hf + 1];
      float hi0 = acc[n + 8][2 * hf], hi1 = acc[n + 8][2 * hf + 1];
      if (!s_warp && cos_t != nullptr) {
        const size_t ti = (size_t)rows[hf] * (D / 2) + 64 * c + L;
        const float c0 = cos_t[ti], c1 = cos_t[ti + 1], s0 = sin_t[ti], s1 = sin_t[ti + 1];
        const float a0 = rope_inv_lo(lo0, hi0, c0, s0), a1 = rope_inv_lo(lo1, hi1, c1, s1);
        hi0 = rope_inv_hi(lo0, hi0, c0, s0);
        hi1 = rope_inv_hi(lo1, hi1, c1, s1);
        lo0 = a0;
        lo1 = a1;
      }
      store2(orow + slice_dim(c, D, L), lo0, lo1);
      store2(orow + slice_dim(c, D, L + 64), hi0, hi1);
    }
  }
}

// q and k already rotated; lse and di (B, T, H); q_lo / q_hi per (b, 64-row
// kv tile) in 64-row q tiles, or null. WITH_DQ: dq_acc (q's size, fp32) is
// zeroed here and dq formed from it.
template <typename E, bool DROP, bool WITH_DQ>
cudaError_t launch_bwd_wide(const E* q, const E* k, const E* v, const E* dout, const float* lse,
                            const float* di, const int* q_seg, const int* kv_seg,
                            const float* cos_t, const float* sin_t, const int* q_lo,
                            const int* q_hi, int* tile_count, float* dq_acc, E* dq, E* dk, E* dv,
                            int B, int T, int H, int D, float scale_log2, float scale, Drop dp,
                            cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = sizeof(BwdSmem<E>);
  cudaError_t e = allow_smem(mh_bwd_wide<E, DROP, WITH_DQ>, smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * T * H * D;
  if constexpr (WITH_DQ) {
    e = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
    if (e != cudaSuccess) return e;
  }
  mh_bwd_wide<E, DROP, WITH_DQ><<<dim3((T / kTile) * (D / kSlice), H, B), kBwdThreads, smem,
                                  st>>>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t,
                                        q_lo, q_hi, tile_count, dq_acc, dk, dv, T, H, D,
                                        scale_log2, scale, dp);
  if constexpr (WITH_DQ) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dq_epilogue<E><<<(unsigned)((n / 2 + 255) / 256), 256, 0, st>>>(dq_acc, cos_t, sin_t, dq,
                                                                     T, H, D, n / 2);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split pair's dq kernel. A CTA owns 64 q rows of one (batch, head) and
// one slice and walks 64-row kv tiles; 4 warps of 16 q rows. Per kv tile:
// S and dP (16 x 64 a warp) over D / 64 panels of q, k, do and v (a
// two-stage cp.async ring), p, the keep bits and ds on their registers, dS
// rounded into the warp's rows of a shared tile, dq (16 x 128) += dS .
// K_slice. No atomics: dq is the same bits from run to run.
// ---------------------------------------------------------------------------
constexpr int kDqThreads = 128;

template <typename E>
struct DqSmem {
  E qp[2][Geo<E>::TILE];
  E kp[2][Geo<E>::TILE];
  E dop[2][Geo<E>::TILE];
  E vp[2][Geo<E>::TILE];
  E ks[Geo<E>::STILE];
  E dss[Geo<E>::TILE];
  int kseg[kTile];
};

template <typename E, bool DROP>
__global__ void __launch_bounds__(kDqThreads) mh_bwd_dq_wide(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi, int* __restrict__ tile_count,
    E* __restrict__ dq, int T, int H, int D, float scale_log2, float scale, Drop dp) {
  using G = Geo<E>;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  DqSmem<E>& sm = *reinterpret_cast<DqSmem<E>*>(wide_smem);
  const int n_slices = D / kSlice, n_panels = D / kPanel;
  const int c = blockIdx.x % n_slices, qt = blockIdx.x / n_slices, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const size_t qrow0 = (size_t)qt * kTile;
  int jt0 = 0, jt1 = T / kTile - 1;
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / kTile) + qt];
    jt1 = kv_hi[b * (T / kTile) + qt];
  }
  const int n_tiles = jt1 - jt0 + 1, n_steps = n_tiles * n_panels;
  if (tile_count != nullptr && c == 0 && tid == 0) atomicAdd(tile_count, n_tiles);
  const int r0 = (int)qrow0 + warp * 16 + g;  // this thread's q rows r0 and r0 + 8
  const int qs0 = q_seg ? q_seg[(size_t)b * T + r0] : 0;
  const int qs1 = q_seg ? q_seg[(size_t)b * T + r0 + 8] : 0;
  const float lse0 = lse[((size_t)b * T + r0) * H + h], lse1 = lse[((size_t)b * T + r0 + 8) * H + h];
  const float di0 = di[((size_t)b * T + r0) * H + h], di1 = di[((size_t)b * T + r0 + 8) * H + h];
  const bool odd = g & 1;
  const int bh = b * H + h;

  auto issue = [&](int s) {
    if (s < n_steps) {
      const int it = s / n_panels, p = s % n_panels;
      const size_t kvrow = (size_t)(jt0 + it) * kTile;
      const size_t col = p * kPanel;
      load_tile<E, kTile, kPanel>(sm.qp[s & 1], G::LD, q + base + qrow0 * rs + col, rs, tid,
                                  kDqThreads);
      load_tile<E, kTile, kPanel>(sm.kp[s & 1], G::LD, k + base + kvrow * rs + col, rs, tid,
                                  kDqThreads);
      load_tile<E, kTile, kPanel>(sm.dop[s & 1], G::LD, dout + base + qrow0 * rs + col, rs, tid,
                                  kDqThreads);
      load_tile<E, kTile, kPanel>(sm.vp[s & 1], G::LD, v + base + kvrow * rs + col, rs, tid,
                                  kDqThreads);
    }
    cp_async_commit();
  };

  float acc[16][4], sc[8][4], dpf[8][4];
  zero<16>(acc);
  issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    const size_t kvrow = (size_t)(jt0 + it) * kTile;
    load_slice(sm.ks, k + base + kvrow * rs, rs, c, D, tid, kDqThreads);
    if (kv_seg != nullptr && tid < kTile / 4)
      cp_async16(sm.kseg + 4 * tid, kv_seg + (size_t)b * T + kvrow + 4 * tid);
    cp_async_commit();
    zero<8>(sc);
    zero<8>(dpf);
    for (int p = 0; p < n_panels; ++p) {
      const int st = it * n_panels + p;
      issue(st + 1);
      cp_async_wait<1>();
      __syncthreads();
      warp_mma<8, kPanel, false, false>(sc, sm.qp[st & 1] + warp * 16 * G::LD, G::LD,
                                        sm.kp[st & 1], G::LD, lane);
      warp_mma<8, kPanel, false, false>(dpf, sm.dop[st & 1] + warp * 16 * G::LD, G::LD,
                                        sm.vp[st & 1], G::LD, lane);
      __syncthreads();
    }
    E* drow = sm.dss + (warp * 16 + g) * G::LD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t4;
      uint32_t kp = 0xfu;
      if constexpr (DROP) kp = keep_rows(dp, bh, r0, (int)kvrow + col, odd);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ksg = kv_seg ? sm.kseg[col + (e & 1)] : 0;
        const float pv = exp2f(score(sc[n][e], scale_log2, e < 2 ? qs0 : qs1, ksg) -
                               (e < 2 ? lse0 : lse1));
        float dpv = dpf[n][e];
        if constexpr (DROP) dpv = (kp >> e) & 1 ? dpv * dp.keep_scale : 0.f;
        ds[e] = pv * (dpv - (e < 2 ? di0 : di1)) * scale;
      }
      store2(drow + col, ds[0], ds[1]);
      store2(drow + 8 * G::LD + col, ds[2], ds[3]);
    }
    __syncwarp();
    warp_mma<16, kTile, false, true>(acc, sm.dss + warp * 16 * G::LD, G::LD, sm.ks, G::LDS, lane);
    __syncthreads();  // ks, kseg and dss are refilled for the next tile
  }
  cp_async_wait<0>();

  const int rows[2] = {r0, r0 + 8};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    E* orow = dq + base + (size_t)rows[hf] * rs;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int L = n * 8 + 2 * t4;
      float lo0 = acc[n][2 * hf], lo1 = acc[n][2 * hf + 1];
      float hi0 = acc[n + 8][2 * hf], hi1 = acc[n + 8][2 * hf + 1];
      if (cos_t != nullptr) {
        const size_t ti = (size_t)rows[hf] * (D / 2) + 64 * c + L;
        const float c0 = cos_t[ti], c1 = cos_t[ti + 1], s0 = sin_t[ti], s1 = sin_t[ti + 1];
        const float a0 = rope_inv_lo(lo0, hi0, c0, s0), a1 = rope_inv_lo(lo1, hi1, c1, s1);
        hi0 = rope_inv_hi(lo0, hi0, c0, s0);
        hi1 = rope_inv_hi(lo1, hi1, c1, s1);
        lo0 = a0;
        lo1 = a1;
      }
      store2(orow + slice_dim(c, D, L), lo0, lo1);
      store2(orow + slice_dim(c, D, L + 64), hi0, hi1);
    }
  }
}

// q and k already rotated; lse and di (B, T, H); kv_lo / kv_hi per (b,
// 64-row q tile) in 64-row kv tiles, or null.
template <typename E, bool DROP>
cudaError_t launch_dq_wide(const E* q, const E* k, const E* v, const E* dout, const float* lse,
                           const float* di, const int* q_seg, const int* kv_seg,
                           const float* cos_t, const float* sin_t, const int* kv_lo,
                           const int* kv_hi, int* tile_count, E* dq, int B, int T, int H, int D,
                           float scale_log2, float scale, Drop dp, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = sizeof(DqSmem<E>);
  cudaError_t e = allow_smem(mh_bwd_dq_wide<E, DROP>, smem, smem_set);
  if (e != cudaSuccess) return e;
  mh_bwd_dq_wide<E, DROP><<<dim3((T / kTile) * (D / kSlice), H, B), kDqThreads, smem, st>>>(
      q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, dq, T, H,
      D, scale_log2, scale, dp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host entries shared by the libraries: rotate q and k into the scratch
// tensors (where RoPE is on), then the kernel of the dtype and dropout.
// ---------------------------------------------------------------------------
template <typename = void>
void rotate_qk(const void*& q, const void*& k, const float* cos_t, const float* sin_t,
                      void* q_rot, void* k_rot, int B, int T, int H, int D, bool bf16,
                      cudaStream_t st) {
  if (cos_t == nullptr) return;
  launch_rope_rows(q, cos_t, sin_t, q_rot, B, T, H, D, bf16, st);
  launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, bf16, st);
  q = q_rot;
  k = k_rot;
}

template <typename E>
cudaError_t fwd_typed(const void* q, const void* k, const void* v, const int* q_seg,
                      const int* kv_seg, const int* kv_lo, const int* kv_hi, int* tile_count,
                      void* o, float* lse, int B, int T, int H, int D, float scale_log2,
                      bool drop, Drop dp, cudaStream_t st) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(o);
  return drop ? launch_fwd_wide<E, true>(qe, ke, ve, q_seg, kv_seg, kv_lo, kv_hi, tile_count, oe,
                                         lse, B, T, H, D, scale_log2, dp, st)
              : launch_fwd_wide<E, false>(qe, ke, ve, q_seg, kv_seg, kv_lo, kv_hi, tile_count,
                                          oe, lse, B, T, H, D, scale_log2, dp, st);
}

// The forward at D > 256. q_rot and k_rot: scratch of q's shape and type,
// read only with RoPE. (Each entry is a template so that a library builds
// only the kernels it launches.)
template <typename = void>
cudaError_t forward(const void* q, const void* k, const void* v, const int* q_seg,
                           const int* kv_seg, const float* cos_t, const float* sin_t,
                           void* q_rot, void* k_rot, const int* kv_lo, const int* kv_hi,
                           int* tile_count, void* o, float* lse, int B, int T, int H, int D,
                           float scale_log2, bool bf16, bool drop, Drop dp, cudaStream_t st) {
  if (cos_t != nullptr && (q_rot == nullptr || k_rot == nullptr)) return cudaErrorInvalidValue;
  rotate_qk(q, k, cos_t, sin_t, q_rot, k_rot, B, T, H, D, bf16, st);
  return bf16 ? fwd_typed<__nv_bfloat16>(q, k, v, q_seg, kv_seg, kv_lo, kv_hi, tile_count, o,
                                         lse, B, T, H, D, scale_log2, drop, dp, st)
              : fwd_typed<float>(q, k, v, q_seg, kv_seg, kv_lo, kv_hi, tile_count, o, lse, B, T,
                                 H, D, scale_log2, drop, dp, st);
}

template <typename E, bool WITH_DQ>
cudaError_t bwd_typed(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                      const float* cos_t, const float* sin_t, const int* q_lo, const int* q_hi,
                      int* tile_count, float* dq_acc, void* dq, void* dk, void* dv, int B,
                      int T, int H, int D, float scale_log2, float scale, bool drop, Drop dp,
                      cudaStream_t st) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  E* dqe = static_cast<E*>(dq);
  E* dke = static_cast<E*>(dk);
  E* dve = static_cast<E*>(dv);
  return drop ? launch_bwd_wide<E, true, WITH_DQ>(qe, ke, ve, de, lse, di, q_seg, kv_seg, cos_t,
                                                  sin_t, q_lo, q_hi, tile_count, dq_acc, dqe,
                                                  dke, dve, B, T, H, D, scale_log2, scale, dp,
                                                  st)
              : launch_bwd_wide<E, false, WITH_DQ>(qe, ke, ve, de, lse, di, q_seg, kv_seg,
                                                   cos_t, sin_t, q_lo, q_hi, tile_count, dq_acc,
                                                   dqe, dke, dve, B, T, H, D, scale_log2, scale,
                                                   dp, st);
}

// The fused backward (WITH_DQ) or the dkv kernel at D > 256; lse and di
// (B, T, H). q_rot and k_rot: scratch of q's shape and type, read only
// with RoPE.
template <bool WITH_DQ>
cudaError_t backward(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* q_rot, void* k_rot,
                     const int* q_lo, const int* q_hi, int* tile_count, float* dq_acc, void* dq,
                     void* dk, void* dv, int B, int T, int H, int D, float scale_log2,
                     float scale, bool bf16, bool drop, Drop dp, cudaStream_t st) {
  if ((cos_t != nullptr && (q_rot == nullptr || k_rot == nullptr)) ||
      (WITH_DQ && dq_acc == nullptr))
    return cudaErrorInvalidValue;
  rotate_qk(q, k, cos_t, sin_t, q_rot, k_rot, B, T, H, D, bf16, st);
  return bf16 ? bwd_typed<__nv_bfloat16, WITH_DQ>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t,
                                                  sin_t, q_lo, q_hi, tile_count, dq_acc, dq, dk,
                                                  dv, B, T, H, D, scale_log2, scale, drop, dp,
                                                  st)
              : bwd_typed<float, WITH_DQ>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t,
                                          q_lo, q_hi, tile_count, dq_acc, dq, dk, dv, B, T, H, D,
                                          scale_log2, scale, drop, dp, st);
}

template <typename E>
cudaError_t dq_typed(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, const int* kv_lo, const int* kv_hi,
                     int* tile_count, void* dq, int B, int T, int H, int D, float scale_log2,
                     float scale, bool drop, Drop dp, cudaStream_t st) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  E* dqe = static_cast<E*>(dq);
  return drop ? launch_dq_wide<E, true>(qe, ke, ve, de, lse, di, q_seg, kv_seg, cos_t, sin_t,
                                        kv_lo, kv_hi, tile_count, dqe, B, T, H, D, scale_log2,
                                        scale, dp, st)
              : launch_dq_wide<E, false>(qe, ke, ve, de, lse, di, q_seg, kv_seg, cos_t, sin_t,
                                         kv_lo, kv_hi, tile_count, dqe, B, T, H, D, scale_log2,
                                         scale, dp, st);
}

// The split pair's dq kernel at D > 256; lse and di (B, T, H). q_rot and
// k_rot: scratch of q's shape and type, read only with RoPE.
template <typename = void>
cudaError_t dq_only(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, const int* q_seg,
                           const int* kv_seg, const float* cos_t, const float* sin_t,
                           void* q_rot, void* k_rot, const int* kv_lo, const int* kv_hi,
                           int* tile_count, void* dq, int B, int T, int H, int D,
                           float scale_log2, float scale, bool bf16, bool drop, Drop dp,
                           cudaStream_t st) {
  if (cos_t != nullptr && (q_rot == nullptr || k_rot == nullptr)) return cudaErrorInvalidValue;
  rotate_qk(q, k, cos_t, sin_t, q_rot, k_rot, B, T, H, D, bf16, st);
  return bf16 ? dq_typed<__nv_bfloat16>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t,
                                        kv_lo, kv_hi, tile_count, dq, B, T, H, D, scale_log2,
                                        scale, drop, dp, st)
              : dq_typed<float>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, kv_lo,
                                kv_hi, tile_count, dq, B, T, H, D, scale_log2, scale, drop, dp,
                                st);
}

// Dynamic shared memory a CTA of each bf16 kernel takes (any D > 256).
inline int fwd_smem_bytes() { return (int)sizeof(FwdSmem<__nv_bfloat16>); }
inline int bwd_smem_bytes() { return (int)sizeof(BwdSmem<__nv_bfloat16>); }
inline int dq_smem_bytes() { return (int)sizeof(DqSmem<__nv_bfloat16>); }

}  // namespace
}  // namespace wide
}  // namespace obt
