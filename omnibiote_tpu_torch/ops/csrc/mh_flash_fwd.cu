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
// Layout (B, T, H*D) row-major for q, k, v, o; segment ids (B, T) int32 or
// null (dense); cos/sin (T, D/2) fp32 or null (no RoPE).
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
// 268 MB of q, k, v and o (80 us at 3.35 TB/s): it is bound by operations.
// The bf16 kernel therefore runs both products on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate) and keeps S and P in registers: a
// warp's 16 query rows stay resident, and P's accumulator fragments are
// reused directly as the A operand of P.V. K and V tiles stream through a
// two-stage cp.async ring in shared memory, so the next tile's copy
// overlaps this tile's products; ldmatrix (transposing for V) feeds the B
// operands from rows padded against bank conflicts. wgmma, TMA and warp
// specialisation are left for later work. The fp32 kernel is the parity
// type and runs on the CUDA cores.
//
// Segment skipping (the TPU kernel's use_bounds). With kv_lo / kv_hi
// non-null, int32 (B, T / q tile) in units of kv tiles, a block walks only
// the kv tiles kv_lo..kv_hi of its (batch, q tile): every tile outside has
// disjoint segment-id ranges and is fully masked. A skipped tile would have
// contributed exact zeros (its p underflows to 0 against any visible
// score, and alpha wipes a leading masked tile), so the result is bit for
// bit that of the full walk. The ring's prologue starts at kv_lo and its
// last refill is kv_hi. tile_count, when non-null, receives the number of
// tiles walked, summed over blocks (checks only).
#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace obt;

// ---------------------------------------------------------------------------
// bf16: 4 warps, 64 query rows (16 per warp) x 64-wide kv tiles, k already
// rotated. Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C:      (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// ---------------------------------------------------------------------------
constexpr int kBf16Tile = 64;

// Dropout of one call: keep iff the element's Philox word >= thresh; kept
// values are multiplied by keep_scale = 1 / (1 - rate) in fp32.
struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  // two stages of K and V tiles (rows padded by 8 elements) and kv segment ids
  return 2 * 2 * kBf16Tile * (D + 8) * sizeof(__nv_bfloat16) + 2 * kBf16Tile * sizeof(int);
}

// BOUNDS: the kernel reads kv_lo / kv_hi; without it the walk starts at a
// constant 0, which the compiler schedules as it did before bounds existed
// (on an H100 the dense serving shape ran 11 % slower through the bounded
// code).
template <int D, bool DROP, bool BOUNDS>
__global__ void __launch_bounds__(128) mh_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    int* __restrict__ tile_count, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int T, int H, float scale_log2, DropParams dp) {
  constexpr int BQ = kBf16Tile, BKV = kBf16Tile, HALF = D / 2;
  constexpr int RS = D + 8;    // K and V tile row stride (elements), padded
  constexpr int CH = D / 8;    // 16-byte chunks in a row
  constexpr int NK = D / 16;   // k-steps of q.k^T
  constexpr int NN = D / 8;    // n-tiles of the output
  constexpr int NS = BKV / 8;  // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BKV][RS]
  __nv_bfloat16* vs = ks + 2 * BKV * RS;                        // [2][BKV][RS]
  int* kseg = reinterpret_cast<int*>(vs + 2 * BKV * RS);        // [2][BKV]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;  // elements between consecutive tokens
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8

  // copy kv tile j0 into ring stage `st`: 16 bytes a thread a step
  auto load_tile = [&](int st, int j0) {
    __nv_bfloat16* kd = ks + st * BKV * RS;
    __nv_bfloat16* vd = vs + st * BKV * RS;
    for (int it = tid; it < BKV * CH; it += 128) {
      const int row = it / CH, c8 = (it % CH) * 8;
      const size_t off = base + (size_t)(j0 + row) * rs + c8;
      cp_async16(kd + row * RS + c8, k + off);
      cp_async16(vd + row * RS + c8, v + off);
    }
    if (seg != nullptr && tid < BKV / 4)
      cp_async16(kseg + st * BKV + tid * 4, seg + (size_t)b * T + j0 + tid * 4);
  };

  // the kv tiles this block walks: all, or its (batch, q tile)'s range
  int jt0 = 0, jt1 = T / BKV - 1;
  if constexpr (BOUNDS) {
    jt0 = kv_lo[b * (T / BQ) + blockIdx.x];
    jt1 = kv_hi[b * (T / BQ) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, jt1 - jt0 + 1);
  load_tile(0, jt0 * BKV);
  cp_async_commit();

  // q fragments, rotated in fp32 and rounded to bf16, resident for the loop
  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + ((r & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t4 + ((r & 2) ? 8 : 0);
      const __nv_bfloat16* qrow = q + base + (size_t)row * rs;
      float2 x = load_bf16x2(qrow + col);
      if (cos_t != nullptr) {
        const bool lo = col < HALF;
        const int tc = lo ? col : col - HALF;
        const float2 y = load_bf16x2(qrow + (lo ? col + HALF : tc));
        const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)row * HALF + tc);
        const float2 s = *reinterpret_cast<const float2*>(sin_t + (size_t)row * HALF + tc);
        x = lo ? make_float2(rope_lo(x.x, y.x, c.x, s.x), rope_lo(x.y, y.y, c.y, s.y))
               : make_float2(rope_hi(y.x, x.x, c.x, s.x), rope_hi(y.y, x.y, c.y, s.y));
      }
      qa[kk][r] = pack_bf16(x.x, x.y);
    }
  }
  const int qs0 = seg ? seg[(size_t)b * T + r0] : 0;
  const int qs1 = seg ? seg[(size_t)b * T + r0 + 8] : 0;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int jt = jt0; jt <= jt1; ++jt) {
    const int st = (jt - jt0) & 1;
    // the other stage was last read in the previous iteration, which ended
    // in a barrier: refill it with the next tile while this one is used
    if (jt + 1 <= jt1) load_tile(st ^ 1, (jt + 1) * BKV);
    cp_async_commit();
    cp_async_wait_one();  // this tile's group has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + st * BKV * RS;
    const __nv_bfloat16* vt = vs + st * BKV * RS;
    const int* sg = kseg + st * BKV;

    // S = q . k^T for this warp's 16 rows x BKV columns; one ldmatrix.x4
    // gives the B fragments of two k-steps of one n-tile
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (j * 8 + (lane & 7)) * RS + p * 32 + (lane >> 3) * 8);
        mma_bf16(s[j], qa[2 * p], bf[0], bf[1]);
        mma_bf16(s[j], qa[2 * p + 1], bf[2], bf[3]);
      }
    }
    // log2-space scores with the segment bias; the tile's row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int ks0 = seg ? sg[j * 8 + 2 * t4] : 0;
      const int ks1 = seg ? sg[j * 8 + 2 * t4 + 1] : 0;
      s[j][0] = score(s[j][0], scale_log2, qs0, ks0);
      s[j][1] = score(s[j][1], scale_log2, qs0, ks1);
      s[j][2] = score(s[j][2], scale_log2, qs1, ks0);
      s[j][3] = score(s[j][3], scale_log2, qs1, ks1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
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
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + rs0;  // per-thread partial sums, reduced at the end
    l1 = alpha1 * l1 + rs1;
    if constexpr (DROP) {
      // rows r0 and r0 + 8 share a parity, so both read words 2 * (r0 & 1)
      // and 2 * (r0 & 1) + 1 of their calls (columns col and col + 1)
      const int bh = b * H + h;
      const bool odd = r0 & 1;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = jt * BKV + j * 8 + 2 * t4;
        const Philox4 u = dropout_bits(dp.seed, bh, r0, col);
        const Philox4 w = dropout_bits(dp.seed, bh, r0 + 8, col);
        s[j][0] = (odd ? u.w[2] : u.w[0]) >= dp.thresh ? s[j][0] * dp.keep_scale : 0.f;
        s[j][1] = (odd ? u.w[3] : u.w[1]) >= dp.thresh ? s[j][1] * dp.keep_scale : 0.f;
        s[j][2] = (odd ? w.w[2] : w.w[0]) >= dp.thresh ? s[j][2] * dp.keep_scale : 0.f;
        s[j][3] = (odd ? w.w[3] : w.w[1]) >= dp.thresh ? s[j][3] * dp.keep_scale : 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    // acc += P (bf16, straight from the score fragments) . V; one
    // ldmatrix.x4.trans gives the B fragments of two n-tiles
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS
                                  + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* o0 = o + base + (size_t)r0 * rs;
  __nv_bfloat16* o1 = o0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t4 == 0) {
    lse[((size_t)b * T + r0) * H + h] = m0 + log2f(l0);
    lse[((size_t)b * T + r0 + 8) * H + h] = m1 + log2f(l1);
  }
}

// ---------------------------------------------------------------------------
// fp32: 128 threads = 32 query rows x 4 threads; thread `sub` of a row owns
// the head dims sub + 4*i, so a row's dot product is 4 partial sums joined
// by two shuffles, and its output columns stay in the thread's registers.
// k already rotated.
// ---------------------------------------------------------------------------
constexpr int kF32Tile = 32;

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    int* __restrict__ tile_count, float* __restrict__ o,
    float* __restrict__ lse, int T, int H, float scale_log2, DropParams dp) {
  constexpr int BQ = kF32Tile, BKV = kF32Tile, HALF = D / 2, PER = D / 4;
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
  const int qs = seg ? seg[(size_t)b * T + row] : 0;

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
    if (tid < BKV) kseg[tid] = seg ? seg[(size_t)b * T + j0 + tid] : 0;
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

template <int D, bool DROP, bool BOUNDS>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const int* seg, const float* cos_t,
                        const float* sin_t, const int* kv_lo, const int* kv_hi,
                        int* tile_count, __nv_bfloat16* o, float* lse, int B, int T,
                        int H, float scale_log2, DropParams dp, cudaStream_t st) {
  const size_t smem = bf16_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      mh_fwd_bf16<D, DROP, BOUNDS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mh_fwd_bf16<D, DROP, BOUNDS><<<dim3(T / kBf16Tile, H, B), 128, smem, st>>>(
      q, k, v, seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, o, lse, T, H, scale_log2, dp);
  return cudaSuccess;
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   const float* cos_t, const float* sin_t, void* k_rot,
                   const int* kv_lo, const int* kv_hi, int* tile_count, void* o,
                   float* lse, int B, int T, int H, float scale_log2, bool bf16,
                   DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows<D>(k, cos_t, sin_t, k_rot, B, T, H, bf16, st);
    k = k_rot;
  }
  if (bf16) {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
    const cudaError_t e =
        kv_lo != nullptr
            ? launch_bf16<D, DROP, true>(qb, kb, vb, seg, cos_t, sin_t, kv_lo, kv_hi,
                                         tile_count, ob, lse, B, T, H, scale_log2, dp, st)
            : launch_bf16<D, DROP, false>(qb, kb, vb, seg, cos_t, sin_t, kv_lo, kv_hi,
                                          tile_count, ob, lse, B, T, H, scale_log2, dp, st);
    if (e != cudaSuccess) return e;
  } else {
    mh_fwd_f32<D, DROP><<<dim3(T / kF32Tile, H, B), 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, cos_t, sin_t, kv_lo, kv_hi,
        tile_count, static_cast<float*>(o), lse, T, H, scale_log2, dp);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* seg,
                     const float* cos_t, const float* sin_t, void* k_rot,
                     const int* kv_lo, const int* kv_hi, int* tile_count, void* o,
                     float* lse, int B, int T, int H, float scale_log2, bool bf16,
                     bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, seg, cos_t, sin_t, k_rot, kv_lo, kv_hi,
                                tile_count, o, lse, B, T, H, scale_log2, bf16, dp, st)
              : launch<D, false>(q, k, v, seg, cos_t, sin_t, k_rot, kv_lo, kv_hi,
                                 tile_count, o, lse, B, T, H, scale_log2, bf16, dp, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. With RoPE (cos_t and sin_t non-null),
// k_rot is a scratch tensor of k's shape and type that receives the rotated
// k. kv_lo and kv_hi, both null or both int32 (B, T / q tile) with the q
// and kv tiles of the dtype's kernel (64 for bf16, 32 for fp32), bound the
// kv tiles each q tile walks; tile_count is null or one int32 that the
// walked tiles are added to. drop != 0 applies dropout with keep threshold
// `thresh` (bits >= thresh keep), scale `keep_scale` and the 64-bit `seed`
// (philox.cuh). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a shape
// or type this file has no kernel for). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int obt_mh_flash_fwd(const void* q, const void* k, const void* v,
                                const void* seg, const void* cos_t,
                                const void* sin_t, void* k_rot,
                                const void* kv_lo, const void* kv_hi,
                                void* tile_count, void* o,
                                void* lse, int B, int T, int H, int D,
                                float scale_log2, int dtype, int drop,
                                uint32_t thresh, float keep_scale,
                                uint64_t seed, void* stream) {
  if ((dtype != 0 && dtype != 1) || T < kBf16Tile || T % kBf16Tile != 0 ||
      B < 1 || B > 65535 || H < 1 || H > 65535 ||
      (cos_t != nullptr && (sin_t == nullptr || k_rot == nullptr)) ||
      ((kv_lo == nullptr) != (kv_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const int* lo = static_cast<const int*>(kv_lo);
  const int* hi = static_cast<const int*>(kv_hi);
  int* tc = static_cast<int*>(tile_count);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropParams dp{seed, thresh, keep_scale};
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, sg, c, s, k_rot, lo, hi, tc, o, l, B, T, H, scale_log2, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, sg, c, s, k_rot, lo, hi, tc, o, l, B, T, H, scale_log2, dtype == 1, drop != 0, dp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* obt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
