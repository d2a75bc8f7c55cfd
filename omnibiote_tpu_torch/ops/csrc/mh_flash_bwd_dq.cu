// Multi-head flash attention backward for Hopper (sm_90a), the dq half of
// the split pair: dq of one q tile, summed over the kv tiles.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_dq_kernel (launched by _mh_bwd when the fused backward is switched
// off or cannot run). Same function, same rounding points:
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
// the sequential axis and a dq accumulator in VMEM scratch. Here one block
// owns (batch, head, 64-row q tile) and loops over 64-wide kv tiles itself:
// the forward kernel's loop shape (mh_flash_fwd.cu). A warp's 16 q rows and
// their dO rows stay resident as A fragments; K and V tiles stream through
// a two-stage cp.async ring; S = Q.K^T and dP = dO.V^T come out of mma.sync
// m16n8k16 in the same accumulator layout, dS is formed in registers and
// reused directly as the A operand of dQ += dS.K (K read by a transposing
// ldmatrix). Three products a tile, one store per output element, no
// atomics and no scratch: every dq tile has one owner, so dq is the same
// bits from run to run, which the fused kernel's atomicAdd sums are not.
// k is rotated once per call into a scratch tensor by the small kernel of
// flash_common.cuh; q is rotated in registers where it is loaded. With
// kv_lo / kv_hi the block walks only the kv tiles whose segment-id range
// meets its q tile's (the TPU kernel's use_bounds); a skipped tile would
// have added exact zeros, so dq is bit for bit that of the full walk.
//
// Bound. At B=8, T=2048, H=8, D=128 in bf16 the three products are
// 6*B*T^2*H*D = 206 GFLOP over all (q, k) pairs (0.208 ms at 989 TFLOP/s),
// less in proportion to the visible tiles on packed rows; q, k, v, do, dq,
// lse2 and di are 169 MB (0.05 ms at 3.35 TB/s): bound by operations. The
// fp32 kernel is the parity type and runs on the CUDA cores.
#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace obt;

struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

// ---------------------------------------------------------------------------
// bf16: 4 warps, 64 q rows (16 per warp) x 64-wide kv tiles, k already
// rotated. Fragment layout of m16n8k16 as in mh_flash_fwd.cu.
// ---------------------------------------------------------------------------
constexpr int kBf16Tile = 64;

template <int D>
constexpr size_t bf16_smem_bytes() {
  // two stages of K and V tiles (rows padded by 8 elements) and kv segment ids
  return 2 * 2 * kBf16Tile * (D + 8) * sizeof(__nv_bfloat16) + 2 * kBf16Tile * sizeof(int);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_bwd_dq_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, int* __restrict__ tile_count,
    __nv_bfloat16* __restrict__ dq, int T, int H, float scale_log2,
    float scale, DropParams dp) {
  constexpr int BQ = kBf16Tile, BKV = kBf16Tile, HALF = D / 2;
  constexpr int RS = D + 8;    // K and V tile row stride (elements), padded
  constexpr int CH = D / 8;    // 16-byte chunks in a row
  constexpr int NK = D / 16;   // k-steps over the head dim
  constexpr int NN = D / 8;    // n-tiles of dq
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
  if (kv_lo != nullptr) {
    jt0 = kv_lo[b * (T / BQ) + blockIdx.x];
    jt1 = kv_hi[b * (T / BQ) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, jt1 - jt0 + 1);
  load_tile(0, jt0 * BKV);
  cp_async_commit();

  // q fragments (rotated in fp32, rounded to bf16) and dO fragments,
  // resident for the loop
  uint32_t qa[NK][4], doa[NK][4];
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
      doa[kk][r] = *reinterpret_cast<const uint32_t*>(dout + base + (size_t)row * rs + col);
    }
  }
  const int qs0 = seg ? seg[(size_t)b * T + r0] : 0;
  const int qs1 = seg ? seg[(size_t)b * T + r0 + 8] : 0;
  const size_t sr0 = ((size_t)b * T + r0) * H + h, sr1 = sr0 + (size_t)8 * H;
  const float lse0 = lse[sr0], lse1 = lse[sr1];
  const float di0 = di[sr0], di1 = di[sr1];

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

    // S = q.k^T and dP = do.v^T for this warp's 16 rows x BKV columns; one
    // ldmatrix.x4 gives the B fragments of two k-steps of one n-tile
    float s[NS][4], dpv[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dpv[j][0] = dpv[j][1] = dpv[j][2] = dpv[j][3] = 0.f;
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bk[4], bv[4];
        const int off = (j * 8 + (lane & 7)) * RS + p * 32 + (lane >> 3) * 8;
        ldmatrix_x4(bk, kt + off);
        ldmatrix_x4(bv, vt + off);
        mma_bf16(s[j], qa[2 * p], bk[0], bk[1]);
        mma_bf16(s[j], qa[2 * p + 1], bk[2], bk[3]);
        mma_bf16(dpv[j], doa[2 * p], bv[0], bv[1]);
        mma_bf16(dpv[j], doa[2 * p + 1], bv[2], bv[3]);
      }
    }
    // dS in place of S: element e of n-tile j is (row r0 + 8 * (e >> 1),
    // column jt * BKV + j * 8 + 2 * t4 + (e & 1))
    const int bh = b * H + h;
    const bool odd = r0 & 1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int ks0 = seg ? sg[j * 8 + 2 * t4] : 0;
      const int ks1 = seg ? sg[j * 8 + 2 * t4 + 1] : 0;
      const float p0 = exp2f(score(s[j][0], scale_log2, qs0, ks0) - lse0);
      const float p1 = exp2f(score(s[j][1], scale_log2, qs0, ks1) - lse0);
      const float p2 = exp2f(score(s[j][2], scale_log2, qs1, ks0) - lse1);
      const float p3 = exp2f(score(s[j][3], scale_log2, qs1, ks1) - lse1);
      float d0 = dpv[j][0], d1 = dpv[j][1], d2 = dpv[j][2], d3 = dpv[j][3];
      if constexpr (DROP) {
        // rows r0 and r0 + 8 share a parity, so both read words 2 * (r0 & 1)
        // and 2 * (r0 & 1) + 1 of their calls (columns col and col + 1)
        const int col = jt * BKV + j * 8 + 2 * t4;
        const Philox4 u = dropout_bits(dp.seed, bh, r0, col);
        const Philox4 w = dropout_bits(dp.seed, bh, r0 + 8, col);
        d0 = (odd ? u.w[2] : u.w[0]) >= dp.thresh ? d0 * dp.keep_scale : 0.f;
        d1 = (odd ? u.w[3] : u.w[1]) >= dp.thresh ? d1 * dp.keep_scale : 0.f;
        d2 = (odd ? w.w[2] : w.w[0]) >= dp.thresh ? d2 * dp.keep_scale : 0.f;
        d3 = (odd ? w.w[3] : w.w[1]) >= dp.thresh ? d3 * dp.keep_scale : 0.f;
      }
      s[j][0] = __fmul_rn(__fmul_rn(p0, __fsub_rn(d0, di0)), scale);
      s[j][1] = __fmul_rn(__fmul_rn(p1, __fsub_rn(d1, di0)), scale);
      s[j][2] = __fmul_rn(__fmul_rn(p2, __fsub_rn(d2, di1)), scale);
      s[j][3] = __fmul_rn(__fmul_rn(p3, __fsub_rn(d3, di1)), scale);
    }
    // acc += dS (bf16, straight from the fragments) . K; one
    // ldmatrix.x4.trans gives the B fragments of two n-tiles
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS
                                  + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], sa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], sa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // dq rotated back by -angle in fp32 (columns d and d + D/2 sit in n-tiles
  // n and n + NN/2 of the same thread), then cast
  __nv_bfloat16* q0p = dq + base + (size_t)r0 * rs;
  __nv_bfloat16* q1p = q0p + 8 * rs;
  if (cos_t != nullptr) {
#pragma unroll
    for (int n = 0; n < NN / 2; ++n) {
      const int col = n * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)row * HALF + col);
        const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)row * HALF + col);
        const float x1a = acc[n][2 * r], x1b = acc[n][2 * r + 1];
        const float x2a = acc[n + NN / 2][2 * r], x2b = acc[n + NN / 2][2 * r + 1];
        __nv_bfloat16* dst = r ? q1p : q0p;
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
      *reinterpret_cast<uint32_t*>(q0p + col) = pack_bf16(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(q1p + col) = pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 128 threads = 32 q rows x 4 threads; thread `sub` of a row owns the
// head dims sub + 4*i (its q, do and dq in registers), so a dot product is 4
// partial sums joined by two shuffles. 32-wide kv tiles, k already rotated.
// ---------------------------------------------------------------------------
constexpr int kF32Tile = 32;

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, int* __restrict__ tile_count,
    float* __restrict__ dq, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int BQ = kF32Tile, BKV = kF32Tile, HALF = D / 2, PER = D / 4;
  __shared__ __align__(16) float ks[BKV * D];
  __shared__ __align__(16) float vs[BKV * D];
  __shared__ int kseg[BKV];

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int sub = tid & 3, row = blockIdx.x * BQ + (tid >> 2);
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;

  float qr[PER], dor[PER];
  {
    const float* qrow = q + base + (size_t)row * rs;
    const float* drow = dout + base + (size_t)row * rs;
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
      dor[i] = drow[d];
    }
  }
  const int qs = seg ? seg[(size_t)b * T + row] : 0;
  const float lse_r = lse[((size_t)b * T + row) * H + h];
  const float di_r = di[((size_t)b * T + row) * H + h];

  float acc[PER];
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

    float ds[BKV];
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        sp = fmaf(qr[i], ks[j * D + sub + 4 * i], sp);
        dpp = fmaf(dor[i], vs[j * D + sub + 4 * i], dpp);
      }
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      sp += __shfl_xor_sync(0xffffffffu, sp, 2);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 1);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 2);
      const float p = exp2f(score(sp, scale_log2, qs, kseg[j]) - lse_r);
      if constexpr (DROP) {
        const Philox4 u = dropout_bits(dp.seed, b * H + h, row, j0 + j);
        const int w = dropout_word(row, j0 + j);
        const uint32_t bits = w == 0 ? u.w[0] : w == 1 ? u.w[1] : w == 2 ? u.w[2] : u.w[3];
        dpp = bits >= dp.thresh ? dpp * dp.keep_scale : 0.f;
      }
      ds[j] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpp, di_r)), scale);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float a = acc[i];
#pragma unroll
      for (int j = 0; j < BKV; ++j) a = fmaf(ds[j], ks[j * D + sub + 4 * i], a);
      acc[i] = a;
    }
  }

  float* dqr = dq + base + (size_t)row * rs;
  if (cos_t != nullptr) {
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const int d = sub + 4 * i;  // < HALF; its partner d + HALF is i + PER/2
      const float c = cos_t[(size_t)row * HALF + d], s = sin_t[(size_t)row * HALF + d];
      dqr[d] = rope_inv_lo(acc[i], acc[i + PER / 2], c, s);
      dqr[d + HALF] = rope_inv_hi(acc[i], acc[i + PER / 2], c, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) dqr[sub + 4 * i] = acc[i];
  }
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* seg,
                   const float* cos_t, const float* sin_t, void* k_rot,
                   const int* kv_lo, const int* kv_hi, int* tile_count, void* dq,
                   int B, int T, int H, float scale_log2, float scale, bool bf16,
                   DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows<D>(k, cos_t, sin_t, k_rot, B, T, H, bf16, st);
    k = k_rot;
  }
  if (bf16) {
    const size_t smem = bf16_smem_bytes<D>();
    const cudaError_t e = cudaFuncSetAttribute(
        mh_bwd_dq_bf16<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mh_bwd_dq_bf16<D, DROP><<<dim3(T / kBf16Tile, H, B), 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, di, seg, cos_t, sin_t, kv_lo, kv_hi, tile_count,
        static_cast<__nv_bfloat16*>(dq), T, H, scale_log2, scale, dp);
  } else {
    mh_bwd_dq_f32<D, DROP><<<dim3(T / kF32Tile, H, B), 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
        seg, cos_t, sin_t, kv_lo, kv_hi, tile_count, static_cast<float*>(dq), T,
        H, scale_log2, scale, dp);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* seg,
                     const float* cos_t, const float* sin_t, void* k_rot,
                     const int* kv_lo, const int* kv_hi, int* tile_count,
                     void* dq, int B, int T, int H, float scale_log2, float scale,
                     bool bf16, bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, seg, cos_t, sin_t, k_rot,
                                kv_lo, kv_hi, tile_count, dq, B, T, H, scale_log2,
                                scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, seg, cos_t, sin_t, k_rot,
                                 kv_lo, kv_hi, tile_count, dq, B, T, H, scale_log2,
                                 scale, bf16, dp, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dq (B, T, H, D) of that
// type; lse2 and di (B, T, H) fp32; seg (B, T) int32 or null; with RoPE
// (cos_t and sin_t non-null), k_rot is a scratch tensor of k's shape and
// type. kv_lo and kv_hi, both null or both int32 (B, T / q tile) with the q
// and kv tiles of the dtype's kernel (64 for bf16, 32 for fp32), bound the
// kv tiles each q tile walks; tile_count is null or one int32 that the
// walked tiles are added to. drop != 0 applies the forward's dropout
// (thresh, keep_scale, seed as in obt_mh_flash_fwd). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a shape
// or type this file has no kernel for). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int obt_mh_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* di, const void* seg,
                                   const void* cos_t, const void* sin_t,
                                   void* k_rot, const void* kv_lo,
                                   const void* kv_hi, void* tile_count,
                                   void* dq, int B, int T, int H, int D,
                                   float scale_log2, float scale, int dtype,
                                   int drop, uint32_t thresh, float keep_scale,
                                   uint64_t seed, void* stream) {
  if ((dtype != 0 && dtype != 1) || T < kBf16Tile || T % kBf16Tile != 0 ||
      B < 1 || B > 65535 || H < 1 || H > 65535 ||
      (cos_t != nullptr && (sin_t == nullptr || k_rot == nullptr)) ||
      ((kv_lo == nullptr) != (kv_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* sg = static_cast<const int*>(seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* lo = static_cast<const int*>(kv_lo);
  const int* hi = static_cast<const int*>(kv_hi);
  int* tc = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, sg, c, s, k_rot, lo, hi, tc, dq, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, sg, c, s, k_rot, lo, hi, tc, dq, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* obt_cuda_error_string_bwd_dq(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
