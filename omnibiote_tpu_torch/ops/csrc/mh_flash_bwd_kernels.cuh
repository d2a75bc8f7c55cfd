// Kernels of the multi-head flash attention backward shared by the fused
// entry (mh_flash_bwd.cu: the fp32 kernel with dq and its dq epilogue) and
// the dk/dv half of the split pair (mh_flash_bwd_dkv.cu: both dtypes); see
// those files for what each replaces. The bf16 fused kernel is Hopper's own
// (mh_flash_bwd.cu).
//
// Segment skipping. With q_lo / q_hi non-null, int32 (B, T / kv tile) in
// units of q tiles, a block walks only the q tiles q_lo..q_hi of its
// (batch, kv tile): every tile outside has disjoint segment-id ranges, its
// p = exp2(mask - lse2) is exactly 0, and it adds exact zeros to dq, dk
// and dv. tile_count, when non-null, receives the tiles walked, summed
// over blocks (checks only).
#pragma once
#include "flash_common.cuh"
#include "philox.cuh"

namespace obt {
namespace bwd {

struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

__device__ __forceinline__ uint32_t pick(const Philox4& u, int w) {
  return w == 0 ? u.w[0] : w == 1 ? u.w[1] : w == 2 ? u.w[2] : u.w[3];
}

// ---------------------------------------------------------------------------
// bf16 dk/dv (the split pair's dkv kernel): 4 warps; a block owns 64 kv rows
// (16 a warp) and walks 32-row q tiles. mma.sync m16n8k16 (g = lane / 4,
// t4 = lane % 4: a thread holds accumulator rows g, g + 8 and columns
// 2 t4, 2 t4 + 1 of each 16 x 8 n-tile); the accumulator rows are kv rows
// j, its columns q rows i.
// ---------------------------------------------------------------------------
constexpr int kDkvKvTile = 64;
constexpr int kDkvQTile = 32;

template <int D>
constexpr size_t bwd_bf16_smem_bytes() {
  // K and V tiles; two stages of Q and dO tiles; two stages of lse2, di and
  // q segment ids. Rows padded by 8 elements against bank conflicts.
  return (2 * kDkvKvTile * (D + 8) + 2 * 2 * kDkvQTile * (D + 8)) * sizeof(__nv_bfloat16) +
         2 * 3 * kDkvQTile * sizeof(float);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_bwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T, int H,
    float scale_log2, float scale, DropParams dp) {
  constexpr int BKV = kDkvKvTile, BQ = kDkvQTile, HALF = D / 2;
  constexpr int RS = D + 8;     // K, V, Q and dO tile row stride (elements)
  constexpr int CH = D / 8;     // 16-byte chunks in a row
  constexpr int NK = D / 16;    // k-steps over the head dim
  constexpr int NN = D / 8;     // n-tiles of dk / dv
  constexpr int NS = BQ / 8;    // n-tiles of a score tile (q columns)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BKV][RS]
  __nv_bfloat16* Vs = Ks + BKV * RS;                            // [BKV][RS]
  __nv_bfloat16* Qs = Vs + BKV * RS;                            // [2][BQ][RS]
  __nv_bfloat16* Os = Qs + 2 * BQ * RS;                         // [2][BQ][RS]
  float* lse_s = reinterpret_cast<float*>(Os + 2 * BQ * RS);   // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                 // [2][BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + 2 * BQ);          // [2][BQ]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)H * D;  // elements between consecutive tokens
  const size_t base = (size_t)b * T * rs + (size_t)h * D;
  const int kv0 = blockIdx.x * BKV;
  const int kw = warp * 16;      // this warp's first kv row in the tile
  const int j0 = kv0 + kw + g;   // the thread's kv rows j0 and j0 + 8
  const int bh = b * H + h;

  for (int it = tid; it < BKV * CH; it += 128) {
    const int row = it / CH, c8 = (it % CH) * 8;
    const size_t off = base + (size_t)(kv0 + row) * rs + c8;
    cp_async16(Ks + row * RS + c8, k + off);
    cp_async16(Vs + row * RS + c8, v + off);
  }
  // q tile i0 into ring stage st (lse2, di and segment ids by plain loads;
  // the barrier at the top of the loop publishes them)
  auto load_q = [&](int st, int i0) {
    __nv_bfloat16* qd = Qs + st * BQ * RS;
    __nv_bfloat16* od = Os + st * BQ * RS;
    for (int it = tid; it < BQ * CH; it += 128) {
      const int row = it / CH, c8 = (it % CH) * 8;
      const size_t off = base + (size_t)(i0 + row) * rs + c8;
      cp_async16(qd + row * RS + c8, q + off);
      cp_async16(od + row * RS + c8, dout + off);
    }
    if (tid < BQ) {
      const size_t r = ((size_t)b * T + i0 + tid) * H + h;
      lse_s[st * BQ + tid] = lse[r];
      di_s[st * BQ + tid] = di[r];
      qseg_s[st * BQ + tid] = seg ? seg[(size_t)b * T + i0 + tid] : 0;
    }
  };
  // the q tiles this block walks: all, or its (batch, kv tile)'s range
  int qt0 = 0, qt1 = T / BQ - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / BKV) + blockIdx.x];
    qt1 = q_hi[b * (T / BKV) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, qt1 - qt0 + 1);
  load_q(0, qt0 * BQ);
  cp_async_commit();  // K, V and the first q tile

  const int ks0 = seg ? seg[(size_t)b * T + j0] : 0;
  const int ks1 = seg ? seg[(size_t)b * T + j0 + 8] : 0;
  float dka[NN][4], dva[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = qt0; qt <= qt1; ++qt) {
    const int st = (qt - qt0) & 1;
    // the other stage was last read in the previous iteration, which ended
    // in a barrier: refill it with the next tile while this one is used
    if (qt + 1 <= qt1) load_q(st ^ 1, (qt + 1) * BQ);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + st * BQ * RS;
    const __nv_bfloat16* Ot = Os + st * BQ * RS;
    const float* lt = lse_s + st * BQ;
    const float* dt = di_s + st * BQ;
    const int* sg = qseg_s + st * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: 16 kv rows x BQ q columns a warp
    float s[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < NK / 2; ++p) {
      uint32_t ka0[4], ka1[4], va0[4], va1[4];
      const int arow = (kw + (lane & 15)) * RS + p * 32 + (lane >> 4) * 8;
      ldmatrix_x4(ka0, Ks + arow);
      ldmatrix_x4(ka1, Ks + arow + 16);
      ldmatrix_x4(va0, Vs + arow);
      ldmatrix_x4(va1, Vs + arow + 16);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bq[4], bo[4];
        const int brow = (n * 8 + (lane & 7)) * RS + p * 32 + (lane >> 3) * 8;
        ldmatrix_x4(bq, Qt + brow);
        ldmatrix_x4(bo, Ot + brow);
        mma_bf16(s[n], ka0, bq[0], bq[1]);
        mma_bf16(s[n], ka1, bq[2], bq[3]);
        mma_bf16(dpt[n], va0, bo[0], bo[1]);
        mma_bf16(dpt[n], va1, bo[2], bo[3]);
      }
    }

    // P^T from lse2, dropout, dS^T; s[] becomes dS^T and dpt[] P_drop^T.
    // Element e of n-tile n is (kv row j0 + 8 * (e >> 1), q row
    // i + (e & 1)) with i = qt * BQ + n * 8 + 2 * t4.
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int il = n * 8 + 2 * t4;
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = il + (e & 1);
        const float s2 = score(s[n][e], scale_log2, sg[ic], (e >> 1) ? ks1 : ks0);
        p[e] = exp2f(s2 - lt[ic]);
        d[e] = dpt[n][e];
      }
      float pd[4] = {p[0], p[1], p[2], p[3]};
      if constexpr (DROP) {
        // i is even: words (j & 1) and 2 + (j & 1) hold columns i and i + 1;
        // rows j0 and j0 + 8 share a parity
        const int i = qt * BQ + il;
        const Philox4 u = dropout_bits(dp.seed, bh, i, j0);
        const Philox4 w = dropout_bits(dp.seed, bh, i, j0 + 8);
        const int wj = j0 & 1;
        const uint32_t bits[4] = {pick(u, wj), pick(u, 2 + wj), pick(w, wj), pick(w, 2 + wj)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = bits[e] >= dp.thresh;
          pd[e] = keep ? p[e] * dp.keep_scale : 0.f;
          d[e] = keep ? d[e] * dp.keep_scale : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __fmul_rn(__fmul_rn(p[e], __fsub_rn(d[e], dt[il + (e & 1)])), scale);
        dpt[n][e] = pd[e];
      }
    }

    // dV += P_drop^T.dO and dK += dS^T.Q: A straight from the fragments, B
    // from the dO / Q rows by a transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t bo[4], bq[4];
        const int brow = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bo, Ot + brow);
        ldmatrix_x4_trans(bq, Qt + brow);
        mma_bf16(dva[2 * np], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * np + 1], pa, bo[2], bo[3]);
        mma_bf16(dka[2 * np], sa, bq[0], bq[1]);
        mma_bf16(dka[2 * np + 1], sa, bq[2], bq[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
  }

  // dv, and dk rotated back by -angle in fp32 (columns d and d + D/2 sit in
  // n-tiles n and n + NN/2 of the same thread)
  __nv_bfloat16* v0 = dv + base + (size_t)j0 * rs;
  __nv_bfloat16* v1 = v0 + 8 * rs;
  __nv_bfloat16* k0p = dk + base + (size_t)j0 * rs;
  __nv_bfloat16* k1p = k0p + 8 * rs;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(v0 + col) = pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(v1 + col) = pack_bf16(dva[n][2], dva[n][3]);
  }
  if (cos_t != nullptr) {
#pragma unroll
    for (int n = 0; n < NN / 2; ++n) {
      const int col = n * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + 8 * r;
        const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)j * HALF + col);
        const float2 sn = *reinterpret_cast<const float2*>(sin_t + (size_t)j * HALF + col);
        const float x1a = dka[n][2 * r], x1b = dka[n][2 * r + 1];
        const float x2a = dka[n + NN / 2][2 * r], x2b = dka[n + NN / 2][2 * r + 1];
        __nv_bfloat16* dst = r ? k1p : k0p;
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
      *reinterpret_cast<uint32_t*>(k0p + col) = pack_bf16(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(k1p + col) = pack_bf16(dka[n][2], dka[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 128 threads = 32 kv rows x 4 threads; thread `sub` of a row owns
// the head dims sub + 4*i (its k, v, dk and dv in registers), so a dot
// product is 4 partial sums joined by two shuffles. 16-row q tiles.
// ---------------------------------------------------------------------------
constexpr int kF32Kv = 32;
constexpr int kF32Q = 16;

template <int D, bool DROP, bool WITH_DQ>
__global__ void __launch_bounds__(128) mh_bwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int* __restrict__ tile_count,
    float* __restrict__ dq_acc, float* __restrict__ dk,
    float* __restrict__ dv, int T, int H, float scale_log2, float scale,
    DropParams dp) {
  constexpr int BKV = kF32Kv, BQ = kF32Q, HALF = D / 2, PER = D / 4;
  __shared__ __align__(16) float Ks[BKV * D];
  __shared__ __align__(16) float Qs[BQ * D];
  __shared__ __align__(16) float Os[BQ * D];
  __shared__ float dSs[BQ * BKV];
  __shared__ float lse_s[BQ], di_s[BQ];
  __shared__ int qseg_s[BQ];

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int sub = tid & 3, rl = tid >> 2, j = blockIdx.x * BKV + rl;
  const int bh = b * H + h;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * T * rs + (size_t)h * D;

  for (int it = tid; it < BKV * (D / 4); it += 128) {
    const int r = it / (D / 4), c4 = (it % (D / 4)) * 4;
    *reinterpret_cast<float4*>(Ks + r * D + c4) = *reinterpret_cast<const float4*>(
        k + base + (size_t)(blockIdx.x * BKV + r) * rs + c4);
  }
  float kr[PER], vr[PER], dka[PER], dva[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    kr[i] = k[base + (size_t)j * rs + sub + 4 * i];
    vr[i] = v[base + (size_t)j * rs + sub + 4 * i];
    dka[i] = dva[i] = 0.f;
  }
  const int ks = seg ? seg[(size_t)b * T + j] : 0;

  int qt0 = 0, qt1 = T / BQ - 1;
  if (q_lo != nullptr) {
    qt0 = q_lo[b * (T / BKV) + blockIdx.x];
    qt1 = q_hi[b * (T / BKV) + blockIdx.x];
  }
  if (tile_count != nullptr && tid == 0) atomicAdd(tile_count, qt1 - qt0 + 1);
  for (int i0 = qt0 * BQ; i0 <= qt1 * BQ; i0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int it = tid; it < BQ * (D / 4); it += 128) {
      const int r = it / (D / 4), c4 = (it % (D / 4)) * 4;
      const size_t off = base + (size_t)(i0 + r) * rs + c4;
      *reinterpret_cast<float4*>(Qs + r * D + c4) = *reinterpret_cast<const float4*>(q + off);
      *reinterpret_cast<float4*>(Os + r * D + c4) = *reinterpret_cast<const float4*>(dout + off);
    }
    if (tid < BQ) {
      const size_t r = ((size_t)b * T + i0 + tid) * H + h;
      lse_s[tid] = lse[r];
      di_s[tid] = di[r];
      qseg_s[tid] = seg ? seg[(size_t)b * T + i0 + tid] : 0;
    }
    __syncthreads();

    for (int qi = 0; qi < BQ; ++qi) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        sp = fmaf(kr[i], Qs[qi * D + sub + 4 * i], sp);
        dpp = fmaf(vr[i], Os[qi * D + sub + 4 * i], dpp);
      }
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      sp += __shfl_xor_sync(0xffffffffu, sp, 2);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 1);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 2);
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
        dva[i] = fmaf(pd, Os[qi * D + sub + 4 * i], dva[i]);
        dka[i] = fmaf(ds, Qs[qi * D + sub + 4 * i], dka[i]);
      }
      if (WITH_DQ && sub == 0) dSs[qi * BKV + rl] = ds;
    }
    __syncthreads();

    // dQ share of this kv tile: thread takes q row tid / 8, columns
    // (tid % 8) + 8 m
    if constexpr (WITH_DQ) {
      const int qi = tid >> 3, c0 = tid & 7;
      float* dst = dq_acc + base + (size_t)(i0 + qi) * rs;
      for (int m = 0; m < D / 8; ++m) {
        const int d = c0 + 8 * m;
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
  for (int i = 0; i < PER; ++i) dvr[sub + 4 * i] = dva[i];
  if (cos_t != nullptr) {
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const int d = sub + 4 * i;  // < HALF; its partner d + HALF is i + PER/2
      const float c = cos_t[(size_t)j * HALF + d], s = sin_t[(size_t)j * HALF + d];
      dkr[d] = rope_inv_lo(dka[i], dka[i + PER / 2], c, s);
      dkr[d + HALF] = rope_inv_hi(dka[i], dka[i + PER / 2], c, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) dkr[sub + 4 * i] = dka[i];
  }
}

// ---------------------------------------------------------------------------
// dq = inverse-RoPE(dq_acc) in fp32, cast to the output type. One thread
// per pair (d, d + D/2) of one (b, t, h) row.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D, typename OutT>
__global__ void dq_epilogue(const float* __restrict__ acc,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            OutT* __restrict__ out, int T, int H,
                            long long n_items) {
  constexpr int HALF = D / 2;
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const long long row = it / HALF;
  const int d = (int)(it % HALF);
  const float x1 = acc[row * D + d], x2 = acc[row * D + d + HALF];
  float lo = x1, hi = x2;
  if (cos_t != nullptr) {
    const int t = (int)((row / H) % T);
    const float c = cos_t[(size_t)t * HALF + d], s = sin_t[(size_t)t * HALF + d];
    lo = rope_inv_lo(x1, x2, c, s);
    hi = rope_inv_hi(x1, x2, c, s);
  }
  store_out(out + row * D + d, lo);
  store_out(out + row * D + d + HALF, hi);
}

}  // namespace bwd
}  // namespace obt
