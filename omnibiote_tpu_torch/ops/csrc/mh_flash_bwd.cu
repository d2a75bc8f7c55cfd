// Multi-head flash attention backward for Hopper (sm_90a): dq, dk and dv in
// one pass over the (q, kv) plane, with RoPE and dropout.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_fused_kernel (launched by _mh_bwd_fused, the single-kv fused
// backward that _mh_bwd takes at T <= 1024). Same function, same rounding
// points:
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
// di = rowsum(o * do) (B, T, H) fp32 comes from the caller, as in JAX.
//
// Design. The TPU kernel carries full-length dk/dv accumulators in VMEM
// over a sequential q grid; Hopper blocks run in no order. Here one block
// owns (batch, head, 64-row kv tile), holds that tile's dk and dv in fp32
// registers (16 kv rows a warp) and loops over 32-row q tiles. It computes
// the transposed scores S^T = K.Q^T and dP^T = V.dO^T, so that P_drop^T
// and dS^T come out of the accumulators already in the A-operand layout
// of dV += P_drop^T.dO and dK += dS^T.Q (mma.sync m16n8k16, bf16 in, fp32
// accumulate; Q and dO tiles stream through a two-stage cp.async ring).
// dQ needs a sum over every kv tile: each block writes its dS^T tile to
// shared memory, forms its 32x128 share dS.K with mma, and adds it into an
// fp32 dq scratch with atomicAdd (float2). So the order of the dq sums
// changes from run to run (dq is not bitwise deterministic; dk and dv are).
// A small epilogue kernel applies the inverse RoPE to the fp32 dq and
// casts it; dk's inverse rotation happens in registers before its store.
// Chosen over a deterministic second pass for dq, which would recompute s
// and dp (7 products a tile instead of 5).
//
// Bound. At the training shape (B=16, T=1024, H=8, D=128, bf16) the five
// products are 10*B*T^2*H*D = 171.8 GFLOP (0.174 ms at 989 TFLOP/s bf16);
// the bytes it must move (q, k, v, do, dq, dk, dv, lse2, di and the 67 MB
// fp32 dq scratch) take under 0.1 ms at 3.35 TB/s: bound by operations.
// wgmma, TMA, warp specialisation, segment-range tile skipping and a
// cheaper dropout draw are left for later work. The fp32 kernel is the
// parity type and runs on the CUDA cores.
#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace obt;

struct DropParams {
  uint64_t seed;
  uint32_t thresh;
  float keep_scale;
};

__device__ __forceinline__ uint32_t pick(const Philox4& u, int w) {
  return w == 0 ? u.w[0] : w == 1 ? u.w[1] : w == 2 ? u.w[2] : u.w[3];
}

// ---------------------------------------------------------------------------
// bf16: 4 warps; a block owns 64 kv rows (16 a warp) and walks 32-row q
// tiles. Fragment layout of m16n8k16 as in mh_flash_fwd.cu; the accumulator
// rows are kv rows j, its columns q rows i.
// ---------------------------------------------------------------------------
constexpr int kKvTile = 64;
constexpr int kQTile = 32;

template <int D>
constexpr size_t bwd_bf16_smem_bytes() {
  // K and V tiles; two stages of Q and dO tiles; dS^T; two stages of lse2,
  // di and q segment ids. Rows padded by 8 elements against bank conflicts.
  return (2 * kKvTile * (D + 8) + 2 * 2 * kQTile * (D + 8) + kKvTile * (kQTile + 8)) *
             sizeof(__nv_bfloat16) +
         2 * 3 * kQTile * sizeof(float);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_bwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float* __restrict__ dq_acc,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T,
    int H, float scale_log2, float scale, DropParams dp) {
  constexpr int BKV = kKvTile, BQ = kQTile, HALF = D / 2;
  constexpr int RS = D + 8;     // K, V, Q and dO tile row stride (elements)
  constexpr int DSS = BQ + 8;   // dS^T row stride
  constexpr int CH = D / 8;     // 16-byte chunks in a row
  constexpr int NK = D / 16;    // k-steps over the head dim
  constexpr int NN = D / 8;     // n-tiles of dk / dv
  constexpr int NS = BQ / 8;    // n-tiles of a score tile (q columns)
  constexpr int NQ = D / 16;    // n-tiles of a warp's half of a dq row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BKV][RS]
  __nv_bfloat16* Vs = Ks + BKV * RS;                            // [BKV][RS]
  __nv_bfloat16* Qs = Vs + BKV * RS;                            // [2][BQ][RS]
  __nv_bfloat16* Os = Qs + 2 * BQ * RS;                         // [2][BQ][RS]
  __nv_bfloat16* dSs = Os + 2 * BQ * RS;                        // [BKV][DSS]
  float* lse_s = reinterpret_cast<float*>(dSs + BKV * DSS);     // [2][BQ]
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
  load_q(0, 0);
  cp_async_commit();  // K, V and the first q tile

  const int ks0 = seg ? seg[(size_t)b * T + j0] : 0;
  const int ks1 = seg ? seg[(size_t)b * T + j0 + 8] : 0;
  float dka[NN][4], dva[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_q = T / BQ;
  for (int qt = 0; qt < n_q; ++qt) {
    const int st = qt & 1;
    // the other stage was last read in the previous iteration, which ended
    // in a barrier: refill it with the next tile while this one is used
    if (qt + 1 < n_q) load_q(st ^ 1, (qt + 1) * BQ);
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

    // dS^T (bf16) to shared memory for the dq product
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int il = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dSs + (kw + g) * DSS + il) = pack_bf16(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(dSs + (kw + g + 8) * DSS + il) = pack_bf16(s[n][2], s[n][3]);
    }
    __syncthreads();

    // dQ share of this kv tile, (BQ x D) = dS (BQ x BKV) . K (BKV x D):
    // warp w takes q rows 16 * (w & 1) and half the head dim, (w >> 1)
    {
      const int qr0 = (warp & 1) * 16, dc0 = (warp >> 1) * HALF;
      float acc[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t a[4];
        // A = dS rows, stored transposed as dS^T: a transposing ldmatrix
        ldmatrix_x4_trans(a, dSs + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * DSS +
                                 qr0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, Ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                    dc0 + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], a, bk[0], bk[1]);
          mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      float* d0 = dq_acc + base + (size_t)(qt * BQ + qr0 + g) * rs + dc0;
      float* d1 = d0 + 8 * rs;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = n * 8 + 2 * t4;
        atomicAdd(reinterpret_cast<float2*>(d0 + col), make_float2(acc[n][0], acc[n][1]));
        atomicAdd(reinterpret_cast<float2*>(d1 + col), make_float2(acc[n][2], acc[n][3]));
      }
    }
    __syncthreads();  // every warp is done with this stage and with dS^T
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

template <int D, bool DROP>
__global__ void __launch_bounds__(128) mh_bwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ seg, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float* __restrict__ dq_acc,
    float* __restrict__ dk, float* __restrict__ dv, int T, int H,
    float scale_log2, float scale, DropParams dp) {
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

  for (int i0 = 0; i0 < T; i0 += BQ) {
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
      if (sub == 0) dSs[qi * BKV + rl] = ds;
    }
    __syncthreads();

    // dQ share of this kv tile: thread takes q row tid / 8, columns
    // (tid % 8) + 8 m
    {
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

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* seg,
                   const float* cos_t, const float* sin_t, void* q_rot,
                   void* k_rot, float* dq_acc, void* dq, void* dk, void* dv,
                   int B, int T, int H, float scale_log2, float scale,
                   bool bf16, DropParams dp, cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows<D>(q, cos_t, sin_t, q_rot, B, T, H, bf16, st);
    launch_rope_rows<D>(k, cos_t, sin_t, k_rot, B, T, H, bf16, st);
    q = q_rot;
    k = k_rot;
  }
  const long long n_rows = (long long)B * T * H;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, (size_t)n_rows * D * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const long long n_pairs = n_rows * (D / 2);
  const unsigned epi_blocks = (unsigned)((n_pairs + 255) / 256);
  if (bf16) {
    const size_t smem = bwd_bf16_smem_bytes<D>();
    e = cudaFuncSetAttribute(mh_bwd_bf16<D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mh_bwd_bf16<D, DROP><<<dim3(T / kKvTile, H, B), 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, di, seg, cos_t, sin_t, dq_acc, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), T, H, scale_log2, scale, dp);
    dq_epilogue<D, __nv_bfloat16><<<epi_blocks, 256, 0, st>>>(
        dq_acc, cos_t, sin_t, static_cast<__nv_bfloat16*>(dq), T, H, n_pairs);
  } else {
    mh_bwd_f32<D, DROP><<<dim3(T / kF32Kv, H, B), 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
        seg, cos_t, sin_t, dq_acc, static_cast<float*>(dk),
        static_cast<float*>(dv), T, H, scale_log2, scale, dp);
    dq_epilogue<D, float><<<epi_blocks, 256, 0, st>>>(
        dq_acc, cos_t, sin_t, static_cast<float*>(dq), T, H, n_pairs);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* seg,
                     const float* cos_t, const float* sin_t, void* q_rot,
                     void* k_rot, float* dq_acc, void* dq, void* dk, void* dv,
                     int B, int T, int H, float scale_log2, float scale,
                     bool bf16, bool drop, DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                k_rot, dq_acc, dq, dk, dv, B, T, H, scale_log2,
                                scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                 k_rot, dq_acc, dq, dk, dv, B, T, H, scale_log2,
                                 scale, bf16, dp, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv (B, T, H, D)
// of that type; lse2 and di (B, T, H) fp32; seg (B, T) int32 or null; with
// RoPE (cos_t and sin_t non-null), q_rot and k_rot are scratch tensors of
// q's shape and type; dq_acc is an fp32 scratch of q's shape (zeroed here).
// drop != 0 applies the forward's dropout (thresh, keep_scale, seed as in
// obt_mh_flash_fwd). Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or type this file has no kernel for).
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int obt_mh_flash_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, const void* seg,
                                const void* cos_t, const void* sin_t,
                                void* q_rot, void* k_rot, void* dq_acc,
                                void* dq, void* dk, void* dv, int B, int T,
                                int H, int D, float scale_log2, float scale,
                                int dtype, int drop, uint32_t thresh,
                                float keep_scale, uint64_t seed, void* stream) {
  if ((dtype != 0 && dtype != 1) || T < kKvTile || T % kKvTile != 0 || B < 1 ||
      B > 65535 || H < 1 || H > 65535 || dq_acc == nullptr ||
      (cos_t != nullptr && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* sg = static_cast<const int*>(seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, acc, dq, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* obt_cuda_error_string_bwd(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
