// Multi-head flash attention backward for Hopper (sm_90a), the dk/dv half
// of the split pair: dk and dv of one kv tile, summed over the q tiles.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_dkv_kernel (launched by _mh_bwd when the fused backward is
// switched off or cannot run) and, through the same source, ::
// _bwd_dkv_kernel (the per-head entry's, without RoPE or bounds). Same
// function, same rounding points as the fused kernel (mh_flash_bwd.cu):
// rotated q and k rounded to the input dtype, s2 with the finite mask bias,
// p = exp2(s2 - lse2), dp = do.v^T in fp32, p_drop and dp masked and scaled
// by the forward's keep-mask, ds from the undropped p, p_drop and ds
// rounded to the input dtype as operands, fp32 accumulators, the inverse
// rotation on the fp32 dk before its cast.
//
// Design. dk and dv are what the fused kernel computes for them, so the
// bf16 kernel is the fused kernel itself without its dq
// (mh_flash_bwd_kernels.cuh::mh_bwd_fused_bf16 with WITH_DQ = false): a CTA
// owns (batch, head, 128-row kv tile) and walks 64-row q tiles that a
// producer warpgroup streams through a TMA ring, two consumer warpgroups of
// 64 kv rows hold dk and dv in fp32 registers (at D = 256: a 64-row kv
// tile, one consumer holding dv and the other dk,
// mh_bwd_d256_bf16 without its dq), and the four products
// (S^T, dP^T, dV += P_drop^T.dO, dK += dS^T.Q) are wgmma. Every kv row has
// one owner, so dk and dv are the same bits from launch to launch. With
// q_lo / q_hi it walks only the q tiles whose segment-id range meets its kv
// tile's (the TPU kernel's use_bounds); a skipped tile would have added
// exact zeros, so dk and dv are bit for bit those of the full walk.
//
// Head dims past 256 (D % 128 == 0). In bf16 at D = 384 and 512 the fused
// kernel's cluster without its dq (mh_flash_bwd_pair.cuh::mh_bwd_pair with
// WITH_DQ = false): a thread-block cluster of two CTAs (three at D = 384)
// owns a 64-row kv tile, each CTA a part of the head dim closed under
// rotate-half, the partial S^T and dP^T summed in rank order through
// distributed shared memory; it takes lse2 and di as (B, H, T) and rotates
// k itself. In fp32, and in bf16 past 512, wide_attention.cuh::mh_bwd_wide
// without its dQ (a CTA a 64-row kv tile and a 128-lane slice of dk and
// dv). The route is by head dim and dtype (fused_route).
//
// Bound. At B=8, T=2048, H=8, D=128 in bf16 the four products are
// 8*B*T^2*H*D = 275 GFLOP over all (q, k) pairs (0.278 ms at 989 TFLOP/s),
// less in proportion to the visible tiles on packed rows; q, k, v, do, dk,
// dv, lse2 and di are 202 MB (0.06 ms at 3.35 TB/s): bound by operations.
#include "mh_flash_bwd_pair.cuh"

namespace {

using namespace obt;
using namespace obt::bwd;

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                   const float* cos_t, const float* sin_t, void* q_rot,
                   void* k_rot, const int* q_lo, const int* q_hi,
                   int* tile_count, void* dk, void* dv, int B, int T, int H,
                   float scale_log2, float scale, bool bf16, DropParams dp,
                   cudaStream_t st) {
  if (cos_t != nullptr) {
    // every kv tile reads all of q: rotated once; the bf16 kernel rotates
    // its own k rows
    launch_rope_rows(q, cos_t, sin_t, q_rot, B, T, H, D, bf16, st);
    q = q_rot;
    if (!bf16) {
      launch_rope_rows(k, cos_t, sin_t, k_rot, B, T, H, D, false, st);
      k = k_rot;
    }
  }
  if (bf16)
    return launch_bf16<D, DROP, false, false>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, di,
        q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, scale_log2,
        scale, dp, st);
  return launch_f32<D, DROP, false>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      q_seg, kv_seg, cos_t, sin_t, q_lo, q_hi, tile_count, nullptr,
      static_cast<float*>(dk), static_cast<float*>(dv), B, T, H, scale_log2,
      scale, dp, st);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* q_seg, const int* kv_seg,
                     const float* cos_t, const float* sin_t, void* q_rot,
                     void* k_rot, const int* q_lo, const int* q_hi,
                     int* tile_count, void* dk, void* dv, int B, int T, int H,
                     float scale_log2, float scale, bool bf16, bool drop,
                     DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_rot,
                                k_rot, q_lo, q_hi, tile_count, dk, dv, B, T, H,
                                scale_log2, scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, q_seg, kv_seg, cos_t, sin_t, q_rot,
                                 k_rot, q_lo, q_hi, tile_count, dk, dv, B, T, H,
                                 scale_log2, scale, bf16, dp, st);
}

// T multiple of each dtype's kernel: the bf16 CTA's 128 kv rows; the fp32
// kernel's 32-row kv tile, held to 64
constexpr int kBf16TMultiple = kBkv, kF32TMultiple = 64;

bool shape_ok(int B, int T, int H, int t_multiple) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= t_multiple &&
         T % t_multiple == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dk, dv (B, T, H, D) of
// that type, D 64, 128, 256 or a multiple of 128 past 256, T a multiple of
// 64 (fp32) or 128 (bf16); lse2 and di fp32, (B, H, T) for bf16 up to 256
// and at 384 and 512 (the producer bulk-copies a q tile's 64 values of one
// head), else (B, T, H); q_seg and kv_seg (B, T) int32, both
// null or both given (as in obt_mh_flash_fwd). With RoPE
// (cos_t and sin_t non-null), q_rot is a scratch tensor of q's shape and
// type, and so is k_rot where lse2 is (B, T, H) (the other kernels rotate k
// in the kernel; k_rot may be null there). q_lo and q_hi, both null or both
// int32 (B, T / kv tile) in units of the dtype's q tile (kv tile 128, 64 at
// D = 256, and q tile 64 for bf16; 32 and 16 for fp32; 64 and 64 past 256),
// bound the q tiles each kv tile walks; tile_count is null or
// one int32 that the walked tiles are added to. drop != 0 applies the
// forward's dropout (thresh, keep_scale, seed as in obt_mh_flash_fwd).
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a shape or type this file has no kernel for). Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int obt_mh_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* di, const void* q_seg, const void* kv_seg,
                                    const void* cos_t, const void* sin_t,
                                    void* q_rot, void* k_rot, const void* q_lo,
                                    const void* q_hi, void* tile_count,
                                    void* dk, void* dv, int B, int T, int H,
                                    int D, float scale_log2, float scale,
                                    int dtype, int drop, uint32_t thresh,
                                    float keep_scale, uint64_t seed,
                                    void* stream) {
  if ((dtype != 0 && dtype != 1) ||
      !shape_ok(B, T, H, dtype == 1 ? kBf16TMultiple : kF32TMultiple) ||
      (cos_t != nullptr &&
       (sin_t == nullptr || q_rot == nullptr || (dtype == 0 && k_rot == nullptr))) ||
      ((q_lo == nullptr) != (q_hi == nullptr)) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* qsg = static_cast<const int*>(q_seg);
  const int* kvsg = static_cast<const int*>(kv_seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* lo = static_cast<const int*>(q_lo);
  const int* hi = static_cast<const int*>(q_hi);
  int* tc = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 256: return (int)launch_d<256>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo, hi, tc, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default:
      if (!obt::wide::head_dim_ok(D)) return (int)cudaErrorInvalidValue;
      if (dtype == 1 && pair_head_dim(D))
        return (int)pair_backward<false>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, lo, hi,
                                         tc, nullptr, nullptr, dk, dv, B, T, H, D, scale_log2,
                                         scale, drop != 0, dp, st);
      return (int)obt::wide::backward<false>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, k_rot, lo,
                                        hi, tc, nullptr, nullptr, dk, dv, B, T, H, D,
                                        scale_log2, scale, dtype == 1, drop != 0,
                                        obt::wide::Drop{seed, thresh, keep_scale}, st);
  }
}

// The bf16 kernel's products alone (its DOTS instance), bf16 (B, T, H, 128)
// q, k, v, dout -> dk, dv, T a multiple of 128: with P = round(k.q^T) and
// dS = round(v.do^T) per head (kv rows by q rows, fp32 products rounded to
// bf16), dv = round(P.do) and dk = round(dS.q), each summed in fp32 over
// 64-row q tiles. Launches on `stream`; returns cudaGetLastError().
extern "C" int obt_mh_flash_bwd_dkv_dots(const void* q, const void* k, const void* v,
                                         const void* dout, void* dk, void* dv, int B, int T,
                                         int H, int D, void* stream) {
  if (!shape_ok(B, T, H, kBf16TMultiple) || D != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<128, false, true, false>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H, 0.f, 0.f,
      DropParams{0, 0, 1.f}, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a CTA of the bf16 kernel takes at head dim D (-1
// for a head dim it is not built for).
extern "C" int obt_mh_flash_bwd_dkv_smem_bytes(int D) {
  return D == 64    ? (int)bf16_smem_bytes<64, false>()
         : D == 128 ? (int)bf16_smem_bytes<128, false>()
         : D == 256 ? (int)bf16_smem_bytes_256()
         : D == 384 ? (int)pair_smem_bytes<384, false>()
         : D == 512 ? (int)pair_smem_bytes<512, false>()
         : obt::wide::head_dim_ok(D) ? obt::wide::bwd_smem_bytes()
                    : -1;
}

// The name of the kernel obt_mh_flash_bwd_dkv launches at head dim D and
// dtype (0 = float32, 1 = bfloat16), each without its dq:
// "mh_bwd_fused_bf16", "mh_bwd_d256_bf16", "mh_bwd_pair", "mh_bwd_f32",
// "mh_bwd_wide", or "none".
extern "C" const char* obt_mh_flash_bwd_dkv_route(int D, int dtype) {
  return fused_route(D, dtype);
}

extern "C" const char* obt_cuda_error_string_bwd_dkv(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
