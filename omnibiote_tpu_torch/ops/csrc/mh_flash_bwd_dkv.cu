// Multi-head flash attention backward for Hopper (sm_90a), the dk/dv half
// of the split pair: dk and dv of one kv tile, summed over the q tiles.
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/flash_attention.py::
// _mh_bwd_dkv_kernel (launched by _mh_bwd when the fused backward is
// switched off or cannot run). Same function, same rounding points as the
// fused kernel (mh_flash_bwd.cu): rotated q and k rounded to the input
// dtype, s2 with the finite mask bias, p = exp2(s2 - lse2), dp = do.v^T in
// fp32, p_drop and dp masked and scaled by the forward's keep-mask, ds from
// the undropped p, p_drop and ds rounded to the input dtype as operands,
// fp32 accumulators, the inverse rotation on the fp32 dk before its cast.
//
// Design. The TPU kernel's grid is (batch, kv block, q block) with q as the
// sequential axis and dk/dv accumulators in VMEM scratch. Here one block owns
// (batch, head, 64-row kv tile), keeps dk and dv in fp32 registers and loops
// over 32-row q tiles streamed through a two-stage cp.async ring
// (mh_flash_bwd_kernels.cuh::mh_bwd_bf16, mma.sync m16n8k16 fed by
// ldmatrix). Four products a tile (S^T, dP^T, dV, dK). With q_lo / q_hi it walks only
// the q tiles whose segment-id range meets its kv tile's (the TPU kernel's
// use_bounds); a skipped tile would have added exact zeros, so dk and dv
// are bit for bit those of the full walk.
//
// Bound. At B=8, T=2048, H=8, D=128 in bf16 the four products are
// 8*B*T^2*H*D = 275 GFLOP over all (q, k) pairs (0.278 ms at 989 TFLOP/s),
// less in proportion to the visible tiles on packed rows; q, k, v, do, dk,
// dv, lse2 and di are 202 MB (0.06 ms at 3.35 TB/s): bound by operations.
#include "mh_flash_bwd_kernels.cuh"

namespace {

using namespace obt;
using namespace obt::bwd;

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* seg,
                   const float* cos_t, const float* sin_t, void* q_rot,
                   void* k_rot, const int* q_lo, const int* q_hi,
                   int* tile_count, void* dk, void* dv, int B, int T, int H,
                   float scale_log2, float scale, bool bf16, DropParams dp,
                   cudaStream_t st) {
  if (cos_t != nullptr) {
    launch_rope_rows<D>(q, cos_t, sin_t, q_rot, B, T, H, bf16, st);
    launch_rope_rows<D>(k, cos_t, sin_t, k_rot, B, T, H, bf16, st);
    q = q_rot;
    k = k_rot;
  }
  if (bf16) {
    const size_t smem = bwd_bf16_smem_bytes<D>();
    const cudaError_t e = cudaFuncSetAttribute(
        mh_bwd_bf16<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mh_bwd_bf16<D, DROP><<<dim3(T / kDkvKvTile, H, B), 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, di, seg, cos_t, sin_t, q_lo, q_hi, tile_count,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, H,
        scale_log2, scale, dp);
  } else {
    mh_bwd_f32<D, DROP, false><<<dim3(T / kF32Kv, H, B), 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
        seg, cos_t, sin_t, q_lo, q_hi, tile_count, nullptr,
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale_log2,
        scale, dp);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* seg,
                     const float* cos_t, const float* sin_t, void* q_rot,
                     void* k_rot, const int* q_lo, const int* q_hi,
                     int* tile_count, void* dk, void* dv, int B, int T, int H,
                     float scale_log2, float scale, bool bf16, bool drop,
                     DropParams dp, cudaStream_t st) {
  return drop ? launch<D, true>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                k_rot, q_lo, q_hi, tile_count, dk, dv, B, T, H,
                                scale_log2, scale, bf16, dp, st)
              : launch<D, false>(q, k, v, dout, lse, di, seg, cos_t, sin_t, q_rot,
                                 k_rot, q_lo, q_hi, tile_count, dk, dv, B, T, H,
                                 scale_log2, scale, bf16, dp, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v, dout, dk, dv (B, T, H, D) of
// that type; lse2 and di (B, T, H) fp32; seg (B, T) int32 or null; with RoPE
// (cos_t and sin_t non-null), q_rot and k_rot are scratch tensors of q's
// shape and type. q_lo and q_hi, both null or both int32 (B, T / kv tile) in
// units of the dtype's q tile (kv tile 64 and q tile 32 for bf16, 32 and 16
// for fp32), bound the q tiles each kv tile walks; tile_count is null or one
// int32 that the walked tiles are added to. drop != 0 applies the forward's
// dropout (thresh, keep_scale, seed as in obt_mh_flash_fwd). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a shape
// or type this file has no kernel for). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int obt_mh_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* di, const void* seg,
                                    const void* cos_t, const void* sin_t,
                                    void* q_rot, void* k_rot, const void* q_lo,
                                    const void* q_hi, void* tile_count,
                                    void* dk, void* dv, int B, int T, int H,
                                    int D, float scale_log2, float scale,
                                    int dtype, int drop, uint32_t thresh,
                                    float keep_scale, uint64_t seed,
                                    void* stream) {
  if ((dtype != 0 && dtype != 1) || T < kDkvKvTile || T % kDkvKvTile != 0 || B < 1 ||
      B > 65535 || H < 1 || H > 65535 ||
      (cos_t != nullptr && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)) ||
      ((q_lo == nullptr) != (q_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DropParams dp{seed, thresh, keep_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const int* sg = static_cast<const int*>(seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* lo = static_cast<const int*>(q_lo);
  const int* hi = static_cast<const int*>(q_hi);
  int* tc = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, lo, hi, tc, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    case 128: return (int)launch_d<128>(q, k, v, dout, l, dd, sg, c, s, q_rot, k_rot, lo, hi, tc, dk, dv, B, T, H, scale_log2, scale, dtype == 1, drop != 0, dp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* obt_cuda_error_string_bwd_dkv(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
