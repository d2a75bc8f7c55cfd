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
// mh_flash_bwd_pair.cuh::mh_bwd_pair: a thread-block cluster of two CTAs
// (three at D = 384) owns a 64-row kv tile, each CTA the D = 256 kernel's
// work on its part of the head dim, the partial scores completed through
// distributed shared memory, each product but S^T done once; see its note.
// In fp32, and in bf16 past 512,
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
#include "mh_flash_bwd_pair.cuh"

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
        return (int)pair_backward<true>(q, k, v, dout, l, dd, qsg, kvsg, c, s, q_rot, lo, hi,
                                        tc, acc, dq, dk, dv, B, T, H, D, scale_log2, scale,
                                        drop != 0, dp, st);
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
         : D == 384 ? (int)pair_smem_bytes<384, true>()
         : D == 512 ? (int)pair_smem_bytes<512, true>()
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
