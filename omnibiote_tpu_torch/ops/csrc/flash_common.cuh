// Pieces shared by the multi-head flash attention kernels (forward and
// backward): the JAX package's rounding points for RoPE and the masked
// log2-space scores, bf16 packing, rows rotated into swizzled wgmma panels,
// and the kernels around the attention kernels at any head dim: the RoPE
// pre-rotation and the dq epilogue of fp32 sums.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace obt {

// DEFAULT_MASK_VALUE of the JAX package: finite, so a fully masked row
// attends uniformly instead of turning into NaN.
constexpr float kMaskValue = -0.7f * FLT_MAX;

// rotate-half, unfused (no FMA contraction) to round exactly as the plain
// version's separate multiply and add: [x1 c - x2 s | x2 c + x1 s]
__device__ __forceinline__ float rope_lo(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x1, c), -__fmul_rn(x2, s));
}
__device__ __forceinline__ float rope_hi(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}
// the inverse rotation (rotate by -angle): [x1 c + x2 s | x2 c - x1 s]
__device__ __forceinline__ float rope_inv_lo(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}
__device__ __forceinline__ float rope_inv_hi(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), -__fmul_rn(x1, s));
}

// s2 = (q.k) * (scale * log2 e) + bias, the bias added after the multiply
__device__ __forceinline__ float score(float s, float scale_log2, int qs, int ks) {
  return __fadd_rn(__fmul_rn(s, scale_log2), qs == ks ? 0.0f : kMaskValue);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows src + r * ld (r < n_rows, D bf16 columns each) into rows dst_r0 + r
// of a 128-byte-swizzled tile of tile_rows rows at dst (hopper.cuh),
// rotated (rotate-half in fp32 from the cos/sin half tables at sequence
// position t0 + r, rounded) when cos_t is non-null, else copied. Thread tid
// of n_threads takes every n_threads-th (row, 8 columns of each half) item.
// WQ < D / 2 copies a part of the row closed under rotate-half: lanes
// [c_lo, c_lo + WQ) to tile columns [0, WQ) and lanes D/2 + the same to
// [WQ, 2 WQ).
template <int D, int WQ = D / 2>
__device__ __forceinline__ void rows_to_panels(unsigned char* dst, int tile_rows, int dst_r0,
                                               const __nv_bfloat16* src, size_t ld,
                                               int n_rows, const float* cos_t,
                                               const float* sin_t, int t0, int tid,
                                               int n_threads, int c_lo = 0) {
  constexpr int HALF = D / 2;
  for (int it = tid; it < n_rows * (WQ / 8); it += n_threads) {
    const int r = it / (WQ / 8), c8 = (it % (WQ / 8)) * 8;
    const __nv_bfloat16* p = src + (size_t)r * ld + c_lo + c8;
    uint4 lo = *reinterpret_cast<const uint4*>(p);
    uint4 hi = *reinterpret_cast<const uint4*>(p + HALF);
    if (cos_t != nullptr) {
      const float* cp = cos_t + (size_t)(t0 + r) * HALF + c_lo + c8;
      const float* sp = sin_t + (size_t)(t0 + r) * HALF + c_lo + c8;
      const __nv_bfloat162* x1 = reinterpret_cast<const __nv_bfloat162*>(&lo);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
      uint32_t yl[4], yh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(x1[e]), w = __bfloat1622float2(x2[e]);
        const float2 c = *reinterpret_cast<const float2*>(cp + 2 * e);
        const float2 s = *reinterpret_cast<const float2*>(sp + 2 * e);
        yl[e] = pack_bf16(rope_lo(u.x, w.x, c.x, s.x), rope_lo(u.y, w.y, c.y, s.y));
        yh[e] = pack_bf16(rope_hi(u.x, w.x, c.x, s.x), rope_hi(u.y, w.y, c.y, s.y));
      }
      lo = make_uint4(yl[0], yl[1], yl[2], yl[3]);
      hi = make_uint4(yh[0], yh[1], yh[2], yh[3]);
    }
    *reinterpret_cast<uint4*>(dst + swizzled_offset(tile_rows, dst_r0 + r, c8)) = lo;
    *reinterpret_cast<uint4*>(dst + swizzled_offset(tile_rows, dst_r0 + r, c8 + WQ)) = hi;
  }
}

// fp32 rows src + r * ld (r < n_rows, D columns each) into shared rows dst
// + r * dld, rotated (rotate-half from the cos/sin half tables at sequence
// position t0 + r) when cos_t is non-null, else copied. Thread tid of
// n_threads takes every n_threads-th (row, 4 columns of each half) item.
template <int D>
__device__ __forceinline__ void rows_rotated_f32(float* dst, int dld, const float* src,
                                                 size_t ld, int n_rows, const float* cos_t,
                                                 const float* sin_t, int t0, int tid,
                                                 int n_threads) {
  constexpr int HALF = D / 2;
  for (int it = tid; it < n_rows * (HALF / 4); it += n_threads) {
    const int r = it / (HALF / 4), c = (it % (HALF / 4)) * 4;
    const float* p = src + (size_t)r * ld + c;
    float4 lo = *reinterpret_cast<const float4*>(p);
    float4 hi = *reinterpret_cast<const float4*>(p + HALF);
    if (cos_t != nullptr) {
      const float4 cs = *reinterpret_cast<const float4*>(cos_t + (size_t)(t0 + r) * HALF + c);
      const float4 sn = *reinterpret_cast<const float4*>(sin_t + (size_t)(t0 + r) * HALF + c);
      const float4 l = lo;
      lo = make_float4(rope_lo(l.x, hi.x, cs.x, sn.x), rope_lo(l.y, hi.y, cs.y, sn.y),
                       rope_lo(l.z, hi.z, cs.z, sn.z), rope_lo(l.w, hi.w, cs.w, sn.w));
      hi = make_float4(rope_hi(l.x, hi.x, cs.x, sn.x), rope_hi(l.y, hi.y, cs.y, sn.y),
                       rope_hi(l.z, hi.z, cs.z, sn.z), rope_hi(l.w, hi.w, cs.w, sn.w));
    }
    *reinterpret_cast<float4*>(dst + r * dld + c) = lo;
    *reinterpret_cast<float4*>(dst + r * dld + HALF + c) = hi;
  }
}

// ---------------------------------------------------------------------------
// x_rot = rotate-half(x) in fp32, rounded to the input dtype, for every
// (b, t, h) row of a (B, T, H, D) tensor, at any head dim D % 16 == 0. One
// thread a 16-byte vector of each half (8 bf16 or 4 fp32 pairs (d, d + D/2)).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                            pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename E>
__global__ void rope_rows(const E* __restrict__ x, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, E* __restrict__ out, int T, int H,
                          int D, long long n_items) {
  constexpr int V = 16 / sizeof(E);
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const int half = D / 2, per_row = half / V;
  const long long row = it / per_row;
  const int c = (int)(it % per_row) * V;
  const int t = (int)((row / H) % T);
  float lo[V], hi[V];
  load_vec(x + row * D + c, lo);
  load_vec(x + row * D + half + c, hi);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float cs = cos_t[(size_t)t * half + c + e], sn = sin_t[(size_t)t * half + c + e];
    const float rl = rope_lo(lo[e], hi[e], cs, sn);
    hi[e] = rope_hi(lo[e], hi[e], cs, sn);
    lo[e] = rl;
  }
  store_vec(out + row * D + c, lo);
  store_vec(out + row * D + half + c, hi);
}

// Rotate the rows of x (B, T, H, D) into out; bf16 or fp32. (A template, so
// that only the sources that launch it build its kernels.)
template <typename = void>
void launch_rope_rows(const void* x, const float* cos_t, const float* sin_t, void* out, int B,
                      int T, int H, int D, bool bf16, cudaStream_t st) {
  const long long n_pairs = (long long)B * T * H * (D / 2);
  if (bf16) {
    const long long n = n_pairs / 8;
    rope_rows<__nv_bfloat16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cos_t, sin_t, static_cast<__nv_bfloat16*>(out),
        T, H, D, n);
  } else {
    const long long n = n_pairs / 4;
    rope_rows<float><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(x), cos_t, sin_t, static_cast<float*>(out), T, H, D, n);
  }
}

// ---------------------------------------------------------------------------
// dq = inverse-RoPE(dq_acc) in fp32 (when cos_t is non-null), cast to the
// output type, from fp32 sums in the (B, T, H, D) layout, or (B, H, T, D)
// with BHTD. One thread per pair (d, d + D/2) of one (b, t, h) row.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename OutT, bool BHTD = false>
__global__ void dq_epilogue(const float* __restrict__ acc, const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t, OutT* __restrict__ out, int T,
                            int H, int D, long long n_items) {
  const int half = D / 2;
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const long long row = it / half;
  const int d = (int)(it % half);
  // row = (b T + t) H + h; its sums at (b H + h) T + t with BHTD
  const long long arow =
      BHTD ? ((row / ((long long)T * H)) * H + row % H) * T + (row / H) % T : row;
  const float x1 = acc[arow * D + d], x2 = acc[arow * D + d + half];
  float lo = x1, hi = x2;
  if (cos_t != nullptr) {
    const int t = (int)((row / H) % T);
    const float c = cos_t[(size_t)t * half + d], s = sin_t[(size_t)t * half + d];
    lo = rope_inv_lo(x1, x2, c, s);
    hi = rope_inv_hi(x1, x2, c, s);
  }
  store_out(out + row * D + d, lo);
  store_out(out + row * D + d + half, hi);
}

}  // namespace obt
