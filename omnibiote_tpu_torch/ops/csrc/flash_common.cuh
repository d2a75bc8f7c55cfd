// Pieces shared by the multi-head flash attention kernels (forward and
// backward): the JAX package's rounding points for RoPE and the masked
// log2-space scores, bf16 packing, the RoPE pre-rotation kernels, and rows
// rotated into swizzled wgmma panels.
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
template <int D>
__device__ __forceinline__ void rows_to_panels(unsigned char* dst, int tile_rows, int dst_r0,
                                               const __nv_bfloat16* src, size_t ld,
                                               int n_rows, const float* cos_t,
                                               const float* sin_t, int t0, int tid,
                                               int n_threads) {
  constexpr int HALF = D / 2;
  for (int it = tid; it < n_rows * (HALF / 8); it += n_threads) {
    const int r = it / (HALF / 8), c8 = (it % (HALF / 8)) * 8;
    const __nv_bfloat16* p = src + (size_t)r * ld + c8;
    uint4 lo = *reinterpret_cast<const uint4*>(p);
    uint4 hi = *reinterpret_cast<const uint4*>(p + HALF);
    if (cos_t != nullptr) {
      const float* cp = cos_t + (size_t)(t0 + r) * HALF + c8;
      const float* sp = sin_t + (size_t)(t0 + r) * HALF + c8;
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
    *reinterpret_cast<uint4*>(dst + swizzled_offset(tile_rows, dst_r0 + r, c8 + HALF)) = hi;
  }
}

// ---------------------------------------------------------------------------
// x_rot = rotate-half(x) in fp32, rounded to the input dtype, for every
// (b, t, h) row of a (B, T, H, D) tensor. One thread per 8 (bf16) or 4
// (fp32) pairs (d, d + D/2) of one row.
// ---------------------------------------------------------------------------
template <int D>
__global__ void rope_rows_bf16(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t,
                               __nv_bfloat16* __restrict__ out, int T, int H,
                               long long n_items) {
  constexpr int HALF = D / 2, PER_ROW = HALF / 8;
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const long long row = it / PER_ROW;
  const int c8 = (int)(it % PER_ROW) * 8;
  const int t = (int)((row / H) % T);
  const __nv_bfloat16* src = x + row * D + c8;
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint4 bb = *reinterpret_cast<const uint4*>(src + HALF);
  const float* cp = cos_t + (size_t)t * HALF + c8;
  const float* sp = sin_t + (size_t)t * HALF + c8;
  const __nv_bfloat162* x1 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&bb);
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x1[e]), w = __bfloat1622float2(x2[e]);
    const float2 c = *reinterpret_cast<const float2*>(cp + 2 * e);
    const float2 s = *reinterpret_cast<const float2*>(sp + 2 * e);
    lo[e] = pack_bf16(rope_lo(u.x, w.x, c.x, s.x), rope_lo(u.y, w.y, c.y, s.y));
    hi[e] = pack_bf16(rope_hi(u.x, w.x, c.x, s.x), rope_hi(u.y, w.y, c.y, s.y));
  }
  __nv_bfloat16* dst = out + row * D + c8;
  *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dst + HALF) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

template <int D>
__global__ void rope_rows_f32(const float* __restrict__ x,
                              const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t,
                              float* __restrict__ out, int T, int H,
                              long long n_items) {
  constexpr int HALF = D / 2, PER_ROW = HALF / 4;
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_items) return;
  const long long row = it / PER_ROW;
  const int c4 = (int)(it % PER_ROW) * 4;
  const int t = (int)((row / H) % T);
  const float* src = x + row * D + c4;
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 bb = *reinterpret_cast<const float4*>(src + HALF);
  const float4 c = *reinterpret_cast<const float4*>(cos_t + (size_t)t * HALF + c4);
  const float4 s = *reinterpret_cast<const float4*>(sin_t + (size_t)t * HALF + c4);
  float* dst = out + row * D + c4;
  *reinterpret_cast<float4*>(dst) =
      make_float4(rope_lo(a.x, bb.x, c.x, s.x), rope_lo(a.y, bb.y, c.y, s.y),
                  rope_lo(a.z, bb.z, c.z, s.z), rope_lo(a.w, bb.w, c.w, s.w));
  *reinterpret_cast<float4*>(dst + HALF) =
      make_float4(rope_hi(a.x, bb.x, c.x, s.x), rope_hi(a.y, bb.y, c.y, s.y),
                  rope_hi(a.z, bb.z, c.z, s.z), rope_hi(a.w, bb.w, c.w, s.w));
}

// Rotate the rows of x (B, T, H, D) into out; bf16 or fp32.
template <int D>
void launch_rope_rows(const void* x, const float* cos_t, const float* sin_t,
                      void* out, int B, int T, int H, bool bf16,
                      cudaStream_t st) {
  const long long n_pairs = (long long)B * T * H * (D / 2);
  if (bf16) {
    const long long n = n_pairs / 8;
    rope_rows_bf16<D><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cos_t, sin_t,
        static_cast<__nv_bfloat16*>(out), T, H, n);
  } else {
    const long long n = n_pairs / 4;
    rope_rows_f32<D><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(x), cos_t, sin_t, static_cast<float*>(out),
        T, H, n);
  }
}

}  // namespace obt
