// Serving-only int8 flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel omnibiote_tpu/ops/int8_attention.py::
// _int8_fwd_kernel (launched by int8_flash_attention). Same function, same
// rounding points, per batch row b and head h:
//   * q and k rows in fp32, rotated by rotate-half RoPE from the cos/sin
//     half tables (not rounded back to the input dtype);
//   * q8, sq and k8, sk: symmetric int8 per (token, head): s = max|x| *
//     (1/127), 0 -> 1, x8 = rint(x / s), an IEEE division, half to even;
//   * s_i = q8 . k8^T in int32; s2 = ((float(s_i) * (sq * scale_log2)) * sk)
//     + bias, bias 0 on equal segment ids and -0.7 * FLT_MAX otherwise;
//   * m2 = the row's max over ALL T keys; p = exp2(s2 - m2); l = sum p in
//     fp32 from the unquantized p; p8 = rint(p * 127);
//   * sv = max|v| * (1/127) per channel over all T tokens of the row's head
//     (masked or not), 0 -> 1; v8 = rint(v / sv);
//   * o = (float(p8 . v8) * (sv * (1/127))) / l, cast to the input dtype.
// exp2 is ex2.approx with subnormal results flushed to zero: a p below
// 2^-126 rounds to p8 = 0 either way and adds nothing l can hold beside the
// row's own p = 1.
// Layout (B, T, H*D) row-major for q, k, v, o; segment ids (B, T) int32 or
// null (dense); cos/sin (T, D/2) fp32 or null (no RoPE). D = 128, 256, or
// any multiple of 128 past 256 (int8_fwd_wide_wgmma up to 512,
// int8_fwd_wide past it, below).
//
// Design. The TPU kernel holds one kv block spanning T and rotates and
// quantizes all of K and V in every grid step. Here that work is done once
// a call by two small kernels ahead of the attention kernel, into scratch
// tensors the caller provides:
//   quant_qk  q, k -> q8, k8 (B, H, T, D) int8 and sq, sk (B, H, T) fp32:
//             one grid for both, a block a (q or k, b, 32 tokens) walking the
//             heads, 16-byte loads;
//   quant_v   v -> sv (B, H, D) fp32 and v8t (B, H, D, T) int8, TRANSPOSED
//             and with the kv axis permuted inside every 32-block (below):
//             one block a (b, h, 16 channels) reduces |v| over T, keeping
//             the slab in shared memory as far as 32 KB go, then quantizes.
// The attention kernel gives one CTA a (batch, head, 128-row q tile) and
// walks 128-wide kv tiles TWICE, since P is quantized against the row's
// final max and so cannot be rescaled as an online softmax would: the
// first walk takes K tiles only and keeps the row maxima, the second
// recomputes the scores, takes p, l and p8, and adds p8 . v8 into int32
// accumulators that need no rescaling. Three warpgroups: a producer whose
// first thread keeps a four-stage ring of K8 and (second walk) V8^T tiles
// full by TMA (uint8 tensor maps, 128-byte swizzle: one int8 head row is one
// swizzle row), with the tile's key scales and segment ids as bulk copies,
// and two consumers of 64 q rows each, which take turns on the tensor cores
// (named barriers). Both products are wgmma m64n128k32 s8 x s8 -> s32 with
// A from registers: S = Q8 . K8^T with the consumer's Q8 rows held as A
// fragments for the whole call, O += P8 . V8 with P8 packed from S's
// accumulators. B comes from shared memory K-major: K8 tiles as they are,
// V8 as V8^T tiles (8-bit wgmma has no transpose bit, which is why the
// prologue writes V transposed). At D = 256 the ring has two stages, and
// Q8 comes from shared memory (see the attention kernel's note).
//
// Fragments (g = lane / 4, t = lane % 4, per warp of 16 rows). A thread's
// score accumulators hold columns 8n + 2t and 8n + 2t + 1 of each 8-column
// block n; its A register j of a 32-deep k-step holds the four consecutive
// k bytes 4t..4t+3 (j = 0, 1) or 16+4t..16+4t+3 (j = 2, 3). So the k order
// of P8 . V8 is not the kv order: within each 32-block, k = 16 hf + 4t + i
// stands for kv 16 hf + 2t + (i & 1) + 8 (i >> 1) (kv_of_k below), and
// quant_v writes V8^T's kv axis in that k order. A thread then packs its
// own p8 bytes in register order, with no exchange between lanes.
//
// Conversions on every (q, k) pair. float(s_i), |s_i| <= 128 * 127^2 < 2^24,
// is exact as cvt.rn.f32.s32, which sm_90 runs as one I2FP: one instruction
// where the integer-add form (bits(s + 0x4B400000) - 1.5 * 2^23) takes two.
// rint(x), half to even, for |x| < 2^22 is the low bits of x + 1.5 * 2^23
// (its low byte is the int8 byte): one float add in place of a float-to-int
// conversion.
//
// Bound. At the serving shape (B=32, T=1024, H=8, D=128, bf16) a call moves
// 268 MB of q, k, v and o (80 us at 3.35 TB/s) and does 4*B*T^2*H*D =
// 137 GOP of products (69 us at 1,979 TOP/s int8): bound by bytes. The two
// walks do 6*B*T^2*H*D = 206 GOP, and every (q, k) pair takes ~14 ALU
// instructions over both walks (conversion, scales, max; again, exp2, sum,
// p8, packing): ~0.13 ms of issue across the card, more than the products'
// 0.10 ms at the int8 peak. On the card neither runs near its rate (short
// wgmma chains wait on their latency, a lone warp's arithmetic on its
// dependencies) and the two overlap only in part (PERF.md, row 9).
#include <atomic>
#include <climits>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "wide_attention.cuh"

namespace {

using namespace obt;

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ float inv127() { return (float)(1.0 / 127.0); }

// bits of x + 1.5 * 2^23: for |x| < 2^22 they are 0x4B400000 + rint(x),
// half to even, so the low byte is rint(x)'s two's-complement byte
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, kMagic));
}

// rint(x / s) as an int8's bits
__device__ __forceinline__ uint32_t quant_byte(float x, float s) {
  return rint_bits(__fdiv_rn(x, s)) & 0xffu;
}

// kv index (within a 32-block) of k position k of the P8 . V8 product
__device__ __forceinline__ int kv_of_k(int k) {
  return (k & 16) | ((k >> 1) & 6) | (k & 1) | ((k & 2) << 2);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) { return load_bf16x2(p); }

// ---------------------------------------------------------------------------
// Prologue 1: rotate and quantize q and k. A block takes 32 consecutive
// tokens of one batch row of q (blockIdx.y == 0) or k and walks the heads,
// each token's cos/sin loaded once; D / 16 threads a (token, head) row,
// thread c holding columns 8c..8c+7 and their rotation partners D/2+8c...
// ---------------------------------------------------------------------------
constexpr int kQkRows = 32;

template <typename InT, int D>
__global__ void __launch_bounds__(kQkRows * D / 16) quant_qk(
    const InT* __restrict__ q, const InT* __restrict__ k, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int8_t* __restrict__ q8, float* __restrict__ sq,
    int8_t* __restrict__ k8, float* __restrict__ sk, int T, int H) {
  constexpr int kD = D, kHalf = D / 2, TPR = D / 16;
  const bool is_k = blockIdx.y != 0;
  const int b = blockIdx.z;
  const int c = threadIdx.x & (TPR - 1), t = blockIdx.x * kQkRows + threadIdx.x / TPR;
  const InT* src = (is_k ? k : q) + ((size_t)b * T + t) * H * kD + 8 * c;
  int8_t* dst = (is_k ? k8 : q8) + ((size_t)b * H * T + t) * kD + 8 * c;
  float* sx = (is_k ? sk : sq) + (size_t)b * H * T + t;
  float cs[8], sn[8];
  if (cos_t != nullptr) {
    load8(cos_t + (size_t)t * kHalf + 8 * c, cs);
    load8(sin_t + (size_t)t * kHalf + 8 * c, sn);
  }
  for (int h = 0; h < H; ++h) {
    float lo[8], hi[8];
    load8(src + (size_t)h * kD, lo);
    load8(src + (size_t)h * kD + kHalf, hi);
    if (cos_t != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float rl = rope_lo(lo[e], hi[e], cs[e], sn[e]);
        hi[e] = rope_hi(lo[e], hi[e], cs[e], sn[e]);
        lo[e] = rl;
      }
    }
    float mx = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fmaxf(fabsf(lo[e]), fabsf(hi[e])));
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = __fmul_rn(mx, inv127());
    if (s == 0.0f) s = 1.0f;
    uint32_t wl[2] = {0, 0}, wh[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wl[e >> 2] |= quant_byte(lo[e], s) << (8 * (e & 3));
      wh[e >> 2] |= quant_byte(hi[e], s) << (8 * (e & 3));
    }
    int8_t* d = dst + (size_t)h * T * kD;
    *reinterpret_cast<uint2*>(d) = make_uint2(wl[0], wl[1]);
    *reinterpret_cast<uint2*>(d + kHalf) = make_uint2(wh[0], wh[1]);
    if (c == 0) sx[(size_t)h * T] = s;
  }
}

// The same at a head dim past 256 (D % 128 == 0), where D / 16 threads a
// row pass a warp: a warp a (token, head) row, walking the heads of its
// token; each lane takes 8 columns of each half at a time, one pass for the
// row's max |x| and a second that rotates and quantizes again.
constexpr int kQkWideThreads = 256;

template <typename InT>
__global__ void __launch_bounds__(kQkWideThreads) quant_qk_wide(
    const InT* __restrict__ q, const InT* __restrict__ k, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int8_t* __restrict__ q8, float* __restrict__ sq,
    int8_t* __restrict__ k8, float* __restrict__ sk, int T, int H, int D) {
  const bool is_k = blockIdx.y != 0;
  const int b = blockIdx.z, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (kQkWideThreads / 32) + (threadIdx.x >> 5);
  const int half = D / 2;
  const InT* src = (is_k ? k : q) + ((size_t)b * T + t) * H * D;
  int8_t* dst = (is_k ? k8 : q8) + ((size_t)b * H * T + t) * D;
  float* sx = (is_k ? sk : sq) + (size_t)b * H * T + t;
  // columns c8..c8 + 7 of each half of head h, rotated
  auto rows8 = [&](int h, int c8, float (&lo)[8], float (&hi)[8]) {
    load8(src + (size_t)h * D + c8, lo);
    load8(src + (size_t)h * D + half + c8, hi);
    if (cos_t != nullptr) {
      float cs[8], sn[8];
      load8(cos_t + (size_t)t * half + c8, cs);
      load8(sin_t + (size_t)t * half + c8, sn);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float rl = rope_lo(lo[e], hi[e], cs[e], sn[e]);
        hi[e] = rope_hi(lo[e], hi[e], cs[e], sn[e]);
        lo[e] = rl;
      }
    }
  };
  for (int h = 0; h < H; ++h) {
    float mx = 0.0f;
    for (int c8 = 8 * lane; c8 < half; c8 += 256) {
      float lo[8], hi[8];
      rows8(h, c8, lo, hi);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fmaxf(fabsf(lo[e]), fabsf(hi[e])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = __fmul_rn(mx, inv127());
    if (s == 0.0f) s = 1.0f;
    int8_t* d = dst + (size_t)h * T * D;
    for (int c8 = 8 * lane; c8 < half; c8 += 256) {
      float lo[8], hi[8];
      rows8(h, c8, lo, hi);
      uint32_t wl[2] = {0, 0}, wh[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        wl[e >> 2] |= quant_byte(lo[e], s) << (8 * (e & 3));
        wh[e >> 2] |= quant_byte(hi[e], s) << (8 * (e & 3));
      }
      *reinterpret_cast<uint2*>(d + c8) = make_uint2(wl[0], wl[1]);
      *reinterpret_cast<uint2*>(d + half + c8) = make_uint2(wh[0], wh[1]);
    }
    if (lane == 0) sx[(size_t)h * T] = s;
  }
}

// ---------------------------------------------------------------------------
// Prologue 2: sv[b, h, d] = max_t |v[b, t, h, d]| * (1/127), 0 -> 1, then
// v8t[b, h, d, 32 j + k] = rint(v[b, 32 j + kv_of_k(k), h, d] / sv). One
// block a (b, h, 16 channels): 32 bytes of each bf16 token row, one memory
// sector. The reduction reads the block's slab two threads a token row and
// keeps its first 32 KB (all of it up to T = 1024 in bf16) in shared
// memory; the quantisation walks it again in 128-token chunks, from there
// or, past those rows, from global memory, and transposes each chunk
// through shared memory: a thread quantizes two channels of four
// consecutive k positions into two 32-bit words; a warp then writes one
// channel's 128 bytes.
// ---------------------------------------------------------------------------
constexpr int kVThreads = 256;
constexpr int kVChannels = 16;
constexpr int kVChunk = 128;
constexpr int kVSlabBytes = 32 * 1024;
constexpr int kTileWords = kVChunk / 4 + 1;  // + 1: two-way bank conflicts at most

template <typename InT, int D>
__global__ void __launch_bounds__(kVThreads) quant_v(
    const InT* __restrict__ v, float* __restrict__ sv, int8_t* __restrict__ v8t, int T,
    int H, int d_rt) {
  const int kD = D > 0 ? D : d_rt;  // D = 0: the head dim at run time (D > 256)
  constexpr int kSlabRows = kVSlabBytes / (kVChannels * sizeof(InT));
  __shared__ __align__(16) InT slab[kSlabRows * kVChannels];
  __shared__ float red[kVThreads / 32][kVChannels];
  __shared__ uint32_t tile[kVChannels * kTileWords];
  __shared__ float svs[kVChannels];
  const int c0 = blockIdx.x * kVChannels, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t rs = (size_t)H * kD;  // elements between consecutive tokens
  const size_t bh = (size_t)b * H + h;
  const InT* vb = v + (size_t)b * T * rs + (size_t)h * kD + c0;

  {
    const int half = tid & 1;  // channels 8 half .. 8 half + 7
    float mx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int t = tid >> 1; t < T; t += kVThreads / 2) {
      const uint4* src = reinterpret_cast<const uint4*>(vb + (size_t)t * rs + 8 * half);
      uint4 raw[sizeof(InT) / 2];
#pragma unroll
      for (int i = 0; i < (int)(sizeof(InT) / 2); ++i) raw[i] = src[i];
      if (t < kSlabRows) {
        uint4* dst = reinterpret_cast<uint4*>(slab + t * kVChannels + 8 * half);
#pragma unroll
        for (int i = 0; i < (int)(sizeof(InT) / 2); ++i) dst[i] = raw[i];
      }
      float x[8];
      load8(reinterpret_cast<const InT*>(raw), x);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], fabsf(x[e]));
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
    if ((tid & 31) < 2) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[tid >> 5][8 * half + e] = mx[e];
    }
  }
  __syncthreads();
  if (tid < kVChannels) {
    float m = red[0][tid];
#pragma unroll
    for (int i = 1; i < kVThreads / 32; ++i) m = fmaxf(m, red[i][tid]);
    float s = __fmul_rn(m, inv127());
    if (s == 0.0f) s = 1.0f;
    svs[tid] = s;
    sv[bh * kD + c0 + tid] = s;
  }
  __syncthreads();

  const int cp = tid & 7;   // channels 2 cp, 2 cp + 1
  const int kq = tid >> 3;  // k positions 4 kq .. 4 kq + 3 of a chunk
  const float s0 = svs[2 * cp], s1 = svs[2 * cp + 1];
  int8_t* ob = v8t + (bh * kD + c0) * T;
  for (int j0 = 0; j0 < T; j0 += kVChunk) {
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kq + i, t = j0 + (k & ~31) + kv_of_k(k & 31);
      const float2 x = t < kSlabRows ? load2(slab + t * kVChannels + 2 * cp)
                                     : load2(vb + (size_t)t * rs + 2 * cp);
      w0 |= quant_byte(x.x, s0) << (8 * i);
      w1 |= quant_byte(x.y, s1) << (8 * i);
    }
    tile[(2 * cp) * kTileWords + kq] = w0;
    tile[(2 * cp + 1) * kTileWords + kq] = w1;
    __syncthreads();
#pragma unroll
    for (int it = tid; it < kVChannels * (kVChunk / 4); it += kVThreads) {
      const int d = it / (kVChunk / 4), w = it % (kVChunk / 4);
      *reinterpret_cast<uint32_t*>(ob + (size_t)d * T + j0 + 4 * w) = tile[d * kTileWords + w];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The attention kernel. A CTA owns 128 query rows of one (batch, head) and
// three warpgroups: warpgroup 0 produces, 1 and 2 consume 64 rows each.
// A thread's accumulators (g = lane / 4, t = lane % 4) are rows 16 w + g
// and + 8 of warp w, columns 8 n + 2 t, + 1. setmaxnreg moves registers from the
// producer (24) to the consumers (240).
//
// D = 256. The O accumulator (64 x 256 int32, 128 a thread) and S (64) leave
// no room for Q8's 32 A registers, so the producer loads the CTA's Q8 rows
// once into shared memory and S = Q8 . K8^T takes both operands from there;
// O += P8 . V8 is two m64n128 products on the halves of the accumulator. A
// K8 tile (128 x 256) is two 128-byte panels, a V8^T tile 256 channel rows:
// 64 KB a stage, so the ring has two stages beside Q8's 32 KB.
//
// DOTS: the products alone, the yardstick of the pipeline (same ring,
// walks, turns and fragment packing): no scales, mask, exp2 or division;
// walk 1 keeps the int32 row max m of S, walk 2 takes p8 = the low byte of
// S (two's complement), and o (B, T, H, D) int32 = m + p8 . v8.
// ---------------------------------------------------------------------------
constexpr int kBq = 128, kBkv = 128;
constexpr int kThreads = 384, kConsumerWarps = 8;
constexpr uint32_t kPanel = kBkv * 128;  // a 128-byte panel of a 128-row tile
// named barriers (0 is __syncthreads): 1 + w, consumer w's turn on the
// tensor cores
constexpr int kBarTurn = 1;

template <int D>
__host__ __device__ constexpr int stages() {
  return D == 256 ? 2 : 4;
}

// Q8 of the CTA's rows at D = 256, as D / 128 panels, and its barrier
template <int D>
struct QTile {
  alignas(1024) int8_t q[kBq * D];
  uint64_t bar;
};
struct NoQTile {};

template <int D>
struct AttnSmem {
  static constexpr int S = stages<D>();
  alignas(1024) int8_t k[S][kBkv * D];  // K8: D / 128 panels of kBkv rows
  alignas(1024) int8_t v[S][D * kBkv];  // V8^T: channel rows of kBkv k bytes
  float sk[S][kBkv];
  int kseg[S][kBkv];
  uint64_t full[S], empty[S];
  typename std::conditional<(D > 128), QTile<D>, NoQTile>::type x;
};

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(AttnSmem<D>) + kSwizzleAtom;  // + room to align the base
}

// The log2-space score of one pair. float(si) is exact (|si| < 2^24) and one
// I2FP on sm_90. A masked pair's x + mask (-0.7 FLT_MAX) is -inf here: it
// never is a row's max (a row sees its own key) and its p is 0 either way.
template <bool SEG>
__device__ __forceinline__ float score8(int si, float sqc, float sk, int qs, int ks) {
  const float x = __fmul_rn(__fmul_rn((float)si, sqc), sk);
  if constexpr (SEG) return qs == ks ? x : -INFINITY;
  return x;
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Of a 32-deep k-step of P8 . V8, accumulator blocks 4kk and 4kk + 1 are
// the k bytes 4t..4t+3 of a thread's A registers and blocks 4kk + 2 and
// 4kk + 3 the bytes 16+4t..16+4t+3 (kv_of_k). pair_bytes puts the low bytes
// of a block's two columns (8n + 2t, + 1) of one row into the low half of
// a word; join_pairs makes one A register of two such words.
__device__ __forceinline__ uint32_t pair_bytes(uint32_t c0, uint32_t c1) {
  return __byte_perm(c0, c1, 0x0040);
}
__device__ __forceinline__ uint32_t join_pairs(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}

template <typename OutT, bool SEG, bool DOTS, int D>
__global__ void __launch_bounds__(kThreads, 1) int8_fwd(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap qmap, const int8_t* __restrict__ q8,
    const float* __restrict__ sq, const float* __restrict__ sk, const float* __restrict__ sv,
    const int* __restrict__ seg, OutT* __restrict__ o, int T, int H, float scale_log2) {
  constexpr int kD = D, kStages = stages<D>(), NKQ = D / 32, NN = D / 8;
  constexpr bool kQShared = D > 128;  // Q8 from shared memory (SS products)
  constexpr uint32_t kTileBytes = kBkv * kD;  // a K8 or V8^T tile, one byte an element
  extern __shared__ unsigned char smem_raw[];
  AttnSmem<D>& sm = *reinterpret_cast<AttnSmem<D>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, tid = threadIdx.x;
  const int bh = b * H + h, NT = T / kBkv;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    if constexpr (kQShared) mbar_init(&sm.x.bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full, walk 1 then walk 2 ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      if constexpr (kQShared) {
        mbar_arrive_expect_tx(&sm.x.bar, kBq * kD);
#pragma unroll
        for (int pn = 0; pn < kD / 128; ++pn)
          tma_load_2d(&sm.x.q[pn * kBq * 128], &qmap, pn * 128, bh * T + qt * kBq, &sm.x.bar);
      }
      for (int it = 0; it < 2 * NT; ++it) {
        const int st = it % kStages;
        const bool second = it >= NT;
        const int j0 = (second ? it - NT : it) * kBkv;
        if (it >= kStages) mbar_wait(&sm.empty[st], ((it / kStages) - 1) & 1);
        const uint32_t bytes = kTileBytes + (second ? kTileBytes : 0u) +
                               (DOTS ? 0u : kBkv * sizeof(float)) +
                               (SEG ? kBkv * sizeof(int) : 0u);
        mbar_arrive_expect_tx(&sm.full[st], bytes);
#pragma unroll
        for (int pn = 0; pn < kD / 128; ++pn)
          tma_load_2d(&sm.k[st][pn * kPanel], &kmap, pn * 128, bh * T + j0, &sm.full[st]);
        if (second) tma_load_2d(sm.v[st], &vmap, j0, bh * kD, &sm.full[st]);
        if (!DOTS) bulk_load(sm.sk[st], sk + (size_t)bh * T + j0, kBkv * sizeof(float), &sm.full[st]);
        if (SEG) bulk_load(sm.kseg[st], seg + (size_t)b * T + j0, kBkv * sizeof(int), &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = qt * kBq + wg * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

    // this thread's Q8 bytes as the A fragments of the four 32-deep k-steps
    // (D = 128; at D = 256 Q8 is read from shared memory)
    uint32_t qa[kQShared ? 1 : NKQ][4];
    if constexpr (!kQShared) {
      const int8_t* q0 = q8 + ((size_t)bh * T + r0) * kD + 4 * t4;
      const int8_t* q1 = q0 + 8 * kD;
#pragma unroll
      for (int kk = 0; kk < NKQ; ++kk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + kk * 32);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(q1 + kk * 32);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + kk * 32 + 16);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + kk * 32 + 16);
      }
    }
    float sqc0 = 0.f, sqc1 = 0.f;
    int qs0 = 0, qs1 = 0;
    if constexpr (!DOTS) {
      sqc0 = __fmul_rn(sq[(size_t)bh * T + r0], scale_log2);
      sqc1 = __fmul_rn(sq[(size_t)bh * T + r0 + 8], scale_log2);
    }
    if constexpr (SEG) {
      qs0 = seg[(size_t)b * T + r0];
      qs1 = seg[(size_t)b * T + r0 + 8];
    }
    int s[64], acc[kD / 2];
    uint32_t p[kBkv / 32][4];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0;

    // S = Q8 . K8^T of ring stage st: 32-byte k-steps along K's rows, four
    // a 128-byte panel
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = shared_addr(sm.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKQ; ++kk) {
        const uint64_t db =
            smem_desc(k_addr + (kk >> 2) * kPanel + (kk & 3) * 32, 16, kSwizzleAtom);
        if constexpr (kQShared) {
          const uint32_t q_addr = shared_addr(sm.x.q) + wg * 64 * 128;
          wgmma_ss_m64n128k32_s8(
              s, smem_desc(q_addr + (kk >> 2) * (kBq * 128) + (kk & 3) * 32, 16, kSwizzleAtom),
              db, kk > 0);
        } else {
          wgmma_rs_m64n128k32_s8(s, qa[kk], db, kk > 0);
        }
      }
      wgmma_commit();
    };
    // acc += P8 . V8 of ring stage st (V8^T K-major along kv; at D = 256 two
    // products, the second on channel rows 128-255)
    auto gemm_pv = [&](int st) {
      const uint32_t v_addr = shared_addr(sm.v[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBkv / 32; ++kk) {
        if constexpr (kD == 256) {
          wgmma_rs_m64n128k32_s8(acc_half<0>(acc), p[kk],
                                 smem_desc(v_addr + kk * 32, 16, kSwizzleAtom), 1);
          wgmma_rs_m64n128k32_s8(acc_half<1>(acc), p[kk],
                                 smem_desc(v_addr + 128 * 128 + kk * 32, 16, kSwizzleAtom), 1);
        } else {
          wgmma_rs_m64n128k32_s8(acc, p[kk], smem_desc(v_addr + kk * 32, 16, kSwizzleAtom), 1);
        }
      }
      wgmma_commit();
    };
    // Turns as in the bf16 forward: warpgroup w waits on barrier kBarTurn + w
    // (its 128 threads and the other's 128 arrivals) before it issues and
    // passes the turn after. Each takes 2 NT + 1 turns; warpgroup 0 goes
    // first and warpgroup 1 passes no turn after its last.
    auto turn_wait = [&]() { named_bar_sync(kBarTurn + wg, 256); };
    auto turn_pass = [&]() { named_bar_arrive(kBarTurn + (wg ^ 1), 256); };
    auto wait_full = [&](int it) { mbar_wait(&sm.full[it % kStages], (it / kStages) & 1); };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[it % kStages]);
    };
    if (wg == 1) turn_pass();
    if constexpr (kQShared) mbar_wait(&sm.x.bar, 0);

    // ---- walk 1: the row maxima over all T keys ----
    float m0 = -INFINITY, m1 = -INFINITY;
    int im0 = INT_MIN, im1 = INT_MIN;
    for (int it = 0; it < NT; ++it) {
      const int st = it % kStages;
      wait_full(it);
      turn_wait();
      gemm_s(st);
      turn_pass();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if constexpr (DOTS) {
          im0 = max(im0, max(s[4 * n], s[4 * n + 1]));
          im1 = max(im1, max(s[4 * n + 2], s[4 * n + 3]));
        } else {
          const int col = 8 * n + 2 * t4;
          const float2 k2 = *reinterpret_cast<const float2*>(&sm.sk[st][col]);
          int2 ks = make_int2(0, 0);
          if constexpr (SEG) ks = *reinterpret_cast<const int2*>(&sm.kseg[st][col]);
          m0 = fmaxf(m0, fmaxf(score8<SEG>(s[4 * n], sqc0, k2.x, qs0, ks.x),
                               score8<SEG>(s[4 * n + 1], sqc0, k2.y, qs0, ks.y)));
          m1 = fmaxf(m1, fmaxf(score8<SEG>(s[4 * n + 2], sqc1, k2.x, qs1, ks.x),
                               score8<SEG>(s[4 * n + 3], sqc1, k2.y, qs1, ks.y)));
        }
      }
      release(it);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the rows' final maxima, over the quad
      if constexpr (DOTS) {
        im0 = max(im0, __shfl_xor_sync(0xffffffffu, im0, off));
        im1 = max(im1, __shfl_xor_sync(0xffffffffu, im1, off));
      } else {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
    }

    // ---- walk 2: p, l, p8 and P8 . V8 ----
    float l0 = 0.f, l1 = 0.f;
    // p, l and p8 of ring stage st's scores into the A fragments p, one
    // k-step at a time: words lo and hi hold the row-g and row-(g + 8) byte
    // pairs of a block
    auto probs = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kBkv / 32; ++kk) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * kk + i;
          uint32_t b0, b1, b2, b3;
          if constexpr (DOTS) {
            b0 = s[4 * n], b1 = s[4 * n + 1], b2 = s[4 * n + 2], b3 = s[4 * n + 3];
          } else {
            const int col = 8 * n + 2 * t4;
            const float2 k2 = *reinterpret_cast<const float2*>(&sm.sk[st][col]);
            int2 ks = make_int2(0, 0);
            if constexpr (SEG) ks = *reinterpret_cast<const int2*>(&sm.kseg[st][col]);
            const float p0 = ex2_ftz(__fadd_rn(score8<SEG>(s[4 * n], sqc0, k2.x, qs0, ks.x), -m0));
            const float p1 = ex2_ftz(__fadd_rn(score8<SEG>(s[4 * n + 1], sqc0, k2.y, qs0, ks.y), -m0));
            const float p2 = ex2_ftz(__fadd_rn(score8<SEG>(s[4 * n + 2], sqc1, k2.x, qs1, ks.x), -m1));
            const float p3 = ex2_ftz(__fadd_rn(score8<SEG>(s[4 * n + 3], sqc1, k2.y, qs1, ks.y), -m1));
            l0 += p0 + p1;  // per-thread partial sums, reduced at the end
            l1 += p2 + p3;
            b0 = rint_bits(__fmul_rn(p0, 127.0f));
            b1 = rint_bits(__fmul_rn(p1, 127.0f));
            b2 = rint_bits(__fmul_rn(p2, 127.0f));
            b3 = rint_bits(__fmul_rn(p3, 127.0f));
          }
          lo[i] = pair_bytes(b0, b1);
          hi[i] = pair_bytes(b2, b3);
        }
        p[kk][0] = join_pairs(lo[0], lo[1]);
        p[kk][1] = join_pairs(hi[0], hi[1]);
        p[kk][2] = join_pairs(lo[2], lo[3]);
        p[kk][3] = join_pairs(hi[2], hi[3]);
      }
    };
    // a turn issues P8 . V8 of tile it - 1 (it > NT) and S of tile it (it <
    // 2 NT); the p8 of tile it follow
    for (int it = NT; it <= 2 * NT; ++it) {
      if (it < 2 * NT) wait_full(it);
      turn_wait();
      if (it > NT) gemm_pv((it - 1) % kStages);
      if (it < 2 * NT) gemm_s(it % kStages);
      if (it < 2 * NT || wg == 0) turn_pass();
      if (it > NT && it < 2 * NT) {
        wgmma_wait<1>();  // P8 . V8 of tile it - 1: its stage and p are free
        fence_regs(acc);
        fence_regs(p);
        release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      fence_regs(s);
      if (it < 2 * NT) probs(it % kStages);
    }

    const size_t rs = (size_t)H * kD;  // elements between consecutive tokens
    OutT* o0 = o + ((size_t)b * T + r0) * rs + (size_t)h * kD;
    OutT* o1 = o0 + 8 * rs;
    if constexpr (DOTS) {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = 8 * n + 2 * t4;
        *reinterpret_cast<int2*>(o0 + col) = make_int2(acc[4 * n] + im0, acc[4 * n + 1] + im0);
        *reinterpret_cast<int2*>(o1 + col) =
            make_int2(acc[4 * n + 2] + im1, acc[4 * n + 3] + im1);
      }
    } else {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = 8 * n + 2 * t4;
        const float2 s2 = *reinterpret_cast<const float2*>(sv + (size_t)bh * kD + col);
        const float c0 = __fmul_rn(s2.x, inv127()), c1 = __fmul_rn(s2.y, inv127());
        store2(o0 + col, __fdiv_rn(__fmul_rn((float)acc[4 * n], c0), l0),
               __fdiv_rn(__fmul_rn((float)acc[4 * n + 1], c1), l0));
        store2(o1 + col, __fdiv_rn(__fmul_rn((float)acc[4 * n + 2], c0), l1),
               __fdiv_rn(__fmul_rn((float)acc[4 * n + 3], c1), l1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The attention kernel at a head dim past 512 (D % 128 == 0; up to 512,
// int8_fwd_wide_wgmma below). A first-cut kernel, right before fast: no TMA,
// no wgmma, no warp specialisation. The O accumulator of 64 rows is D / 2
// int32 a thread there, and a 128-row Q8 and K8 tile pair passes the
// shared memory, so the output's channels are
// sliced: a CTA owns 64 q rows of one (batch, head) and 128 channels
// [128 c, 128 c + 128) of V8 (D / 128 slices on the grid's first axis), with
// 4 warps of 16 q rows, and walks 64-row kv tiles twice as the kernel above
// does. S = Q8 . K8^T (16 x 64 int32 a warp) is summed over D / 128 panels
// of 128 bytes of Q8 and K8 streamed through a two-stage cp.async ring, by
// mma.sync m16n8k32 s8 x s8 -> s32 on ldmatrix fragments; every slice CTA
// sums the same exact integers, so m, p, l and the P8 bytes are the same
// bits in all of them. Walk 2 packs each thread's P8 bytes as the kernel
// above does (the mma.sync A fragment is the wgmma one, so V8^T's kv axis
// keeps the products' k order) and adds P8 . V8_slice, B from the slice's
// 128 channel rows of the tile (shared memory, rows of 64 kv bytes).
// ---------------------------------------------------------------------------
constexpr int kW8Threads = 128, kW8Tile = 64, kW8Panel = 128;
constexpr int kW8Ld = kW8Panel + 16;  // padded 128-byte panel rows
constexpr int kW8VLd = kW8Tile + 16;  // padded 64-byte V8^T slice rows

struct W8Smem {
  int8_t qp[2][kW8Tile * kW8Ld];
  int8_t kp[2][kW8Tile * kW8Ld];
  int8_t vs[128 * kW8VLd];
  float sk[kW8Tile];
  int kseg[kW8Tile];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename OutT, bool SEG>
__global__ void __launch_bounds__(kW8Threads) int8_fwd_wide(
    const int8_t* __restrict__ q8, const float* __restrict__ sq, const int8_t* __restrict__ k8,
    const float* __restrict__ sk, const int8_t* __restrict__ v8t, const float* __restrict__ sv,
    const int* __restrict__ seg, OutT* __restrict__ o, int T, int H, int D, float scale_log2) {
  __shared__ __align__(16) W8Smem sm;
  const int n_slices = D / 128, n_panels = D / kW8Panel;
  const int c = blockIdx.x % n_slices, qt = blockIdx.x / n_slices, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int l8 = lane & 7, mi = lane >> 3;
  const int bh = b * H + h, NT = T / kW8Tile, n_steps = 2 * NT * n_panels;
  const int r0 = qt * kW8Tile + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int8_t* qrows = q8 + ((size_t)bh * T + qt * kW8Tile) * D;
  const int8_t* krows = k8 + (size_t)bh * T * D;
  const float sqc0 = __fmul_rn(sq[(size_t)bh * T + r0], scale_log2);
  const float sqc1 = __fmul_rn(sq[(size_t)bh * T + r0 + 8], scale_log2);
  int qs0 = 0, qs1 = 0;
  if constexpr (SEG) {
    qs0 = seg[(size_t)b * T + r0];
    qs1 = seg[(size_t)b * T + r0 + 8];
  }

  // panel p of kv tile it of walk w: step s = (w * NT + it) * n_panels + p
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int it = (s / n_panels) % NT, p = s % n_panels;
      obt::wide::load_tile<int8_t, kW8Tile, kW8Panel>(sm.qp[s & 1], kW8Ld, qrows + p * kW8Panel, D,
                                                 tid, kW8Threads);
      obt::wide::load_tile<int8_t, kW8Tile, kW8Panel>(
          sm.kp[s & 1], kW8Ld, krows + (size_t)it * kW8Tile * D + p * kW8Panel, D, tid,
          kW8Threads);
    }
    obt::cp_async_commit();
  };

  int s[8][4], acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  issue(0);
  for (int walk = 0; walk < 2; ++walk) {
    for (int it = 0; it < NT; ++it) {
      const int j0 = it * kW8Tile;
      // the tile's key scales and ids and (walk 2) its V8^T slice
      if (tid < kW8Tile / 4) obt::cp_async16(sm.sk + 4 * tid, sk + (size_t)bh * T + j0 + 4 * tid);
      if (SEG && tid >= 32 && tid < 32 + kW8Tile / 4)
        obt::cp_async16(sm.kseg + 4 * (tid - 32), seg + (size_t)b * T + j0 + 4 * (tid - 32));
      if (walk == 1)
        obt::wide::load_tile<int8_t, 128, kW8Tile>(sm.vs, kW8VLd,
                                              v8t + ((size_t)bh * D + 128 * c) * T + j0, T,
                                              tid, kW8Threads);
      obt::cp_async_commit();
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0;
      for (int p = 0; p < n_panels; ++p) {
        const int st = (walk * NT + it) * n_panels + p;
        issue(st + 1);
        obt::cp_async_wait<1>();
        __syncthreads();
        const int8_t* qa = sm.qp[st & 1] + warp * 16 * kW8Ld;
        const int8_t* kb = sm.kp[st & 1];
#pragma unroll
        for (int k0 = 0; k0 < kW8Panel; k0 += 32) {
          uint32_t af[4];
          obt::wide::ldsm_x4(af, qa + (lane & 15) * kW8Ld + k0 + (lane >> 4) * 16);
#pragma unroll
          for (int nb = 0; nb < 8; nb += 2) {
            uint32_t bf[4];
            obt::wide::ldsm_x4(bf, kb + (nb * 8 + (mi >> 1) * 8 + l8) * kW8Ld + k0 + (mi & 1) * 16);
            mma_s8(s[nb], af, bf[0], bf[1]);
            mma_s8(s[nb + 1], af, bf[2], bf[3]);
          }
        }
        __syncthreads();
      }
      if (walk == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 8 * n + 2 * t4;
          const float2 k2 = *reinterpret_cast<const float2*>(&sm.sk[col]);
          int2 ks = make_int2(0, 0);
          if constexpr (SEG) ks = *reinterpret_cast<const int2*>(&sm.kseg[col]);
          m0 = fmaxf(m0, fmaxf(score8<SEG>(s[n][0], sqc0, k2.x, qs0, ks.x),
                               score8<SEG>(s[n][1], sqc0, k2.y, qs0, ks.y)));
          m1 = fmaxf(m1, fmaxf(score8<SEG>(s[n][2], sqc1, k2.x, qs1, ks.x),
                               score8<SEG>(s[n][3], sqc1, k2.y, qs1, ks.y)));
        }
        if (it == NT - 1) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {  // the rows' final maxima, over the quad
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
        }
      } else {
        uint32_t pa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 4 * kk + i, col = 8 * n + 2 * t4;
            const float2 k2 = *reinterpret_cast<const float2*>(&sm.sk[col]);
            int2 ks = make_int2(0, 0);
            if constexpr (SEG) ks = *reinterpret_cast<const int2*>(&sm.kseg[col]);
            const float p0 = ex2_ftz(__fadd_rn(score8<SEG>(s[n][0], sqc0, k2.x, qs0, ks.x), -m0));
            const float p1 = ex2_ftz(__fadd_rn(score8<SEG>(s[n][1], sqc0, k2.y, qs0, ks.y), -m0));
            const float p2 = ex2_ftz(__fadd_rn(score8<SEG>(s[n][2], sqc1, k2.x, qs1, ks.x), -m1));
            const float p3 = ex2_ftz(__fadd_rn(score8<SEG>(s[n][3], sqc1, k2.y, qs1, ks.y), -m1));
            l0 += p0 + p1;  // per-thread partial sums, reduced at the end
            l1 += p2 + p3;
            lo[i] = pair_bytes(rint_bits(__fmul_rn(p0, 127.0f)), rint_bits(__fmul_rn(p1, 127.0f)));
            hi[i] = pair_bytes(rint_bits(__fmul_rn(p2, 127.0f)), rint_bits(__fmul_rn(p3, 127.0f)));
          }
          pa[kk][0] = join_pairs(lo[0], lo[1]);
          pa[kk][1] = join_pairs(hi[0], hi[1]);
          pa[kk][2] = join_pairs(lo[2], lo[3]);
          pa[kk][3] = join_pairs(hi[2], hi[3]);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int nb = 0; nb < 16; nb += 2) {
            uint32_t bf[4];
            obt::wide::ldsm_x4(bf, sm.vs + (nb * 8 + (mi >> 1) * 8 + l8) * kW8VLd + kk * 32 +
                                  (mi & 1) * 16);
            mma_s8(acc[nb], pa[kk], bf[0], bf[1]);
            mma_s8(acc[nb + 1], pa[kk], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // sk, kseg and vs are refilled for the next tile
    }
  }
  obt::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const size_t rs = (size_t)H * D;  // elements between consecutive tokens
  OutT* o0 = o + ((size_t)b * T + r0) * rs + (size_t)h * D + 128 * c;
  OutT* o1 = o0 + 8 * rs;
  const float* svc = sv + (size_t)bh * D + 128 * c;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = 8 * n + 2 * t4;
    const float2 s2 = *reinterpret_cast<const float2*>(svc + col);
    const float c0 = __fmul_rn(s2.x, inv127()), c1 = __fmul_rn(s2.y, inv127());
    store2(o0 + col, __fdiv_rn(__fmul_rn((float)acc[n][0], c0), l0),
           __fdiv_rn(__fmul_rn((float)acc[n][1], c1), l0));
    store2(o1 + col, __fdiv_rn(__fmul_rn((float)acc[n][2], c0), l1),
           __fdiv_rn(__fmul_rn((float)acc[n][3], c1), l1));
  }
}

// ---------------------------------------------------------------------------
// The attention kernel at head dims past 256 up to kWideMaxD (D % 128 ==
// 0), by wgmma from a TMA ring. A CTA owns 64 q rows of one (batch, head)
// and all D channels, and three warpgroups: warpgroup 0 produces, 1 and 2
// consume. Each product is done once, split between the consumers:
//   * S = Q8 . K8^T: consumer c takes the kv columns [64 c, 64 c + 64) of
//     each 128-row kv tile over the whole head dim (wgmma m64n64k32 s8, Q8
//     and K8 from shared memory), so its int32 scores need no exchange.
//     Walk 1 keeps each row's maximum over the consumer's columns; the two
//     consumers' maxima meet once, through shared memory, at its end.
//   * Walk 2: each consumer takes p, l and p8 of its columns and stores its
//     P8 A-fragment words (the register order quant_v's kv permutation
//     assumes) into the tile's P8 panel in shared memory, 64 rows x 128
//     k bytes, 128-byte swizzled as a TMA tile is; after a named barrier
//     both add P8 . V8 over the whole tile into their own channels [c D/2,
//     (c + 1) D/2) (wgmma m64n128k32 s8, and m64n64k32 for the last 64
//     channels at D = 384). l's two halves meet at the end, l = l_0 + l_1
//     in both (fp32 addition commutes).
// The ring: two 64 KB slots (at D = 512) on full / empty mbarriers. Walk 1
// streams K8 tiles through them; walk 2 alternates K8 and V8^T tiles, so
// K8 of tile j + 1 loads while tile j's P8 . V8 runs (its slot is released
// once p8 has read the tile's key scales and ids). Q8 (32 KB) is
// loaded once; the P8 panel is double-buffered by tile parity (a consumer
// may still be reading the previous one). Shared memory at D = 512: 32 KB +
// 2 x 64 KB + 2 x 8 KB and the slots' key scales and ids (attn8_wide_smem_bytes).
// ---------------------------------------------------------------------------
constexpr int kWideMaxD = 512;
constexpr int kW8Bq = 64;  // q rows a CTA; the kv tile is kBkv = 128 rows
// named barriers (0 is __syncthreads): 1, both consumers' P8 halves of a
// tile are written; 2, both consumers' row statistics are written
constexpr int kBarP8 = 1, kBarRows = 2;

template <int D>
struct Attn8WideSmem {
  alignas(1024) int8_t q[kW8Bq * D];       // Q8: D / 128 panels of 64 rows
  alignas(1024) int8_t slot[2][kBkv * D];  // a K8 tile (D / 128 panels) or a V8^T tile (D rows)
  alignas(1024) int8_t p[2][kW8Bq * kBkv]; // P8 panels, by tile parity
  float sk[2][kBkv];
  int kseg[2][kBkv];
  float rows[2][kW8Bq];  // each consumer's row maxima, then its row sums
  uint64_t qbar, full[2], empty[2];
};

template <int D>
constexpr size_t attn8_wide_smem_bytes() {
  return sizeof(Attn8WideSmem<D>) + kSwizzleAtom;  // + room to align the base
}
static_assert(attn8_wide_smem_bytes<kWideMaxD>() <= 232448, "a CTA takes at most 227 KB");

// byte offset of (row r, k byte kb) in a 128-byte-swizzled 8-bit panel
__device__ __forceinline__ uint32_t panel8_offset(int r, int kb) {
  return (uint32_t)(r * 128 + ((((kb >> 4) ^ (r & 7))) << 4) + (kb & 15));
}

template <typename OutT, bool SEG, int D>
__global__ void __launch_bounds__(kThreads, 1) int8_fwd_wide_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ sq,
    const float* __restrict__ sk, const float* __restrict__ sv, const int* __restrict__ seg,
    OutT* __restrict__ o, int T, int H, float scale_log2) {
  constexpr int NH = D / 2, NKQ = D / 32;
  constexpr uint32_t kQPanel = kW8Bq * 128;  // bytes of a 128-byte panel of Q8
  static_assert(NH == 256 || NH == 192, "a half is two 128-channel products, or one and a 64");
  extern __shared__ unsigned char smem_raw[];
  Attn8WideSmem<D>& sm = *reinterpret_cast<Attn8WideSmem<D>*>(
      smem_raw + ((kSwizzleAtom - (shared_addr(smem_raw) & (kSwizzleAtom - 1))) &
                  (kSwizzleAtom - 1)));

  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, tid = threadIdx.x;
  const int bh = b * H + h, NT = T / kBkv;
  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: Q8 once; then load li = 0 .. 3 NT - 1 into slot li % 2:
    // K8 of tile li (walk 1), then K8 and V8^T of tile j at NT + 2 j and
    // NT + 2 j + 1 (walk 2) ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.qbar, kW8Bq * D);
#pragma unroll
      for (int pn = 0; pn < D / 128; ++pn)
        tma_load_2d(&sm.q[pn * kQPanel], &qmap, pn * 128, bh * T + qt * kW8Bq, &sm.qbar);
      for (int li = 0; li < 3 * NT; ++li) {
        const int s = li & 1;
        const bool is_v = li >= NT && ((li - NT) & 1);
        const int j0 = (li < NT ? li : (li - NT) >> 1) * kBkv;
        if (li >= 2) mbar_wait(&sm.empty[s], ((li >> 1) - 1) & 1);
        if (is_v) {
          mbar_arrive_expect_tx(&sm.full[s], D * kBkv);
          tma_load_2d(&sm.slot[s][0], &vmap, j0, bh * D, &sm.full[s]);
          tma_load_2d(&sm.slot[s][NH * kBkv], &vmap, j0, bh * D + NH, &sm.full[s]);
        } else {
          mbar_arrive_expect_tx(&sm.full[s], kBkv * D + kBkv * sizeof(float) +
                                                 (SEG ? kBkv * sizeof(int) : 0u));
#pragma unroll
          for (int pn = 0; pn < D / 128; ++pn)
            tma_load_2d(&sm.slot[s][pn * kPanel], &kmap, pn * 128, bh * T + j0, &sm.full[s]);
          bulk_load(sm.sk[s], sk + (size_t)bh * T + j0, kBkv * sizeof(float), &sm.full[s]);
          if (SEG) bulk_load(sm.kseg[s], seg + (size_t)b * T + j0, kBkv * sizeof(int), &sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 kv columns of S, D / 2 channels of O each ----
    setmaxnreg_inc<240>();
    const int wg = (tid >> 7) - 1, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rl = warp * 16 + g;      // this thread's rows rl and rl + 8 of the CTA's 64
    const int r0 = qt * kW8Bq + rl;
    const float sqc0 = __fmul_rn(sq[(size_t)bh * T + r0], scale_log2);
    const float sqc1 = __fmul_rn(sq[(size_t)bh * T + r0 + 8], scale_log2);
    int qs0 = 0, qs1 = 0;
    if constexpr (SEG) {
      qs0 = seg[(size_t)b * T + r0];
      qs1 = seg[(size_t)b * T + r0 + 8];
    }
    int s[32], acc[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0;

    auto wait_full = [&](int li) { mbar_wait(&sm.full[li & 1], (li >> 1) & 1); };
    auto release = [&](int li) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[li & 1]);
    };
    const uint32_t q_addr = shared_addr(sm.q);
    // S = Q8 . K8^T on the consumer's 64 kv rows of the K8 tile in li's slot
    auto gemm_s = [&](int li) {
      const uint32_t k_addr = shared_addr(sm.slot[li & 1]) + wg * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKQ; ++kk)
        wgmma_ss_m64n64k32_s8(
            s, smem_desc(q_addr + (kk >> 2) * kQPanel + (kk & 3) * 32, 16, kSwizzleAtom),
            smem_desc(k_addr + (kk >> 2) * kPanel + (kk & 3) * 32, 16, kSwizzleAtom), kk > 0);
      wgmma_commit();
    };
    // acc += P8 . V8 on the consumer's channel rows of the V8^T tile in li's
    // slot, A the P8 panel of parity par
    auto gemm_pv = [&](int li, int par) {
      const uint32_t v_addr = shared_addr(sm.slot[li & 1]) + wg * NH * kBkv;
      const uint32_t p_addr = shared_addr(sm.p[par]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBkv / 32; ++kk) {
        const uint64_t da = smem_desc(p_addr + kk * 32, 16, kSwizzleAtom);
        wgmma_ss_m64n128k32_s8(acc_at<0, 64>(acc), da,
                               smem_desc(v_addr + kk * 32, 16, kSwizzleAtom), 1);
        const uint64_t db = smem_desc(v_addr + 128 * kBkv + kk * 32, 16, kSwizzleAtom);
        if constexpr (NH == 256) {
          wgmma_ss_m64n128k32_s8(acc_at<64, 64>(acc), da, db, 1);
        } else {
          wgmma_ss_m64n64k32_s8(acc_at<64, 32>(acc), da, db, 1);
        }
      }
      wgmma_commit();
    };
    // the log2-space score of element e (0-3) of the consumer's block n of
    // the K8 tile in slot sl
    auto score_at = [&](int sl, int n, int e) {
      const int col = 64 * wg + 8 * n + 2 * t4 + (e & 1);
      const int ks = SEG ? sm.kseg[sl][col] : 0;
      return score8<SEG>(s[4 * n + e], e < 2 ? sqc0 : sqc1, sm.sk[sl][col], e < 2 ? qs0 : qs1,
                         ks);
    };

    // ---- walk 1: the row maxima over all T keys ----
    float m0 = -INFINITY, m1 = -INFINITY;
    mbar_wait(&sm.qbar, 0);
    for (int it = 0; it < NT; ++it) {
      wait_full(it);
      gemm_s(it);
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        m0 = fmaxf(m0, fmaxf(score_at(it & 1, n, 0), score_at(it & 1, n, 1)));
        m1 = fmaxf(m1, fmaxf(score_at(it & 1, n, 2), score_at(it & 1, n, 3)));
      }
      release(it);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // over the quad, then over both consumers
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (t4 == 0) {
      sm.rows[wg][rl] = m0;
      sm.rows[wg][rl + 8] = m1;
    }
    named_bar_sync(kBarRows, 256);
    m0 = fmaxf(sm.rows[0][rl], sm.rows[1][rl]);
    m1 = fmaxf(sm.rows[0][rl + 8], sm.rows[1][rl + 8]);

    // ---- walk 2: p, l, p8 and P8 . V8 ----
    float l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < NT; ++j) {
      const int lk = NT + 2 * j, par = j & 1;
      wait_full(lk);
      gemm_s(lk);
      wgmma_wait<0>();  // S, and P8 . V8 of tile j - 1: V8^T of tile j - 1 is free
      fence_regs(s);
      fence_regs(acc);
      if (j > 0) release(lk - 1);
      // the consumer's k-steps 2 wg, 2 wg + 1 of P8 . V8: A-fragment words
      // as int8_fwd packs them, stored at their (row, k) in the P8 panel
      unsigned char* pp = reinterpret_cast<unsigned char*>(sm.p[par]);
#pragma unroll
      for (int kl = 0; kl < 2; ++kl) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * kl + i;
          const float p0 = ex2_ftz(__fadd_rn(score_at(lk & 1, n, 0), -m0));
          const float p1 = ex2_ftz(__fadd_rn(score_at(lk & 1, n, 1), -m0));
          const float p2 = ex2_ftz(__fadd_rn(score_at(lk & 1, n, 2), -m1));
          const float p3 = ex2_ftz(__fadd_rn(score_at(lk & 1, n, 3), -m1));
          l0 += p0 + p1;  // per-thread partial sums, reduced at the end
          l1 += p2 + p3;
          lo[i] = pair_bytes(rint_bits(__fmul_rn(p0, 127.0f)), rint_bits(__fmul_rn(p1, 127.0f)));
          hi[i] = pair_bytes(rint_bits(__fmul_rn(p2, 127.0f)), rint_bits(__fmul_rn(p3, 127.0f)));
        }
        const int kb = 32 * (2 * wg + kl) + 4 * t4;
        *reinterpret_cast<uint32_t*>(pp + panel8_offset(rl, kb)) = join_pairs(lo[0], lo[1]);
        *reinterpret_cast<uint32_t*>(pp + panel8_offset(rl + 8, kb)) = join_pairs(hi[0], hi[1]);
        *reinterpret_cast<uint32_t*>(pp + panel8_offset(rl, kb + 16)) = join_pairs(lo[2], lo[3]);
        *reinterpret_cast<uint32_t*>(pp + panel8_offset(rl + 8, kb + 16)) =
            join_pairs(hi[2], hi[3]);
      }
      release(lk);  // the K8 tile's key scales and ids are read
      fence_async_shared();
      named_bar_sync(kBarP8, 256);
      wait_full(lk + 1);
      gemm_pv(lk + 1, par);
    }
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // both consumers read the maxima before their first P8 barrier, which
    // the other passed before writing here
    if (t4 == 0) {
      sm.rows[wg][rl] = l0;
      sm.rows[wg][rl + 8] = l1;
    }
    named_bar_sync(kBarRows, 256);
    l0 = sm.rows[0][rl] + sm.rows[1][rl];
    l1 = sm.rows[0][rl + 8] + sm.rows[1][rl + 8];

    const size_t rs = (size_t)H * D;  // elements between consecutive tokens
    OutT* o0 = o + ((size_t)b * T + r0) * rs + (size_t)h * D + wg * NH;
    OutT* o1 = o0 + 8 * rs;
    const float* svc = sv + (size_t)bh * D + wg * NH;
#pragma unroll
    for (int n = 0; n < NH / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      const float2 s2 = *reinterpret_cast<const float2*>(svc + col);
      const float c0 = __fmul_rn(s2.x, inv127()), c1 = __fmul_rn(s2.y, inv127());
      store2(o0 + col, __fdiv_rn(__fmul_rn((float)acc[4 * n], c0), l0),
             __fdiv_rn(__fmul_rn((float)acc[4 * n + 1], c1), l0));
      store2(o1 + col, __fdiv_rn(__fmul_rn((float)acc[4 * n + 2], c0), l1),
             __fdiv_rn(__fmul_rn((float)acc[4 * n + 3], c1), l1));
    }
  }
}

template <typename OutT, int D>
cudaError_t launch_attn_wide_wgmma(const int8_t* q8, const float* sq, const int8_t* k8,
                                   const float* sk, const int8_t* v8t, const float* sv,
                                   const int* seg, OutT* o, int B, int T, int H,
                                   float scale_log2, cudaStream_t st) {
  // q8 and k8 as (B * H * T, D) and v8t as a (B * H * D, T) uint8 matrix,
  // loaded as boxes of one 128-byte panel: 64 rows of q8, 128 of k8, D / 2
  // channel rows of v8t (each consumer's half)
  CUtensorMap qmap, kmap, vmap;
  cudaError_t e = encode_u8_panels(&qmap, q8, (uint64_t)B * H * T, D, D, kW8Bq);
  if (e == cudaSuccess) e = encode_u8_panels(&kmap, k8, (uint64_t)B * H * T, D, D, kBkv);
  if (e == cudaSuccess) e = encode_u8_panels(&vmap, v8t, (uint64_t)B * H * D, T, T, D / 2);
  if (e != cudaSuccess) return e;
  const size_t smem = attn8_wide_smem_bytes<D>();
  if (seg != nullptr) {
    static std::atomic<uint64_t> smem_set{0};
    e = obt::wide::allow_smem(int8_fwd_wide_wgmma<OutT, true, D>, smem, smem_set);
    if (e != cudaSuccess) return e;
    int8_fwd_wide_wgmma<OutT, true, D><<<dim3(T / kW8Bq, H, B), kThreads, smem, st>>>(
        qmap, kmap, vmap, sq, sk, sv, seg, o, T, H, scale_log2);
  } else {
    static std::atomic<uint64_t> smem_set{0};
    e = obt::wide::allow_smem(int8_fwd_wide_wgmma<OutT, false, D>, smem, smem_set);
    if (e != cudaSuccess) return e;
    int8_fwd_wide_wgmma<OutT, false, D><<<dim3(T / kW8Bq, H, B), kThreads, smem, st>>>(
        qmap, kmap, vmap, sq, sk, sv, seg, o, T, H, scale_log2);
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_attn_wide(const int8_t* q8, const float* sq, const int8_t* k8,
                             const float* sk, const int8_t* v8t, const float* sv, const int* seg,
                             OutT* o, int B, int T, int H, int D, float scale_log2,
                             cudaStream_t st) {
  const dim3 grid((T / kW8Tile) * (D / 128), H, B);
  if (seg != nullptr)
    int8_fwd_wide<OutT, true><<<grid, kW8Threads, 0, st>>>(q8, sq, k8, sk, v8t, sv, seg, o, T,
                                                           H, D, scale_log2);
  else
    int8_fwd_wide<OutT, false><<<grid, kW8Threads, 0, st>>>(q8, sq, k8, sk, v8t, sv, seg, o, T,
                                                            H, D, scale_log2);
  return cudaGetLastError();
}

template <typename InT, int D>
cudaError_t launch_prologue(const InT* q, const InT* k, const InT* v, const float* cos_t,
                            const float* sin_t, int8_t* q8, float* sq, int8_t* k8,
                            float* sk, int8_t* v8t, float* sv, int B, int T, int H,
                            cudaStream_t st) {
  quant_qk<InT, D><<<dim3(T / kQkRows, 2, B), kQkRows * D / 16, 0, st>>>(
      q, k, cos_t, sin_t, q8, sq, k8, sk, T, H);
  quant_v<InT, D><<<dim3(D / kVChannels, H, B), kVThreads, 0, st>>>(v, sv, v8t, T, H, D);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t launch_prologue_d(const InT* q, const InT* k, const InT* v, const float* cos_t,
                              const float* sin_t, int8_t* q8, float* sq, int8_t* k8,
                              float* sk, int8_t* v8t, float* sv, int B, int T, int H, int D,
                              cudaStream_t st) {
  if (obt::wide::head_dim_ok(D)) {
    quant_qk_wide<InT><<<dim3(T / (kQkWideThreads / 32), 2, B), kQkWideThreads, 0, st>>>(
        q, k, cos_t, sin_t, q8, sq, k8, sk, T, H, D);
    quant_v<InT, 0><<<dim3(D / kVChannels, H, B), kVThreads, 0, st>>>(v, sv, v8t, T, H, D);
    return cudaGetLastError();
  }
  return D == 256 ? launch_prologue<InT, 256>(q, k, v, cos_t, sin_t, q8, sq, k8, sk, v8t, sv,
                                               B, T, H, st)
                  : launch_prologue<InT, 128>(q, k, v, cos_t, sin_t, q8, sq, k8, sk, v8t, sv,
                                               B, T, H, st);
}

template <typename OutT, bool SEG, bool DOTS, int D>
cudaError_t launch_attn(const int8_t* q8, const float* sq, const int8_t* k8, const float* sk,
                        const int8_t* v8t, const float* sv, const int* seg, OutT* o, int B,
                        int T, int H, float scale_log2, cudaStream_t st) {
  // q8 and k8 as (B * H * T, D) and v8t as a (B * H * D, T) uint8 matrix,
  // loaded as boxes of one 128-byte panel: 128 rows of q8 and k8, D rows of
  // v8t (q8 by TMA at D = 256 only; below it the kernel reads no qmap)
  CUtensorMap kmap, vmap, qmap;
  cudaError_t e = encode_u8_panels(&kmap, k8, (uint64_t)B * H * T, D, D, kBkv);
  if (e == cudaSuccess) e = encode_u8_panels(&vmap, v8t, (uint64_t)B * H * D, T, T, D);
  if constexpr (D > 128) {
    if (e == cudaSuccess) e = encode_u8_panels(&qmap, q8, (uint64_t)B * H * T, D, D, kBq);
  } else {
    qmap = kmap;
  }
  if (e != cudaSuccess) return e;
  // the shared-memory limit belongs to the instance on a device, not to the
  // call: set it at the first launch on each device
  static std::atomic<uint64_t> smem_set{0};
  const size_t smem = attn_smem_bytes<D>();
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t dev_bit = 1ull << (dev & 63);
  if (!(smem_set.load(std::memory_order_acquire) & dev_bit)) {
    e = cudaFuncSetAttribute(int8_fwd<OutT, SEG, DOTS, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(dev_bit, std::memory_order_release);
  }
  int8_fwd<OutT, SEG, DOTS, D><<<dim3(T / kBq, H, B), kThreads, smem, st>>>(
      kmap, vmap, qmap, q8, sq, sk, sv, seg, o, T, H, scale_log2);
  return cudaGetLastError();
}

template <typename OutT, int D>
cudaError_t launch_attn_seg(const int8_t* q8, const float* sq, const int8_t* k8,
                            const float* sk, const int8_t* v8t, const float* sv,
                            const int* seg, OutT* o, int B, int T, int H, float scale_log2,
                            cudaStream_t st) {
  return seg != nullptr
             ? launch_attn<OutT, true, false, D>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                                 scale_log2, st)
             : launch_attn<OutT, false, false, D>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                                  scale_log2, st);
}

template <typename OutT>
cudaError_t launch_attn_d(const int8_t* q8, const float* sq, const int8_t* k8,
                          const float* sk, const int8_t* v8t, const float* sv,
                          const int* seg, OutT* o, int B, int T, int H, int D,
                          float scale_log2, cudaStream_t st) {
  // past 256 by head dim: the wgmma kernel up to kWideMaxD, the slice
  // kernel above it
  if (D == 384)
    return launch_attn_wide_wgmma<OutT, 384>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                             scale_log2, st);
  if (D == 512)
    return launch_attn_wide_wgmma<OutT, 512>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                             scale_log2, st);
  if (obt::wide::head_dim_ok(D))
    return launch_attn_wide<OutT>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H, D, scale_log2, st);
  return D == 256 ? launch_attn_seg<OutT, 256>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                                scale_log2, st)
                  : launch_attn_seg<OutT, 128>(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H,
                                                scale_log2, st);
}

cudaError_t attention(const void* q8, const void* sq, const void* k8, const void* sk,
                      const void* v8t, const void* sv, const void* seg, void* o, int B,
                      int T, int H, int D, float scale_log2, int dtype, cudaStream_t st) {
  const int8_t* q8p = static_cast<const int8_t*>(q8);
  const int8_t* k8p = static_cast<const int8_t*>(k8);
  const int8_t* v8p = static_cast<const int8_t*>(v8t);
  const float* sqp = static_cast<const float*>(sq);
  const float* skp = static_cast<const float*>(sk);
  const float* svp = static_cast<const float*>(sv);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 1)
    return launch_attn_d<__nv_bfloat16>(q8p, sqp, k8p, skp, v8p, svp, sg,
                                        static_cast<__nv_bfloat16*>(o), B, T, H, D,
                                        scale_log2, st);
  return launch_attn_d<float>(q8p, sqp, k8p, skp, v8p, svp, sg, static_cast<float*>(o), B, T,
                              H, D, scale_log2, st);
}

// B and H bound the grids; D 128, 256 or a multiple of 128 past 256,
// T % 128 == 0
bool shape_ok(int B, int T, int H, int D) {
  return (D == 128 || D == 256 || obt::wide::head_dim_ok(D)) && T >= kBq && T % kBq == 0 && B >= 1 && B <= 65535 &&
         H >= 1 && H <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D 128, 256 or a multiple of 128 past
// 256, and T a multiple of 128.
// q8, k8 (B, H, T, D) int8, sq, sk (B, H, T) fp32, v8t (B, H, D, T) int8 (the
// kv axis in the products' k order, kv_of_k) and sv (B, H, D) fp32 are
// scratch tensors that receive the prologue's results. o null runs the
// prologue alone. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or type this file has no kernel for).
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int obt_int8_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* seg, const void* cos_t,
                                  const void* sin_t, void* q8, void* sq, void* k8,
                                  void* sk, void* v8t, void* sv, void* o, int B,
                                  int T, int H, int D, float scale_log2, int dtype,
                                  void* stream) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, T, H, D) ||
      ((cos_t == nullptr) != (sin_t == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  int8_t* q8p = static_cast<int8_t*>(q8);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8t);
  float* sqp = static_cast<float*>(sq);
  float* skp = static_cast<float*>(sk);
  float* svp = static_cast<float*>(sv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 1
          ? launch_prologue_d<__nv_bfloat16>(
                static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), c, s, q8p, sqp, k8p, skp, v8p, svp, B,
                T, H, D, st)
          : launch_prologue_d<float>(static_cast<const float*>(q),
                                     static_cast<const float*>(k),
                                     static_cast<const float*>(v), c, s, q8p, sqp, k8p, skp,
                                     v8p, svp, B, T, H, D, st);
  if (e != cudaSuccess || o == nullptr) return (int)e;
  return (int)attention(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H, D, scale_log2, dtype, st);
}

// The attention kernel alone on a prologue's outputs (the same scratch
// tensors obt_int8_flash_fwd fills), o in dtype: for timing it apart from
// the prologue.
extern "C" int obt_int8_flash_attn(const void* q8, const void* sq, const void* k8,
                                   const void* sk, const void* v8t, const void* sv,
                                   const void* seg, void* o, int B, int T, int H, int D,
                                   float scale_log2, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, T, H, D)) return (int)cudaErrorInvalidValue;
  return (int)attention(q8, sq, k8, sk, v8t, sv, seg, o, B, T, H, D, scale_log2, dtype,
                        static_cast<cudaStream_t>(stream));
}

// The attention kernel's products alone (its DOTS instance): q8, k8
// (B, H, T, 128) and v8t (B, H, 128, T, the kernel's kv order) int8 ->
// o (B, T, H, 128) int32 = max_j S[., j] + sum_j lowbyte(S[., j]) v8[j, .]
// with S = q8 k8^T per head. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int obt_int8_flash_fwd_dots(const void* q8, const void* k8, const void* v8t,
                                       void* o, int B, int T, int H, int D, void* stream) {
  if (!shape_ok(B, T, H, D) || D != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_attn<int, false, true, 128>(
      static_cast<const int8_t*>(q8), nullptr, static_cast<const int8_t*>(k8), nullptr,
      static_cast<const int8_t*>(v8t), nullptr, nullptr, static_cast<int*>(o), B, T, H, 0.f,
      static_cast<cudaStream_t>(stream));
}

// Shared memory a CTA of the attention kernel takes at head dim D (dynamic;
// static for int8_fwd_wide past 512; -1 for a head dim it is not built for).
extern "C" int obt_int8_flash_fwd_smem_bytes(int D) {
  return D == 128                ? (int)attn_smem_bytes<128>()
         : D == 256              ? (int)attn_smem_bytes<256>()
         : D == 384              ? (int)attn8_wide_smem_bytes<384>()
         : D == 512              ? (int)attn8_wide_smem_bytes<512>()
         : obt::wide::head_dim_ok(D) ? (int)sizeof(W8Smem)
                                 : -1;
}

extern "C" const char* obt_cuda_error_string_int8(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
