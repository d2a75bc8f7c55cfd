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
// Layout (B, T, H*D) row-major for q, k, v, o; segment ids (B, T) int32 or
// null (dense); cos/sin (T, D/2) fp32 or null (no RoPE). D = 128.
//
// Design. The TPU kernel holds one kv block spanning T and rotates and
// quantizes all of K and V in every grid step. Here that work is done once
// a call by three small kernels ahead of the attention kernel, into
// scratch tensors the caller provides:
//   quant_rows  q, k -> q8, k8 (B, H, T, D) int8 and sq, sk (B, H, T) fp32,
//               one warp a (token, head) row;
//   v_absmax    v -> sv (B, H, D) fp32, the column reduction over T that
//               must end before any v8 exists;
//   quant_v     v, sv -> v8t (B, H, D, T) int8, TRANSPOSED: the B operand
//               of the int8 tensor-core product holds four consecutive
//               k-dimension bytes in a register, for p8 . v8 that is the kv
//               axis, and ldmatrix.trans has no byte form.
// The attention kernel gives one block a (batch, head, 64-row q tile) and
// walks 64-wide kv tiles TWICE, since P is quantized against the row's
// final max and so cannot be rescaled as an online softmax would: the
// first walk takes K tiles only and keeps the row maxima, the second
// recomputes the scores (half again the int8 operations, no bytes beyond
// the K tiles), takes p, l and p8, and adds p8 . v8 into int32
// accumulators that need no rescaling. Both products run on the tensor
// cores (mma.sync m16n8k32 s8 x s8 -> s32).
//
// Fragments (g = lane / 4, t = lane % 4). A score accumulator of n-tile j
// holds columns 2t, 2t+1 of the tile, but the A operand of the next
// product wants four consecutive kv bytes a register (k = 4t..4t+3 and
// 16+4t..16+4t+3 of a 32-deep step). So the K tile is laid out in shared
// memory in "fragment order": kv row r of the tile goes to row frag_pos(r),
// chosen so that n-tile j = 4*kk + w, column n holds the kv row
// 32*kk + 16*(w/2) + 4*(n/2) + 2*(w%2) + n%2. Then a thread's eight
// scores of a 32-wide k-step are exactly its A operand's bytes, in order,
// and V stays in natural order. The permutation costs nothing: cp.async
// writes each K row where it belongs.
//
// Bound. At the serving shape (B=32, T=1024, H=8, D=128, bf16) a call does
// 4*B*T^2*H*D = 137 GOP (69 us at the H100's 1,979 TOP/s int8) and moves
// 268 MB of q, k, v and o (80 us at 3.35 TB/s): bound by bytes.
#include "flash_common.cuh"

namespace {

using namespace obt;

constexpr int kD = 128;      // head dim
constexpr int kHalf = kD / 2;
constexpr int kTile = 64;    // q rows a block, kv rows a tile
constexpr int kKRow = kD + 16;     // K tile row stride, bytes (conflict-free ldmatrix)
constexpr int kVRow = kTile + 16;  // V^T tile row stride, bytes

__device__ __forceinline__ float inv127() { return (float)(1.0 / 127.0); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) { return load_bf16x2(p); }

// x8 = rint(x / s) as an int8's bits
__device__ __forceinline__ uint32_t quant_byte(float x, float s) {
  return (uint32_t)__float2int_rn(__fdiv_rn(x, s)) & 0xffu;
}

// D (16x8, s32) += A (16x32, s8, row) * B (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Prologue 1: rotate and quantize the (b, t, h) rows of q or k. One warp a
// row; lane l holds columns 2l, 2l+1 and their rotation partners 64+2l,
// 64+2l+1.
// ---------------------------------------------------------------------------
template <typename InT>
__global__ void __launch_bounds__(256) quant_rows(
    const InT* __restrict__ x, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int8_t* __restrict__ x8,
    float* __restrict__ sx, int T, int H, long long n_rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int h = (int)(row % H);
  const long long bt = row / H;
  const int t = (int)(bt % T);
  const long long b = bt / T;
  const InT* src = x + row * kD;
  float2 lo = load2(src + 2 * lane), hi = load2(src + kHalf + 2 * lane);
  if (cos_t != nullptr) {
    const float2 c = *reinterpret_cast<const float2*>(cos_t + (size_t)t * kHalf + 2 * lane);
    const float2 s = *reinterpret_cast<const float2*>(sin_t + (size_t)t * kHalf + 2 * lane);
    const float2 rl = make_float2(rope_lo(lo.x, hi.x, c.x, s.x), rope_lo(lo.y, hi.y, c.y, s.y));
    const float2 rh = make_float2(rope_hi(lo.x, hi.x, c.x, s.x), rope_hi(lo.y, hi.y, c.y, s.y));
    lo = rl;
    hi = rh;
  }
  float mx = fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)), fmaxf(fabsf(hi.x), fabsf(hi.y)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float s = __fmul_rn(mx, inv127());
  if (s == 0.0f) s = 1.0f;
  const long long orow = (b * H + h) * T + t;
  int8_t* dst = x8 + orow * kD;
  *reinterpret_cast<uint16_t*>(dst + 2 * lane) =
      (uint16_t)(quant_byte(lo.x, s) | (quant_byte(lo.y, s) << 8));
  *reinterpret_cast<uint16_t*>(dst + kHalf + 2 * lane) =
      (uint16_t)(quant_byte(hi.x, s) | (quant_byte(hi.y, s) << 8));
  if (lane == 0) sx[orow] = s;
}

// ---------------------------------------------------------------------------
// Prologue 2: sv[b, h, d] = max_t |v[b, t, h, d]| * (1/127), 0 -> 1. One
// block a (b, h): 128 channels x 8 token groups.
// ---------------------------------------------------------------------------
constexpr int kVGroups = 8;

template <typename InT>
__global__ void __launch_bounds__(kD * kVGroups) v_absmax(
    const InT* __restrict__ v, float* __restrict__ sv, int T, int H) {
  __shared__ float red[kVGroups][kD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int d = threadIdx.x & (kD - 1), tg = threadIdx.x >> 7;
  const InT* col = v + ((size_t)b * T * H + h) * kD + d;
  const size_t step = (size_t)H * kD;
  float mx = 0.0f;
#pragma unroll 4
  for (int t = tg; t < T; t += kVGroups) mx = fmaxf(mx, fabsf(to_f32(col[(size_t)t * step])));
  red[tg][d] = mx;
  __syncthreads();
  if (tg == 0) {
#pragma unroll
    for (int i = 1; i < kVGroups; ++i) mx = fmaxf(mx, red[i][d]);
    float s = __fmul_rn(mx, inv127());
    if (s == 0.0f) s = 1.0f;
    sv[(size_t)bh * kD + d] = s;
  }
}

// ---------------------------------------------------------------------------
// Prologue 3: v8t[b, h, d, t] = rint(v[b, t, h, d] / sv[b, h, d]). One block
// a (b, h, 64-token tile), transposed through shared memory.
// ---------------------------------------------------------------------------
template <typename InT>
__global__ void __launch_bounds__(256) quant_v(
    const InT* __restrict__ v, const float* __restrict__ sv,
    int8_t* __restrict__ v8t, int T, int H) {
  constexpr int RS = kTile + 4;  // bytes a channel row, 4-byte aligned
  __shared__ __align__(4) int8_t tile[kD * RS];
  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, d = tid & (kD - 1);
  const size_t bh = (size_t)b * H + h;
  const float s = sv[bh * kD + d];
  for (int t = tid >> 7; t < kTile; t += 2) {
    const float x = to_f32(v[(((size_t)b * T + j0 + t) * H + h) * kD + d]);
    tile[d * RS + t] = (int8_t)__float2int_rn(__fdiv_rn(x, s));
  }
  __syncthreads();
  for (int it = tid; it < kD * (kTile / 4); it += 256) {
    const int dd = it / (kTile / 4), w = it % (kTile / 4);
    *reinterpret_cast<uint32_t*>(v8t + (bh * kD + dd) * T + j0 + 4 * w) =
        *reinterpret_cast<const uint32_t*>(tile + dd * RS + 4 * w);
  }
}

// ---------------------------------------------------------------------------
// The attention kernel: 4 warps, 64 query rows (16 a warp), 64-wide kv
// tiles, two walks. Fragment layout of m16n8k32 (g = lane / 4, t = lane % 4):
//   A regs: (g, 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8, 16+4t..)
//   B regs: (k = 4t..4t+3, n = g), (k = 16+4t..16+4t+3, n = g)
//   C:      (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// ---------------------------------------------------------------------------

// shared-memory row of kv row r of a tile (fragment order, see the header)
__device__ __forceinline__ int frag_pos(int r) {
  return (r & 48) | ((r & 2) << 2) | ((r >> 1) & 6) | (r & 1);
}

// kv row (within the tile) behind column 2t of n-tile j; column 2t+1 is the next
__device__ __forceinline__ int frag_col(int j, int t4) {
  return 32 * (j >> 2) + 16 * ((j >> 1) & 1) + 2 * (j & 1) + 4 * t4;
}

__device__ __forceinline__ float score8(int si, float sqc, float sk, int qs, int ks) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)si, sqc), sk), qs == ks ? 0.0f : kMaskValue);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(128) int8_fwd(
    const int8_t* __restrict__ q8, const float* __restrict__ sq,
    const int8_t* __restrict__ k8, const float* __restrict__ sk,
    const int8_t* __restrict__ v8t, const float* __restrict__ sv,
    const int* __restrict__ seg, OutT* __restrict__ o, int T, int H,
    float scale_log2) {
  constexpr int NJ = kTile / 8;  // n-tiles of a score tile
  constexpr int NN = kD / 8;     // n-tiles of the output
  __shared__ __align__(16) int8_t ks[2][kTile * kKRow];
  __shared__ __align__(16) int8_t vs[2][kD * kVRow];
  __shared__ __align__(16) float sks[2][kTile];
  __shared__ __align__(16) int ksg[2][kTile];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int8_t* kb = k8 + bh * T * kD;
  const int8_t* vb = v8t + bh * kD * T;
  const float* skb = sk + bh * T;
  const int* segb = seg != nullptr ? seg + (size_t)b * T : nullptr;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;  // rows r0 and r0 + 8

  // copy kv tile j0 into ring stage `st`: K rows in fragment order, the
  // keys' scales and ids, and (second walk) the V^T tile
  auto load_tile = [&](int st, int j0, bool with_v) {
    for (int it = tid; it < kTile * (kD / 16); it += 128) {
      const int row = it >> 3, c = (it & 7) * 16;
      cp_async16(&ks[st][frag_pos(row) * kKRow + c], kb + (size_t)(j0 + row) * kD + c);
    }
    if (with_v) {
      for (int it = tid; it < kD * (kTile / 16); it += 128) {
        const int d = it >> 2, c = (it & 3) * 16;
        cp_async16(&vs[st][d * kVRow + c], vb + (size_t)d * T + j0 + c);
      }
    }
    if (tid < kTile / 4) {
      cp_async16(&sks[st][tid * 4], skb + j0 + tid * 4);
    } else if (segb != nullptr && tid < kTile / 2) {
      const int i = tid - kTile / 4;
      cp_async16(&ksg[st][i * 4], segb + j0 + i * 4);
    }
  };

  const int NT = T / kTile;
  load_tile(0, 0, false);
  cp_async_commit();

  // this warp's q8 rows as A fragments of the four 32-deep k-steps
  uint32_t qa[kD / 32][4];
  {
    const int8_t* q0 = q8 + (bh * T + r0) * kD;
    const int8_t* q1 = q0 + 8 * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + kk * 32 + 4 * t4);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(q1 + kk * 32 + 4 * t4);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + kk * 32 + 16 + 4 * t4);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + kk * 32 + 16 + 4 * t4);
    }
  }
  const float sqc0 = __fmul_rn(sq[bh * T + r0], scale_log2);
  const float sqc1 = __fmul_rn(sq[bh * T + r0 + 8], scale_log2);
  const int qs0 = segb != nullptr ? segb[r0] : 0;
  const int qs1 = segb != nullptr ? segb[r0 + 8] : 0;

  // s2 of this warp's 16 rows against the 64 keys of stage `st`
  auto scores = [&](int st, float (&s)[NJ][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int p = 0; p < kD / 64; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &ks[st][(j * 8 + (lane & 7)) * kKRow + p * 64 + (lane >> 3) * 16]);
        mma_s8(si, qa[2 * p], bf[0], bf[1]);
        mma_s8(si, qa[2 * p + 1], bf[2], bf[3]);
      }
      const int col = frag_col(j, t4);
      const float2 k2 = *reinterpret_cast<const float2*>(&sks[st][col]);
      const int ks0 = segb != nullptr ? ksg[st][col] : 0;
      const int ks1 = segb != nullptr ? ksg[st][col + 1] : 0;
      s[j][0] = score8(si[0], sqc0, k2.x, qs0, ks0);
      s[j][1] = score8(si[1], sqc0, k2.y, qs0, ks1);
      s[j][2] = score8(si[2], sqc1, k2.x, qs1, ks0);
      s[j][3] = score8(si[3], sqc1, k2.y, qs1, ks1);
    }
  };

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;

  // steps 0..NT-1: the first walk (maxima), NT..2NT-1: the second (P . V)
  for (int step = 0; step < 2 * NT; ++step) {
    const int st = step & 1;
    // the other stage was last read in the previous step, which ended in a
    // barrier: refill it with the next tile while this one is used
    if (step + 1 < 2 * NT) {
      const bool second = step + 1 >= NT;
      load_tile(st ^ 1, (second ? step + 1 - NT : step + 1) * kTile, second);
    }
    cp_async_commit();
    cp_async_wait_one();  // this step's group has landed
    __syncthreads();

    float s[NJ][4];
    scores(st, s);
    if (step < NT) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      if (step == NT - 1) {  // the rows' final maxima, over the quad
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
    } else {
      uint32_t pb[NJ][2];  // p8 of (rows g | g+8) x (columns 2t, 2t+1), two bytes each
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
        const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
        l0 += p0 + p1;  // per-thread partial sums, reduced at the end
        l1 += p2 + p3;
        pb[j][0] = (uint32_t)__float2int_rn(__fmul_rn(p0, 127.0f)) |
                   ((uint32_t)__float2int_rn(__fmul_rn(p1, 127.0f)) << 8);
        pb[j][1] = (uint32_t)__float2int_rn(__fmul_rn(p2, 127.0f)) |
                   ((uint32_t)__float2int_rn(__fmul_rn(p3, 127.0f)) << 8);
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 32; ++kk) {
        // fragment order: the scores of n-tiles 4kk..4kk+3 are this
        // k-step's kv bytes 4t..4t+3 and 16+4t..16+4t+3
        const uint32_t pa[4] = {pb[4 * kk][0] | (pb[4 * kk + 1][0] << 16),
                                pb[4 * kk][1] | (pb[4 * kk + 1][1] << 16),
                                pb[4 * kk + 2][0] | (pb[4 * kk + 3][0] << 16),
                                pb[4 * kk + 2][1] | (pb[4 * kk + 3][1] << 16)};
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int8_t* vrow = &vs[st][(n * 8 + g) * kVRow + kk * 32 + 4 * t4];
          mma_s8(acc[n], pa, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 16));
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const size_t rs = (size_t)H * kD;  // elements between consecutive tokens
  OutT* o0 = o + ((size_t)b * T + r0) * rs + (size_t)h * kD;
  OutT* o1 = o0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = n * 8 + 2 * t4;
    const float2 s2 = *reinterpret_cast<const float2*>(sv + bh * kD + col);
    const float c0 = __fmul_rn(s2.x, inv127()), c1 = __fmul_rn(s2.y, inv127());
    store2(o0 + col, __fdiv_rn(__fmul_rn((float)acc[n][0], c0), l0),
           __fdiv_rn(__fmul_rn((float)acc[n][1], c1), l0));
    store2(o1 + col, __fdiv_rn(__fmul_rn((float)acc[n][2], c0), l1),
           __fdiv_rn(__fmul_rn((float)acc[n][3], c1), l1));
  }
}

template <typename T_>
cudaError_t launch(const T_* q, const T_* k, const T_* v, const int* seg,
                   const float* cos_t, const float* sin_t, int8_t* q8, float* sq,
                   int8_t* k8, float* sk, int8_t* v8t, float* sv, T_* o, int B,
                   int T, int H, float scale_log2, cudaStream_t st) {
  const long long n_rows = (long long)B * T * H;
  const unsigned row_blocks = (unsigned)((n_rows + 7) / 8);
  quant_rows<T_><<<row_blocks, 256, 0, st>>>(q, cos_t, sin_t, q8, sq, T, H, n_rows);
  quant_rows<T_><<<row_blocks, 256, 0, st>>>(k, cos_t, sin_t, k8, sk, T, H, n_rows);
  v_absmax<T_><<<B * H, kD * kVGroups, 0, st>>>(v, sv, T, H);
  quant_v<T_><<<dim3(T / kTile, H, B), 256, 0, st>>>(v, sv, v8t, T, H);
  if (o != nullptr)
    int8_fwd<T_><<<dim3(T / kTile, H, B), 128, 0, st>>>(q8, sq, k8, sk, v8t, sv, seg, o,
                                                       T, H, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 128 and T a multiple of 64.
// q8, k8 (B, H, T, D) int8, sq, sk (B, H, T) fp32, v8t (B, H, D, T) int8 and
// sv (B, H, D) fp32 are scratch tensors that receive the prologue's results.
// o null runs the prologue alone. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape or type this file has no
// kernel for). Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int obt_int8_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* seg, const void* cos_t,
                                  const void* sin_t, void* q8, void* sq, void* k8,
                                  void* sk, void* v8t, void* sv, void* o, int B,
                                  int T, int H, int D, float scale_log2, int dtype,
                                  void* stream) {
  if ((dtype != 0 && dtype != 1) || D != kD || T < kTile || T % kTile != 0 ||
      B < 1 || B > 65535 || H < 1 || H > 65535 ||
      ((cos_t == nullptr) != (sin_t == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  int8_t* q8p = static_cast<int8_t*>(q8);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8t);
  float* sqp = static_cast<float*>(sq);
  float* skp = static_cast<float*>(sk);
  float* svp = static_cast<float*>(sv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sg, c, s, q8p, sqp, k8p, skp, v8p, svp,
        static_cast<__nv_bfloat16*>(o), B, T, H, scale_log2, st);
  return (int)launch<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), sg, c, s, q8p, sqp, k8p, skp,
                            v8p, svp, static_cast<float*>(o), B, T, H, scale_log2, st);
}

extern "C" const char* obt_cuda_error_string_int8(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
