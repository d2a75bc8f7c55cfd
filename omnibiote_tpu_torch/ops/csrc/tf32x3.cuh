// fp32 products on the tensor cores with a 3xTF32 split, for the fp32
// attention kernels (mh_flash_fwd.cu::mh_fwd_f32 and
// mh_flash_bwd_kernels.cuh::mh_bwd_f32).
//
// An fp32 operand x becomes hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest, ties to even (cvt.rn.tf32.f32): x - hi is exact, and
// hi + lo keeps 22 of x's 24 mantissa bits. A NaN stays a NaN in hi, so a
// NaN operand makes NaN products as an FFMA would (an infinity makes a NaN
// lo, and so NaN or infinite products). A product a.b is then
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, three mma.sync m16n8k8 products into
// one fp32 accumulator (the lo.lo term, below 2^-22 of the product, is
// dropped). A 1xTF32 product (hi.hi alone) keeps about three decimal digits
// and misses the fp32 kernels' tolerances; this split meets them
// (tests/test_torch_f32_tf32_split.py emulates it on the CPU). The kernels
// read no torch.backends flag: the split is the kernels' own arithmetic.
//
// Fragments of mma.sync.m16n8k8 (tf32, row.col), g = lane / 4, t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1)
// A product whose A operand is a C fragment of an earlier one (P.V, dV, dK
// from P^T and dS^T) takes its 8 k indices in the order 0, 2, 4, 6 for
// k = 0..3 and 1, 3, 5, 7 for k = 4..7: then a0..a3 are c0, c2, c1, c3 with
// no shuffle, and its B fragment reads rows 2 t and 2 t + 1. The sum over k
// is the same sum in another order.
#pragma once
#include <stdint.h>

namespace obt {
namespace x3 {

// x rounded to the nearest tf32, ties to even, as a 32-bit pattern whose
// low 13 bits are 0 (the form the mma operands take, and the float that
// split subtracts). cvt.rn.tf32.f32 (sm_90) keeps NaN and infinity. Two
// other roundings were slower or wrong: cvt.rna.tf32.f32 compiles to a
// NaN-guarded FSETP / SEL sequence, and an integer add of half an ulp and
// mask carries the NaN that CUDA arithmetic makes (0x7fffffff) into the
// sign bit, a zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (to 2^-22 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// An A fragment split into its hi and lo fragments.
struct AFrag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ AFrag split_a(float a0, float a1, float a2, float a3) {
  AFrag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32 for B fragment (b0, b1), split here: the small terms
// first, then hi.hi
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// The same with the small terms in an accumulator of their own: two
// dependency chains a block in place of one three times as long, for the
// products whose warp tile has few column blocks (S, S^T, dP^T, dQ), where
// the chain's latency, not the issue rate, would set the pace. The sum is
// big + small once the k-steps are done.
__device__ __forceinline__ void mma3_apart(float (&big)[4], float (&small)[4], const AFrag& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, a.lo, bh0, bh1);
  mma_tf32(big, a.hi, bh0, bh1);
  mma_tf32(small, a.hi, bl0, bl1);
}

}  // namespace x3
}  // namespace obt
