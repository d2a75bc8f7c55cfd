// Philox4x32-10 counter-based random bits for attention dropout.
//
// The TPU kernels draw dropout bits from the TPU's own in-kernel generator
// (pltpu.prng_random_bits), which cannot be reproduced elsewhere. Here the
// keep-mask of attention element (b, h, i, j) (query row i, key column j)
// is a pure function of (seed, b, h, i, j), so the forward and the backward
// draw the same mask whatever their tiles are, and the plain PyTorch
// version (ops/flash_attention.py::philox4x32, dropout_keep) reproduces it
// bit for bit.
//
// Layout. One Philox call covers a 2x2 block of (i, j):
//   key     = (seed & 0xffffffff, seed >> 32)
//   counter = (j >> 1, i >> 1, b * H + h, 0)
//   word    = 2 * (i & 1) + (j & 1)
// The forward's mma fragments hold pairs of adjacent columns j, the
// backward's (which computes the transposed scores) pairs of adjacent rows
// i; either way one call serves two of a thread's elements.
//
// Keep rule of the JAX package: keep iff bits >= min(floor(rate * 2^32),
// 2^32 - 1), and a kept value is scaled by 1 / (1 - rate).
#pragma once
#include <stdint.h>

namespace obt {

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = M0 * c0, hi0 = __umulhi(M0, c0);
    const uint32_t lo1 = M1 * c2, hi1 = __umulhi(M1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// The words of element pair block (i >> 1, j >> 1) of head bh.
__device__ __forceinline__ Philox4 dropout_bits(uint64_t seed, int bh, int i,
                                                int j) {
  return philox4x32_10((uint32_t)j >> 1, (uint32_t)i >> 1, (uint32_t)bh, 0u,
                       (uint32_t)seed, (uint32_t)(seed >> 32));
}

__device__ __forceinline__ int dropout_word(int i, int j) {
  return 2 * (i & 1) + (j & 1);
}

}  // namespace obt
