// Philox4x32-10 for the training kernels, bit for bit the generator of
// multimodalautoencoder_tpu_torch/ops/philox.py (the kernels' plain twin
// draws from that file, so sampling, corruption and dropout agree exactly).
//
// Keys are (instance seed, purpose); counters are (step, row, column,
// draw).  Decisions are made from integer bits: a row index in [0, n) is
// (bits * n) >> 32, a uniform in [0, 1) is (bits >> 8) * 2^-24, exact in
// float32.  Only Box-Muller's logf/cosf may differ from PyTorch's by an ulp.
#pragma once

#include <stdint.h>

namespace philox {

// Purposes: the second key word, one stream per kind of draw (ops/philox.py).
// Phase 2 (the classification run) draws from its own purposes; head layer
// j's dropout is purpose CLS_HEAD_DROP + j (j < 3).  The depth >= 3 run samples with
// ROW, ELEM and TYPE, draws the VAE's eps from DEEP_EPS, and layer k of its
// 2L-layer chain (encode 0..L-1, decode L..2L-1) its dropout from
// DEEP_DROP + k.
enum Purpose : uint32_t { ROW = 0, ELEM = 1, TYPE = 2, DROP1 = 3, DROP3 = 4,
                          EPS = 5, PROBE = 6, CLS_ROW = 7, CLS_ELEM = 8,
                          CLS_TYPE = 9, CLS_DROP1 = 10, CLS_EPS = 11,
                          CLS_HEAD_DROP = 12, DEEP_EPS = 15, DEEP_DROP = 16 };

struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += W0; k1 += W1; }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return U4{c0, c1, c2, c3};
}

__device__ __forceinline__ uint32_t bits(uint32_t seed, uint32_t purpose,
                                         uint32_t step, uint32_t row,
                                         uint32_t col, uint32_t draw = 0) {
  return philox4x32_10(step, row, col, draw, seed, purpose).x;
}

__device__ __forceinline__ float uniform(uint32_t b) {
  return (float)(b >> 8) * 5.9604644775390625e-08f;   // 2^-24
}

__device__ __forceinline__ int index_below(uint32_t b, uint32_t n) {
  return (int)(((uint64_t)b * (uint64_t)n) >> 32);
}

// Box-Muller from the first two words of one counter.
__device__ __forceinline__ float normal(uint32_t seed, uint32_t purpose,
                                        uint32_t step, uint32_t row,
                                        uint32_t col) {
  const U4 o = philox4x32_10(step, row, col, 0, seed, purpose);
  const float u1 = uniform(o.x), u2 = uniform(o.y);
  const float r = sqrtf(-2.0f * logf(u1 + 1e-12f));
  return r * cosf(6.28318530717958647692f * u2);
}

}  // namespace philox
