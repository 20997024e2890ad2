// Threefry-2x32 and jax.random's uniform derivation as CUDA device functions.
//
// Replaces izpi_tpu/ops/threefry.py:26-101 (threefry2x32, fold_in,
// bits_to_uniform, uniforms_n), which the TPU megakernel calls inline. The
// words are native uint32_t, so every add wraps at 2^32 as the cipher needs.
// The output is bit-identical to izpi_tpu_torch/ops/threefry.py and to the
// JAX package; the megakernel's sample streams rest on that.
#pragma once

#include <stdint.h>

namespace izpi {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20-round block cipher: (x0, x1) are replaced by the cipher words.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = rotl32(x1, rot[r % 8]);
    x1 ^= x0;
    if (r % 4 == 3) {
      const int j = r / 4 + 1;  // key-schedule injection 1..5
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + (uint32_t)j;
    }
  }
}

// jax.random.fold_in on raw key words: the cipher of the counter pair (0, d).
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t& o0, uint32_t& o1) {
  o0 = 0u;
  o1 = d;
  threefry2x32(k0, k1, o0, o1);
}

// Word -> float in [0, 1): 23 mantissa bits under the exponent of 1.0, minus 1.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Counter pair i (0 <= i < ceil(N/2)) of the classic jax.random layout of
// N uniforms: the counters i and i + ceil(N/2), ciphered under (k0, k1),
// give uniforms i (a) and i + ceil(N/2) (b). For odd N the last pair's b is
// the pad's word, which uniforms_n drops.
template <int N>
__device__ __forceinline__ void uniform_pair(uint32_t k0, uint32_t k1, int i,
                                             float& a, float& b) {
  constexpr int kHalf = (N + 1) / 2;
  uint32_t x0 = (uint32_t)i, x1 = (uint32_t)(i + kHalf);
  threefry2x32(k0, k1, x0, x1);
  a = bits_to_uniform(x0);
  b = bits_to_uniform(x1);
}

// N uniforms in the classic jax.random counter layout: counters [0..N-1],
// zero-padded to even length, split in half and ciphered pairwise; for odd N
// the pad's word is dropped.
template <int N>
__device__ __forceinline__ void uniforms_n(uint32_t k0, uint32_t k1,
                                           float (&out)[N]) {
  constexpr int kHalf = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    float a, b;
    uniform_pair<N>(k0, k1, i, a, b);
    out[i] = a;
    if (i + kHalf < N) out[i + kHalf] = b;
  }
}

// The key the uniforms for use `salt` at bounce `depth` of the path keyed
// (k0, k1) are drawn under: fold the depth, fold the salt.
__device__ __forceinline__ void bounce_key(uint32_t k0, uint32_t k1, uint32_t depth,
                                           uint32_t salt, uint32_t& f0, uint32_t& f1) {
  uint32_t d0, d1;
  fold_in(k0, k1, depth, d0, d1);
  fold_in(d0, d1, salt, f0, f1);
}

// n uniforms for use `salt` at bounce `depth` of the path keyed (k0, k1)
// (core/rng.py bounce_uniforms_perray).
template <int N>
__device__ __forceinline__ void bounce_uniforms(uint32_t k0, uint32_t k1,
                                                uint32_t depth, uint32_t salt,
                                                float (&out)[N]) {
  uint32_t f0, f1;
  bounce_key(k0, k1, depth, salt, f0, f1);
  uniforms_n<N>(f0, f1, out);
}

}  // namespace izpi
