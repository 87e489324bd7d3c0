// The counter-based random numbers and the rounding shared by the port's
// augmentation kernels (full_pass.cu, light_augment.cu).
//
// Philox4x32-10 keyed by a per-sample seed, the 23-bit-mantissa uniform and
// Box-Muller, as the TPU kernels' _uniform and _gaussian draw them. The
// plain PyTorch versions in mliis_tpu_torch/ops/augment_kernels.py
// (`philox_words`, `uniform_from_bits`, `_box_muller`, `_randint`) compute
// the same numbers. Arithmetic that decides a discrete outcome uses
// __fmul_rn/__fadd_rn, so nvcc cannot contract it into an FMA: it then
// rounds as the plain version's separate ops do.
#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

struct Words { uint32_t w0, w1; };

// Philox4x32-10, key (seed, 0), counter (c0, c1, 0, 0); the first two words.
__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1,
                                        uint32_t key) {
  uint32_t c2 = 0, c3 = 0, k0 = key, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return {c0, c1};
}

// U[0,1) from the 23 high bits under the exponent of 1.0.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float scalar_uniform(uint32_t key, int i) {
  return uniform(philox(static_cast<uint32_t>(i), 0u, key).w0);
}

// Box-Muller on two uniforms, as the TPU kernel's _gaussian.
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(fmaxf(u1, 1e-7f)))),
                   cosf(__fmul_rn(6.2831855f, u2)));
}

__device__ __forceinline__ int randint(float u, int low, int high) {
  return low + static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(
                                                        high - low))));
}

}  // namespace
