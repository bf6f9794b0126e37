// Shared helpers of the port's kernels: launch geometry and the bit views
// of the float types (float32, bfloat16, float16 are carried as raw
// uint32_t / uint16_t words, so every kernel here is exact integer code).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// dtype tags shared with the Python wrappers
enum Kind : int { kF32 = 0, kBF16 = 1, kF16 = 2, kU8 = 3, kU16 = 4 };

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t work, int64_t threads = kThreads) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  // grid-stride loops cover the rest; 132 SMs x 16 resident blocks
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks);
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// A float's raw bits as a float value, for comparisons.
__device__ __forceinline__ float bits_to_float(uint32_t b, int kind) {
  if (kind == kF32) return __uint_as_float(b);
  if (kind == kBF16) return __uint_as_float(b << 16);
  // float16 -> float32, exact
  uint32_t sign = (b & 0x8000u) << 16, exp = (b >> 10) & 0x1Fu,
           man = b & 0x3FFu;
  if (exp == 0x1Fu) return __uint_as_float(sign | 0x7F800000u | (man << 13));
  if (exp == 0) {
    float v = __int2float_rn(static_cast<int>(man)) * 5.9604644775390625e-8f;
    return sign ? -v : v;   // subnormal (or zero): man * 2^-24
  }
  return __uint_as_float(sign | ((exp + 112u) << 23) | (man << 13));
}

// The bits of the product (value * 0.0f) rounded back to the kind: a
// signed zero for a finite value, a quiet NaN otherwise.
__device__ __forceinline__ uint32_t zero_product_bits(uint32_t b, int kind) {
  float r = bits_to_float(b, kind) * 0.0f;
  uint32_t rb = __float_as_uint(r);
  if (kind == kF32) return rb;
  uint32_t sign16 = (rb >> 16) & 0x8000u;
  if (r != r) return sign16 | (kind == kBF16 ? 0x7FC0u : 0x7E00u);
  return sign16;
}

}  // namespace rt
