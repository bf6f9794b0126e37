// Shared helpers of the port's kernels: launch geometry, the bit views of
// the float types (float32, bfloat16, float16 are carried as raw uint32_t
// / uint16_t words, so every kernel here is exact integer code), and the
// one definition of the Eq. 7 codes that ocs_quant.cu and maxpool.cu both
// use.
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

template <typename U>
struct Sign {
  static constexpr U value = static_cast<U>(U(1) << (sizeof(U) * 8 - 1));
};

// Eq. 7 encode: a float's raw word (UIn) -> its order-embedded unsigned
// code (the sign-flip trick) shifted down to D = width - shift bits.
template <typename UIn, typename UOut>
struct Encode {
  int shift;
  __device__ __forceinline__ UOut operator()(UIn b) const {
    constexpr UIn s = Sign<UIn>::value;
    UIn code = (b & s) ? static_cast<UIn>(~b) : static_cast<UIn>(b | s);
    return static_cast<UOut>(code >> shift);
  }
};

// Eq. 7 decode: a D-bit code -> the raw word of its bucket's lowest float
// (low bits zero-filled).  The lowest bucket lands in NaN bit space and
// decodes to -inf, as any NaN word would.
template <typename UCode, typename UOut>
struct Decode {
  int shift;
  UOut exp_mask, man_mask, neg_inf;
  __device__ __forceinline__ UOut operator()(UCode c) const {
    constexpr UOut s = Sign<UOut>::value;
    UOut full = static_cast<UOut>(static_cast<UOut>(c) << shift);
    UOut b = (full & s) ? static_cast<UOut>(full & static_cast<UOut>(~s))
                        : static_cast<UOut>(~full);
    bool nan = (b & exp_mask) == exp_mask && (b & man_mask) != 0;
    return nan ? neg_inf : b;
  }
};

// The decode of `bits`-bit codes into floats of `kind`: UOut is uint32_t
// for float32, uint16_t for bfloat16 and float16.
template <typename UCode, typename UOut>
inline Decode<UCode, UOut> decode_for(int kind, int bits) {
  uint32_t exp = 0x7F800000u, man = 0x007FFFFFu, ninf = 0xFF800000u;
  if (kind == kBF16) {
    exp = 0x7F80u, man = 0x007Fu, ninf = 0xFF80u;
  } else if (kind == kF16) {
    exp = 0x7C00u, man = 0x03FFu, ninf = 0xFC00u;
  }
  return {static_cast<int>(8 * sizeof(UOut)) - bits, static_cast<UOut>(exp),
          static_cast<UOut>(man), static_cast<UOut>(ninf)};
}

}  // namespace rt
