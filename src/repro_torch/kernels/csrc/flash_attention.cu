// Flash attention forward: causal or non-causal attention of q (B, H, Sq, D)
// over k, v (B, Hkv, Sk, D) with an online softmax, query head h reading
// KV head h / (H / Hkv).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel.  The TPU kernel walks a sequential grid axis of KV blocks
// and carries the running max m, sum l and accumulator acc of a query block
// in VMEM scratch.  Here one thread block of four warps owns one (b, h,
// 64-row query tile) and walks the KV tiles itself, 64 keys at a time,
// through shared memory; m, l and acc stay in registers for the whole walk.
// Each warp owns 16 query rows: lane i computes the scores of keys i and
// i + 32 for those rows, the row max and sum are warp shuffles, and for
// P.V each lane accumulates D / 2 of the warp's 16 x D outputs.  Scores,
// probabilities and P.V are float32 FMAs, as the TPU kernel computes them
// in float32 (no tensor cores yet: the first design is the simple one).
// Tiles wholly above the causal diagonal are skipped; masked scores are
// -1e30 exactly as in the TPU kernel, and keys past Sk (a ragged last
// tile, which the TPU kernel's shapes never have) are -inf, so they add 0.
//
// What bounds it on an H100: at the prefill shapes (one prompt, 16 heads,
// head_dim 64, S of a few hundred) the work is ~S^2 * H * D * 2 FMAs over
// a few MB of q, k, v: compute, and at these sizes the launch and the
// per-tile shared-memory traffic of the FMA loops.  The tensor-core (mma /
// wgmma) redesign is a later step; PERF.md holds its time beside the bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreadsFA = kWarps * 32;
constexpr int kRows = kBQ / kWarps;    // query rows per warp
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Accumulator element j of a lane: row r of the warp's 16, column d.
template <int D>
__device__ __forceinline__ int acc_row(int j, int lane) {
  if constexpr (D >= 32) return (32 * j) / D;
  return j * (32 / D) + lane / D;
}
template <int D>
__device__ __forceinline__ int acc_col(int j, int lane) {
  if constexpr (D >= 32) return (32 * j) % D + lane;
  return lane % D;
}

// A per-row register value for accumulator element j, with compile-time
// indices only (a runtime index would put the array in local memory).
template <int D>
__device__ __forceinline__ float row_value(const float (&vals)[kRows], int j,
                                           int lane) {
  if constexpr (D >= 32) {
    return vals[(32 * j) / D];
  } else {
    static_assert(32 / D == 2, "head_dim 16 is the only one below 32");
    return (lane >> 4) ? vals[2 * j + 1] : vals[2 * j];
  }
}

template <int D>
constexpr int smem_floats() {
  // Q and K tiles (row stride D + 1: conflict-free column reads), the V
  // tile, and the P tile (row stride kBK + 1)
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsFA)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int kAcc = kRows * D / 32;   // accumulator elements per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y % H;
  const int64_t b = blockIdx.y / H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int row0 = warp * kRows;
  const T* qb = q + (b * H + h) * static_cast<int64_t>(Sq) * D;
  const T* kb = k + (b * Hkv + hk) * static_cast<int64_t>(Sk) * D;
  const T* vb = v + (b * Hkv + hk) * static_cast<int64_t>(Sk) * D;
  T* ob = o + (b * H + h) * static_cast<int64_t>(Sq) * D;

  for (int i = tid; i < kBQ * D; i += kThreadsFA) {
    const int r = i / D, d = i % D;
    Qs[r * DP + d] =
        (q0 + r < Sq) ? to_f(qb[static_cast<int64_t>(q0 + r) * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], corr[kRows], acc[kAcc];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // Q is loaded; the last tile's K and V are consumed
    for (int i = tid; i < kBK * D; i += kThreadsFA) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + d;
      Ks[r * DP + d] = in ? to_f(kb[off]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * DP + d], kc = Ks[(lane + 32) * DP + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qs[(row0 + r) * DP + d];
        s0[r] = fmaf(qv, ka, s0[r]);
        s1[r] = fmaf(qv, kc, s1[r]);
      }
    }

    // online softmax, row by row (m, l, corr are the same in every lane)
    const int ka_pos = k0 + lane, kc_pos = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r;
      float a = s0[r] * scale, c = s1[r] * scale;
      if (causal) {
        if (ka_pos > qpos) a = kNegInf;
        if (kc_pos > qpos) c = kNegInf;
      }
      if (ka_pos >= Sk) a = -__int_as_float(0x7f800000);   // -inf
      if (kc_pos >= Sk) c = -__int_as_float(0x7f800000);
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(pa + pc);
      m[r] = m_new;
      Ps[(row0 + r) * PP + lane] = pa;
      Ps[(row0 + r) * PP + lane + 32] = pc;
    }
    __syncwarp();

    // acc = acc * corr + P.V over this tile's keys
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] *= row_value<D>(corr, j, lane);
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int r = acc_row<D>(j, lane), d = acc_col<D>(j, lane);
        acc[j] = fmaf(Ps[(row0 + r) * PP + c], Vs[c * D + d], acc[j]);
      }
    }
    __syncwarp();      // the warp's P rows are consumed before the next tile
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = acc_row<D>(j, lane), d = acc_col<D>(j, lane);
    const int qpos = q0 + row0 + r;
    if (qpos < Sq) {
      const float lr = row_value<D>(l, j, lane);
      ob[static_cast<int64_t>(qpos) * D + d] =
          from_f<T>(acc[j] / fmaxf(lr, 1e-30f));
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, float scale, int causal,
               cudaStream_t s) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, static_cast<unsigned>(B) * H);
  flash_fwd_kernel<T, D><<<grid, kThreadsFA, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, int D, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_fwd<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                               s);
    case 32:
      return launch_fwd<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                               s);
    case 64:
      return launch_fwd<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                               s);
    case 128:
      return launch_fwd<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale,
                                causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D), all of one
// kind (float32, bfloat16, float16) and contiguous; D in {16, 32, 64, 128}.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Sk, int D, int kind, int causal,
              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 ||
      static_cast<int64_t>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case rt::kF32:
      return dispatch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale,
                               causal, s);
    case rt::kBF16:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D,
                                       scale, causal, s);
    case rt::kF16:
      return dispatch_d<__half>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale,
                                causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
