// Worker max-pool: the pooled max over the worker axis plus the first
// argmax (paper Eq. 4), and the Eq. 6 winner-routed backward that scatters
// the pooled cotangent one-hot into the winner's row.
//
// Replaces src/repro/kernels/maxpool/maxpool.py::_maxpool_kernel and
// ::_maxpool_bwd_kernel.  Layout (B, N, E): a batch (the p_miss lanes) of
// N worker rows of E elements each.  One thread owns one (b, e) output and
// loops over the short worker axis, so neighbouring threads read
// neighbouring addresses of each worker row and the reduction never leaves
// registers.  Both kernels do one compare (or one select) per input byte
// or two: on an H100 they are bound by memory, and at the paper's widths
// (N = 4, E = 4096) by the launch.  The backward writes every element of
// the (B, N, E) gradient itself, so it needs no memset pass.
#include "common.cuh"

namespace {

// Ordering of the raw words: codes compare as unsigned integers; floats by
// value, with NaN above everything (the first NaN wins, as jnp.argmax).
// The pooled value is the winner's word, except that a tie of -0.0 and
// +0.0 pools to +0.0.
template <typename T>
__device__ __forceinline__ bool greater(T a, T b, int kind) {
  if (kind == rt::kU8 || kind == rt::kU16) return a > b;
  float fa = rt::bits_to_float(static_cast<uint32_t>(a), kind);
  float fb = rt::bits_to_float(static_cast<uint32_t>(b), kind);
  if (fb != fb) return false;
  if (fa != fa) return true;
  return fa > fb;
}

template <typename T>
__device__ __forceinline__ bool float_equal(T a, T b, int kind) {
  if (kind == rt::kU8 || kind == rt::kU16) return false;
  return rt::bits_to_float(static_cast<uint32_t>(a), kind) ==
         rt::bits_to_float(static_cast<uint32_t>(b), kind);
}

template <typename T>
__global__ void maxpool_fwd_kernel(const T* __restrict__ h,
                                   T* __restrict__ v,
                                   int32_t* __restrict__ winner,
                                   int64_t batch, int n, int64_t e,
                                   int kind) {
  int64_t total = batch * e;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += stride) {
    int64_t b = idx / e, i = idx - b * e;
    const T* col = h + b * n * e + i;
    T best = col[0];
    int32_t w = 0;
    for (int k = 1; k < n; ++k) {
      T x = col[k * e];
      if (greater(x, best, kind)) {
        best = x;
        w = k;
      } else if (float_equal(x, best, kind)) {
        // equal floats have equal bits except -0.0 / +0.0, whose max is
        // +0.0 (IEEE maximum, as jnp.max); the winner stays the first
        best = static_cast<T>(best & x);
      }
    }
    v[idx] = best;
    winner[idx] = w;
  }
}

template <typename T>
__global__ void winner_bwd_kernel(const int32_t* __restrict__ winner,
                                  const T* __restrict__ g,
                                  T* __restrict__ out, int64_t batch, int n,
                                  int64_t e, int kind) {
  int64_t total = batch * e;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += stride) {
    int64_t b = idx / e, i = idx - b * e;
    int32_t w = winner[idx];
    T gv = g[idx];
    // the product g * onehot, as the pooling laws' backward computes it:
    // off the winner a zero with g's sign (NaN for a non-finite g)
    T zero = static_cast<T>(rt::zero_product_bits(
        static_cast<uint32_t>(gv), kind));
    T* col = out + b * n * e + i;
    for (int k = 0; k < n; ++k) col[k * e] = (k == w) ? gv : zero;
  }
}

}  // namespace

extern "C" {

// h (batch, n, e) of kind -> v (batch, e) of kind, winner (batch, e) int32.
int maxpool_fwd(const void* h, void* v, void* winner, int64_t batch, int n,
                int64_t e, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * e == 0) return 0;
  unsigned grid = rt::grid_for(batch * e);
  int32_t* w = static_cast<int32_t*>(winner);
  switch (kind) {
    case rt::kF32:
      maxpool_fwd_kernel<uint32_t><<<grid, rt::kThreads, 0, s>>>(
          static_cast<const uint32_t*>(h), static_cast<uint32_t*>(v), w,
          batch, n, e, kind);
      break;
    case rt::kBF16:
    case rt::kF16:
    case rt::kU16:
      maxpool_fwd_kernel<uint16_t><<<grid, rt::kThreads, 0, s>>>(
          static_cast<const uint16_t*>(h), static_cast<uint16_t*>(v), w,
          batch, n, e, kind);
      break;
    case rt::kU8:
      maxpool_fwd_kernel<uint8_t><<<grid, rt::kThreads, 0, s>>>(
          static_cast<const uint8_t*>(h), static_cast<uint8_t*>(v), w,
          batch, n, e, kind);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// winner (batch, e) int32, g (batch, e) float of kind -> out (batch, n, e).
int maxpool_winner_bwd(const void* winner, const void* g, void* out,
                       int64_t batch, int n, int64_t e, int kind,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * e == 0) return 0;
  unsigned grid = rt::grid_for(batch * e);
  const int32_t* w = static_cast<const int32_t*>(winner);
  if (kind == rt::kF32) {
    winner_bwd_kernel<uint32_t><<<grid, rt::kThreads, 0, s>>>(
        w, static_cast<const uint32_t*>(g), static_cast<uint32_t*>(out),
        batch, n, e, kind);
  } else if (kind == rt::kBF16 || kind == rt::kF16) {
    winner_bwd_kernel<uint16_t><<<grid, rt::kThreads, 0, s>>>(
        w, static_cast<const uint16_t*>(g), static_cast<uint16_t*>(out),
        batch, n, e, kind);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
