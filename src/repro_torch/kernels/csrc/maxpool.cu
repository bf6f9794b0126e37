// Worker max-pool: the pooled max over the worker axis plus the first
// argmax (paper Eq. 4), the same pass fused with the Eq. 7 decode of the
// pooled code, and the Eq. 6 winner-routed backward that scatters the
// pooled cotangent one-hot into the winner's row.
//
// Replaces src/repro/kernels/maxpool/maxpool.py::_maxpool_kernel and
// ::_maxpool_bwd_kernel; maxpool_decode also takes the place of
// src/repro/kernels/ocs_quant/ocs_quant.py::_decode_kernel wherever a pooled
// code is decoded.  Layout (B, N, E): a batch (the p_miss lanes) of N
// worker rows of E elements each.
//
// At the paper's widths one call moves 0.06-0.2 MB, which the card's
// memory moves in well under a microsecond: these kernels are bound by
// latency (the launch, one round of loads, a thread's chain of compares),
// not by bytes.  So:
// - No shared memory, TMA or tensor cores: nothing is read twice, and the
//   reduction is a handful of integer compares per byte.
// - One thread per column (B x E threads: 8,192 at serving's 16 x 8192,
//   16,384 at the curves' 4 x 4 x 4096), neighbouring threads on
//   neighbouring addresses of each worker row.  A thread issues the loads
//   of up to kRowBatch rows, and of their mask bytes, before its first
//   compare, so their latencies overlap instead of adding up (loading a
//   mask byte under the compare's branch cost 0.1-0.3 us a call).  Four
//   columns per thread, as vectors of 4-16 bytes, were built and measured
//   on an H100 (chip_ab.py --kernels, in turns): 2.48 us a call at the
//   curves' shape and 3.0-3.1 us at serving's, against 2.02 and 2.48 us
//   here: with a quarter of the threads, a thread's serial compares, not
//   the loads, set the time.
// - maxpool_decode picks the winner's own code from the registers of the
//   same pass (no second read), compares it with the max (`correct`) and
//   decodes the pooled code with the one Eq. 7 Decode of common.cuh.  So a
//   channel site launches once where it launched a dozen small kernels.
// - maxpool_fwd (any float or code) runs the same column loop; only how a
//   column takes one more row differs (CodeMax, FloatMax).
// The backward writes every element of the (B, N, E) gradient itself, so
// it needs no memset pass.
#include "common.cuh"

namespace {

constexpr int kRowBatch = 16;    // worker rows whose loads go out together
constexpr int kPoolThreads = 128;

// How a column's running max takes row k's word x.  Codes compare as
// unsigned integers; the first maximum keeps the index.
struct CodeMax {
  template <typename T>
  __device__ __forceinline__ void operator()(T x, int k, T& best,
                                             int32_t& arg) const {
    if (x > best) {
      best = x;
      arg = k;
    }
  }
};

// Floats compare by value, with NaN above everything (the first NaN wins,
// as jnp.argmax).  The pooled value is the winner's word, except that a
// tie of -0.0 and +0.0 pools to +0.0 (IEEE maximum, as jnp.max): equal
// floats have equal bits but for the zeros, whose AND is +0.0.
struct FloatMax {
  int kind;
  template <typename T>
  __device__ __forceinline__ void operator()(T x, int k, T& best,
                                             int32_t& arg) const {
    float fx = rt::bits_to_float(static_cast<uint32_t>(x), kind);
    float fb = rt::bits_to_float(static_cast<uint32_t>(best), kind);
    if (fb != fb) return;
    if (fx != fx || fx > fb) {
      best = x;
      arg = k;
    } else if (fx == fb) {
      best = static_cast<T>(best & x);
    }
  }
};

// The column loop: one column of one batch row, starting at `col` (worker
// row 0), over n worker rows e apart.  A worker whose `live` byte is 0
// counts as code 0 (jnp.where(mask, codes, 0)); `live` null means every
// worker.  With kSelect, `sel` is the word of row `win`.
template <bool kSelect, typename T, typename Max>
__device__ __forceinline__ void pool_column(
    const T* __restrict__ col, int n, int64_t e,
    const uint8_t* __restrict__ live, int32_t win, const Max& max_of,
    T& best, int32_t& arg, T& sel) {
  for (int k0 = 0; k0 < n; k0 += kRowBatch) {
    // every load of the batch (codes and mask bytes) before any compare:
    // a load under a compare's branch would wait for the rows before it
    T rows[kRowBatch];
    bool alive[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      if (k0 + r < n) {
        rows[r] = col[(k0 + r) * e];
        alive[r] = live == nullptr || live[k0 + r] != 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int k = k0 + r;
      if (k < n) {
        const T x = rows[r];
        if (kSelect && k == win) sel = x;
        const T m = alive[r] ? x : T(0);
        if (k == 0) {
          best = m;
          arg = 0;
        } else {
          max_of(m, k, best, arg);
        }
      }
    }
  }
}

template <typename T, typename Max>
__global__ void __launch_bounds__(kPoolThreads)
maxpool_fwd_kernel(const T* __restrict__ h, T* __restrict__ v,
                   int32_t* __restrict__ winner, int64_t batch, int n,
                   int64_t e, Max max_of) {
  const int64_t total = batch * e;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += stride) {
    const int64_t b = idx / e, i = idx - b * e;
    T best, sel;
    int32_t arg;
    pool_column<false>(h + b * n * e + i, n, e, nullptr, 0, max_of, best,
                       arg, sel);
    v[idx] = best;
    winner[idx] = arg;
  }
}

// maxpool_decode's operands; the optional outputs are null when the
// caller does not read them.
template <typename T, typename UOut>
struct DecodeArgs {
  const T* codes;
  const uint8_t* mask;
  int64_t mask_stride;
  const int32_t* winner;
  UOut* pooled;
  T* max_code;
  int32_t* argmax;
  uint8_t* correct;
  int64_t batch;
  int n;
  int64_t e;
  rt::Decode<T, UOut> decode;
};

template <typename T, typename UOut, bool kWinner>
__global__ void __launch_bounds__(kPoolThreads)
maxpool_decode_kernel(const DecodeArgs<T, UOut> a) {
  const int64_t total = a.batch * a.e;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += stride) {
    const int64_t b = idx / a.e, i = idx - b * a.e;
    const int32_t win = kWinner ? a.winner[idx] : 0;
    T best, sel = 0;
    int32_t arg;
    pool_column<kWinner>(
        a.codes + b * a.n * a.e + i, a.n, a.e,
        a.mask == nullptr ? nullptr : a.mask + b * a.mask_stride, win,
        CodeMax{}, best, arg, sel);
    a.pooled[idx] = a.decode(kWinner ? sel : best);
    if (a.max_code != nullptr) a.max_code[idx] = best;
    if (a.argmax != nullptr) a.argmax[idx] = arg;
    if (kWinner && a.correct != nullptr) a.correct[idx] = sel == best;
  }
}

template <typename T, typename Max>
int fwd_launch(const void* h, void* v, void* winner, int64_t batch, int n,
               int64_t e, Max max_of, cudaStream_t s) {
  maxpool_fwd_kernel<T>
      <<<rt::grid_for(batch * e, kPoolThreads), kPoolThreads, 0, s>>>(
          static_cast<const T*>(h), static_cast<T*>(v),
          static_cast<int32_t*>(winner), batch, n, e, max_of);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename UOut>
int decode_launch(const void* codes, const void* mask, int64_t mask_stride,
                  const void* winner, void* pooled, void* max_code,
                  void* argmax, void* correct, int64_t batch, int n,
                  int64_t e, int out_kind, int bits, cudaStream_t s) {
  const DecodeArgs<T, UOut> a{
      static_cast<const T*>(codes), static_cast<const uint8_t*>(mask),
      mask_stride, static_cast<const int32_t*>(winner),
      static_cast<UOut*>(pooled), static_cast<T*>(max_code),
      static_cast<int32_t*>(argmax), static_cast<uint8_t*>(correct), batch,
      n, e, rt::decode_for<T, UOut>(out_kind, bits)};
  const unsigned grid = rt::grid_for(batch * e, kPoolThreads);
  if (winner != nullptr)
    maxpool_decode_kernel<T, UOut, true><<<grid, kPoolThreads, 0, s>>>(a);
  else
    maxpool_decode_kernel<T, UOut, false><<<grid, kPoolThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e == 0) return 0;
  switch (kind) {
    case rt::kF32:
      return fwd_launch<uint32_t>(h, v, winner, batch, n, e, FloatMax{kind},
                                  s);
    case rt::kBF16:
    case rt::kF16:
      return fwd_launch<uint16_t>(h, v, winner, batch, n, e, FloatMax{kind},
                                  s);
    case rt::kU16:
      return fwd_launch<uint16_t>(h, v, winner, batch, n, e, CodeMax{}, s);
    case rt::kU8:
      return fwd_launch<uint8_t>(h, v, winner, batch, n, e, CodeMax{}, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// codes (batch, n, e) of `bits` <= 16 bits in code_bytes (1: uint8, 2:
// uint16); mask null or n bytes per batch row, row b at mask + b *
// mask_stride (0: one row for all); winner null or (batch, e) int32 ->
// pooled (batch, e) floats of out_kind: the decoded code of the winner, or
// of the max without one; where not null, max_code (batch, e) codes,
// argmax (batch, e) int32 and correct (batch, e) bytes (winner's code ==
// max; needs the winner).
int maxpool_decode(const void* codes, const void* mask, int64_t mask_stride,
                   const void* winner, void* pooled, void* max_code,
                   void* argmax, void* correct, int64_t batch, int n,
                   int64_t e, int code_bytes, int out_kind, int bits,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || bits < 1 || bits > 8 * code_bytes ||
      (correct != nullptr && winner == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e == 0) return 0;
  const bool f32 = out_kind == rt::kF32;
  if (out_kind != rt::kF32 && out_kind != rt::kBF16 && out_kind != rt::kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1) {
    if (f32)
      return decode_launch<uint8_t, uint32_t>(
          codes, mask, mask_stride, winner, pooled, max_code, argmax,
          correct, batch, n, e, out_kind, bits, s);
    return decode_launch<uint8_t, uint16_t>(
        codes, mask, mask_stride, winner, pooled, max_code, argmax, correct,
        batch, n, e, out_kind, bits, s);
  }
  if (code_bytes == 2) {
    if (f32)
      return decode_launch<uint16_t, uint32_t>(
          codes, mask, mask_stride, winner, pooled, max_code, argmax,
          correct, batch, n, e, out_kind, bits, s);
    return decode_launch<uint16_t, uint16_t>(
        codes, mask, mask_stride, winner, pooled, max_code, argmax, correct,
        batch, n, e, out_kind, bits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
