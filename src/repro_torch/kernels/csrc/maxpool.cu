// Worker max-pool: the pooled max over the worker axis plus the first
// argmax (paper Eq. 4), the same pass fused with the Eq. 7 decode of the
// pooled code, and the Eq. 6 winner-routed backward that scatters the
// pooled cotangent one-hot into the winner's row.
//
// Replaces src/repro/kernels/maxpool/maxpool.py::_maxpool_kernel and
// ::_maxpool_bwd_kernel; maxpool_decode also takes the place of
// src/repro/kernels/ocs_quant/ocs_quant.py::_decode_kernel wherever a pooled
// code is decoded, and, given the float features, of ::_encode_kernel
// before it.  Layout (B, N, E): a batch (the p_miss lanes) of N worker rows
// of E elements each.
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
//   Given the float features in place of codes it encodes each row as it
//   loads it (common.cuh's Encode, the EncodeRows policy), so no code
//   tensor exists: the row loads are issued as before, and the encode is a
//   few integer operations on registers.
// - maxpool_fwd (any float or code) runs the same column loop; only how a
//   column takes one more row differs (CodeMax, FloatMax).
// The backward writes every element of the (B, N, E) gradient itself, so
// it needs no memset pass; the curves' lane stack (the noisy lanes and the
// ideal lane, B = L + 1) takes one launch of it per training step.
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

// How the column loop reads a worker row's word: as it lies (codes, or
// floats for maxpool_fwd), or as the Eq. 7 code of a float's raw bits UIn
// (T the code type).  `Raw` is what a load brings to registers.  Measured
// on an H100 (chip_ab.py --kernels): codes read through the read-only
// path (__ldg) pool in 2.04 us at the curves' shape against 2.46 us with
// plain loads, while floats to encode pool faster with plain loads (2.08
// against 2.13 us).
template <typename T>
struct PlainRows {
  using Raw = T;
  const T* src;
  __device__ __forceinline__ Raw load(int64_t at) const {
    return __ldg(src + at);
  }
  __device__ __forceinline__ T word(Raw x) const { return x; }
};

template <typename UIn, typename T>
struct EncodeRows {
  using Raw = UIn;
  const UIn* src;
  rt::Encode<UIn, T> encode;          // shift: the float's width - bits
  __device__ __forceinline__ Raw load(int64_t at) const { return src[at]; }
  __device__ __forceinline__ T word(Raw x) const { return encode(x); }
};

// The column loop: one column of one batch row, starting at element `col`
// of `rows_in` (worker row 0), over n worker rows e apart.  A worker whose
// `live` byte is 0 counts as code 0 (jnp.where(mask, codes, 0)); `live`
// null means every worker.  With kSelect, `sel` is the word of row `win`.
template <bool kSelect, typename T, typename Rows, typename Max>
__device__ __forceinline__ void pool_column(
    const Rows& rows_in, int64_t col, int n, int64_t e,
    const uint8_t* __restrict__ live, int32_t win, const Max& max_of,
    T& best, int32_t& arg, T& sel) {
  for (int k0 = 0; k0 < n; k0 += kRowBatch) {
    // every load of the batch (rows and mask bytes) before any compare:
    // a load under a compare's branch would wait for the rows before it
    typename Rows::Raw rows[kRowBatch];
    bool alive[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      if (k0 + r < n) {
        rows[r] = rows_in.load(col + (k0 + r) * e);
        alive[r] = live == nullptr || live[k0 + r] != 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int k = k0 + r;
      if (k < n) {
        const T x = rows_in.word(rows[r]);
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
    pool_column<false>(PlainRows<T>{h}, b * n * e + i, n, e, nullptr, 0,
                       max_of, best, arg, sel);
    v[idx] = best;
    winner[idx] = arg;
  }
}

// maxpool_decode's operands; the optional outputs are null when the
// caller does not read them.  T is the code type, Rows how a row's code
// is read.
template <typename Rows, typename T, typename UOut>
struct DecodeArgs {
  Rows rows;
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

template <typename Rows, typename T, typename UOut, bool kWinner>
__global__ void __launch_bounds__(kPoolThreads)
maxpool_decode_kernel(const DecodeArgs<Rows, T, UOut> a) {
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
        a.rows, b * a.n * a.e + i, a.n, a.e,
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

template <typename Rows, typename T, typename UOut>
int decode_launch(const Rows& rows, const void* mask, int64_t mask_stride,
                  const void* winner, void* pooled, void* max_code,
                  void* argmax, void* correct, int64_t batch, int n,
                  int64_t e, int out_kind, int bits, cudaStream_t s) {
  const DecodeArgs<Rows, T, UOut> a{
      rows, static_cast<const uint8_t*>(mask), mask_stride,
      static_cast<const int32_t*>(winner), static_cast<UOut*>(pooled),
      static_cast<T*>(max_code), static_cast<int32_t*>(argmax),
      static_cast<uint8_t*>(correct), batch, n, e,
      rt::decode_for<T, UOut>(out_kind, bits)};
  const unsigned grid = rt::grid_for(batch * e, kPoolThreads);
  if (winner != nullptr)
    maxpool_decode_kernel<Rows, T, UOut, true>
        <<<grid, kPoolThreads, 0, s>>>(a);
  else
    maxpool_decode_kernel<Rows, T, UOut, false>
        <<<grid, kPoolThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch into floats of out_kind (uint32_t words for float32, else
// uint16_t); args are decode_launch's after `rows`.
template <typename T, typename Rows, typename... Args>
int decode_to(int out_kind, const Rows& rows, Args... args) {
  return out_kind == rt::kF32
      ? decode_launch<Rows, T, uint32_t>(rows, args...)
      : decode_launch<Rows, T, uint16_t>(rows, args...);
}

// The launch for `bits`-bit codes of type T read from src of src_kind:
// codes as they lie (rt::kU8 / rt::kU16) or floats encoded in the kernel.
template <typename T>
int decode_from(const void* src, int src_kind, const void* mask,
                int64_t mask_stride, const void* winner, void* pooled,
                void* max_code, void* argmax, void* correct, int64_t batch,
                int n, int64_t e, int out_kind, int bits, cudaStream_t s) {
  if (src_kind == rt::kF32)
    return decode_to<T>(
        out_kind,
        EncodeRows<uint32_t, T>{static_cast<const uint32_t*>(src),
                                {32 - bits}},
        mask, mask_stride, winner, pooled, max_code, argmax, correct, batch,
        n, e, out_kind, bits, s);
  if (src_kind == rt::kBF16 || src_kind == rt::kF16)
    return decode_to<T>(
        out_kind,
        EncodeRows<uint16_t, T>{static_cast<const uint16_t*>(src),
                                {16 - bits}},
        mask, mask_stride, winner, pooled, max_code, argmax, correct, batch,
        n, e, out_kind, bits, s);
  return decode_to<T>(out_kind, PlainRows<T>{static_cast<const T*>(src)},
                      mask, mask_stride, winner, pooled, max_code, argmax,
                      correct, batch, n, e, out_kind, bits, s);
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
winner_bwd_kernel(const int32_t* __restrict__ winner,
                  const T* __restrict__ g, T* __restrict__ out,
                  int64_t batch, int n, int64_t e, int kind) {
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

// src (batch, n, e) of src_kind: `bits` <= 16-bit codes (rt::kU8 for
// bits <= 8, rt::kU16), or floats (rt::kF32, kBF16, kF16) whose Eq. 7
// codes the kernel forms as it loads them (the codes are uint8 for bits
// <= 8, else uint16); mask null or n bytes per batch row, row b at mask +
// b * mask_stride (0: one row for all); winner null or (batch, e) int32 ->
// pooled (batch, e) floats of out_kind: the decoded code of the winner, or
// of the max without one; where not null, max_code (batch, e) codes,
// argmax (batch, e) int32 and correct (batch, e) bytes (winner's code ==
// max; needs the winner).
int maxpool_decode(const void* src, const void* mask, int64_t mask_stride,
                   const void* winner, void* pooled, void* max_code,
                   void* argmax, void* correct, int64_t batch, int n,
                   int64_t e, int src_kind, int out_kind, int bits,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool is_float = src_kind == rt::kF32 || src_kind == rt::kBF16 ||
                        src_kind == rt::kF16;
  const int width = src_kind == rt::kU8 ? 8
                    : src_kind == rt::kF32 ? 32 : 16;
  if (n < 1 || bits < 1 || bits > 16 || bits > width ||
      (!is_float && src_kind != rt::kU8 && src_kind != rt::kU16) ||
      (src_kind == rt::kU16 && bits <= 8) ||
      (correct != nullptr && winner == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind != rt::kF32 && out_kind != rt::kBF16 && out_kind != rt::kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e == 0) return 0;
  if (bits <= 8)
    return decode_from<uint8_t>(src, src_kind, mask, mask_stride, winner,
                                pooled, max_code, argmax, correct, batch, n,
                                e, out_kind, bits, s);
  return decode_from<uint16_t>(src, src_kind, mask, mask_stride, winner,
                               pooled, max_code, argmax, correct, batch, n,
                               e, out_kind, bits, s);
}

// winner (batch, e) int32, g (batch, e) float of kind -> out (batch, n, e).
int maxpool_winner_bwd(const void* winner, const void* g, void* out,
                       int64_t batch, int n, int64_t e, int kind,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * e == 0) return 0;
  // one thread per column, blocks of 128: the curves' stack (5 lanes x
  // 4096 columns) spreads over 160 blocks, more than the card's 132 SMs
  unsigned grid = rt::grid_for(batch * e, kPoolThreads);
  const int32_t* w = static_cast<const int32_t*>(winner);
  if (kind == rt::kF32) {
    winner_bwd_kernel<uint32_t><<<grid, kPoolThreads, 0, s>>>(
        w, static_cast<const uint32_t*>(g), static_cast<uint32_t*>(out),
        batch, n, e, kind);
  } else if (kind == rt::kBF16 || kind == rt::kF16) {
    winner_bwd_kernel<uint16_t><<<grid, kPoolThreads, 0, s>>>(
        w, static_cast<const uint16_t*>(g), static_cast<uint16_t*>(out),
        batch, n, e, kind);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
