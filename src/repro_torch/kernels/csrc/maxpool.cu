// Worker max-pool: the pooled max over the worker axis with, where the
// caller reads them, the first argmax (paper Eq. 4) and the tie mask of
// the `tie_break="all"` law; the same pass fused with the Eq. 7 decode of
// the pooled code; the Eq. 6 winner-routed backward that scatters the
// pooled cotangent one-hot into the winner's row; and the tie-routed
// backward that gives it to every tied row.
//
// Replaces src/repro/kernels/maxpool/maxpool.py::_maxpool_kernel and
// ::_maxpool_bwd_kernel (maxpool_ties_bwd also the "all" law's jnp
// backward, src/repro/core/fedocs.py::_winner_mask and _maxpool_bwd);
// maxpool_decode also takes the place of
// src/repro/kernels/ocs_quant/ocs_quant.py::_decode_kernel wherever a pooled
// code is decoded, and, given the float features, of ::_encode_kernel
// before it.  Layout (B, N, E): a batch (the p_miss lanes) of N worker rows
// of E elements each.
//
// At the paper's widths one call moves 0.06-0.2 MB, which the card's
// memory moves in well under a microsecond: maxpool_decode and
// maxpool_winner_bwd are bound by latency (the launch, one round of loads,
// a thread's chain of compares), not by bytes.  So:
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
//
// maxpool_fwd and maxpool_ties_bwd serve the LM train step's max-fusion
// sites: (16 workers, 8 x 256 x 1024) bf16 partials, 48 sites a step.
// There one call moves 75.5 MB (the partials read, the max and a uint16
// tie mask written; the mask and g read, the gradient written), so they
// are bound by bytes (3.35 TB/s: 0.0225 ms).  So:
// - Each thread owns kCols = 8 adjacent columns: one 16-byte load per
//   worker row (two for float32, 8 bytes for uint8 codes), all of a batch
//   of rows issued before the first compare; a warp reads 512 contiguous
//   bytes of each row.
// - Outputs are written only where the caller passes them: the int32
//   winner (the "first" law) and the tie mask (the "all" law), one
//   uint16_t word per column per 16 workers.  The mask is all the "all"
//   law's backward reads, so autograd keeps it in place of the partials
//   (64 MiB a site at the LM shape).
// - The LM's form (floats, mask, no winner, <= 16 workers) compares order
//   keys of the raw words, two bf16 columns to a 32-bit register
//   (maxpool_fwd_ties_kernel).  The general loop (maxpool_fwd_kernel,
//   which keeps the first argmax and serves codes, winners and more
//   workers) pays a float compare chain per column, and was measured
//   slower at the LM site on an H100 (chip_ab.py --kernels; PERF.md §6).
// - maxpool_ties_bwd writes every element of the (B, N, E) gradient
//   itself (no memset): one 16-byte load of g and of the mask word per 8
//   columns, the select done on whole registers, then evict-first
//   16-byte stores (__stcs): plain stores of the 64 MiB of gradient were
//   measured at about half the memory rate (PERF.md §6).
// - An `e` that is not a multiple of 8, or an operand that is not 16-byte
//   aligned, takes the same kernels with scalar accesses per column (the
//   kVec=false instantiations), never the plain version.
// - Grids: one 8-column group a thread (rt::grid_for: 2,048 blocks of
//   128 at the LM site), a grid-stride loop past 132 x 16 blocks.
//   Forward blocks of 128 threads (the general loop's ~166 registers
//   leave one 256-thread block an SM), backward blocks of 256.
//
// The backwards write every element of the (B, N, E) gradient themselves;
// the curves' lane stack (the noisy lanes and the ideal lane, B = L + 1)
// takes one launch of maxpool_winner_bwd per training step.
#include "common.cuh"

namespace {

constexpr int kRowBatch = 16;    // worker rows whose loads go out together
constexpr int kPoolThreads = 128;
constexpr int kCols = 8;         // maxpool_fwd / _ties_bwd: columns a thread
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

// How a column's running max takes row k's word x.  Codes compare as
// unsigned integers; the first maximum keeps the index.  operator() is
// pool_column's form; key / take / tied maxpool_fwd's, which keeps each
// column's compare key beside its word.
struct CodeMax {
  template <typename T>
  __device__ __forceinline__ void operator()(T x, int k, T& best,
                                             int32_t& arg) const {
    if (x > best) {
      best = x;
      arg = k;
    }
  }
  template <typename T>
  static __device__ __forceinline__ uint32_t key(T x) {
    return static_cast<uint32_t>(x);
  }
  template <typename T>
  static __device__ __forceinline__ void take(T x, uint32_t kx, int k,
                                              T& best, uint32_t& kb,
                                              int32_t& arg) {
    const bool up = kx > kb;
    best = up ? x : best;
    kb = up ? kx : kb;
    arg = up ? k : arg;
  }
  // the tie mask's predicate against the final max
  static __device__ __forceinline__ bool tied(uint32_t kx, uint32_t kb) {
    return kx == kb;
  }
};

// Floats of kKind compare by value, with NaN above everything (the first
// NaN wins, as jnp.argmax).  The pooled value is the winner's word, except
// that a tie of -0.0 and +0.0 pools to +0.0 (IEEE maximum, as jnp.max):
// equal floats have equal bits but for the zeros, whose AND is +0.0.  A
// row ties when its value equals the max's (h == max, as the "all" law
// computes it): -0.0 and +0.0 tie, a NaN max ties no row.
template <int kKind>
struct FloatMax {
  template <typename T>
  static __device__ __forceinline__ float key(T x) {
    return rt::bits_to_float(static_cast<uint32_t>(x), kKind);
  }
  template <typename T>
  static __device__ __forceinline__ void take(T x, float kx, int k, T& best,
                                              float& kb, int32_t& arg) {
    const bool up = kb == kb && (kx != kx || kx > kb);
    const bool tie = kx == kb;
    best = up ? x : tie ? static_cast<T>(best & x) : best;
    kb = up ? kx : kb;
    arg = up ? k : arg;
  }
  static __device__ __forceinline__ bool tied(float kx, float kb) {
    return kx == kb;
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

// Eight adjacent columns of one row as the registers of wide accesses:
// one 16-byte access for 16-bit words, two for 32-bit, one of 8 bytes for
// uint8.  kVec: aligned vector accesses; else `cols` (<= 8) scalar ones,
// the ragged or misaligned case, the other words zero.
template <typename T>
struct Cols8 {
  static constexpr int kPer = 4 / sizeof(T);   // words per register
  static constexpr int kRegs = kCols / kPer;
  static constexpr int kBits = 8 * sizeof(T);
  static constexpr uint32_t kOnes = 0xFFFFFFFFu >> (32 - kBits);
  uint32_t r[kRegs];

  __device__ __forceinline__ T get(int j) const {
    return static_cast<T>(r[j / kPer] >> (kBits * (j % kPer)));
  }
  // into a zeroed word
  __device__ __forceinline__ void put(int j, uint32_t x) {
    r[j / kPer] |= (x & kOnes) << (kBits * (j % kPer));
  }
  __device__ __forceinline__ void set(int j, uint32_t x) {
    r[j / kPer] &= ~(kOnes << (kBits * (j % kPer)));
    put(j, x);
  }
  template <bool kVec>
  __device__ __forceinline__ void load(const T* p, int cols) {
    if constexpr (kVec) {
      if constexpr (kRegs == 2) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
        r[0] = a.x;
        r[1] = a.y;
      } else {
#pragma unroll
        for (int q = 0; q < kRegs / 4; ++q) {
          const uint4 a = __ldg(reinterpret_cast<const uint4*>(p) + q);
          r[4 * q] = a.x;
          r[4 * q + 1] = a.y;
          r[4 * q + 2] = a.z;
          r[4 * q + 3] = a.w;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) r[q] = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < cols) put(j, p[j]);
    }
  }
  // kStream: evict-first stores (__stcs), for data written once and not
  // read back soon
  template <bool kVec, bool kStream = false>
  __device__ __forceinline__ void store(T* p, int cols) const {
    if constexpr (kVec) {
      if constexpr (kRegs == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
      } else {
#pragma unroll
        for (int q = 0; q < kRegs / 4; ++q) {
          const uint4 a =
              make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
          if constexpr (kStream)
            __stcs(reinterpret_cast<uint4*>(p) + q, a);
          else
            reinterpret_cast<uint4*>(p)[q] = a;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < cols) p[j] = get(j);
    }
  }
};

// The 8-column group `idx` of a (batch, e) plane: its batch row b, its
// first column i and how many of its columns exist.
struct Group {
  int64_t b, i;
  int cols;
  __device__ __forceinline__ Group(int64_t idx, int64_t groups, int64_t e)
      : b(idx / groups), i((idx - b * groups) * kCols),
        cols(static_cast<int>(e - i < kCols ? e - i : kCols)) {}
};

// The column loop of maxpool_fwd for any operands: codes, or floats
// compared as floats (FloatMax), a winner and a tie mask where the
// pointers are not null, any number of workers.
template <typename T, typename Max, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
maxpool_fwd_kernel(const T* __restrict__ h, T* __restrict__ v,
                   int32_t* __restrict__ winner, uint16_t* __restrict__ ties,
                   int64_t batch, int n, int64_t e) {
  using Key = decltype(Max::key(T()));
  const int64_t groups = (e + kCols - 1) / kCols;
  const int words = (n + kRowBatch - 1) / kRowBatch;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < batch * groups; idx += stride) {
    const Group at(idx, groups, e);
    const T* col = h + at.b * n * e + at.i;
    T best[kCols];
    Key kb[kCols];
    int32_t arg[kCols];
    Cols8<T> rows[kRowBatch];
    for (int k0 = 0; k0 < n; k0 += kRowBatch) {
      // every load of the batch before the first compare
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r)
        if (k0 + r < n)
          rows[r].template load<kVec>(col + (k0 + r) * e, at.cols);
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        if (k0 + r >= n) continue;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const T x = rows[r].get(j);
          const Key kx = Max::key(x);
          if (r == 0 && k0 == 0) {
            best[j] = x;
            kb[j] = kx;
            arg[j] = 0;
          } else {
            Max::take(x, kx, k0 + r, best[j], kb[j], arg[j]);
          }
        }
      }
    }
    Cols8<T> pooled = {};
#pragma unroll
    for (int j = 0; j < kCols; ++j) pooled.put(j, best[j]);
    pooled.template store<kVec>(v + at.b * e + at.i, at.cols);
    if (winner != nullptr) {
      Cols8<uint32_t> w = {};
#pragma unroll
      for (int j = 0; j < kCols; ++j) w.put(j, static_cast<uint32_t>(arg[j]));
      w.template store<kVec>(
          reinterpret_cast<uint32_t*>(winner) + at.b * e + at.i, at.cols);
    }
    if (ties == nullptr) continue;
    // against the final max: the rows of the one batch are still in
    // registers at n <= 16; above that each batch is read again
    for (int k0 = 0; k0 < n; k0 += kRowBatch) {
      if (words > 1) {
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r)
          if (k0 + r < n)
            rows[r].template load<kVec>(col + (k0 + r) * e, at.cols);
      }
      Cols8<uint16_t> m = {};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        uint32_t bits = 0;
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r)
          if (k0 + r < n && Max::tied(Max::key(rows[r].get(j)), kb[j]))
            bits |= 1u << r;
        m.put(j, bits);
      }
      m.template store<kVec>(
          ties + (at.b * words + k0 / kRowBatch) * e + at.i, at.cols);
    }
  }
}

// Order keys of the float words of one register (two 16-bit words or one
// 32-bit word): the sign-flip code, larger float -> larger key, -0.0 just
// below +0.0, a NaN above +inf (positive sign) or below -inf (negative).
// order_words is the inverse.
template <typename T>
__device__ __forceinline__ uint32_t order_keys(uint32_t x) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t neg = (x >> 15) & 0x00010001u;
    return x ^ (neg * 0x7FFFu | 0x80008000u);
  } else {
    return x ^ (static_cast<uint32_t>(static_cast<int32_t>(x) >> 31) |
                0x80000000u);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t order_words(uint32_t k) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t pos = (k >> 15) & 0x00010001u;
    return k ^ ~(pos * 0x7FFFu);
  } else {
    return k ^ ~((k >> 31) * 0x7FFFFFFFu);
  }
}

// The larger and the smaller of each lane of two registers of words T.
template <typename T>
__device__ __forceinline__ uint32_t lane_max(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    return __vmaxu2(a, b);
  } else {
    return a > b ? a : b;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t lane_min(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    return __vminu2(a, b);
  } else {
    return a < b ? a : b;
  }
}

// The top bit of each lane set where that lane of x is zero.
template <typename T>
__device__ __forceinline__ uint32_t zero_lanes(uint32_t x) {
  if constexpr (sizeof(T) == 2) {
    return ~(((x & 0x7FFF7FFFu) + 0x7FFF7FFFu) | x) & 0x80008000u;
  } else {
    return x == 0 ? 0x80000000u : 0u;
  }
}

// maxpool_fwd's form at the LM site: floats, at most 16 workers, the
// pooled max and the tie mask, no winner.  The rows are compared through
// their order keys, a register's lanes at once (two bf16 columns to a
// register), so a row costs a few integer operations per register where
// the float loop pays a compare chain per column.  The max key is the
// IEEE maximum (+0.0 above -0.0, as jnp.max); a row ties where its key is
// the max's, or it is -0.0 at a +0.0 max.  A group with a NaN (a key above
// +inf's or below -inf's) walks its columns' rows again in order: a column
// with a NaN pools its first NaN and ties no row.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
maxpool_fwd_ties_kernel(const T* __restrict__ h, T* __restrict__ v,
                        uint16_t* __restrict__ ties, int64_t batch, int n,
                        int64_t e, uint32_t inf_bits) {
  using C = Cols8<T>;
  static_assert(C::kRegs == Cols8<uint16_t>::kRegs || sizeof(T) == 4,
                "a register of keys maps onto a register of mask words");
  constexpr uint32_t kSign = 1u << (C::kBits - 1);
  constexpr uint32_t kLanes = C::kPer == 2 ? 0x00010001u : 1u;
  const uint32_t inf_key = (inf_bits | kSign) * kLanes;     // +inf's key
  const uint32_t ninf_key = (~(inf_bits | kSign) & C::kOnes) * kLanes;
  const int64_t groups = (e + kCols - 1) / kCols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < batch * groups; idx += stride) {
    const Group at(idx, groups, e);
    const T* col = h + at.b * n * e + at.i;
    C rows[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r)
      if (r < n) rows[r].template load<kVec>(col + r * e, at.cols);
    // each row's words become their keys in place
    C top, low;
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      if (r >= n) continue;
#pragma unroll
      for (int q = 0; q < C::kRegs; ++q) {
        const uint32_t k = order_keys<T>(rows[r].r[q]);
        rows[r].r[q] = k;
        top.r[q] = r == 0 ? k : lane_max<T>(top.r[q], k);
        low.r[q] = r == 0 ? k : lane_min<T>(low.r[q], k);
      }
    }
    C pooled;
    Cols8<uint16_t> m = {};
    bool nan = false;
#pragma unroll
    for (int q = 0; q < C::kRegs; ++q) {
      const uint32_t kmax = top.r[q];
      pooled.r[q] = order_words<T>(kmax);
      // at a +0.0 max (key kSign) -0.0 (key kSign - 1) ties too
      const uint32_t alt =
          kmax ^ ((zero_lanes<T>(kmax ^ (kSign * kLanes)) >> (C::kBits - 1)) *
                  C::kOnes);
      uint32_t bits = 0;
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        if (r >= n) continue;
        const uint32_t hit = zero_lanes<T>(rows[r].r[q] ^ kmax) |
                             zero_lanes<T>(rows[r].r[q] ^ alt);
        // lane tops to bit r of each 16-bit mask word
        bits |= (hit >> (C::kBits - 1 - r)) & (kLanes << r);
      }
      if constexpr (C::kPer == 2) {
        m.r[q] = bits;
      } else {
        m.put(q, bits);
      }
      nan |= lane_max<T>(kmax, inf_key) != inf_key ||
             lane_min<T>(low.r[q], ninf_key) != ninf_key;
    }
    if (nan) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r) {
          const uint32_t x = order_words<T>(rows[r].get(j)) & C::kOnes;
          if (r < n && (x & ~kSign) > inf_bits) {
            pooled.set(j, x);
            m.set(j, 0);
            break;
          }
        }
      }
    }
    pooled.template store<kVec>(v + at.b * e + at.i, at.cols);
    m.template store<kVec>(ties + at.b * e + at.i, at.cols);
  }
}

// maxpool_fwd's operands; winner and ties are null when not written.
struct FwdArgs {
  const void* h;
  void* v;
  void* winner;
  void* ties;
  int64_t batch;
  int n;
  int64_t e;
};

template <typename T, typename Max, bool kVec>
int fwd_launch(const FwdArgs& a, cudaStream_t s) {
  const int64_t groups = (a.e + kCols - 1) / kCols;
  maxpool_fwd_kernel<T, Max, kVec>
      <<<rt::grid_for(a.batch * groups, kFwdThreads), kFwdThreads, 0, s>>>(
          static_cast<const T*>(a.h), static_cast<T*>(a.v),
          static_cast<int32_t*>(a.winner), static_cast<uint16_t*>(a.ties),
          a.batch, a.n, a.e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int ties_launch(const FwdArgs& a, uint32_t inf_bits, cudaStream_t s) {
  const int64_t groups = (a.e + kCols - 1) / kCols;
  maxpool_fwd_ties_kernel<T, kVec>
      <<<rt::grid_for(a.batch * groups, kFwdThreads), kFwdThreads, 0, s>>>(
          static_cast<const T*>(a.h), static_cast<T*>(a.v),
          static_cast<uint16_t*>(a.ties), a.batch, a.n, a.e, inf_bits);
  return static_cast<int>(cudaGetLastError());
}

// Vector accesses where e is a multiple of 8 and every operand is aligned
// for them, scalar ones otherwise; floats (kInfBits: their infinity's
// bits; 0 for codes) with a tie mask, no winner and at most 16 workers
// take the keyed kernel.
template <typename T, typename Max, uint32_t kInfBits>
int fwd_dispatch(const FwdArgs& a, cudaStream_t s) {
  constexpr int kAlign = 8 * sizeof(T) < 16 ? 8 * sizeof(T) : 16;
  const bool vec = a.e % kCols == 0 && rt::aligned(a.h, kAlign) &&
                   rt::aligned(a.v, kAlign) &&
                   (a.winner == nullptr || rt::aligned(a.winner, 16)) &&
                   (a.ties == nullptr || rt::aligned(a.ties, 16));
  if constexpr (kInfBits != 0) {
    if (a.ties != nullptr && a.winner == nullptr && a.n <= kRowBatch)
      return vec ? ties_launch<T, true>(a, kInfBits, s)
                 : ties_launch<T, false>(a, kInfBits, s);
  }
  return vec ? fwd_launch<T, Max, true>(a, s)
             : fwd_launch<T, Max, false>(a, s);
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

// The "all" law's backward, g * (h == max), from the tie mask: g in the
// rows whose bit is set, g * 0 (rt::zero_product_bits) in the others.
// Per 8-column group: one access of g and one of each mask word, then one
// access per row, the select done on whole 32-bit registers.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
ties_bwd_kernel(const uint16_t* __restrict__ ties, const T* __restrict__ g,
                T* __restrict__ out, int64_t batch, int n, int64_t e,
                int kind) {
  using C = Cols8<T>;
  const int64_t groups = (e + kCols - 1) / kCols;
  const int words = (n + kRowBatch - 1) / kRowBatch;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < batch * groups; idx += stride) {
    const Group at(idx, groups, e);
    C gv, zero = {};
    gv.template load<kVec>(g + at.b * e + at.i, at.cols);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      zero.put(j, rt::zero_product_bits(gv.get(j), kind));
    T* col = out + at.b * n * e + at.i;
    for (int w = 0; w < words; ++w) {
      Cols8<uint16_t> m;
      m.template load<kVec>(ties + (at.b * words + w) * e + at.i, at.cols);
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        const int k = w * kRowBatch + r;
        if (k >= n) break;
        C o;
#pragma unroll
        for (int q = 0; q < C::kRegs; ++q) {
          // the lanes of register q whose column has bit r set
          uint32_t sel = 0;
#pragma unroll
          for (int t = 0; t < C::kPer; ++t) {
            const uint32_t bit = (m.get(q * C::kPer + t) >> r) & 1u;
            sel |= (0u - bit) & ((0xFFFFFFFFu >> (32 - C::kBits))
                                 << (C::kBits * t));
          }
          o.r[q] = (gv.r[q] & sel) | (zero.r[q] & ~sel);
        }
        o.template store<kVec, true>(col + k * e, at.cols);
      }
    }
  }
}

template <typename T, bool kVec>
int ties_bwd_launch(const void* ties, const void* g, void* out,
                    int64_t batch, int n, int64_t e, int kind,
                    cudaStream_t s) {
  const int64_t groups = (e + kCols - 1) / kCols;
  ties_bwd_kernel<T, kVec>
      <<<rt::grid_for(batch * groups, kBwdThreads), kBwdThreads, 0, s>>>(
          static_cast<const uint16_t*>(ties), static_cast<const T*>(g),
          static_cast<T*>(out), batch, n, e, kind);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ties_bwd_dispatch(const void* ties, const void* g, void* out,
                      int64_t batch, int n, int64_t e, int kind,
                      cudaStream_t s) {
  const bool vec = e % kCols == 0 && rt::aligned(ties, 16) &&
                   rt::aligned(g, 16) && rt::aligned(out, 16);
  return vec ? ties_bwd_launch<T, true>(ties, g, out, batch, n, e, kind, s)
             : ties_bwd_launch<T, false>(ties, g, out, batch, n, e, kind, s);
}

}  // namespace

extern "C" {

// h (batch, n, e) of kind -> v (batch, e) of kind; where not null, winner
// (batch, e) int32, the first argmax, and ties (batch, ceil(n / 16), e)
// uint16: bit r of word w set where row 16 w + r equals the max (as a
// float; as an integer for codes).
int maxpool_fwd(const void* h, void* v, void* winner, void* ties,
                int64_t batch, int n, int64_t e, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e == 0) return 0;
  const FwdArgs a{h, v, winner, ties, batch, n, e};
  switch (kind) {
    case rt::kF32:
      return fwd_dispatch<uint32_t, FloatMax<rt::kF32>, 0x7F800000u>(a, s);
    case rt::kBF16:
      return fwd_dispatch<uint16_t, FloatMax<rt::kBF16>, 0x7F80u>(a, s);
    case rt::kF16:
      return fwd_dispatch<uint16_t, FloatMax<rt::kF16>, 0x7C00u>(a, s);
    case rt::kU16:
      return fwd_dispatch<uint16_t, CodeMax, 0>(a, s);
    case rt::kU8:
      return fwd_dispatch<uint8_t, CodeMax, 0>(a, s);
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

// ties (batch, ceil(n / 16), e) uint16 as maxpool_fwd writes them, g
// (batch, e) float of kind -> out (batch, n, e): g in the rows whose bit
// is set, g * 0 in the others.
int maxpool_ties_bwd(const void* ties, const void* g, void* out,
                     int64_t batch, int n, int64_t e, int kind,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e == 0) return 0;
  if (kind == rt::kF32)
    return ties_bwd_dispatch<uint32_t>(ties, g, out, batch, n, e, kind, s);
  if (kind == rt::kBF16 || kind == rt::kF16)
    return ties_bwd_dispatch<uint16_t>(ties, g, out, batch, n, e, kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
