// The noisy OCS tournament (paper Alg. 1 with missed carrier sensing):
// max_rounds rounds of n_slots bit-plane sub-slots over the contention
// words [value code | id code], lowest-index capture at the end, and the
// per-round counts of still-contending and collided sub-frames.
//
// Replaces src/repro/kernels/ocs_contention/ocs_contention.py::
// _contention_kernel, in two entries that share one tournament body, a
// template on where a worker's word and a sensing bit come from:
//   ocs_contend  reads pre-formed words and the bit from pre-drawn packed
//                planes (the TPU kernel's interface: bit n_slots-1-d of
//                heard[l, r, n, k]);
//   ocs_noisy    reads the float features themselves and forms each word
//                in registers as it loads it (the Eq. 7 code of
//                common.cuh's Encode, shifted above the worker's id code:
//                core/ocs.py's word, bit for bit), and hashes each sensing
//                bit in place: the threefry2x32 stream of
//                repro_torch.random (jax_threefry_partitionable), so bit
//                heard[l, r, d, n, k] is one hash of the key
//                fold_in(fold_in(rng_l, r), d) at counter n*K + k.
//                Neither the codes, the words nor the sensing stream is
//                materialised, and each block adds its share of the
//                lane's accounting (rounds, collisions, contention slots).
//
// Layout.  The worker axis runs across the lanes of a warp: a column
// (one element k of one lane l) is a segment of SEG = next_pow2(N) lanes
// (32 for N > 16), and a warp holds 32 / SEG columns; for 33 <= N <= 64
// each lane holds two workers (n and n + 32).  A sub-slot is
//   tx    = __ballot_sync(alive && bit d of my word)   (the segment's bits)
//   a silent alive worker that hears a transmission quits,
// and the winner is the lowest set bit of the alive ballot.  A sensing bit
// is read, and so hashed, only where it can matter: sub-slot d <
// total_bits, worker alive and silent, and some worker of the column
// transmitting.  A resolved column (at most one survivor) never changes
// again, so a warp stops as soon as all its columns are resolved; the
// counts of the rounds it skips are 0, as the TPU kernel counts them.
// The counts are integer adds (per warp a popcount of a ballot, per block
// shared atomics, one global atomicAdd per block and round): exact in any
// order.  ocs_noisy also adds each block's share of its lane's accounting
// (rounds, collisions, contention slots) with three atomics, so the site
// needs no reduction kernels after the tournament.
//
// What bounds it on an H100.  ocs_noisy: the hashes its inputs need,
// ~85 integer operations each (20 rounds of add, rotate, xor plus the key
// injections and the uniform), against the INT32 rate of 132 SMs x 64
// lanes per clock; at the serving tick's 16 workers x 8192 columns that is
// far below the memory time of the features, so what is left is the
// launch.  The layout gives the tick's 8192 columns 131,072 threads
// instead of 8,192, so the serial part per thread is a few sub-slots of
// one worker.  Reading the features in place of words moves fewer bytes
// (2 a worker and column in bfloat16, where a word is 4) and takes the
// encode kernel and the word's int64 glue off the site.
// ocs_contend: bytes (a word and a plane word per worker and column).
#include "common.cuh"

namespace {

constexpr int kThreadsCT = 256;
constexpr int kMaxRounds = 64;

// ---------------------------------------------------------------------------
// threefry2x32 (20 rounds), as repro_torch/random.py::threefry2x32
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// ---------------------------------------------------------------------------
// Where a sensing bit comes from
// ---------------------------------------------------------------------------

// The TPU kernel's operand: one 32-bit plane word per (lane, round,
// worker, column), read once per round for each live worker.
template <int WPL>
struct PackedPlanes {
  const uint32_t* heard;
  int n_slots, max_rounds, n;
  int64_t k;
  uint32_t plane[WPL];

  __device__ void begin_round(int lane, int r, const int (&worker)[WPL],
                              const bool (&alive)[WPL], int64_t col) {
#pragma unroll
    for (int i = 0; i < WPL; ++i)
      plane[i] = alive[i]
          ? heard[((static_cast<int64_t>(lane) * max_rounds + r) * n +
                   worker[i]) * k + col]
          : 0u;
  }
  __device__ bool heard_bit(int i, int /*r*/, int d, int /*worker*/,
                            int64_t /*col*/) const {
    return (plane[i] >> (n_slots - 1 - d)) & 1u;
  }
};

// The hashed stream: keys[r * kd + d] is fold_in(fold_in(rng_l, r), d) in
// shared memory; the uniform is drawn in p_keep's type (random.uniform):
// float32 from the top 23 of 32 bits, bfloat16 from the low 8 bits (the
// top 7 of them), float16 from the low 16 bits (the top 10), each exact in
// float32, so the compare with p_keep widened to float32 is the compare in
// p_keep's type.
template <int WPL>
struct HashedStream {
  const uint32_t* keys;   // shared: (max_rounds * kd, 2)
  int kd, kind;
  int64_t k;
  float p[WPL];

  __device__ void begin_round(int, int, const int (&)[WPL],
                              const bool (&)[WPL], int64_t) {}
  __device__ bool heard_bit(int i, int r, int d, int worker,
                            int64_t col) const {
    const uint32_t* key = keys + 2 * (r * kd + d);
    const uint64_t c = static_cast<uint64_t>(worker) * k + col;
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(key[0], key[1], x0, x1);
    const uint32_t bits = x0 ^ x1;
    float u;
    if (kind == rt::kF32)
      u = static_cast<float>(bits >> 9) * 1.1920928955078125e-7f;   // 2^-23
    else if (kind == rt::kBF16)
      u = static_cast<float>((bits & 0xFFu) >> 1) * 0.0078125f;     // 2^-7
    else
      u = static_cast<float>((bits & 0xFFFFu) >> 6) * 0.0009765625f;  // 2^-10
    return u < p[i];
  }
};

// ---------------------------------------------------------------------------
// Where a worker's contention word comes from
// ---------------------------------------------------------------------------

// Pre-formed 32-bit words (the TPU kernel's operand).
struct FormedWords {
  const uint32_t* word;
  __device__ uint32_t operator()(int64_t at, int /*worker*/) const {
    return word[at];
  }
};

// The word formed from a float's raw bits UIn as it is loaded:
// [D-bit Eq. 7 code | id code 2^id_bits - 1 - worker], the id code taken
// mod 2^32 (a padding worker past 2^id_bits wraps, and is masked out), as
// core/ocs.py forms it.  bits + id_bits <= 32.
template <typename UIn>
struct WordsFromFloats {
  const UIn* h;
  rt::Encode<UIn, uint32_t> encode;   // shift: the float's width - bits
  int id_bits;
  __device__ uint32_t operator()(int64_t at, int worker) const {
    const uint32_t id = (1u << id_bits) - 1u - static_cast<uint32_t>(worker);
    return (encode(h[at]) << id_bits) | id;
  }
};

// ---------------------------------------------------------------------------
// The tournament body, shared by both entries
// ---------------------------------------------------------------------------

template <int SEG, int WPL, class Src, class Words>
__device__ void tournament(Src& src, const Words& words,
                           const uint8_t* __restrict__ mask,
                           int32_t* __restrict__ winner, int* cnt, int n,
                           int64_t k, int kd, int max_rounds,
                           int total_bits, int mask_lane_stride) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr unsigned kSegBits = SEG == 32 ? kFull : ((1u << SEG) - 1u);
  const int lane = blockIdx.y;
  const int tid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = tid / SEG, in_seg = tid % SEG;
  const unsigned seg_shift = static_cast<unsigned>(seg * SEG);
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) *
          (32 / SEG) + seg;
  const bool live = col < k;

  int worker[WPL];
  bool alive[WPL];
  uint32_t w[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    worker[i] = in_seg + 32 * i;
    alive[i] = live && worker[i] < n &&
               mask[lane * mask_lane_stride + worker[i]] != 0;
    w[i] = alive[i]
        ? words((static_cast<int64_t>(lane) * n + worker[i]) * k + col,
                worker[i])
        : 0u;
  }
  // the segment's alive set, identical in each of its lanes
  auto seg_alive = [&](unsigned& lo, unsigned& hi) {
    lo = (__ballot_sync(kFull, alive[0]) >> seg_shift) & kSegBits;
    hi = WPL == 2 ? __ballot_sync(kFull, alive[WPL - 1]) : 0u;
  };

  bool done = !live;   // a padding column contends in no round
  for (int r = 0; r < max_rounds; ++r) {
    if (__all_sync(kFull, done)) break;   // later rounds count 0
    src.begin_round(lane, r, worker, alive, col);
    for (int d = 0; d < kd; ++d) {
      unsigned lo, hi;
      seg_alive(lo, hi);
      // one survivor (or none) per column: the rest of the round is inert
      if (!__any_sync(kFull, __popc(lo) + __popc(hi) > 1)) break;
      const int shift = total_bits - 1 - d;
      bool tx[WPL];
#pragma unroll
      for (int i = 0; i < WPL; ++i) tx[i] = alive[i] && ((w[i] >> shift) & 1u);
      unsigned any = (__ballot_sync(kFull, tx[0]) >> seg_shift) & kSegBits;
      if (WPL == 2) any |= __ballot_sync(kFull, tx[WPL - 1]);
      if (any) {
#pragma unroll
        for (int i = 0; i < WPL; ++i)
          if (alive[i] && !tx[i] && src.heard_bit(i, r, d, worker[i], col))
            alive[i] = false;
      }
    }
    unsigned lo, hi;
    seg_alive(lo, hi);
    const bool coll = live && __popc(lo) + __popc(hi) > 1;
    const bool lead = in_seg == 0;
    const int n_cont = __popc(__ballot_sync(kFull, lead && !done));
    const int n_coll = __popc(__ballot_sync(kFull, lead && coll));
    if (tid == 0) {
      if (n_cont) atomicAdd(&cnt[r], n_cont);
      if (n_coll) atomicAdd(&cnt[max_rounds + r], n_coll);
    }
    done = done || !coll;
  }
  unsigned lo, hi;
  seg_alive(lo, hi);
  if (live && in_seg == 0)
    winner[static_cast<int64_t>(lane) * k + col] =
        lo ? __ffs(lo) - 1 : (hi ? 32 + __ffs(hi) - 1 : 0);
}

// After the body: the block's per-round counts to the output, one
// atomicAdd each.
__device__ __forceinline__ void flush_counts(const int* cnt,
                                             int32_t* contending,
                                             int32_t* collided,
                                             int max_rounds) {
  __syncthreads();
  const int lane = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * max_rounds; i += blockDim.x) {
    if (!cnt[i]) continue;
    int32_t* dst = i < max_rounds ? contending + lane * max_rounds + i
                                  : collided + lane * max_rounds +
                                        (i - max_rounds);
    atomicAdd(dst, cnt[i]);
  }
}

// ocs_noisy's accounting, as core/ocs.py's plain version computes it from
// the finished counts: rounds = rounds with a contending sub-frame,
// collisions = the collided sum, contention slots = total_bits x the
// contending sum (int32, wrapping as the plain version's cast does).  No
// block waits for the others: a sub-frame resolved stays resolved, so a
// lane's contending count never grows from one round to the next, nor
// does any block's share of it, and the lane's rounds are the most rounds
// any of its blocks counted (an atomicMax); the sums are sums of the
// blocks' sums mod 2^32 (atomicAdd).  Warp 0 reduces the block's counts
// with ballots and shuffles; lane 0 adds them.  The caller zeroes acct.
__device__ __forceinline__ void add_accounting(const int* cnt,
                                               int32_t* __restrict__ acct,
                                               int lanes, int max_rounds,
                                               int total_bits) {
  if (threadIdx.x >= 32) return;   // after flush_counts' __syncthreads
  constexpr unsigned kFull = 0xffffffffu;
  uint32_t cont = 0, coll = 0;
  unsigned live = 0;
  for (int r0 = 0; r0 < max_rounds; r0 += 32) {
    const int r = r0 + static_cast<int>(threadIdx.x);
    const int c = r < max_rounds ? cnt[r] : 0;
    cont += static_cast<uint32_t>(c);
    coll += r < max_rounds ? static_cast<uint32_t>(cnt[max_rounds + r]) : 0u;
    live += __popc(__ballot_sync(kFull, c > 0));
  }
  cont = __reduce_add_sync(kFull, cont);
  coll = __reduce_add_sync(kFull, coll);
  if (threadIdx.x != 0) return;
  const int lane = blockIdx.y;
  if (live) atomicMax(&acct[lane], static_cast<int>(live));
  if (coll) atomicAdd(&acct[lanes + lane], static_cast<int>(coll));
  if (cont)
    atomicAdd(reinterpret_cast<unsigned*>(&acct[2 * lanes + lane]),
              static_cast<uint32_t>(total_bits) * cont);
}

template <int SEG, int WPL>
__global__ void __launch_bounds__(kThreadsCT)
    contend_kernel(const uint32_t* __restrict__ word,
                   const uint32_t* __restrict__ heard,
                   const uint8_t* __restrict__ mask,
                   int32_t* __restrict__ winner,
                   int32_t* __restrict__ contending,
                   int32_t* __restrict__ collided, int n, int64_t k,
                   int n_slots, int max_rounds, int total_bits,
                   int mask_lane_stride) {
  __shared__ int cnt[2 * kMaxRounds];
  for (int i = threadIdx.x; i < 2 * max_rounds; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  PackedPlanes<WPL> src{heard, n_slots, max_rounds, n, k, {}};
  tournament<SEG, WPL>(src, FormedWords{word}, mask, winner, cnt, n, k,
                       max(0, min(n_slots, total_bits)), max_rounds,
                       total_bits, mask_lane_stride);
  flush_counts(cnt, contending, collided, max_rounds);
}

template <int SEG, int WPL, class Words>
__global__ void __launch_bounds__(kThreadsCT)
    noisy_kernel(const Words words, const uint8_t* __restrict__ mask,
                 const int64_t* __restrict__ lane_keys,
                 const void* __restrict__ p_keep, int p_kind,
                 int p_worker_stride, int32_t* __restrict__ winner,
                 int32_t* __restrict__ contending,
                 int32_t* __restrict__ collided, int32_t* __restrict__ acct,
                 int n, int64_t k, int kd, int max_rounds, int total_bits,
                 int mask_lane_stride) {
  extern __shared__ uint32_t keys[];   // (max_rounds * kd + max_rounds, 2)
  __shared__ int cnt[2 * kMaxRounds];
  const int lane = blockIdx.y;
  uint32_t* round_keys = keys + 2 * max_rounds * kd;
  for (int i = threadIdx.x; i < 2 * max_rounds; i += blockDim.x) cnt[i] = 0;
  // fold_in(key, x) = threefry2x32(key, (0, x))
  for (int r = threadIdx.x; r < max_rounds; r += blockDim.x) {
    uint32_t x0 = 0, x1 = static_cast<uint32_t>(r);
    threefry2x32(static_cast<uint32_t>(lane_keys[2 * lane]),
                 static_cast<uint32_t>(lane_keys[2 * lane + 1]), x0, x1);
    round_keys[2 * r] = x0;
    round_keys[2 * r + 1] = x1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < max_rounds * kd; i += blockDim.x) {
    const int r = i / kd, d = i % kd;
    uint32_t x0 = 0, x1 = static_cast<uint32_t>(d);
    threefry2x32(round_keys[2 * r], round_keys[2 * r + 1], x0, x1);
    keys[2 * i] = x0;
    keys[2 * i + 1] = x1;
  }
  __syncthreads();

  HashedStream<WPL> src{keys, kd, p_kind, k, {}};
  const int p_lane_stride = p_worker_stride ? n : 1;
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int seg_lane = (threadIdx.x & 31) % SEG;
    const int wk = min(seg_lane + 32 * i, n - 1);   // padding lanes read 0's
    const int64_t at = static_cast<int64_t>(lane) * p_lane_stride +
                       (p_worker_stride ? wk : 0);
    const uint32_t bits = p_kind == rt::kF32
        ? static_cast<const uint32_t*>(p_keep)[at]
        : static_cast<const uint16_t*>(p_keep)[at];
    src.p[i] = rt::bits_to_float(bits, p_kind);
  }
  tournament<SEG, WPL>(src, words, mask, winner, cnt, n, k, kd, max_rounds,
                       total_bits, mask_lane_stride);
  flush_counts(cnt, contending, collided, max_rounds);
  add_accounting(cnt, acct, gridDim.y, max_rounds, total_bits);
}

inline unsigned col_blocks(int64_t k, int seg) {
  const int64_t cols = (kThreadsCT / 32) * (32 / seg);
  return static_cast<unsigned>((k + cols - 1) / cols);
}

bool bad_shape(int lanes, int n, int64_t k, int n_slots, int max_rounds) {
  return n < 1 || n > 64 || n_slots < 1 || n_slots > 32 || max_rounds < 1 ||
         max_rounds > kMaxRounds || lanes < 1 || lanes > 65535 || k < 0;
}

// CALL(SEG, WPL) for the segment of n workers
#define RT_BY_SEGMENT(n, CALL)         \
  if ((n) <= 1) CALL(1, 1);            \
  else if ((n) <= 2) CALL(2, 1);       \
  else if ((n) <= 4) CALL(4, 1);       \
  else if ((n) <= 8) CALL(8, 1);       \
  else if ((n) <= 16) CALL(16, 1);     \
  else if ((n) <= 32) CALL(32, 1);     \
  else CALL(32, 2)

}  // namespace

extern "C" {

// word (lanes, n, k) u32; heard (lanes, max_rounds, n, k) u32 with bit
// n_slots-1-d of each word the draw of sub-slot d; mask (lanes or 1, n)
// uint8 -> winner (lanes, k) int32; contending / collided (lanes,
// max_rounds) int32, which the caller zeroes.
int ocs_contend(const void* word, const void* heard, const void* mask,
                void* winner, void* contending, void* collided, int lanes,
                int n, int64_t k, int n_slots, int max_rounds,
                int total_bits, int mask_lane_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(lanes, n, k, n_slots, max_rounds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
#define RT_CONTEND(SEG, WPL)                                              \
  contend_kernel<SEG, WPL>                                                \
      <<<dim3(col_blocks(k, SEG), static_cast<unsigned>(lanes)),          \
         kThreadsCT, 0, s>>>(                                             \
          static_cast<const uint32_t*>(word),                             \
          static_cast<const uint32_t*>(heard),                            \
          static_cast<const uint8_t*>(mask), static_cast<int32_t*>(winner), \
          static_cast<int32_t*>(contending),                              \
          static_cast<int32_t*>(collided), n, k, n_slots, max_rounds,     \
          total_bits, mask_lane_stride)
  RT_BY_SEGMENT(n, RT_CONTEND);
#undef RT_CONTEND
  return static_cast<int>(cudaGetLastError());
}

// The tournament over float features with the sensing stream hashed in
// place.  h (lanes, n, k) raw words of h_kind (float32, bfloat16,
// float16), each worker's word [bits-bit Eq. 7 code | id code] formed in
// the kernel, bits + id_bits <= 32; lane_keys (lanes, 2) int64 threefry
// keys (repro_torch.random's words, below 2^32); p_keep (lanes, 1) or (lanes, n) raw words of p_kind, per worker
// when p_worker_stride is 1; mask, winner, contending and collided as
// ocs_contend; acct (3, lanes) int32 (rounds, collisions, contention
// slots), which the caller zeroes with the counts.
int ocs_noisy(const void* h, int h_kind, int bits, int id_bits,
              const void* mask, const void* lane_keys, const void* p_keep,
              int p_kind, int p_worker_stride, void* winner,
              void* contending, void* collided, void* acct,
              int lanes, int n, int64_t k, int n_slots, int max_rounds,
              int mask_lane_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = h_kind == rt::kF32 ? 32 : 16;
  if (bad_shape(lanes, n, k, n_slots, max_rounds) ||
      (p_kind != rt::kF32 && p_kind != rt::kBF16 && p_kind != rt::kF16) ||
      (h_kind != rt::kF32 && h_kind != rt::kBF16 && h_kind != rt::kF16) ||
      bits < 1 || bits > width || id_bits < 0 || bits + id_bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  const int total_bits = bits + id_bits;
  const int kd = max(0, min(n_slots, total_bits));
  const size_t smem = sizeof(uint32_t) * 2 * max_rounds * (kd + 1);
#define RT_NOISY(SEG, WPL)                                                \
  noisy_kernel<SEG, WPL>                                                  \
      <<<dim3(col_blocks(k, SEG), static_cast<unsigned>(lanes)),          \
         kThreadsCT, smem, s>>>(                                          \
          words, static_cast<const uint8_t*>(mask),                       \
          static_cast<const int64_t*>(lane_keys), p_keep, p_kind,         \
          p_worker_stride, static_cast<int32_t*>(winner),                 \
          static_cast<int32_t*>(contending),                              \
          static_cast<int32_t*>(collided), static_cast<int32_t*>(acct),   \
          n, k, kd, max_rounds, total_bits, mask_lane_stride)
  if (h_kind == rt::kF32) {
    const WordsFromFloats<uint32_t> words{
        static_cast<const uint32_t*>(h), {32 - bits}, id_bits};
    RT_BY_SEGMENT(n, RT_NOISY);
  } else {
    const WordsFromFloats<uint16_t> words{
        static_cast<const uint16_t*>(h), {16 - bits}, id_bits};
    RT_BY_SEGMENT(n, RT_NOISY);
  }
#undef RT_NOISY
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
