// The noisy OCS tournament (paper Alg. 1 with missed carrier sensing):
// max_rounds rounds of n_slots bit-plane sub-slots over the contention
// words [value code | id code], lowest-index capture at the end, and the
// per-round counts of still-contending and collided sub-frames.
//
// Replaces src/repro/kernels/ocs_contention/ocs_contention.py::
// _contention_kernel.  One thread owns one element column of one lane
// (blockIdx.y is the lane, so one launch serves every p_miss lane of a
// step).  The live set of the column's N <= 64 workers is one uint64_t
// mask; each sub-slot is a few word operations on registers:
//   tx    = alive & plane(d)          (workers whose bit d is 1 transmit)
//   heard = plane of the packed sensing draws
//   alive = tx ? alive & (tx | ~heard) : alive
// and the winner is the lowest set bit (__ffsll).  The words and the
// packed draws are read once (4 bytes each per worker and round), so the
// kernel is bound by memory at large K and by the launch at the paper's
// K of a few thousand columns.  The counts are integers, reduced per block
// with warp shuffles and added with one atomicAdd per block and round, so
// their order does not matter.
#include "common.cuh"

namespace {

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum `v` over the block; thread 0 adds it to *dst.  Every thread calls.
__device__ __forceinline__ void block_add(int v, int* smem, int32_t* dst) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < (blockDim.x + 31) / 32; ++i) total += smem[i];
    if (total) atomicAdd(dst, total);
  }
  __syncthreads();
}

template <int NMAX>
__global__ void contend_kernel(const uint32_t* __restrict__ word,
                               const uint32_t* __restrict__ heard,
                               const uint8_t* __restrict__ mask,
                               int32_t* __restrict__ winner,
                               int32_t* __restrict__ contending,
                               int32_t* __restrict__ collided, int n,
                               int64_t k, int n_slots, int max_rounds,
                               int total_bits, int mask_lane_stride) {
  __shared__ int smem[2][32];
  const int lane = blockIdx.y;
  const int64_t col = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const bool live = col < k;

  uint32_t w[NMAX];
  uint64_t alive = 0;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    w[i] = 0;
    if (i < n && live) {
      w[i] = word[(static_cast<int64_t>(lane) * n + i) * k + col];
      if (mask[lane * mask_lane_stride + i]) alive |= 1ull << i;
    }
  }
  bool done = !live;   // a padding thread contends in no round
  for (int r = 0; r < max_rounds; ++r) {
    uint32_t hw[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      hw[i] = 0;
      if (i < n && live)
        hw[i] = heard[((static_cast<int64_t>(lane) * max_rounds + r) * n + i)
                      * k + col];
    }
    const int cont = done ? 0 : 1;
    for (int d = 0; d < n_slots && d < total_bits; ++d) {
      const int shift = total_bits - 1 - d, hshift = n_slots - 1 - d;
      uint64_t tx = 0, hm = 0;
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i < n) {
          tx |= static_cast<uint64_t>((w[i] >> shift) & 1u) << i;
          hm |= static_cast<uint64_t>((hw[i] >> hshift) & 1u) << i;
        }
      }
      tx &= alive;
      // a sensing worker quits only if someone transmitted AND it heard
      if (tx) alive &= (tx | ~hm);
    }
    const int coll = __popcll(alive) > 1 ? 1 : 0;
    done = done || !coll;
    block_add(cont, smem[0], contending + lane * max_rounds + r);
    block_add(coll, smem[1], collided + lane * max_rounds + r);
  }
  if (live)
    winner[static_cast<int64_t>(lane) * k + col] =
        alive ? __ffsll(static_cast<long long>(alive)) - 1 : 0;
}

template <int NMAX>
void launch(const uint32_t* word, const uint32_t* heard, const uint8_t* mask,
            int32_t* winner, int32_t* contending, int32_t* collided,
            int lanes, int n, int64_t k, int n_slots, int max_rounds,
            int total_bits, int mask_lane_stride, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((k + rt::kThreads - 1) / rt::kThreads),
            static_cast<unsigned>(lanes));
  contend_kernel<NMAX><<<grid, rt::kThreads, 0, s>>>(
      word, heard, mask, winner, contending, collided, n, k, n_slots,
      max_rounds, total_bits, mask_lane_stride);
}

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
  if (n < 1 || n > 64 || n_slots < 1 || n_slots > 32 || max_rounds < 1 ||
      lanes < 1 || k < 0 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  auto* w = static_cast<const uint32_t*>(word);
  auto* h = static_cast<const uint32_t*>(heard);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* win = static_cast<int32_t*>(winner);
  auto* cont = static_cast<int32_t*>(contending);
  auto* coll = static_cast<int32_t*>(collided);
#define RT_CONTEND(NM)                                                     \
  launch<NM>(w, h, m, win, cont, coll, lanes, n, k, n_slots, max_rounds,   \
             total_bits, mask_lane_stride, s)
  if (n <= 4) RT_CONTEND(4);
  else if (n <= 8) RT_CONTEND(8);
  else if (n <= 16) RT_CONTEND(16);
  else if (n <= 32) RT_CONTEND(32);
  else RT_CONTEND(64);
#undef RT_CONTEND
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
