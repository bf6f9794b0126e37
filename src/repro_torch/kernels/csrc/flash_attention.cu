// Flash attention forward: causal or non-causal attention of q (B, H, Sq, D)
// over k, v (B, Hkv, Sk, D) with an online softmax, query head h reading
// KV head h / (H / Hkv).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel.  The TPU kernel walks a sequential grid axis of KV blocks
// and carries the running max m, sum l and accumulator acc of a query block
// in VMEM scratch.  Here one thread block owns one (b, h, 64-row query
// tile) and walks the KV tiles itself, 64 keys at a time, with m, l and
// acc in registers for the whole walk.  Masked scores are -1e30 and tiles
// wholly above the causal diagonal are skipped, as in the TPU kernel; keys
// past Sk (a ragged last tile, which the TPU kernel's shapes never have)
// are -inf, so they add exactly 0.  Two designs, chosen by type:
//
// bfloat16 / float16, head_dim 64 or 128: tensor cores.  One warpgroup
// (128 threads) per block.  TMA brings the Q tile once and the K and V
// tiles into a ring of kStages stages in shared memory, 128-byte swizzled,
// each stage behind an mbarrier; thread 0 issues tile j + kStages - 1
// while the warpgroup computes on tile j, so the next tile's load overlaps
// this tile's products.  S = Q K^T is wgmma m64n64k16 with Q and K read
// K-major from shared memory; the online softmax runs on the f32
// accumulator in registers (a row's max and sum across the quad of lanes
// that holds it, the scale folded into one FFMA per score before ex2);
// P is rounded to the input type in registers, where the accumulator
// layout is already wgmma's A-operand layout, and O += P V is wgmma
// m64nDk16 with P from registers and V read MN-major from shared memory
// through the B-transpose flag.  The QK^T products of bf16 or f16 inputs
// are exact in the f32 accumulator (the sum runs in another order than
// the TPU's); the one rounding this design adds is P to 16 bits before
// PV.
//
// float32, and head_dim 16 or 32 in every type: the FMA design.  Four
// warps per block; each warp owns 16 query rows, lane i computes the
// scores of keys i and i + 32 (float32 FMAs, as the TPU kernel computes in
// float32), row max and sum are warp shuffles, and P.V accumulates D / 2
// outputs per lane.  No tensor-core product meets the float32 parity
// tolerance (3e-5), and no configuration of the repo runs 16-bit heads
// narrower than 64.
//
// What bounds it on an H100: the causal pairs' two products, 4 * H * D *
// S (S + 1) / 2 flops, on the 989 TFLOP/s bf16 tensor rate, and q, k, v,
// o moved once at 3.35 TB/s; at the prefill shapes (one prompt, 16 heads
// of 64, S of a few hundred) both are well under a microsecond, so the
// launch, the first tile's load and the per-tile softmax set the time.
// At long prompts the softmax's exp2 (4096 per tile: 256 cycles of an
// SM's 16 special-function results per clock, against 277 cycles of its
// tensor cores for the tile's two products) and each tile's serial QK^T ->
// softmax -> PV chain do; five blocks per SM (90 registers at D = 64,
// 41 KB of shared memory) interleave those chains.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete.  A transaction that never
// lands traps (a launch failure the caller sees) instead of hanging the
// card: 2^24 polls is seconds, each try_wait itself waits a while.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit (flushes subnormal results to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each >> 4.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// wgmma.mma_async: SS (A and B from shared memory, both K-major) for
// S = Q K^T; RS (A from registers, B MN-major: the transpose flag) for
// O += P V.  Generated operand lists: d[i] is accumulator register i.

__device__ __forceinline__ void wgmma_ss_m64n64k16_bf16(float (&d)[32], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16_bf16(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16_bf16(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n64k16_f16(float (&d)[32], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16_f16(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16_f16(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}


template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    wgmma_ss_m64n64k16_bf16(d, a, b, scale_d);
  else
    wgmma_ss_m64n64k16_f16(d, a, b, scale_d);
}

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (D == 64) wgmma_rs_m64n64k16_bf16(d, a, b);
    else wgmma_rs_m64n128k16_bf16(d, a, b);
  } else {
    if constexpr (D == 64) wgmma_rs_m64n64k16_f16(d, a, b);
    else wgmma_rs_m64n128k16_f16(d, a, b);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core design (bfloat16 / float16, D = 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                       // query rows = keys per tile
constexpr int kBoxBytes = kTile * 64 * 2;       // one 64 x 64 16-bit box
constexpr int kStages = 2;

template <int D>
constexpr int wg_smem_bytes() {
  // Q, then per stage K and V; each D / 64 boxes; 1024 for the alignment
  return (D / 64) * kBoxBytes * (1 + 2 * kStages) + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, int H, int Hkv, int Sq, int Sk,
                       float scale_log2, int causal) {
  constexpr int DB = D / 64;                    // 64-column boxes per row
  constexpr int kBytesKV = 2 * DB * kBoxBytes;  // one stage: K and V
  constexpr int kAccO = D / 2;                  // O registers per thread
  constexpr float kMasked = -1e30f;             // the TPU kernel's mask
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + kStages];        // Q, then one per stage

  // 1024-byte aligned base: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* q_s = base;
  auto k_s = [&](int s) { return base + (1 + 2 * s) * DB * kBoxBytes; };
  auto v_s = [&](int s) { return base + (2 + 2 * s) * DB * kBoxBytes; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int hk = h / (H / Hkv);
  // the longest causal rows first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int kv_head = b * Hkv + hk;
  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, q0 / kTile + 1);

  // the maps stay in parameter space: TMA reads them from there
  const CUtensorMap* tk_p = &tk;
  const CUtensorMap* tv_p = &tv;
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(&bars[1 + s], kBytesKV);
#pragma unroll
    for (int cb = 0; cb < DB; ++cb) {
      tma_load_3d(k_s(s) + cb * kBoxBytes, tk_p, &bars[1 + s], cb * 64,
                  j * kTile, kv_head);
      tma_load_3d(v_s(s) + cb * kBoxBytes, tv_p, &bars[1 + s], cb * 64,
                  j * kTile, kv_head);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], DB * kBoxBytes);
#pragma unroll
    for (int cb = 0; cb < DB; ++cb)
      tma_load_3d(q_s + cb * kBoxBytes, &tq, &bars[0], cb * 64, q0,
                  b * H + h);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv(j);
  }

  // this thread's rows of the tile (wgmma's accumulator layout): r0 and
  // r0 + 8; its columns of each 8-wide block: 2 * (lane % 4) + {0, 1}
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[kAccO];
#pragma unroll
  for (int i = 0; i < kAccO; ++i) acc[i] = 0.f;
  float s_acc[32];
  const uint32_t q_addr = smem_u32(q_s);
  const float masked = kMasked / scale_log2;   // raw score of s' = -1e30
  mbar_wait(&bars[0], 0);
  __syncwarp();   // the warp converged again for the .aligned wgmma

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (tid == 0 && j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    mbar_wait(&bars[1 + stage], (j / kStages) & 1);
    __syncwarp();
    const uint32_t k_addr = smem_u32(k_s(stage));
    const uint32_t v_addr = smem_u32(v_s(stage));

    // S = Q K^T over D / 16 steps of 16 (32 bytes along the swizzled row)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_qk<T>(s_acc, desc_sw128(q_addr + off, 16, 1024),
                  desc_sw128(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // online softmax in the log2 domain, s' = s * scale * log2(e), with the
    // scale folded into one FMA per score: masking (on the diagonal and
    // past Sk) writes the raw score whose s' is the TPU kernel's -1e30,
    // or -inf; the row max is taken on raw scores (the scale is > 0)
    const int k0 = j * kTile;
    if ((causal && k0 + kTile - 1 > q0) || k0 + kTile > Sk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
        if (causal && key > q0 + ((i & 2) ? r0 + 8 : r0)) s_acc[i] = masked;
        if (key >= Sk) s_acc[i] = -__int_as_float(0x7f800000);   // -inf
      }
    }
    float mx[2] = {masked, masked};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s_acc[i] = ex2(fmaf(s_acc[i], scale_log2, -m[r]));
      l[r] += s_acc[i];
    }
    uint32_t p_frag[4][4];
    // the accumulator of keys 16kk..16kk+15 is the A operand of step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        p_frag[kk][t] = pack2<T>(s_acc[8 * kk + 2 * t],
                                 s_acc[8 * kk + 2 * t + 1]);
#pragma unroll
    for (int i = 0; i < kAccO; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: V's keys are the K dimension, its D columns contiguous
    // (MN-major, transposed B); 16 keys are 2048 bytes, the second box of
    // 64 columns is kBoxBytes on (the leading byte offset)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<T, D>(acc, p_frag[kk],
                     desc_sw128(v_addr + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();   // the stage is read: free for tile j + kStages
  }

  // the quad's partial sums, then O / l to the output type
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] = fmaxf(l[r] + __shfl_xor_sync(0xffffffffu, l[r], 2), 1e-30f);
  }
  T* ob = o + (static_cast<int64_t>(b) * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + 8 * r;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const uint32_t v = pack2<T>(acc[4 * jb + 2 * r] / l[r],
                                  acc[4 * jb + 2 * r + 1] / l[r]);
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(qpos) * D +
                                   8 * jb + c0) = v;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, rows, D) 16-bit, contiguous, read in 64 x 64 boxes, 128-byte
// swizzled; rows past the end read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt,
                int heads, int rows, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Hkv, int Sq, int Sk, float scale, int causal,
                 cudaStream_t s) {
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (!rt::aligned(p, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType dt = std::is_same_v<T, __nv_bfloat16>
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, dt, B * H, Sq, D) ||
      !tensor_map(&tk, k, dt, B * Hkv, Sk, D) ||
      !tensor_map(&tv, v, dt, B * Hkv, Sk, D))
    return static_cast<int>(cudaErrorNotSupported);
  constexpr int bytes = wg_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Sq + kTile - 1) / kTile, static_cast<unsigned>(B) * H);
  flash_wgmma_kernel<T, D><<<grid, 128, bytes, s>>>(
      tq, tk, tv, static_cast<T*>(o), H, Hkv, Sq, Sk,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

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
// bfloat16 and float16 at D 64 and 128 run on the tensor cores (their
// pointers 16-byte aligned), the rest on the FMA design.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Sk, int D, int kind, int causal,
              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 ||
      static_cast<int64_t>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tensor_cores = (kind == rt::kBF16 || kind == rt::kF16) &&
                            (D == 64 || D == 128);
  if (tensor_cores) {
#define RT_WG(T, DD) \
  launch_wgmma<T, DD>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, s)
    if (kind == rt::kBF16)
      return D == 64 ? RT_WG(__nv_bfloat16, 64) : RT_WG(__nv_bfloat16, 128);
    return D == 64 ? RT_WG(__half, 64) : RT_WG(__half, 128);
#undef RT_WG
  }
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
