// Eq. 7 monotone D-bit codes: encode a float into its order-embedded
// unsigned code shifted to D bits, and decode a code back to its bucket's
// lowest float (the lowest bucket, which lands in NaN bit space, is -inf).
//
// Replaces src/repro/kernels/ocs_quant/ocs_quant.py::_encode_kernel and
// ::_decode_kernel.  Both are elementwise integer code: a few operations per
// element against 4-6 bytes moved, so on an H100 they are bound by memory
// (3.35 TB/s), and at the paper's widths (a few thousand elements) by the
// launch itself.  The design moves each byte once: every thread handles
// one 16-byte vector of the wider side where the pointers and the length
// allow it, and a scalar loop takes the tail.
#include "common.cuh"

namespace {

using rt::Encode;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// out[i] = f(in[i]); VEC elements per thread when `vec`, else one.
template <typename TIn, typename TOut, int VEC, typename F>
__global__ void elementwise(const TIn* __restrict__ in, TOut* __restrict__ out,
                            int64_t n, bool vec, F f) {
  int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    int64_t nv = n / VEC;
    const Vec<TIn, VEC>* vin = reinterpret_cast<const Vec<TIn, VEC>*>(in);
    Vec<TOut, VEC>* vout = reinterpret_cast<Vec<TOut, VEC>*>(out);
    for (int64_t i = tid; i < nv; i += stride) {
      Vec<TIn, VEC> a = vin[i];
      Vec<TOut, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = f(a.v[j]);
      vout[i] = o;
    }
    done = nv * VEC;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = f(in[i]);
}

template <typename TIn, typename TOut, int VEC, typename F>
int run(const void* in, void* out, int64_t n, F f, cudaStream_t stream) {
  bool vec = rt::aligned(in, sizeof(TIn) * VEC) &&
             rt::aligned(out, sizeof(TOut) * VEC);
  int64_t work = vec ? n / VEC + n % VEC : n;
  elementwise<TIn, TOut, VEC, F><<<rt::grid_for(work), rt::kThreads, 0,
                                   stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), n, vec, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n floats of in_bytes (4: float32; 2: bfloat16/float16) -> n codes of
// out_bytes (1: D <= 8; 2: D <= 16).
int ocs_encode(const void* x, void* out, int64_t n, int in_bytes,
               int out_bytes, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (in_bytes == 4) {
    int shift = 32 - bits;
    if (out_bytes == 1)
      return run<uint32_t, uint8_t, 4>(x, out, n, Encode<uint32_t, uint8_t>{shift}, s);
    return run<uint32_t, uint16_t, 4>(x, out, n, Encode<uint32_t, uint16_t>{shift}, s);
  }
  int shift = 16 - bits;
  if (out_bytes == 1)
    return run<uint16_t, uint8_t, 8>(x, out, n, Encode<uint16_t, uint8_t>{shift}, s);
  return run<uint16_t, uint16_t, 8>(x, out, n, Encode<uint16_t, uint16_t>{shift}, s);
}

// codes: n codes of code_bytes -> n floats of out_kind (rt::Kind).
int ocs_decode(const void* codes, void* out, int64_t n, int code_bytes,
               int out_kind, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (out_kind == rt::kF32) {
    if (code_bytes == 1)
      return run<uint8_t, uint32_t, 4>(
          codes, out, n, rt::decode_for<uint8_t, uint32_t>(out_kind, bits), s);
    return run<uint16_t, uint32_t, 4>(
        codes, out, n, rt::decode_for<uint16_t, uint32_t>(out_kind, bits), s);
  }
  if (code_bytes == 1)
    return run<uint8_t, uint16_t, 8>(
        codes, out, n, rt::decode_for<uint8_t, uint16_t>(out_kind, bits), s);
  return run<uint16_t, uint16_t, 8>(
      codes, out, n, rt::decode_for<uint16_t, uint16_t>(out_kind, bits), s);
}

}  // extern "C"
