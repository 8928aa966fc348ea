// Shared helpers of the hand-written kernels: dtype codes, fp32 conversion,
// warp reductions.  Dtype codes match kernels/_build.py::DTYPE_CODES.
// Activations are fp32 or bf16; float16 is only an RMSNorm weight (and its gradient).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

enum DtypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);   // round to nearest even, as torch's .to(float16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp_sum of N values a lane at once (N a power of two <= 32), each to
// warp_sum's bits: at each level of its xor butterfly a lane keeps half of
// the values it carries and sends the other half to its partner, whose sum
// of a value is the same bits (a + b == b + a), so N values take
// N + 4 - log2 N shuffles, not 5 N.  Lane l ends with the sum of value
// l >> (5 - log2 N).
template <int N>
__device__ __forceinline__ float warp_sum_many(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N is a power of two <= 32");
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int o = 16 >> level;
    const int c = N >> level;  // values a lane carries into this level
    if (c > 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < c / 2; ++i) {
        const float send = upper ? v[i] : v[i + c / 2];
        const float keep = upper ? v[i + c / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}
// log2 of a power of two up to 32, at compile time
__host__ __device__ constexpr int log2_pow2(int n) {
  return n >= 32 ? 5 : n >= 16 ? 4 : n >= 8 ? 3 : n >= 4 ? 2 : n >= 2 ? 1 : 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kernel_attributes of every library: cudaFuncGetAttributes of one kernel
// instantiation into out[4] = {static shared bytes, the dynamic shared bytes
// its launch requests, registers, local (spill) bytes}; the kernel gate
// holds a kernel's declared spec to these on the card.
template <typename K>
inline int func_attributes(K kernel, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = static_cast<int>(a.sharedSizeBytes);
  out[1] = dynamic_smem;
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

// Every library exports the runtime's message for the codes its launchers
// return, so the Python wrapper can raise with it.
#define DEFINE_ERROR_STRING                                   \
  extern "C" const char* error_string(int err) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
