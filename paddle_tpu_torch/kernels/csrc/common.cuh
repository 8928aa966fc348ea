// Shared helpers of the hand-written kernels: dtype codes, fp32 conversion,
// warp reductions.  Dtype codes match kernels/_build.py::DTYPE_CODES.
// Activations are fp32 or bf16; float16 is read only as an RMSNorm weight.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
