// RMSNorm forward for Hopper.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rms_norm.py
// (_rms_norm_fwd_kernel_call): y = x * rsqrt(mean(x^2) + eps) * w, with the
// statistics in fp32 and y stored in x's dtype.
//
// Bound: memory.  The work is 3 flops per element against 2 * itemsize bytes
// (read x, write y), far below the card's ~295 flop/byte balance point, so
// the least time is bytes / bandwidth with
//   bytes = 2 * rows * D * itemsize(x) + D * itemsize(w).
// Design: one block per row; every thread loads its share of the row with
// 16-byte vector loads, keeps it in registers (up to 4 vectors a thread), so
// x is read from device memory exactly once; the fp32 sum of squares is
// reduced by warp shuffles and then across warps through shared memory; the
// second sweep scales the register copy and writes 16-byte vectors.  The
// weight (D elements, any float dtype) stays in L1/L2 across rows.
#include "common.cuh"

namespace {

constexpr int kMaxVecPerThread = 4;

template <typename T, typename W>
__global__ void __launch_bounds__(1024)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint4 cache[kMaxVecPerThread];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      cache[k] = xr[i];
      const T* v = reinterpret_cast<const T*>(&cache[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(v[j]);
        ss += f * f;
      }
    }
  }

  __shared__ float partial[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      const T* v = reinterpret_cast<const T*>(&cache[k]);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = from_float<T>(to_float(v[j]) * r * to_float(w[i * VEC + j]));
      yr[i] = packed;
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  if (d % VEC != 0 || nvec > kMaxVecPerThread * 1024) return cudaErrorInvalidValue;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  if (rows > 0)
    rms_norm_kernel<T, W><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
        d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(const void* x, const void* w, void* y, int rows, int d,
                       float eps, int w_dtype, cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch<T, float>(x, w, y, rows, d, eps, stream);
    case kBFloat16: return launch<T, __nv_bfloat16>(x, w, y, rows, d, eps, stream);
    case kFloat16: return launch<T, __half>(x, w, y, rows, d, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes_w(int w_dtype, int* out) {
  switch (w_dtype) {
    case kFloat32: return func_attributes(rms_norm_kernel<T, float>, 0, out);
    case kBFloat16: return func_attributes(rms_norm_kernel<T, __nv_bfloat16>, 0, out);
    case kFloat16: return func_attributes(rms_norm_kernel<T, __half>, 0, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// kernel 0: rms_norm_kernel<dtype, a = weight dtype>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32: return attributes_w<float>(a, out);
    case kBFloat16: return attributes_w<__nv_bfloat16>(a, out);
  }
  return cudaErrorInvalidValue;
}

extern "C" int rms_norm_launch(const void* x, const void* w, void* y, int rows,
                               int d, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return dispatch_w<float>(x, w, y, rows, d, eps, w_dtype, s);
    case kBFloat16: return dispatch_w<__nv_bfloat16>(x, w, y, rows, d, eps, w_dtype, s);
  }
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
