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
// What holds such a kernel is the bytes it keeps in flight and the serial
// steps between a row's load and its store.  Two kernels, chosen by the
// launcher from (rows, D) (kernels/rms_norm.py::plan picks, the C side
// checks):
//   rms_norm_rows_kernel, for 384 rows or more of up to 16 KB: a CTA
//     a row of G groups of 32 16-byte vectors, G / RMS_LANE_VECTORS warps (G
//     rounded up to a power of two, at least RMS_LANE_VECTORS), each lane
//     RMS_LANE_VECTORS vectors, all loaded before the first use; a warp sums
//     its groups by shuffles at once, one __syncthreads joins the row's
//     warps.  Few registers a thread, so many rows stay in flight.
//   rms_norm_kernel: a CTA a row, a 16-byte vector a thread (up to 4), for a
//     few rows (the decode step's 8) or rows too wide for the row kernel.
// Both read the weight as 16-byte vectors (8 bf16 or 4 fp32 values a load;
// 8 bytes for a 2-byte weight under fp32 x), through the read-only cache,
// where every row finds it.
//
// Both sum a row's squares in one order, so their results are the same bits
// for every shape either takes: thread t of the CTA kernel takes vectors t,
// t + T, ..., its fp32 sum goes through warp_sum's xor butterfly, then the
// warps' partials, zero-padded to 32, through the butterfly again; in the row
// kernel the lane l that holds vector l + 32k (k = the CTA kernel's warp)
// sums it as thread l + 32k would, and the same two butterflies follow.
// y = (x * r) * w, rounded once to x's dtype, as the plain version computes.
#include "common.cuh"

namespace {

constexpr int kMaxVecPerThread = 4;
constexpr int kLaneVectors = RMS_LANE_VECTORS;  // 16-byte vectors a lane of the row kernel

// the VEC weights of x's 16-byte vector i, as fp32: 16-byte loads (two for an
// fp32 weight under bf16 x), or one 8-byte load of a 2-byte weight under
// fp32 x
template <typename W, int VEC>
__device__ __forceinline__ void load_weights(const W* __restrict__ w, int i, float (&out)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(W));
  if constexpr (kBytes >= 16) {
    constexpr int kLoads = kBytes / 16;
    const uint4* p = reinterpret_cast<const uint4*>(w) + static_cast<size_t>(i) * kLoads;
    uint4 raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) raw[k] = __ldg(p + k);
    const W* vals = reinterpret_cast<const W*>(raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_float(vals[j]);
  } else {
    static_assert(kBytes == 8, "an fp32 row's vector holds 4 two-byte weights");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(w) + i);
    const W* vals = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_float(vals[j]);
  }
}

// fp32 sum of the squares of one 16-byte vector, from 0 in element order
template <typename T>
__device__ __forceinline__ float vector_squares(const uint4& raw) {
  constexpr int VEC = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_float(v[j]);
    ss += f * f;
  }
  return ss;
}

// y's 16-byte vector i: (x * r) * w, rounded once
template <typename T, typename W>
__device__ __forceinline__ uint4 scaled(const uint4& raw, float r, const W* __restrict__ w, int i) {
  constexpr int VEC = 16 / sizeof(T);
  float wf[VEC];
  load_weights<W, VEC>(w, i, wf);
  const T* v = reinterpret_cast<const T*>(&raw);
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = from_float<T>(to_float(v[j]) * r * wf[j]);
  return packed;
}

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
    if (i < nvec) yr[i] = scaled<T, W>(cache[k], r, w, i);
  }
}

// A CTA a row of NV vector groups (group k: the 32 vectors 32k .. 32k + 31,
// one a lane, as the CTA kernel's warp k holds them): NV / kLaneVectors
// warps, warp p's lane l holding vectors l + 32k of groups k = p *
// kLaneVectors ...  Each group's sum goes through warp_sum's butterfly
// (warp_sum_many: a warp's groups at once), then the row's group sums, one a
// lane and zero past the last, through it again: the CTA kernel's order.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(32 * NV / kLaneVectors)
rms_norm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     T* __restrict__ y, int d, float eps) {
  static_assert(NV >= kLaneVectors && NV <= 32, "a row of kLaneVectors to 32 groups");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NL = kLaneVectors;
  const int nvec = d / VEC;
  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(blockIdx.x) * d);
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(blockIdx.x) * d);

  // every load of the row in flight before the first use; a lane past the
  // row's vectors loads the last one again and counts it nowhere
  uint4 cache[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) cache[k] = xr[min(lane + 32 * (part * NL + k), nvec - 1)];
  float sq[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const float ss = vector_squares<T>(cache[k]);
    sq[k] = lane + 32 * (part * NL + k) < nvec ? ss : 0.f;
  }
  __shared__ float sums[NV];
  const float g = warp_sum_many<NL>(sq, lane);  // group part * NL + (lane >> kShift)
  constexpr int kShift = 5 - log2_pow2(NL);
  if ((lane & ((1 << kShift) - 1)) == 0) sums[part * NL + (lane >> kShift)] = g;
  __syncthreads();
  const float r = rsqrtf(warp_sum(lane < NV ? sums[lane] : 0.f) / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int i = lane + 32 * (part * NL + k);
    if (i < nvec) yr[i] = scaled<T, W>(cache[k], r, w, i);
  }
}

template <typename T, typename W, int NV>
cudaError_t launch_rows(const void* x, const void* w, void* y, int rows, int d, float eps,
                        cudaStream_t stream) {
  rms_norm_rows_kernel<T, W, NV><<<rows, 32 * NV / kLaneVectors, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

// nv == 0: rms_norm_kernel; else rms_norm_rows_kernel with nv vectors a lane
template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, float eps, int nv,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  if (d % VEC != 0 || nvec > kMaxVecPerThread * 1024) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaGetLastError();
  if (nv != 0) {
    if (nvec > 32 * nv) return cudaErrorInvalidValue;
    switch (nv) {
      case 4: return launch_rows<T, W, 4>(x, w, y, rows, d, eps, stream);
      case 8: return launch_rows<T, W, 8>(x, w, y, rows, d, eps, stream);
      case 16: return launch_rows<T, W, 16>(x, w, y, rows, d, eps, stream);
      case 32: return launch_rows<T, W, 32>(x, w, y, rows, d, eps, stream);
    }
    return cudaErrorInvalidValue;
  }
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rms_norm_kernel<T, W><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(const void* x, const void* w, void* y, int rows, int d, float eps,
                       int w_dtype, int nv, cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch<T, float>(x, w, y, rows, d, eps, nv, stream);
    case kBFloat16: return launch<T, __nv_bfloat16>(x, w, y, rows, d, eps, nv, stream);
    case kFloat16: return launch<T, __half>(x, w, y, rows, d, eps, nv, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
int attributes(int kernel, int nv, int* out) {
  if (kernel == 0) return func_attributes(rms_norm_kernel<T, W>, 0, out);
  if (kernel != 1) return cudaErrorInvalidValue;
  switch (nv) {
    case 4: return func_attributes(rms_norm_rows_kernel<T, W, 4>, 0, out);
    case 8: return func_attributes(rms_norm_rows_kernel<T, W, 8>, 0, out);
    case 16: return func_attributes(rms_norm_rows_kernel<T, W, 16>, 0, out);
    case 32: return func_attributes(rms_norm_rows_kernel<T, W, 32>, 0, out);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes_w(int kernel, int w_dtype, int nv, int* out) {
  switch (w_dtype) {
    case kFloat32: return attributes<T, float>(kernel, nv, out);
    case kBFloat16: return attributes<T, __nv_bfloat16>(kernel, nv, out);
    case kFloat16: return attributes<T, __half>(kernel, nv, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// kernel 0: rms_norm_kernel<dtype, a = weight dtype>;
// kernel 1: rms_norm_rows_kernel<dtype, a = weight dtype, b = vectors a lane>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  switch (dtype) {
    case kFloat32: return attributes_w<float>(kernel, a, b, out);
    case kBFloat16: return attributes_w<__nv_bfloat16>(kernel, a, b, out);
  }
  return cudaErrorInvalidValue;
}

// nv: 0 for rms_norm_kernel, else rms_norm_rows_kernel with nv 16-byte
// vectors a lane (4, 8, 16 or 32); kernels/rms_norm.py::plan picks it
extern "C" int rms_norm_launch(const void* x, const void* w, void* y, int rows,
                               int d, float eps, int x_dtype, int w_dtype, int nv,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return dispatch_w<float>(x, w, y, rows, d, eps, w_dtype, nv, s);
    case kBFloat16: return dispatch_w<__nv_bfloat16>(x, w, y, rows, d, eps, w_dtype, nv, s);
  }
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
