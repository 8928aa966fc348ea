// Residual add + RMSNorm, forward and backward, for Hopper.
//
// The fuse_add_rms_norm site of paddle_tpu/kernels/emit.py (its forward in
// _row_block_call, its backward in _single_block_call), and the norm half of
// the fuse_rms_norm_head site's backward:
//   forward   s = x + h;  normed = rms(s) * w, rounded to the activations'
//             dtype (_add_rms_norm_ref: the statistics in fp32, as _rms_rows)
//   backward  from the primals (x, h, w) and the cotangents (d_s, d_normed):
//             s recomputed; g = d_normed * w, s_hat = s * r (fp32);
//             ds = d_s + round(r (g - s_hat mean(g s_hat)));  dx = dh = ds,
//             stored once (autograd of x + h hands both inputs one gradient);
//             dw = sum over rows of d_normed * s_hat
// The norm's input gradient is rounded to the activations' dtype before the
// add, as torch's autograd of the plain reference rounds the gradient of the
// fp32 cast.  The head's backward passes no h and no d_s: dx = round(...).
//
// dw is summed in a fixed two-stage order, so it is deterministic: the rows
// are cut into at most kGroups contiguous groups, one block each, which sums
// its rows into a shared-memory row of partials in row order; a second
// kernel adds the groups' partials column by column in group order.
//
// Bound: memory.  At `base` ([6144, 2048] bf16) the forward moves 100.7 MB
// (x, h read; s, normed written), the backward 125.8 MB (x, h, d_s,
// d_normed read; ds written once), a few flops a byte.
// Design: one block per row (forward) or per row group (backward), 16-byte
// vector loads; each row is swept twice, the second sweep re-reading the
// row from L1/L2 rather than holding it in registers, so any hidden size
// works with one kernel; the row statistics (sum of squares and, backward,
// sum of g s) reduce together through warp shuffles and one shared step.
// A reduction plus an elementwise pass: Triton would serve too, but every
// kernel of the port builds with nvcc from one toolchain, so it is CUDA.
#include "common.cuh"

namespace {

constexpr int kGroups = ADD_RMS_NORM_GROUPS;   // most row groups of the backward's dw (-D, _build.GEOMETRY)

template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
  float f[N];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_float(v[j]);
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4 u;
    T* v = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = from_float<T>(f[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// (a, b) summed over the block; every thread gets both totals
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) partial[warp] = make_float2(a, b);
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float2 t = lane < nwarps ? partial[lane] : make_float2(0.f, 0.f);
  t.x = warp_sum(t.x);
  t.y = warp_sum(t.y);
  __syncthreads();   // partial is reused by the next row
  return t;
}

// s = x + h rounded to T, vector i of a row
template <typename T>
__device__ __forceinline__ Vec<T> residual(const T* x, const T* h, long long off) {
  Vec<T> s;
  s.load(x + off);
  if (h != nullptr) {
    Vec<T> hv;
    hv.load(h + off);
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) s.f[j] = round_to<T>(s.f[j] + hv.f[j]);
  }
  return s;
}

template <typename T, typename W>
__global__ void add_rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                        const W* __restrict__ w, T* __restrict__ s_out,
                                        T* __restrict__ y, int d, float eps) {
  constexpr int V = Vec<T>::N;
  const int nvec = d / V;
  const long long row = static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Vec<T> s = residual(x, h, row + i * V);
    s.store(s_out + row + i * V);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += s.f[j] * s.f[j];
  }
  const float r = rsqrtf(block_sum2(ss, 0.f).x / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T> o = residual(x, h, row + i * V);
#pragma unroll
    for (int j = 0; j < V; ++j) o.f[j] = o.f[j] * r * to_float(w[i * V + j]);
    o.store(y + row + i * V);
  }
}

template <typename T, typename W>
__global__ void add_rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                        const W* __restrict__ w, const T* __restrict__ d_s,
                                        const T* __restrict__ dn, T* __restrict__ dx,
                                        float* __restrict__ partial,
                                        int rows, int d, int rows_per_group, float eps) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float dw_acc[];   // [d]: this group's partial dw
  const int nvec = d / V;
  for (int c = threadIdx.x; c < d; c += blockDim.x) dw_acc[c] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * rows_per_group;
  const int r1 = min(rows, r0 + rows_per_group);
  for (int rr = r0; rr < r1; ++rr) {
    const long long row = static_cast<long long>(rr) * d;
    float ss = 0.f, gs = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const Vec<T> s = residual(x, h, row + i * V);
      Vec<T> g;
      g.load(dn + row + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss += s.f[j] * s.f[j];
        gs += g.f[j] * to_float(w[i * V + j]) * s.f[j];
      }
    }
    const float2 tot = block_sum2(ss, gs);
    const float r = rsqrtf(tot.x / static_cast<float>(d) + eps);
    const float mean = r * tot.y / static_cast<float>(d);   // mean(g s_hat)
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const Vec<T> s = residual(x, h, row + i * V);
      Vec<T> g, o;
      g.load(dn + row + i * V);
      if (d_s != nullptr) o.load(d_s + row + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float sh = s.f[j] * r;
        const float gw = g.f[j] * to_float(w[i * V + j]);
        const float part = round_to<T>(r * (gw - sh * mean));
        o.f[j] = d_s != nullptr ? o.f[j] + part : part;
        dw_acc[i * V + j] += g.f[j] * sh;   // each column has one owner thread
      }
      o.store(dx + row + i * V);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * d + c] = dw_acc[c];
}

// dw[c] = sum over groups of partial[g, c], groups in order: 32 columns a
// block, 8 warps each summing every 8th group, then the 8 in order
template <typename W>
__global__ void dw_reduce_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                                 int groups, int d) {
  __shared__ float acc[8][33];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (c < d)
    for (int g = wy; g < groups; g += 8) t += partial[static_cast<long long>(g) * d + c];
  acc[wy][lane] = t;
  __syncthreads();
  if (wy == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += acc[k][lane];
    dw[c] = from_float<W>(sum);
  }
}

int threads_for(int nvec) {
  int t = (nvec + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename T, typename W>
cudaError_t fwd(const void* x, const void* h, const void* w, void* s, void* y, int rows, int d,
                float eps, cudaStream_t stream) {
  if (d % Vec<T>::N != 0) return cudaErrorInvalidValue;
  if (rows > 0)
    add_rms_norm_fwd_kernel<T, W><<<rows, threads_for(d / Vec<T>::N), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const W*>(w),
        static_cast<T*>(s), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t bwd(const void* x, const void* h, const void* w, const void* d_s, const void* dn,
                void* dx, void* partial, void* dw, int rows, int d, float eps,
                cudaStream_t stream) {
  if (d % Vec<T>::N != 0) return cudaErrorInvalidValue;
  const int smem = d * static_cast<int>(sizeof(float));
  auto kernel = add_rms_norm_bwd_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int groups = 0;
  if (rows > 0) {
    const int want = rows < kGroups ? rows : kGroups;
    const int per = (rows + want - 1) / want;
    groups = (rows + per - 1) / per;
    kernel<<<groups, threads_for(d / Vec<T>::N), smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const W*>(w),
        static_cast<const T*>(d_s), static_cast<const T*>(dn), static_cast<T*>(dx),
        static_cast<float*>(partial), rows, d, per, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dw_reduce_kernel<W><<<(d + 31) / 32, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                         static_cast<W*>(dw), groups, d);
  return cudaGetLastError();
}

template <typename T, typename W>
int attributes(int kernel, int d, int* out) {
  switch (kernel) {
    case 0: return func_attributes(add_rms_norm_fwd_kernel<T, W>, 0, out);
    case 1: return func_attributes(add_rms_norm_bwd_kernel<T, W>,
                                   d * static_cast<int>(sizeof(float)), out);
    case 2: return func_attributes(dw_reduce_kernel<W>, 0, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

#define DISPATCH(FN, ...)                                                          \
  do {                                                                             \
    if (dtype == kFloat32 && w_dtype == kFloat32) return FN<float, float>(__VA_ARGS__); \
    if (dtype == kBFloat16 && w_dtype == kFloat32)                                 \
      return FN<__nv_bfloat16, float>(__VA_ARGS__);                                \
    if (dtype == kBFloat16 && w_dtype == kBFloat16)                                \
      return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                        \
    return cudaErrorInvalidValue;                                                  \
  } while (0)

// kernel 0: add_rms_norm_fwd_kernel, 1: add_rms_norm_bwd_kernel (its dynamic
// shared memory is a row of b = d floats), 2: dw_reduce_kernel; <dtype,
// a = the weight's dtype>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  const int w_dtype = a;
  DISPATCH(attributes, kernel, b, out);
}

// s = x + h and normed = rms(s) * w; rows 16-byte aligned, d a multiple of 8
extern "C" int add_rms_norm_fwd_launch(const void* x, const void* h, const void* w, void* s,
                                       void* y, int rows, int d, float eps, int dtype,
                                       int w_dtype, void* stream) {
  DISPATCH(fwd, x, h, w, s, y, rows, d, eps, static_cast<cudaStream_t>(stream));
}

// dx (= dh when h is given) and dw; h and d_s may be null; partial holds
// min(rows, 512) x d floats of scratch
extern "C" int add_rms_norm_bwd_launch(const void* x, const void* h, const void* w,
                                       const void* d_s, const void* dn, void* dx, void* partial,
                                       void* dw, int rows, int d, float eps,
                                       int dtype, int w_dtype, void* stream) {
  DISPATCH(bwd, x, h, w, d_s, dn, dx, partial, dw, rows, d, eps,
           static_cast<cudaStream_t>(stream));
}

DEFINE_ERROR_STRING
