// The kernel gate's seeded defects, for Hopper: two kernels that are wrong
// on purpose, so that the gate (python -m paddle_tpu_torch.kernels.registry
// under KERNEL_GATE_INJECT) is proven able to fail.  They replace the
// seeded-defect Pallas kernels of paddle_tpu/kernels/registry.py:
//   injected_write_race_kernel     _build_injected_write_race (registry.py:152)
//   injected_parallel_carry_kernel _build_injected_parallel_carry (:176)
// Each computes what its TPU counterpart computes, defect included.  Neither
// runs on any path of the system but the gate's.
//
// injected_write_race_kernel: grid (rows / 8,); CTA i reads its 8 x 128
//   fp32 tile of x, doubles it and stores it to tile 0 of y.  A correct
//   kernel gives y = 2 x; this one races on tile 0 (which CTA stores last is
//   undefined) and never writes tiles 1.. (they keep whatever y held).
// injected_parallel_carry_kernel: grid (groups, tiles); CTA (g, i) adds its
//   8 x 128 tile of x[g] to the running sum of row g, kept in a global
//   8 x 128 accumulator (CTA i == 0 starts it from zero instead of reading
//   it), stores the sum and writes it back.  A correct kernel gives the
//   running sum over i; this one carries state across blockIdx.y, whose
//   CTAs run in no guaranteed order.  Tile i == 0 of each row is defined
//   (it reads no carried state); the others are not.
//
// Bound: bytes.  Each reads its input once and writes its output once
// (8 bytes an element) for one flop an element.
// Design: 256 threads a CTA, four fp32 elements (one float4) a thread.
#include "common.cuh"

namespace {

// geometry: -D defines from _build.GEOMETRY
constexpr int kTileRows = INJECTED_TILE_ROWS;
constexpr int kTileCols = INJECTED_TILE_COLS;
constexpr int kThreads = kTileRows * kTileCols / 4;   // one float4 a thread

__global__ void __launch_bounds__(kThreads)
injected_write_race_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  const float4 v = x[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x];
  // the seeded defect: every CTA stores to tile 0
  y[threadIdx.x] = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

__global__ void __launch_bounds__(kThreads)
injected_parallel_carry_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                               float4* __restrict__ acc, int tiles) {
  const int g = blockIdx.x;
  const int i = blockIdx.y;
  const size_t at = (static_cast<size_t>(g) * tiles + i) * kThreads + threadIdx.x;
  float4* a = acc + static_cast<size_t>(g) * kThreads + threadIdx.x;
  // the seeded defect: the carry crosses blockIdx.y, an unordered axis
  const float4 prev = i == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *a;
  const float4 v = x[at];
  const float4 s = make_float4(prev.x + v.x, prev.y + v.y, prev.z + v.z, prev.w + v.w);
  *a = s;
  y[at] = s;
}

}  // namespace

// x, y [rows, 128] fp32 contiguous, rows a multiple of 8
extern "C" int injected_write_race_launch(const void* x, void* y, int rows, void* stream) {
  if (rows <= 0 || rows % kTileRows) return cudaErrorInvalidValue;
  injected_write_race_kernel<<<rows / kTileRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y));
  return cudaGetLastError();
}

// x, y [groups, tiles * 8, 128] fp32 contiguous; acc [groups, 8, 128] fp32
extern "C" int injected_parallel_carry_launch(const void* x, void* y, void* acc, int groups,
                                              int tiles, void* stream) {
  if (groups <= 0 || tiles <= 0) return cudaErrorInvalidValue;
  injected_parallel_carry_kernel<<<dim3(groups, tiles), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), static_cast<float4*>(acc), tiles);
  return cudaGetLastError();
}

// kernel 0: injected_write_race_kernel, 1: injected_parallel_carry_kernel
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel == 0) return func_attributes(injected_write_race_kernel, 0, out);
  if (kernel == 1) return func_attributes(injected_parallel_carry_kernel, 0, out);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
