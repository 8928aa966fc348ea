// Fused single-pass AdamW / Adam step for Hopper, over one flat fp32 leaf.
//
// Replaces the Pallas kernel paddle_tpu/kernels/adamw.py (_adamw_fused_call):
// p, m and v are updated in place (the Pallas kernel aliases them through
// input_output_aliases) and the optional model-dtype copy of the new p is
// written in the same pass.  The arithmetic is adamw_reference's, expression
// for expression, each operation rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction), so the kernel gives the bits
// of the plain PyTorch version, whose every operation is a separate kernel.
// The per-step scalars lr, c1 = 1 - beta1^t, c2 = 1 - beta2^t and
// decay = 1 - lr * wd come from the wrapper, computed once per step in fp32
// the way the reference computes them.
//
// Bound: bytes.  Per element it reads p, g, m, v and writes p, m, v (28 B),
// plus 2 B for a bf16 copy, against ~12 flops: far below the card's
// flop/byte balance, so the least time is bytes / bandwidth.
// Design: a grid-stride loop over 16-byte vectors (float4 of each of p, g,
// m, v), the in-place writes from the same registers, and a scalar tail
// (or a scalar loop when a pointer is not 16-byte aligned).
#include "common.cuh"

namespace {

// geometry: -D defines from _build.GEOMETRY
constexpr int kThreads = ADAMW_THREADS;
constexpr long long kMaxBlocks = ADAMW_MAX_BLOCKS;  // a few waves over the SMs

struct Scalars {
  float lr, c1, c2, decay;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd;
  int coupled;  // L2 decay added to the gradient (Adam with weight_decay)
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Scalars& s) {
  if (s.coupled) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  p = __fmul_rn(p, s.decay);
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v), __fmul_rn(s.one_minus_beta2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m, s.c1);
  const float v_hat = __fdiv_rn(v, s.c2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
}

struct alignas(8) Bf16x4 {
  __nv_bfloat16 x[4];
};

template <bool CAST, bool VEC>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, __nv_bfloat16* __restrict__ out, long long n, Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += stride) {
      float4 pp = reinterpret_cast<const float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, s);
      adam_one(pp.y, gg.y, mm.y, vv.y, s);
      adam_one(pp.z, gg.z, mm.z, vv.z, s);
      adam_one(pp.w, gg.w, mm.w, vv.w, s);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
      if (CAST) {
        Bf16x4 o;
        o.x[0] = __float2bfloat16_rn(pp.x);
        o.x[1] = __float2bfloat16_rn(pp.y);
        o.x[2] = __float2bfloat16_rn(pp.z);
        o.x[3] = __float2bfloat16_rn(pp.w);
        reinterpret_cast<Bf16x4*>(out)[i] = o;
      }
    }
    tail = n4 * 4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(pi, g[i], mi, vi, s);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
    if (CAST) out[i] = __float2bfloat16_rn(pi);
  }
}

template <bool CAST, bool VEC>
cudaError_t launch(void* p, const void* g, void* m, void* v, void* out, long long n,
                   const Scalars& s, cudaStream_t stream) {
  const long long work = VEC ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  if (blocks > 0)
    adamw_kernel<CAST, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<__nv_bfloat16*>(out), n, s);
  return cudaGetLastError();
}

}  // namespace

// kernel 0: adamw_kernel<a = bf16 copy, b = vectorised>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel != 0) return cudaErrorInvalidValue;
  if (a) return b ? func_attributes(adamw_kernel<true, true>, 0, out)
                  : func_attributes(adamw_kernel<true, false>, 0, out);
  return b ? func_attributes(adamw_kernel<false, true>, 0, out)
           : func_attributes(adamw_kernel<false, false>, 0, out);
}

// One leaf: p, g, m, v are n contiguous fp32 values; p, m, v are written in
// place.  out_dtype is -1 (no copy) or the bf16 code, then `out` receives n
// bf16 values of the new p.  vec = 1 when p, g, m, v (and out) are 16-byte
// aligned (8 for out).
extern "C" int adamw_launch(void* p, const void* g, void* m, void* v, void* out,
                            long long n, float lr, float c1, float c2, float decay,
                            float beta1, float one_minus_beta1, float beta2,
                            float one_minus_beta2, float eps, float wd, int coupled,
                            int out_dtype, int vec, void* stream) {
  if (n < 0 || (out_dtype != -1 && out_dtype != kBFloat16)) return cudaErrorInvalidValue;
  const Scalars s{lr, c1, c2, decay, beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                  wd, coupled};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cast = out_dtype == kBFloat16;
  if (cast)
    return vec ? launch<true, true>(p, g, m, v, out, n, s, st)
               : launch<true, false>(p, g, m, v, out, n, s, st);
  return vec ? launch<false, true>(p, g, m, v, out, n, s, st)
             : launch<false, false>(p, g, m, v, out, n, s, st);
}

DEFINE_ERROR_STRING
