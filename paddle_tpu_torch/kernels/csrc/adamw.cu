// Multi-tensor AdamW / Adam step for Hopper: one launch over a table of leaves.
//
// Replaces the Pallas kernel paddle_tpu/kernels/adamw.py (_adamw_fused_call),
// which the JAX optimizer calls once a leaf inside one XLA program: here the
// whole optimizer update of a step is ONE launch.  p, m and v are updated in
// place (the Pallas kernel aliases them through input_output_aliases) and the
// optional bf16 copy of the new p is written in the same pass.  The
// arithmetic is adamw_reference's, expression for expression, each operation
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA
// contraction), so the kernel gives the bits of the plain PyTorch version,
// whose every operation is a separate kernel.  The per-step scalars lr,
// c1 = 1 - beta1^t, c2 = 1 - beta2^t and decay = 1 - lr * wd come from the
// wrapper, computed once a step in fp32 the way the reference computes them.
//
// Bound: bytes.  Per element it reads p, g, m, v and writes p, m, v (28 B with
// an fp32 gradient, 26 with a bf16 one), plus 2 B for a bf16 copy, against
// ~12 flops: far below the card's flop/byte balance.  Each leaf's gradient is
// read in its own dtype, so a table mixing them (a bf16 model's fp32 MoE
// routers) moves no widened copy.
//
// Design (what holds a per-leaf launch back, and what this does about it):
// - The table of leaves (pointers, sizes, flags) rides in the kernel's
//   parameter space as a __grid_constant__ struct (CUDA 12.1+ allows 32 KB of
//   parameters on Hopper): no host-to-device copy a step.  A table holds up to
//   ADAMW_TABLE_CAP leaves; the wrapper takes ceil(leaves / cap) launches.
// - Every leaf is cut into chunks of ADAMW_CHUNK elements, numbered across the
//   table (the wrapper gives each leaf its first chunk); CTA c takes chunk c,
//   finding its leaf by a binary search over the leaves' first chunks.  A
//   2048-element norm leaf is one small CTA, not a launch with a tail wave of
//   its own.  One CTA a chunk, scheduled by the hardware, rather than a
//   persistent grid of a few CTAs an SM walking the chunks: the block
//   scheduler evens out the chunks' ragged ends and the CTAs' skew.
// - A chunk's body moves by 1-D TMA bulk copies through a ring of
//   ADAMW_STAGES shared-memory slots of ADAMW_STAGE values: thread 0 loads a
//   slot's p, g, m and v on its mbarrier, the CTA updates the slot in shared
//   memory, and thread 0 stores p, m and v (and the bf16 copy) back by bulk
//   copies, then refills the slot once those have read it.  A stream moves in
//   8 KB transfers and the threads spend no instructions on addresses; this
//   reads more of the bound than 16-byte loads and stores from registers.
// - Each leaf has its own vector flag and head: the elements before p's first
//   16-byte boundary run scalar in the leaf's first chunk, the ragged tail in
//   its last, and a leaf whose streams disagree on that boundary (bf16 ones:
//   on 16-byte alignment at the head) runs scalar alone, at no cost to the
//   rest of the table.  Chunk boundaries follow p's head only, so they stay
//   fixed while the gradients' pointers (and with them the vector flag)
//   change from step to step.
// - A leaf's gradient dtype (fp32 or bf16, widened exactly when read from
//   shared memory) is a flag of its own, branched on once a CTA: one launch
//   takes a table that mixes them.  A template on whether any leaf writes a
//   bf16 copy.
#include "common.cuh"
#include "hopper.cuh"

#include <string.h>

namespace {

// geometry: -D defines from _build.GEOMETRY
constexpr int kThreads = ADAMW_THREADS;
constexpr long long kChunk = ADAMW_CHUNK;    // elements a chunk
constexpr int kStage = ADAMW_STAGE;          // elements a ring slot
constexpr int kStages = ADAMW_STAGES;        // ring slots
constexpr int kCap = ADAMW_TABLE_CAP;        // leaves a launch
constexpr int kMinCtasPerSm = ADAMW_MIN_CTAS_PER_SM;  // resident CTAs the registers allow
static_assert(kStage % (4 * kThreads) == 0 && kChunk % kStage == 0,
              "a slot is whole float4 rounds of the CTA, a chunk whole slots");

// Leaf::flags
enum : int { kVec = 1, kCoupled = 2, kDecay = 4, kBf16Grad = 8, kHeadShift = 4 };

// One leaf of the table; mirrored by kernels/adamw.py::_Leaf (64 bytes).
struct Leaf {
  float* p;
  const void* g;             // bf16 where flags has kBf16Grad, else fp32
  float* m;
  float* v;
  __nv_bfloat16* out;        // the bf16 copy of the new p, or null
  long long n;
  int chunk0;                // the leaf's first chunk in the launch's numbering
  int flags;                 // kVec | kCoupled | kDecay | kBf16Grad | head << kHeadShift
  long long reserved;
};
static_assert(sizeof(Leaf) == 64, "kernels/adamw.py::_Leaf mirrors this layout");

struct Scalars {
  float lr, c1, c2, decay;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd;
};

struct Table {
  Scalars s;
  int count;                 // leaves
  int chunks;                // chunks over all leaves
  Leaf leaf[kCap];
};
static_assert(sizeof(Table) <= 32764, "a launch's parameters are at most 32764 bytes");

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Scalars& s, float decay, bool coupled) {
  if (coupled) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  p = __fmul_rn(p, decay);
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v), __fmul_rn(s.one_minus_beta2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m, s.c1);
  const float v_hat = __fdiv_rn(v, s.c2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
}

// four gradient values from a slot in shared memory (bf16 widened exactly)
__device__ __forceinline__ float4 smem_g4(const float* g) {
  return *reinterpret_cast<const float4*>(g);
}
__device__ __forceinline__ float4 smem_g4(const __nv_bfloat16* g) {
  const uint2 w = *reinterpret_cast<const uint2*>(g);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float load_g1(const float* g, long long i) { return g[i]; }
__device__ __forceinline__ float load_g1(const __nv_bfloat16* g, long long i) {
  return __bfloat162float(g[i]);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

template <typename G, bool CAST>
__device__ __forceinline__ void scalar_range(const Leaf& L, const Scalars& s, float decay,
                                             bool coupled, long long lo, long long hi) {
  const G* g = static_cast<const G*>(L.g);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    float pi = L.p[i], mi = L.m[i], vi = L.v[i];
    adam_one(pi, load_g1(g, i), mi, vi, s, decay, coupled);
    L.p[i] = pi;
    L.m[i] = mi;
    L.v[i] = vi;
    if (CAST && L.out != nullptr) L.out[i] = __float2bfloat16_rn(pi);
  }
}

// The ring's shared memory: kStages slots (p, m, v and the gradient as fp32
// arrays, a bf16 gradient in the first half of its array, the bf16 copy),
// then one mbarrier a slot.
struct __align__(128) Slot {
  float p[kStage], m[kStage], v[kStage], g[kStage];
  __nv_bfloat16 out[kStage];
};
constexpr int kSmem = kStages * static_cast<int>(sizeof(Slot)) + 128;

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// chunk k of leaf L, its gradient of type G
template <typename G, bool CAST>
__device__ __forceinline__ void adam_chunk(const Leaf& L, const Scalars& s, long long k,
                                           unsigned char* smem) {
  Slot* slots = reinterpret_cast<Slot*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * sizeof(Slot));
  const float decay = (L.flags & kDecay) ? s.decay : 1.0f;
  const bool coupled = (L.flags & kCoupled) != 0;
  const long long head = L.flags >> kHeadShift;
  const long long s0 = head + k * kChunk;
  const long long e0 = s0 + kChunk < L.n ? s0 + kChunk : L.n;
  const long long nb = (L.flags & kVec) && e0 > s0 ? (e0 - s0) / 8 * 8 : 0;
  const int nstage = static_cast<int>((nb + kStage - 1) / kStage);
  const bool out_on = CAST && L.out != nullptr;
  if (nstage > 0) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) bar_init(&full[i], 1);
      bar_init_fence();
    }
    __syncthreads();
    auto issue = [&](int j) {
      Slot& sl = slots[j % kStages];
      const long long off = s0 + static_cast<long long>(j) * kStage;
      const long long rem = nb - static_cast<long long>(j) * kStage;
      const unsigned len = static_cast<unsigned>(rem < kStage ? rem : kStage);
      bar_expect(&full[j % kStages], len * (12 + static_cast<unsigned>(sizeof(G))));
      bulk_load(sl.p, L.p + off, len * 4, &full[j % kStages]);
      bulk_load(sl.m, L.m + off, len * 4, &full[j % kStages]);
      bulk_load(sl.v, L.v + off, len * 4, &full[j % kStages]);
      bulk_load(sl.g, static_cast<const G*>(L.g) + off, len * sizeof(G), &full[j % kStages]);
    };
    if (threadIdx.x == 0)
      for (int j = 0; j < kStages && j < nstage; ++j) issue(j);
    for (int j = 0; j < nstage; ++j) {
      Slot& sl = slots[j % kStages];
      const long long off = s0 + static_cast<long long>(j) * kStage;
      const long long rem = nb - static_cast<long long>(j) * kStage;
      const int len = static_cast<int>(rem < kStage ? rem : kStage);
      bar_wait(&full[j % kStages], (j / kStages) & 1);
      for (int e = threadIdx.x * 4; e < len; e += kThreads * 4) {
        float4 pp = *reinterpret_cast<float4*>(sl.p + e);
        float4 mm = *reinterpret_cast<float4*>(sl.m + e);
        float4 vv = *reinterpret_cast<float4*>(sl.v + e);
        const float4 gg = smem_g4(reinterpret_cast<const G*>(sl.g) + e);
        adam_one(pp.x, gg.x, mm.x, vv.x, s, decay, coupled);
        adam_one(pp.y, gg.y, mm.y, vv.y, s, decay, coupled);
        adam_one(pp.z, gg.z, mm.z, vv.z, s, decay, coupled);
        adam_one(pp.w, gg.w, mm.w, vv.w, s, decay, coupled);
        *reinterpret_cast<float4*>(sl.p + e) = pp;
        *reinterpret_cast<float4*>(sl.m + e) = mm;
        *reinterpret_cast<float4*>(sl.v + e) = vv;
        if (out_on)
          *reinterpret_cast<uint2*>(sl.out + e) =
              make_uint2(pack_bf16(pp.x, pp.y), pack_bf16(pp.z, pp.w));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        bulk_store(L.p + off, sl.p, len * 4);
        bulk_store(L.m + off, sl.m, len * 4);
        bulk_store(L.v + off, sl.v, len * 4);
        if (out_on) bulk_store(L.out + off, sl.out, len * 2);
        bulk_commit();
        if (j + kStages < nstage) {
          bulk_wait_read();
          issue(j + kStages);
        }
      }
    }
    if (threadIdx.x == 0) bulk_wait_all();
  }
  if (k == 0) scalar_range<G, CAST>(L, s, decay, coupled, 0, head < L.n ? head : L.n);
  scalar_range<G, CAST>(L, s, decay, coupled, s0 + nb, e0);
}

template <bool CAST>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
adamw_multi_kernel(const __grid_constant__ Table t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  if (L.flags & kBf16Grad) adam_chunk<__nv_bfloat16, CAST>(L, t.s, c - L.chunk0, smem);
  else adam_chunk<float, CAST>(L, t.s, c - L.chunk0, smem);
}

template <bool CAST>
cudaError_t launch(const Table& t, cudaStream_t stream) {
  static bool granted = false;
  const cudaError_t e = allow_smem(adamw_multi_kernel<CAST>, kSmem, granted);
  if (e != cudaSuccess) return e;
  adamw_multi_kernel<CAST><<<t.chunks, kThreads, kSmem, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// kernel 0: adamw_multi_kernel<a = bf16 copies>; dtype, a gradient's code
// (fp32 or bf16), is checked only: one kernel takes both
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel != 0 || (dtype != kFloat32 && dtype != kBFloat16)) return cudaErrorInvalidValue;
  return a ? func_attributes(adamw_multi_kernel<true>, kSmem, out)
           : func_attributes(adamw_multi_kernel<false>, kSmem, out);
}

// The table's layout as compiled: out[3] = {sizeof(Leaf), leaves a launch,
// elements a chunk, threads a CTA}; the wrapper checks its mirror against it.
extern "C" int adamw_layout(int* out) {
  out[0] = static_cast<int>(sizeof(Leaf));
  out[1] = kCap;
  out[2] = static_cast<int>(kChunk);
  out[3] = kThreads;
  return cudaSuccess;
}

// One launch over `count` leaves (a host array of Leaf, at most kCap) whose
// chunks number `chunks`, a CTA each; each leaf's flags say its gradient's
// dtype.  cast = 1 when any leaf has a bf16 copy.
extern "C" int adamw_multi_launch(const void* leaves, int count, int chunks, float lr,
                                  float c1, float c2, float decay, float beta1,
                                  float one_minus_beta1, float beta2, float one_minus_beta2,
                                  float eps, float wd, int cast, void* stream) {
  if (count < 1 || count > kCap || chunks < 1) return cudaErrorInvalidValue;
  thread_local Table t;  // 30 KB, off the host stack; copied into the launch
  t.s = Scalars{lr, c1, c2, decay, beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd};
  t.count = count;
  t.chunks = chunks;
  memcpy(t.leaf, leaves, static_cast<size_t>(count) * sizeof(Leaf));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cast ? launch<true>(t, st) : launch<false>(t, st);
}

DEFINE_ERROR_STRING
