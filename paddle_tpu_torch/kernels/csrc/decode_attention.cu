// Single-token GQA decode attention for Hopper, over a dense or a paged cache.
//
// Replaces four Pallas kernels of paddle_tpu/kernels/decode_attention.py:
//   dense cache [B, C, Hk, D]:   _pallas_decode_fused, _pallas_decode
//   paged pools [NB, Hk, bs, D]: _pallas_paged_decode_fused, _pallas_paged_decode
// The TPU pairs (per-head vs fused heads, resident vs streamed) exist for
// VMEM and DMA limits; here one kernel, templated on the addressing, covers
// every case of both pairs.
//
// out[b, 0, g*rep + r, :] = softmax(q_r . K[:L] * sm_scale) @ V[:L]
// for the rep = H/Hk query rows of kv-head g, L = lengths[b] (clipped to the
// cache's capacity); L == 0 writes zeros.
//
// Bound: memory.  Each live key costs ~4*rep flops per K/V element read, far
// below the card's flop/byte balance, so the least time is
//   bytes = sum_b L_b * Hk * D * 2 * itemsize  (+ q and out)
// over the memory bandwidth.
//
// Design.  A TPU program walks a sequence's blocks in order; on Hopper the
// sequential walk becomes split-K, so enough CTAs stream at once:
//   pass 1, grid (Hk, B, splits): a CTA of 4 warps takes kSplitKeys keys of
//     one (batch row, kv-head) and keeps its rep query rows in shared memory
//     in fp32.  It walks its live keys 32 at a time; each K/V tile is staged
//     into shared memory with 16-byte cp.async copies, double-buffered so the
//     next tile's copy overlaps this tile's math.  Scores: one thread per
//     (row, key) dot product; softmax statistics: one warp per row, one lane
//     per key (fp32 running max and sum, exactly as the Pallas kernels carry
//     them); p @ V: threads split D.  It writes the unnormalised acc and its
//     (max, sum) to a workspace.
//   pass 2, grid (Hk, B): rescales the splits of each row to a common max
//     and normalises, with the Pallas kernels' max(l, 1e-30) guard.
// Positions >= L are never loaded, so NaN in a stale block tail or in the
// trash block cannot reach the output; for paged pools the block table is
// read only for live positions (nothing at all when L == 0).  Masking uses
// the Pallas kernels' -1e30 constant.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// geometry: -D defines from _build.GEOMETRY
constexpr int kTile = DECODE_TILE;            // keys per step = lanes of the softmax warp
constexpr int kMaxRep = DECODE_MAX_REP;        // query rows per kv-head (H / Hk)
constexpr int kSplitKeys = DECODE_SPLIT_KEYS;  // keys per CTA of pass 1 (multiple of kTile)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int D>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T)) + 16;  // +16: bank skew
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;    // 16-byte chunks a row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kKvBytes = 2 * 2 * kTileBytes;                     // 2 stages x (K, V)
  static constexpr int kBytes = kKvBytes + (kMaxRep * D + kMaxRep * kTile + 3 * kMaxRep) * 4;
};

// element offset of key position p of (b, g)
template <bool PAGED>
__device__ __forceinline__ long long key_offset(const int* table, int b, int g, int p,
                                                int Hk, int cap, int maxb, int D) {
  if (PAGED) {
    const int phys = table[static_cast<size_t>(b) * maxb + p / cap];
    return ((static_cast<long long>(phys) * Hk + g) * cap + p % cap) * D;
  }
  return ((static_cast<long long>(b) * cap + p) * Hk + g) * D;
}

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      const int* __restrict__ table, float* __restrict__ ws,
                      int H, int Hk, int cap, int maxb, int nsplit, float sm_scale) {
  using S = Smem<T, D>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DPT = D >= kThreads ? D / kThreads : 1;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int rep = H / Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int capacity = PAGED ? maxb * cap : cap;
  int L = lengths[b];
  L = L < 0 ? 0 : (L > capacity ? capacity : L);
  const int begin = split * kSplitKeys;
  const int end = min(L, begin + kSplitKeys);
  if (begin >= end) return;  // uniform: the combine pass reads live splits only

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem;
  float* q_s = reinterpret_cast<float*>(smem + S::kKvBytes);  // [kMaxRep][D]
  float* p_s = q_s + kMaxRep * D;                             // [kMaxRep][kTile]
  float* m_s = p_s + kMaxRep * kTile;
  float* l_s = m_s + kMaxRep;
  float* alpha_s = l_s + kMaxRep;

  auto issue_tile = [&](int t0, int stage) {
    const int n = min(kTile, end - t0);
    unsigned char* ks = kv_s + (2 * stage) * S::kTileBytes;
    unsigned char* vs = ks + S::kTileBytes;
    for (int c = tid; c < n * S::kChunks; c += kThreads) {
      const int j = c / S::kChunks;
      const int ch = c % S::kChunks;
      const long long off = key_offset<PAGED>(table, b, g, t0 + j, Hk, cap, maxb, D);
      cp_async16(ks + j * S::kRowBytes + ch * 16,
                 reinterpret_cast<const unsigned char*>(k + off) + ch * 16);
      cp_async16(vs + j * S::kRowBytes + ch * 16,
                 reinterpret_cast<const unsigned char*>(v + off) + ch * 16);
    }
    cp_async_commit();
  };

  issue_tile(begin, 0);
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_float(qb[i]);
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep][DPT] = {};
  const bool pv_thread = D >= kThreads || tid < D;

  const int ntiles = (end - begin + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = begin + t * kTile;
    const int n = min(kTile, end - t0);
    if (t + 1 < ntiles) {
      issue_tile(t0 + kTile, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ks = kv_s + (2 * (t & 1)) * S::kTileBytes;
    const unsigned char* vs = ks + S::kTileBytes;

    // 1. scores: one thread per (query row, live key)
    for (int idx = tid; idx < rep * kTile; idx += kThreads) {
      const int r = idx / kTile;
      const int j = idx % kTile;
      if (j < n) {
        const unsigned char* row = ks + j * S::kRowBytes;
        const float* qr = q_s + r * D;
        float s = 0.f;
#pragma unroll 4
        for (int ch = 0; ch < S::kChunks; ++ch) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + ch * 16);
          const T* kvals = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s += qr[ch * VEC + e] * to_float(kvals[e]);
        }
        p_s[r * kTile + j] = s * sm_scale;
      }
    }
    __syncthreads();

    // 2. online-softmax statistics, one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      const bool live = lane < n;
      const float s = live ? p_s[r * kTile + lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = live ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(pr);
      p_s[r * kTile + lane] = pr;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. rescale and accumulate p @ V over the live keys
    if (pv_thread) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float alpha = alpha_s[r];
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[r][i] *= alpha;
        }
      }
      for (int j = 0; j < n; ++j) {
        const T* vr = reinterpret_cast<const T*>(vs + j * S::kRowBytes);
        float vf[DPT];
#pragma unroll
        for (int i = 0; i < DPT; ++i) vf[i] = to_float(vr[tid + i * kThreads]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float pr = p_s[r * kTile + j];
#pragma unroll
            for (int i = 0; i < DPT; ++i) acc[r][i] += pr * vf[i];
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  // workspace row of (b, g, split): acc [rep][D], then m [rep], then l [rep]
  float* w = ws + ((static_cast<size_t>(b) * Hk + g) * nsplit + split) * rep * (D + 2);
  if (pv_thread) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) w[r * D + tid + i * kThreads] = acc[r][i];
      }
    }
  }
  if (tid < rep) {
    w[rep * D + tid] = m_s[tid];
    w[rep * D + rep + tid] = l_s[tid];
  }
}

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                      T* __restrict__ out, int H, int Hk, int capacity, int nsplit) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hk;
  int L = lengths[b];
  L = L < 0 ? 0 : (L > capacity ? capacity : L);
  const int live = (L + kSplitKeys - 1) / kSplitKeys;
  const float* w0 = ws + (static_cast<size_t>(b) * Hk + g) * nsplit * rep * (D + 2);
  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * D;
  const size_t stride = static_cast<size_t>(rep) * (D + 2);
  for (int r = 0; r < rep; ++r) {
    float m = kNegInf;
    for (int s = 0; s < live; ++s) m = fmaxf(m, w0[s * stride + rep * D + r]);
    float l = 0.f;
    for (int s = 0; s < live; ++s)
      l += expf(w0[s * stride + rep * D + r] - m) * w0[s * stride + rep * D + rep + r];
    l = fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float a = 0.f;
      for (int s = 0; s < live; ++s)
        a += expf(w0[s * stride + rep * D + r] - m) * w0[s * stride + r * D + d];
      ob[r * D + d] = from_float<T>(a / l);
    }
  }
}

template <typename T, int D, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   const void* table, void* ws, void* out, int B, int H, int Hk,
                   int cap, int maxb, int nsplit, float sm_scale, cudaStream_t stream) {
  using S = Smem<T, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T, D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int capacity = PAGED ? maxb * cap : cap;
  if (static_cast<long long>(nsplit) * kSplitKeys < capacity) return cudaErrorInvalidValue;
  if (B > 0) {
    decode_partial_kernel<T, D, PAGED><<<dim3(Hk, B, nsplit), kThreads, S::kBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(lengths), static_cast<const int*>(table),
        static_cast<float*>(ws), H, Hk, cap, maxb, nsplit, sm_scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_combine_kernel<T, D, PAGED><<<dim3(Hk, B), kThreads, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const int*>(lengths),
        static_cast<T*>(out), H, Hk, capacity, nsplit);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_paged(const void* q, const void* k, const void* v,
                           const void* lengths, const void* table, void* ws, void* out,
                           int B, int H, int Hk, int cap, int maxb, int paged, int nsplit,
                           float sm_scale, cudaStream_t stream) {
  if (paged)
    return launch<T, D, true>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                              nsplit, sm_scale, stream);
  return launch<T, D, false>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                             nsplit, sm_scale, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* lengths,
                       const void* table, void* ws, void* out, int B, int H, int Hk,
                       int D, int cap, int maxb, int paged, int nsplit, float sm_scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:   // the tiny hybrid SSD stack's attention layers
      return dispatch_paged<T, 32>(q, k, v, lengths, table, ws, out, B, H, Hk, cap,
                                   maxb, paged, nsplit, sm_scale, stream);
    case 64:
      return dispatch_paged<T, 64>(q, k, v, lengths, table, ws, out, B, H, Hk, cap,
                                   maxb, paged, nsplit, sm_scale, stream);
    case 128:
      return dispatch_paged<T, 128>(q, k, v, lengths, table, ws, out, B, H, Hk, cap,
                                    maxb, paged, nsplit, sm_scale, stream);
    case 256:
      return dispatch_paged<T, 256>(q, k, v, lengths, table, ws, out, B, H, Hk, cap,
                                    maxb, paged, nsplit, sm_scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool PAGED>
int attributes(int kernel, int* out) {
  if (kernel == 0)
    return func_attributes(decode_partial_kernel<T, D, PAGED>, Smem<T, D>::kBytes, out);
  if (kernel == 1) return func_attributes(decode_combine_kernel<T, D, PAGED>, 0, out);
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes_d(int kernel, int D, int paged, int* out) {
  switch (D) {
    case 32: return paged ? attributes<T, 32, true>(kernel, out) : attributes<T, 32, false>(kernel, out);
    case 64: return paged ? attributes<T, 64, true>(kernel, out) : attributes<T, 64, false>(kernel, out);
    case 128:
      return paged ? attributes<T, 128, true>(kernel, out) : attributes<T, 128, false>(kernel, out);
    case 256:
      return paged ? attributes<T, 256, true>(kernel, out) : attributes<T, 256, false>(kernel, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// kernel 0: decode_partial_kernel, 1: decode_combine_kernel; <dtype, a = D, b = paged>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  switch (dtype) {
    case kFloat32: return attributes_d<float>(kernel, a, b, out);
    case kBFloat16: return attributes_d<__nv_bfloat16>(kernel, a, b, out);
  }
  return cudaErrorInvalidValue;
}

// Keys per pass-1 CTA; the caller sizes the workspace from it:
// ws holds B * Hk * nsplit * rep * (D + 2) floats, nsplit = ceil(capacity / this).
extern "C" int decode_attention_split_keys() { return kSplitKeys; }

// Dense (paged == 0): k, v are [B, cap, Hk, D], table is unused.
// Paged (paged == 1): k, v are [NB, Hk, cap, D] (cap = block size) and
// table is [B, maxb] int32.  q and out are [B, 1, H, D]; lengths is [B] int32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, const void* table, void* ws,
                                       void* out, int B, int H, int Hk, int D, int cap,
                                       int maxb, int paged, int nsplit, float sm_scale,
                                       int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || H / Hk > kMaxRep || cap <= 0 || nsplit <= 0 ||
      (paged && maxb <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(q, k, v, lengths, table, ws, out, B, H, Hk, D, cap, maxb,
                               paged, nsplit, sm_scale, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(q, k, v, lengths, table, ws, out, B, H, Hk, D, cap,
                                       maxb, paged, nsplit, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
