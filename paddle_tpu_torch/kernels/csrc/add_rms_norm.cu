// Residual add + RMSNorm, forward and backward, for Hopper; and the stock
// RMSNorm's backward.
//
// The fuse_add_rms_norm site of paddle_tpu/kernels/emit.py (its forward in
// _row_block_call, its backward in _single_block_call), the norm half of
// the fuse_rms_norm_head site's backward, and the backward of the stock
// RMSNorm (kernels/rms_norm.py, the port of _rms_bwd_rule in
// paddle_tpu/kernels/rms_norm.py, which the JAX package leaves to XLA):
//   forward   s = x + h;  normed = rms(s) * w, rounded to the activations'
//             dtype (_add_rms_norm_ref: the statistics in fp32, as _rms_rows)
//   backward  from the primals (x, h, w) and the cotangents (d_s, d_normed):
//             s recomputed; g = d_normed * w, s_hat = s * r (fp32);
//             ds = d_s + round(r (g - s_hat mean(g s_hat)));  dx = dh = ds,
//             stored once (autograd of x + h hands both inputs one gradient);
//             dw = sum over rows of d_normed * s_hat
// The norm's input gradient is rounded to the activations' dtype before the
// add, as torch's autograd of the plain reference rounds the gradient of the
// fp32 cast.  The head's backward and the stock RMSNorm's pass no h and no
// d_s: dx = round(...).  The stock RMSNorm's backward launches the same code
// under names of its own (rms_norm_bwd_*), so a profile tells it from the
// fusion sites' kernels.
//
// Bound: memory.  At `base` ([6144, 2048] bf16) the forward moves 100.7 MB
// (x, h read; s, normed written), the site's backward 125.8 MB (x, h, d_s,
// d_normed read; ds written once), the stock backward 75.5 MB (x, dy read,
// dx written), a few flops a byte.
//
// Forward: a CTA a row, 16-byte vector loads, the row swept twice (the
// second sweep from L1/L2), the sum of squares through warp shuffles and
// one shared step.
//
// Backward, add_rms_norm_bwd_ring_kernel, for rows of at most
// ARN_CONSUMER_WARPS x 32 x ARN_LANE_VECTORS 16-byte vectors whose ring of
// at least two row slots fits ARN_RING_BYTES (kernels/add_rms_norm.py::
// bwd_plan picks, the C side checks):
//  - a persistent grid of ARN_CTAS_PER_SM CTAs an SM (at most one a row);
//    CTA c of G takes the rows [c rows / G, (c + 1) rows / G) in order;
//  - a producer warp streams each row's tensors (x, [h], [d_s], d_normed)
//    into a ring of `slots` row slots in shared memory by cp.async.bulk (1-D
//    TMA, no tensor map) on full/empty mbarriers: every input byte is read
//    from DRAM once, and later rows are in flight while a row is reduced and
//    written;
//  - `teams` consumer teams of `warps` warps take the CTA's rows in turn
//    (team t the rows t, t + teams, ...); lane l of a team's warp p owns the
//    row's vectors (k warps + p) 32 + l, k < ARN_LANE_VECTORS, the same on
//    every row, so it loads its weights once (16-byte vectors) and sums its
//    dw columns in registers over all the CTA's rows; a row's two sums
//    (squares, g s) reduce by warp shuffles and, over a team's warps, one
//    named barrier (bar.sync 2 + team; two rows' slots of partials, so no
//    second barrier), never a CTA-wide one; dx goes out as 16-byte stores
//    from registers;
//  - at the end the teams' dw rows add in team order into the CTA's partial
//    row, and dw_reduce_kernel adds the CTAs' partial rows in CTA order: dw
//    is summed in a fixed order, the same bits run to run.
// Wider rows (to the forward's 4096 vectors) take add_rms_norm_bwd_kernel:
// a CTA a group of at most ceil(rows / ADD_RMS_NORM_GROUPS) rows, each row
// swept twice, the group's dw partial row in shared memory.
// A reduction plus an elementwise pass: Triton would serve too, but every
// kernel of the port builds with nvcc from one toolchain, so it is CUDA.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// -D defines, _build.GEOMETRY["add_rms_norm"]
constexpr int kGroups = ADD_RMS_NORM_GROUPS;         // most row groups of the wide backward
constexpr int kLaneVectors = ARN_LANE_VECTORS;       // 16-byte vectors of a row a lane owns
constexpr int kConsumerWarps = ARN_CONSUMER_WARPS;   // consumer warps of a ring CTA
constexpr int kMaxSlots = ARN_MAX_SLOTS;             // most row slots of the ring
constexpr int kRingBytes = ARN_RING_BYTES;           // most shared memory of the ring
constexpr int kCtasPerSm = ARN_CTAS_PER_SM;          // ring CTAs an SM (the grid's size)
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxRowVectors = 4096;                 // the forward's limit (kernels/rms_norm.py)

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

// ---------------------------------------------------------------------------
// the ring backward
// ---------------------------------------------------------------------------

// the weights of row vector i (its 16 / sizeof(T) columns) as fp32: 16-byte
// loads (two for fp32 weights under bf16 rows), or one 8-byte load of
// 2-byte weights under fp32 rows
template <typename T, typename W>
__device__ __forceinline__ void load_weights(const W* __restrict__ w, int i,
                                             float (&out)[Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  constexpr int kBytes = V * static_cast<int>(sizeof(W));
  if constexpr (kBytes >= 16) {
    constexpr int kLoads = kBytes / 16;
    const uint4* p = reinterpret_cast<const uint4*>(w) + static_cast<size_t>(i) * kLoads;
    uint4 raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) raw[k] = __ldg(p + k);
    const W* vals = reinterpret_cast<const W*>(raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_float(vals[j]);
  } else {
    static_assert(kBytes == 8, "an fp32 row's vector holds 4 two-byte weights");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(w) + i);
    const W* vals = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_float(vals[j]);
  }
}

// The ring backward over this CTA's rows (see the header); the launch has
// 32 (warps teams + 1) threads, the last warp the producer, and `slots` x
// (2 + kH + kDs) rows of dynamic shared memory.  dx and the CTA's partial
// dw row [d] are its outputs.
template <typename T, typename W, bool kH, bool kDs>
__device__ __forceinline__ void bwd_ring(const T* __restrict__ x, const T* __restrict__ h,
                                         const W* __restrict__ w, const T* __restrict__ d_s,
                                         const T* __restrict__ dn, T* __restrict__ dx,
                                         float* __restrict__ partial, int rows, int d,
                                         float eps, int warps, int teams, int slots) {
  constexpr int V = Vec<T>::N;
  constexpr int K = kLaneVectors;
  constexpr int NT = 2 + kH + kDs;   // a slot: a row of x, [h], [d_s], d_normed
  extern __shared__ __align__(16) unsigned char arn_ring[];
  __shared__ uint64_t full[kMaxSlots], empty[kMaxSlots];
  __shared__ float2 red[2 * kConsumerWarps];   // a row's (squares, g s) by warp, 2 rows a team
  const int nvec = d / V;
  const unsigned row_bytes = static_cast<unsigned>(d) * sizeof(T);
  const unsigned slot_bytes = NT * row_bytes;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows / gridDim.x;
  const int n = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * rows / gridDim.x - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int consumers = warps * teams;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 32 * warps);   // every thread of the team that read the slot
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == consumers) {   // the producer: one thread issues every copy
    if (lane == 0) {
      for (int j = 0; j < n; ++j) {
        const int s = j % slots, use = j / slots;
        if (use > 0) bar_wait(&empty[s], (use - 1) & 1);
        bar_expect(&full[s], slot_bytes);
        unsigned char* dst = arn_ring + s * slot_bytes;
        const long long off = (r0 + j) * d;
        bulk_load(dst, x + off, row_bytes, &full[s]);
        dst += row_bytes;
        if constexpr (kH) {
          bulk_load(dst, h + off, row_bytes, &full[s]);
          dst += row_bytes;
        }
        if constexpr (kDs) {
          bulk_load(dst, d_s + off, row_bytes, &full[s]);
          dst += row_bytes;
        }
        bulk_load(dst, dn + off, row_bytes, &full[s]);
      }
    }
    return;
  }

  const int team = warp / warps, sub = warp - team * warps;
  int vi[K];
  float wv[K][V], acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    vi[k] = (k * warps + sub) * 32 + lane;
    if (vi[k] < nvec) {
      load_weights<T, W>(w, vi[k], wv[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) wv[k][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  }

  int parity = 0;
  for (int j = team; j < n; j += teams) {
    const int s = j % slots;
    bar_wait(&full[s], (j / slots) & 1);
    const T* sx = reinterpret_cast<const T*>(arn_ring + s * slot_bytes);
    const T* sh = sx + d;                            // h (kH)
    const T* sds = sx + (1 + kH) * d;                // d_s (kDs)
    const T* sdn = sx + (NT - 1) * d;                // d_normed
    float sv[K][V];
    float ss = 0.f, gs = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (vi[k] >= nvec) continue;
      Vec<T> xv, g;
      xv.load(sx + vi[k] * V);
      if constexpr (kH) {
        Vec<T> hv;
        hv.load(sh + vi[k] * V);
#pragma unroll
        for (int e = 0; e < V; ++e) xv.f[e] = round_to<T>(xv.f[e] + hv.f[e]);
      }
      g.load(sdn + vi[k] * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sv[k][e] = xv.f[e];
        ss += xv.f[e] * xv.f[e];
        gs += g.f[e] * wv[k][e] * xv.f[e];
      }
    }
    ss = warp_sum(ss);
    gs = warp_sum(gs);
    if (warps > 1) {   // the team's warps, in warp order
      float2* rb = red + (parity * teams + team) * warps;
      if (lane == 0) rb[sub] = make_float2(ss, gs);
      named_sync(2 + team, 32 * warps);
      float2 t = make_float2(0.f, 0.f);
      for (int p = 0; p < warps; ++p) {
        const float2 q = rb[p];
        t.x += q.x;
        t.y += q.y;
      }
      ss = t.x;
      gs = t.y;
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mean = r * gs / static_cast<float>(d);   // mean(g s_hat)
    T* out = dx + (r0 + j) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (vi[k] >= nvec) continue;
      Vec<T> g, o;
      g.load(sdn + vi[k] * V);
      if constexpr (kDs) o.load(sds + vi[k] * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float s_hat = sv[k][e] * r;
        const float gw = g.f[e] * wv[k][e];
        const float part = round_to<T>(r * (gw - s_hat * mean));
        o.f[e] = kDs ? o.f[e] + part : part;
        acc[k][e] += g.f[e] * s_hat;
      }
      o.store(out + vi[k] * V);
    }
    bar_arrive(&empty[s]);
  }

  // the teams' dw rows, over the ring (every row has been read), then their
  // sum in team order
  named_sync(1, 32 * consumers);
  float* comb = reinterpret_cast<float*>(arn_ring);   // [teams][d]
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (vi[k] >= nvec) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) comb[team * d + vi[k] * V + e] = acc[k][e];
  }
  named_sync(1, 32 * consumers);
  float* prow = partial + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += 32 * consumers) {
    float t = 0.f;
    for (int tt = 0; tt < teams; ++tt) t += comb[tt * d + c];
    prow[c] = t;
  }
}

template <typename T, typename W, bool kH, bool kDs>
__global__ void __launch_bounds__(kRingThreads, kCtasPerSm)
add_rms_norm_bwd_ring_kernel(const T* __restrict__ x, const T* __restrict__ h,
                             const W* __restrict__ w, const T* __restrict__ d_s,
                             const T* __restrict__ dn, T* __restrict__ dx,
                             float* __restrict__ partial, int rows, int d, float eps, int warps,
                             int teams, int slots) {
  bwd_ring<T, W, kH, kDs>(x, h, w, d_s, dn, dx, partial, rows, d, eps, warps, teams, slots);
}

// the stock RMSNorm's backward: the norm-only ring under its own name (h
// and d_s null; the site kernel's parameters, so one launch takes either)
template <typename T, typename W>
__global__ void __launch_bounds__(kRingThreads, kCtasPerSm)
rms_norm_bwd_ring_kernel(const T* __restrict__ x, const T* __restrict__, const W* __restrict__ w,
                         const T* __restrict__, const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ partial, int rows, int d, float eps, int warps,
                         int teams, int slots) {
  bwd_ring<T, W, false, false>(x, nullptr, w, nullptr, dy, dx, partial, rows, d, eps, warps,
                               teams, slots);
}

// ---------------------------------------------------------------------------
// the wide backward and the dw sum
// ---------------------------------------------------------------------------

template <typename T, typename W>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ x, const T* __restrict__ h,
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

template <typename T, typename W>
__global__ void add_rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                        const W* __restrict__ w, const T* __restrict__ d_s,
                                        const T* __restrict__ dn, T* __restrict__ dx,
                                        float* __restrict__ partial,
                                        int rows, int d, int rows_per_group, float eps) {
  bwd_rows<T, W>(x, h, w, d_s, dn, dx, partial, rows, d, rows_per_group, eps);
}

template <typename T, typename W>
__global__ void rms_norm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__,
                                         const W* __restrict__ w, const T* __restrict__,
                                         const T* __restrict__ dy, T* __restrict__ dx,
                                         float* __restrict__ partial,
                                         int rows, int d, int rows_per_group, float eps) {
  bwd_rows<T, W>(x, nullptr, w, nullptr, dy, dx, partial, rows, d, rows_per_group, eps);
}

// dw[c] = sum over groups of partial[g, c], groups in order: 32 columns a
// block, 8 warps each summing every 8th group (four loads in flight, added
// in order), then the 8 in order
template <typename W>
__device__ __forceinline__ void dw_sum(const float* __restrict__ partial, W* __restrict__ dw,
                                       int groups, int d) {
  __shared__ float acc[8][33];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (c < d) {
    const float* p = partial + c;
    int g = wy;
    for (; g + 24 < groups; g += 32) {
      const float a0 = __ldg(p + static_cast<long long>(g) * d);
      const float a1 = __ldg(p + static_cast<long long>(g + 8) * d);
      const float a2 = __ldg(p + static_cast<long long>(g + 16) * d);
      const float a3 = __ldg(p + static_cast<long long>(g + 24) * d);
      t += a0;
      t += a1;
      t += a2;
      t += a3;
    }
    for (; g < groups; g += 8) t += __ldg(p + static_cast<long long>(g) * d);
  }
  acc[wy][lane] = t;
  __syncthreads();
  if (wy == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += acc[k][lane];
    dw[c] = from_float<W>(sum);
  }
}

template <typename W>
__global__ void dw_reduce_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                                 int groups, int d) {
  dw_sum<W>(partial, dw, groups, d);
}

template <typename W>
__global__ void rms_norm_bwd_dw_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                                       int groups, int d) {
  dw_sum<W>(partial, dw, groups, d);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

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

// rows a ring slot holds in `mode` (bit 0: h, bit 1: d_s): x, [h], [d_s], d_normed
constexpr int row_tensors(int mode) { return 2 + (mode & 1) + ((mode >> 1) & 1); }

template <typename T, typename W>
using RingKernel = void (*)(const T*, const T*, const W*, const T*, const T*, T*, float*, int,
                            int, float, int, int, int);

// the ring kernel of `mode` (bit 0: h, bit 1: d_s; 4: the stock RMSNorm's)
template <typename T, typename W>
RingKernel<T, W> ring_kernel(int mode) {
  switch (mode) {
    case 0: return add_rms_norm_bwd_ring_kernel<T, W, false, false>;
    case 1: return add_rms_norm_bwd_ring_kernel<T, W, true, false>;
    case 2: return add_rms_norm_bwd_ring_kernel<T, W, false, true>;
    case 3: return add_rms_norm_bwd_ring_kernel<T, W, true, true>;
    case 4: return rms_norm_bwd_ring_kernel<T, W>;
  }
  return nullptr;
}

template <typename T, typename W>
cudaError_t launch_ring(const void* x, const void* h, const void* w, const void* d_s,
                        const void* dn, void* dx, void* partial, int rows, int d, float eps,
                        int warps, int teams, int slots, int ctas, int mode,
                        cudaStream_t stream) {
  const int nvec = d / Vec<T>::N;
  const int smem = slots * row_tensors(mode & 3) * d * static_cast<int>(sizeof(T));
  if (warps < 1 || teams < 1 || warps * teams > kConsumerWarps ||
      nvec > 32 * kLaneVectors * warps || slots < 2 || slots < teams || slots > kMaxSlots ||
      smem > kRingBytes || ctas < 1 || ctas > rows)
    return cudaErrorInvalidValue;
  static bool granted[5] = {false, false, false, false, false};
  const RingKernel<T, W> kernel = ring_kernel<T, W>(mode);
  const cudaError_t err = allow_smem(kernel, kRingBytes, granted[mode]);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, 32 * (warps * teams + 1), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const W*>(w),
      static_cast<const T*>(d_s), static_cast<const T*>(dn), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, eps, warps, teams, slots);
  return cudaGetLastError();
}

// warps == 0: the wide kernel, row groups as ADD_RMS_NORM_GROUPS gives them;
// else the ring kernel at (warps, teams, slots) on `ctas` CTAs.  stock: the
// stock RMSNorm's kernels (no h, no d_s)
template <typename T, typename W>
cudaError_t bwd(const void* x, const void* h, const void* w, const void* d_s, const void* dn,
                void* dx, void* partial, void* dw, int rows, int d, float eps, int warps,
                int teams, int slots, int ctas, int stock, cudaStream_t stream) {
  if (d % Vec<T>::N != 0 || d / Vec<T>::N > kMaxRowVectors) return cudaErrorInvalidValue;
  if (stock && (h != nullptr || d_s != nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int groups = 0;
  if (rows > 0 && warps != 0) {
    const int mode = stock ? 4 : (h != nullptr) | (d_s != nullptr) << 1;
    err = launch_ring<T, W>(x, h, w, d_s, dn, dx, partial, rows, d, eps, warps, teams, slots,
                            ctas, mode, stream);
    if (err != cudaSuccess) return err;
    groups = ctas;
  } else if (rows > 0) {
    const int smem = d * static_cast<int>(sizeof(float));
    auto kernel = stock ? rms_norm_bwd_wide_kernel<T, W> : add_rms_norm_bwd_kernel<T, W>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
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
  auto reduce = stock ? rms_norm_bwd_dw_kernel<W> : dw_reduce_kernel<W>;
  reduce<<<(d + 31) / 32, 256, 0, stream>>>(static_cast<const float*>(partial),
                                            static_cast<W*>(dw), groups, d);
  return cudaGetLastError();
}

template <typename T, typename W>
int attributes(int kernel, int b, int c, int* out) {
  const int wide = b * static_cast<int>(sizeof(float));
  const int ring = (c >> 2) * row_tensors(c & 3) * b * static_cast<int>(sizeof(T));
  switch (kernel) {
    case 0: return func_attributes(add_rms_norm_fwd_kernel<T, W>, 0, out);
    case 1: return func_attributes(add_rms_norm_bwd_kernel<T, W>, wide, out);
    case 2: return func_attributes(dw_reduce_kernel<W>, 0, out);
    case 3: return func_attributes(ring_kernel<T, W>(c & 3), ring, out);
    case 4: return func_attributes(rms_norm_bwd_ring_kernel<T, W>, ring, out);
    case 5: return func_attributes(rms_norm_bwd_wide_kernel<T, W>, wide, out);
    case 6: return func_attributes(rms_norm_bwd_dw_kernel<W>, 0, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// every (rows, weight) pair the forwards take: fp32 or bf16 rows over an
// fp32, bf16 or fp16 weight
#define DISPATCH(FN, ...)                                                          \
  do {                                                                             \
    if (dtype == kFloat32 && w_dtype == kFloat32) return FN<float, float>(__VA_ARGS__); \
    if (dtype == kFloat32 && w_dtype == kBFloat16)                                 \
      return FN<float, __nv_bfloat16>(__VA_ARGS__);                                \
    if (dtype == kFloat32 && w_dtype == kFloat16) return FN<float, __half>(__VA_ARGS__); \
    if (dtype == kBFloat16 && w_dtype == kFloat32)                                 \
      return FN<__nv_bfloat16, float>(__VA_ARGS__);                                \
    if (dtype == kBFloat16 && w_dtype == kBFloat16)                                \
      return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                        \
    if (dtype == kBFloat16 && w_dtype == kFloat16)                                 \
      return FN<__nv_bfloat16, __half>(__VA_ARGS__);                               \
    return cudaErrorInvalidValue;                                                  \
  } while (0)

// <dtype, a = the weight's dtype>: kernel 0 add_rms_norm_fwd_kernel; 1
// add_rms_norm_bwd_kernel (b = d: its dynamic shared memory is a row of d
// floats); 2 dw_reduce_kernel; 3 add_rms_norm_bwd_ring_kernel and 4
// rms_norm_bwd_ring_kernel (b = d, c = 4 slots + mode, mode bit 0 h, bit 1
// d_s: the dynamic shared memory is slots rows of each tensor); 5
// rms_norm_bwd_wide_kernel (as 1); 6 rms_norm_bwd_dw_kernel
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  const int w_dtype = a;
  DISPATCH(attributes, kernel, b, c, out);
}

// s = x + h and normed = rms(s) * w; rows 16-byte aligned, d a multiple of 8
extern "C" int add_rms_norm_fwd_launch(const void* x, const void* h, const void* w, void* s,
                                       void* y, int rows, int d, float eps, int dtype,
                                       int w_dtype, void* stream) {
  DISPATCH(fwd, x, h, w, s, y, rows, d, eps, static_cast<cudaStream_t>(stream));
}

// dx (= dh when h is given) and dw; h and d_s may be null.  warps 0: the wide
// kernel, partial holds min(rows, ADD_RMS_NORM_GROUPS) x d floats of
// scratch; else the ring kernel at (warps a row, teams, slots) on ctas CTAs,
// partial ctas x d floats.  stock: the stock RMSNorm's backward (h and d_s
// null), under its own kernel names
extern "C" int add_rms_norm_bwd_launch(const void* x, const void* h, const void* w,
                                       const void* d_s, const void* dn, void* dx, void* partial,
                                       void* dw, int rows, int d, float eps, int dtype,
                                       int w_dtype, int warps, int teams, int slots, int ctas,
                                       int stock, void* stream) {
  DISPATCH(bwd, x, h, w, d_s, dn, dx, partial, dw, rows, d, eps, warps, teams, slots, ctas,
           stock, static_cast<cudaStream_t>(stream));
}

DEFINE_ERROR_STRING
