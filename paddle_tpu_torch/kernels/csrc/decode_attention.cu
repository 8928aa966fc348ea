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
// over the memory bandwidth.  At serving lengths the work is small (a few
// MB), so what holds the kernel is latency: the bytes it keeps in flight,
// the serial steps between a split's first load and its last store, and
// the shared-memory wavefronts each step costs.
//
// Design.  A TPU program walks a sequence's blocks in order; on Hopper the
// sequential walk becomes split-K, so enough CTAs stream at once:
//   pass 1, grid (Hk, B, splits): a CTA of DECODE_WARPS warps takes the
//     kSplitKeys keys of one split of one (batch row, kv-head).  It asks for
//     every 32-key tile of K and V of the split at once (up to
//     DECODE_RESIDENT_BYTES; the whole split up to D 128 in bf16): a whole
//     tile is one TMA box a 128-byte column span (tensor maps over the dense
//     cache or the pool; a pool tile after one block-table read), landing
//     128-byte swizzled, so that the lanes' 16-byte reads of 32 rows hit
//     distinct banks; a tile that ends at L (or crosses a pool block) is
//     copied row by row with cp.async into the same layout, so no position
//     >= L is ever loaded.  Each tile completes on its slot's mbarrier for
//     its route (one arrival with the bytes for TMA, one a thread for
//     cp.async: a barrier every thread arrives on serialises the arrivals);
//     where the split takes more than one round of tiles, a slot's two
//     barriers count their phases apart (the last, partial tile goes by
//     cp.async into a slot whose earlier tiles went by TMA).  Then three phases
//     with one __syncthreads between them, none a tile:
//       scores: a warp takes (2 tiles, 4 query rows), a lane a key of each,
//         so a K chunk is read once for the rows and a query chunk (a
//         broadcast, kept in bf16) once for the tiles; it starts once its
//         tiles land;
//       softmax statistics: a warp a query row, every tile at once; the
//         running max entering a tile is the max of the tiles' maxima
//         before it, and the tiles' sums share one butterfly;
//       p @ V: a thread 2 columns of 2 rows, the keys in order, 4
//         probabilities a load.
//     A broadcast shared-memory read moves 4 bytes a wavefront whatever its
//     width, so these shapes set the wavefronts the phases cost.
//     It writes the unnormalised acc and its (max, sum) to a workspace.
//   pass 2, grid (Hk, B, rep), a thread an output element: rescales the
//     splits of its row to a common max and normalises, with the Pallas
//     kernels' max(l, 1e-30) guard.
// The arithmetic is the one-tile-at-a-time online softmax of the Pallas
// kernels, in fp32, in one fixed order: a score is a dot product summed
// over D in order, then scaled; each 32-key tile moves the row's running
// max to max(m, its max), rescales the running sum and acc by exp(m_old -
// m_new) and adds its exp(s - m_new) (the sum by warp_sum's butterfly, acc
// key by key).  So a result does not depend on how the CTA's threads share
// the work.
// The trash block and stale tails are never read, so NaN there cannot reach
// the output; for paged pools the block table is read only for live
// positions (nothing at all when L == 0).  Masking uses the Pallas kernels'
// -1e30 constant.  No host sync, no allocation, and the shared-memory grant
// once a kernel: the launch can be captured in a CUDA graph.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// geometry: -D defines from _build.GEOMETRY
constexpr int kWarps = DECODE_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = DECODE_TILE;             // keys a tile = lanes of a warp
constexpr int kMaxRep = DECODE_MAX_REP;        // query rows a kv-head (H / Hk)
constexpr int kSplitKeys = DECODE_SPLIT_KEYS;  // keys a CTA of pass 1 (multiple of kTile)
constexpr int kSplitTiles = kSplitKeys / kTile;
constexpr int kRows = 4;                       // query rows a warp scores at once
constexpr int kScoreTiles = 2;                 // tiles a warp scores at once
constexpr int kPvRows = 2;                     // query rows a p @ V thread sums, 2 columns each
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "a tile's keys are the lanes of a warp");
static_assert(kSplitKeys % kTile == 0, "a split is whole tiles");
static_assert(kThreads == 8 * kTile, "eight threads copy each key row of a tile");
static_assert(kWarps >= kMaxRep, "a warp a query row for the softmax statistics");

template <typename T, int D>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;              // 16-byte chunks a row
  static constexpr int SW = kRowBytes >= 128 ? 128 : 64;      // TMA swizzle span, bytes
  static constexpr int E = SW / static_cast<int>(sizeof(T));  // its elements
  static constexpr int kTileBytes = kTile * kRowBytes;        // K or V of a tile
  // tiles resident at once: the whole split where its K and V fit
  static constexpr int kResident =
      2 * kTileBytes * kSplitTiles <= DECODE_RESIDENT_BYTES ? kSplitTiles
      : 2 * kTileBytes * 4 <= DECODE_RESIDENT_BYTES ? 4
      : 2 * kTileBytes * 2 <= DECODE_RESIDENT_BYTES ? 2 : 1;
  static constexpr int kKvBytes = 2 * kResident * kTileBytes;
  static constexpr int kQBytes = kMaxRep * kRowBytes;  // query rows, as given
  // scores then probabilities, each (row, tile)'s max, sum and rescale, each
  // row's running max and sum (fp32)
  static constexpr int kFloats = kMaxRep * kResident * kTile + 3 * kMaxRep * kResident +
                                 2 * kMaxRep;
  // 1024: alignment slack (TMA's swizzle follows the address bits)
  static constexpr int kBytes = 1024 + kKvBytes + kQBytes + kFloats * 4 + 2 * kResident * 8;
};

// byte offset of 16-byte chunk c of key row j in a K or V tile, as TMA lays
// it out: boxes of [kTile rows][SW bytes], the 16-byte units of each row
// XOR-swizzled by the address bits above the span
template <typename T, int D>
__device__ __forceinline__ int tile_offset(int j, int c) {
  using S = Smem<T, D>;
  constexpr int kPer = S::SW / 16;
  const int off = j * S::SW + (c % kPer) * 16;
  return (c / kPer) * (kTile * S::SW) + (off ^ (((off >> 7) & (S::SW == 128 ? 7 : 3)) << 4));
}

// two adjacent elements of a row in shared memory, as fp32, in one load
template <typename T>
__device__ __forceinline__ void column_pair(const unsigned char* p, float (&v)[2]);
template <>
__device__ __forceinline__ void column_pair<float>(const unsigned char* p, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x;
  v[1] = f.y;
}
template <>
__device__ __forceinline__ void column_pair<__nv_bfloat16>(const unsigned char* p,
                                                           float (&v)[2]) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(h);
  v[1] = __high2float(h);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
// an arrival on bar once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// element offset of key position p of (b, g)
template <bool PAGED>
__device__ __forceinline__ long long key_offset(const int* table, int b, int g, int p, int Hk,
                                                int cap, int maxb, int D) {
  if (PAGED) {
    const int phys = table[static_cast<size_t>(b) * maxb + p / cap];
    return ((static_cast<long long>(phys) * Hk + g) * cap + p % cap) * D;
  }
  return ((static_cast<long long>(b) * cap + p) * Hk + g) * D;
}

template <typename T>
struct PartialArgs {
  CUtensorMap kmap, vmap;  // the K and V caches or pools
  const T* q;
  const T* k;
  const T* v;
  const int* lengths;
  const int* table;
  float* ws;
  int H, Hk, cap, maxb, nsplit;
  float sm_scale;
};

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __grid_constant__ PartialArgs<T> a) {
  using S = Smem<T, D>;
  constexpr int R = S::kResident;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kRowElems = R * kTile;  // a row's scores
  constexpr int kItems = (D / 2 * (kMaxRep / kPvRows) + kThreads - 1) / kThreads;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int rep = a.H / a.Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {  // the tensor maps' descriptors, fetched while lengths[b] loads
    asm volatile("prefetch.tensormap [%0];" ::"l"(&a.kmap) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&a.vmap) : "memory");
  }
  const int capacity = PAGED ? a.maxb * a.cap : a.cap;
  int L = a.lengths[b];
  L = L < 0 ? 0 : (L > capacity ? capacity : L);
  const int begin = split * kSplitKeys;
  const int end = min(L, begin + kSplitKeys);
  if (begin >= end) return;  // uniform: the combine pass reads live splits only
  const int ntiles = (end - begin + kTile - 1) / kTile;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [R][K, V]
  T* q_s = reinterpret_cast<T*>(kv_s + S::kKvBytes);            // [kMaxRep][D]
  float* p_s = reinterpret_cast<float*>(kv_s + S::kKvBytes + S::kQBytes);  // [kMaxRep][R * kTile]
  float* tmax_s = p_s + kMaxRep * kRowElems;                    // [kMaxRep][R]
  float* tsum_s = tmax_s + kMaxRep * R;
  float* alpha_s = tsum_s + kMaxRep * R;
  float* m_s = alpha_s + kMaxRep * R;                           // [kMaxRep]
  float* l_s = m_s + kMaxRep;
  // a tile's barriers: one arrival with its bytes when it goes by TMA, one a
  // thread (once its copies land) when it goes by cp.async
  uint64_t* full = reinterpret_cast<uint64_t*>(l_s + kMaxRep);  // [R]
  uint64_t* copied = full + R;                                  // [R]

  auto keys = [&](int t) { return min(kTile, end - (begin + t * kTile)); };
  // a whole tile in one pool block (or in the dense cache) goes by TMA
  auto by_tma = [&](int t) { return keys(t) == kTile && (!PAGED || a.cap % kTile == 0); };
  // the copies of the round of tiles from t_lo; every thread arrives once
  // on each tile's barrier
  auto issue = [&](int t_lo) {
    const int nt = min(R, ntiles - t_lo);
    // lane t of warp 0 asks for tile t, all tiles at once
    if (warp == 0 && lane < nt && by_tma(t_lo + lane)) {
      const int t = lane;
      const int p = begin + (t_lo + t) * kTile;
      int c1 = g, c2 = p, c3 = b;               // dense: (column, head, position, batch)
      if (PAGED) {                              // pool: (column, slot, head, block)
        c1 = p % a.cap;
        c2 = g;
        c3 = a.table[static_cast<size_t>(b) * a.maxb + p / a.cap];
      }
      unsigned char* ks = kv_s + 2 * t * S::kTileBytes;
      bar_expect(&full[t], 2 * S::kTileBytes);
#pragma unroll
      for (int box = 0; box < S::kRowBytes / S::SW; ++box) {
        tma_load(ks + box * kTile * S::SW, &a.kmap, box * S::E, c1, c2, c3, &full[t]);
        tma_load(ks + S::kTileBytes + box * kTile * S::SW, &a.vmap, box * S::E, c1, c2, c3,
                 &full[t]);
      }
    }
    // the other tiles: eight threads a key row, 16-byte chunks apart by 8;
    // a row's offset from one block-table read, all read before a copy
    const int row = tid >> 3;
    long long off[R];
#pragma unroll
    for (int t = 0; t < R; ++t)
      off[t] = t < nt && !by_tma(t_lo + t) && row < keys(t_lo + t)
                   ? key_offset<PAGED>(a.table, b, g, begin + (t_lo + t) * kTile + row, a.Hk,
                                          a.cap, a.maxb, D)
                   : 0;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t >= nt) continue;
      if (by_tma(t_lo + t)) continue;
      if (row < keys(t_lo + t)) {
        const unsigned char* kg = reinterpret_cast<const unsigned char*>(a.k + off[t]);
        const unsigned char* vg = reinterpret_cast<const unsigned char*>(a.v + off[t]);
        unsigned char* ks = kv_s + 2 * t * S::kTileBytes;
        for (int c = tid & 7; c < S::kChunks; c += 8) {
          const int o = tile_offset<T, D>(row, c);
          cp_async16(ks + o, kg + c * 16);
          cp_async16(ks + S::kTileBytes + o, vg + c * 16);
        }
      }
      cp_async_arrive(&copied[t]);
    }
  };
  auto landed = [&](int t) { return by_tma(t) ? &full[t % R] : &copied[t % R]; };
  // the phase parity tile t waits on: its barrier has completed one phase
  // for each earlier tile of its slot that went the same way (a slot's tiles
  // may go by TMA in one round and by cp.async in a later one)
  auto parity_of = [&](int t) {
    int n = 0;
    for (int u = t % R; u < t; u += R) n += by_tma(u) == by_tma(t);
    return n & 1;
  };

  // the query rows, loaded while the barriers are set up and the first
  // round's copies go out
  constexpr int kQ = (kMaxRep * D + kThreads - 1) / kThreads;
  const T* qb = a.q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(g) * rep) * D;
  T qv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (tid + i * kThreads < rep * D) qv[i] = qb[tid + i * kThreads];
  if (tid == 0) {
    for (int t = 0; t < R; ++t) {
      bar_init(&full[t], 1);
      bar_init(&copied[t], kThreads);
    }
    bar_init_fence();
  }
  __syncthreads();
  issue(0);
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (tid + i * kThreads < rep * D) q_s[tid + i * kThreads] = qv[i];
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int row_groups = (rep + kRows - 1) / kRows;
  const int pv_groups = (rep + kPvRows - 1) / kPvRows;
  float acc[kItems][kPvRows][2] = {};
  for (int t_lo = 0; t_lo < ntiles; t_lo += R) {
    const int nt = min(R, ntiles - t_lo);  // tiles resident this round

    // scores: a job is (kScoreTiles tiles, kRows query rows), lane j scores
    // key j of each tile, so a K chunk is read and widened once for the rows
    // and a query chunk (a broadcast) once for the tiles; a tile past the
    // round or a row past rep repeats the last one and is dropped.  Each
    // tile's max follows from its lanes at once
    const int tile_groups = (nt + kScoreTiles - 1) / kScoreTiles;
    for (int job = warp; job < tile_groups * row_groups; job += kWarps) {
      const int t0 = job % tile_groups * kScoreTiles;
      const int r0 = job / tile_groups * kRows;
      const unsigned char* kt[kScoreTiles];
#pragma unroll
      for (int v = 0; v < kScoreTiles; ++v) {
        const int t = min(t0 + v, nt - 1);
        kt[v] = kv_s + 2 * t * S::kTileBytes;
        bar_wait(landed(t_lo + t), parity_of(t_lo + t));
      }
      const T* qr[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) qr[u] = q_s + min(r0 + u, rep - 1) * D;
      float s[kScoreTiles][kRows] = {};
#pragma unroll 2
      for (int ch = 0; ch < S::kChunks; ++ch) {
        float kf[kScoreTiles][VEC];
#pragma unroll
        for (int v = 0; v < kScoreTiles; ++v) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kt[v] + tile_offset<T, D>(lane, ch));
          const T* kvals = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[v][e] = to_float(kvals[e]);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const uint4 qraw = *reinterpret_cast<const uint4*>(qr[u] + ch * VEC);
          const T* qvals = reinterpret_cast<const T*>(&qraw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float qe = to_float(qvals[e]);
#pragma unroll
            for (int v = 0; v < kScoreTiles; ++v) s[v][u] += qe * kf[v][e];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kScoreTiles; ++v) {
        const int t = t0 + v;
        if (t >= nt) continue;
        const int n = keys(t_lo + t);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r0 + u < rep) {
            const float sc = s[v][u] * a.sm_scale;
            p_s[(r0 + u) * kRowElems + t * kTile + lane] = sc;
            const float mx = warp_max(lane < n ? sc : kNegInf);
            if (lane == 0) tmax_s[(r0 + u) * R + t] = mx;
          }
        }
      }
    }
    __syncthreads();

    // softmax statistics: a warp a query row, every tile of the round at
    // once; the running max entering tile t is the max of the maxima before
    if (warp < rep) {
      const int r = warp;
      float* pr = p_s + r * kRowElems;
      float m_in[R], m_out[R], p[R];
      float m = m_s[r];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        m_in[t] = m;
        if (t < nt) m = fmaxf(m, tmax_s[r * R + t]);
        m_out[t] = m;
      }
#pragma unroll
      for (int t = 0; t < R; ++t) {
        p[t] = t < nt && lane < keys(t_lo + t) ? expf(pr[t * kTile + lane] - m_out[t]) : 0.f;
        if (t < nt) pr[t * kTile + lane] = p[t];
      }
      const float psum = warp_sum_many<R>(p, lane);  // tile lane >> (5 - log2 R)'s sum
      constexpr int kShift = 5 - log2_pow2(R);
      if ((lane & ((1 << kShift) - 1)) == 0 && (lane >> kShift) < nt)
        tsum_s[r * R + (lane >> kShift)] = psum;
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < R; ++t)
          if (t < nt) alpha_s[r * R + t] = expf(m_in[t] - m_out[t]);
      }
    }
    __syncthreads();

    // p @ V: a thread two adjacent columns of kPvRows rows (a row past rep
    // repeats the last one and is dropped), the keys in order; eight keys'
    // loads go out before their products.  The swizzle of a row repeats
    // every 8 rows, so a thread's 8 offsets into a tile are fixed
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      if (item >= D / 2 * pv_groups) continue;
      const int d = item % (D / 2) * 2;
      const int r0 = item / (D / 2) * kPvRows;
      const int c = d * static_cast<int>(sizeof(T)) / 16;
      const int within = (d * static_cast<int>(sizeof(T))) % 16;
      int rowoff[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) rowoff[jj] = tile_offset<T, D>(jj, c) + within;
      const float* prow[kPvRows];
#pragma unroll
      for (int u = 0; u < kPvRows; ++u) prow[u] = p_s + min(r0 + u, rep - 1) * kRowElems;
      for (int t = 0; t < nt; ++t) {
#pragma unroll
        for (int u = 0; u < kPvRows; ++u) {
          const float alpha = alpha_s[min(r0 + u, rep - 1) * R + t];
          acc[i][u][0] *= alpha;
          acc[i][u][1] *= alpha;
        }
        const unsigned char* vt = kv_s + (2 * t + 1) * S::kTileBytes;
        const int n = keys(t_lo + t);
        if (n == kTile) {
#pragma unroll 2
          for (int j0 = 0; j0 < kTile; j0 += 8) {
            float v[8][2];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) column_pair<T>(vt + j0 * S::SW + rowoff[jj], v[jj]);
            float4 pa[kPvRows], pb[kPvRows];
#pragma unroll
            for (int u = 0; u < kPvRows; ++u) {
              pa[u] = *reinterpret_cast<const float4*>(prow[u] + t * kTile + j0);
              pb[u] = *reinterpret_cast<const float4*>(prow[u] + t * kTile + j0 + 4);
            }
#pragma unroll
            for (int u = 0; u < kPvRows; ++u) {
              const float p[8] = {pa[u].x, pa[u].y, pa[u].z, pa[u].w,
                                  pb[u].x, pb[u].y, pb[u].z, pb[u].w};
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                acc[i][u][0] += p[jj] * v[jj][0];
                acc[i][u][1] += p[jj] * v[jj][1];
              }
            }
          }
        } else {
          for (int j = 0; j < n; ++j) {
            float v[2];
            column_pair<T>(vt + tile_offset<T, D>(j, c) + within, v);
#pragma unroll
            for (int u = 0; u < kPvRows; ++u) {
              const float p = prow[u][t * kTile + j];
              acc[i][u][0] += p * v[0];
              acc[i][u][1] += p * v[1];
            }
          }
        }
      }
    }
    // each row's running max and sum past these tiles
    if (tid < rep) {
      float m = m_s[tid];
      float l = l_s[tid];
      for (int t = 0; t < nt; ++t) {
        const float alpha = alpha_s[tid * R + t];
        l = alpha * l + tsum_s[tid * R + t];
        m = fmaxf(m, tmax_s[tid * R + t]);
      }
      m_s[tid] = m;
      l_s[tid] = l;
    }
    __syncthreads();  // the next round's copies and statistics reuse the tiles
    if (t_lo + R < ntiles) issue(t_lo + R);
  }

  // workspace row of (b, g, split): acc [rep][D], then m [rep], then l [rep]
  float* w = a.ws + ((static_cast<size_t>(b) * a.Hk + g) * a.nsplit + split) * rep * (D + 2);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = tid + i * kThreads;
    if (item >= D / 2 * pv_groups) continue;
    const int d = item % (D / 2) * 2;
    const int r0 = item / (D / 2) * kPvRows;
#pragma unroll
    for (int u = 0; u < kPvRows; ++u) {
      if (r0 + u < rep) {
        w[(r0 + u) * D + d] = acc[i][u][0];
        w[(r0 + u) * D + d + 1] = acc[i][u][1];
      }
    }
  }
  if (tid < rep) {
    w[rep * D + tid] = m_s[tid];
    w[rep * D + rep + tid] = l_s[tid];
  }
}

// pass 2: a thread an output element (b, g, row blockIdx.z, column)
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                      T* __restrict__ out, int H, int Hk, int capacity, int nsplit) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int r = blockIdx.z;
  const int d = threadIdx.x;
  const int rep = H / Hk;
  int L = lengths[b];
  L = L < 0 ? 0 : (L > capacity ? capacity : L);
  const int live = (L + kSplitKeys - 1) / kSplitKeys;
  const size_t stride = static_cast<size_t>(rep) * (D + 2);
  const float* w0 = ws + (static_cast<size_t>(b) * Hk + g) * nsplit * stride;
  const float* ms = w0 + rep * D + r;
  float m = kNegInf;
  for (int s = 0; s < live; ++s) m = fmaxf(m, ms[s * stride]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += expf(ms[s * stride] - m) * ms[s * stride + rep];
  l = fmaxf(l, 1e-30f);
  float acc = 0.f;
  for (int s = 0; s < live; ++s) acc += expf(ms[s * stride] - m) * w0[s * stride + r * D + d];
  out[(static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep + r) * D + d] =
      from_float<T>(acc / l);
}

// The 4-D TMA map of a K or V operand, boxes of one 32-key tile by SW bytes
// of columns: the dense cache [B, C, Hk, D] as (column, head, position,
// batch), or the pool [NB, Hk, bs, D] as (column, slot, head, block)
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, bool paged, int lead, int cap, int Hk) {
  using S = Smem<T, D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t s = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(paged ? cap : Hk),
                              static_cast<cuuint64_t>(paged ? Hk : cap),
                              static_cast<cuuint64_t>(lead)};
  const cuuint64_t strides[3] = {dims[0] * s, dims[0] * dims[1] * s,
                                 dims[0] * dims[1] * dims[2] * s};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::E), paged ? kTile : 1u,
                             paged ? 1u : static_cast<cuuint32_t>(kTile), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        S::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <typename T, int D, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   const void* table, void* ws, void* out, int B, int H, int Hk,
                   int cap, int maxb, int lead, int nsplit, float sm_scale, cudaStream_t stream) {
  using S = Smem<T, D>;
  static bool configured = false;
  const cudaError_t granted =
      allow_smem(decode_partial_kernel<T, D, PAGED>, S::kBytes, configured);
  if (granted != cudaSuccess) return granted;
  const int capacity = PAGED ? maxb * cap : cap;
  if (static_cast<long long>(nsplit) * kSplitKeys < capacity) return cudaErrorInvalidValue;
  if (B > 0) {
    PartialArgs<T> a;
    a.q = static_cast<const T*>(q);
    a.k = static_cast<const T*>(k);
    a.v = static_cast<const T*>(v);
    a.lengths = static_cast<const int*>(lengths);
    a.table = static_cast<const int*>(table);
    a.ws = static_cast<float*>(ws);
    a.H = H, a.Hk = Hk, a.cap = cap, a.maxb = maxb, a.nsplit = nsplit;
    a.sm_scale = sm_scale;
    if (!make_map<T, D>(&a.kmap, k, PAGED, lead, cap, Hk) ||
        !make_map<T, D>(&a.vmap, v, PAGED, lead, cap, Hk))
      return cudaErrorInvalidValue;
    decode_partial_kernel<T, D, PAGED><<<dim3(Hk, B, nsplit), kThreads, S::kBytes, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_combine_kernel<T, D><<<dim3(Hk, B, H / Hk), D, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const int*>(lengths),
        static_cast<T*>(out), H, Hk, capacity, nsplit);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_paged(const void* q, const void* k, const void* v,
                           const void* lengths, const void* table, void* ws, void* out,
                           int B, int H, int Hk, int cap, int maxb, int lead, int paged,
                           int nsplit, float sm_scale, cudaStream_t stream) {
  if (paged)
    return launch<T, D, true>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb, lead,
                              nsplit, sm_scale, stream);
  return launch<T, D, false>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb, lead,
                             nsplit, sm_scale, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* lengths,
                       const void* table, void* ws, void* out, int B, int H, int Hk,
                       int D, int cap, int maxb, int lead, int paged, int nsplit,
                       float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32:   // the tiny hybrid SSD stack's attention layers
      return dispatch_paged<T, 32>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                                   lead, paged, nsplit, sm_scale, stream);
    case 64:
      return dispatch_paged<T, 64>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                                   lead, paged, nsplit, sm_scale, stream);
    case 128:
      return dispatch_paged<T, 128>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                                    lead, paged, nsplit, sm_scale, stream);
    case 256:
      return dispatch_paged<T, 256>(q, k, v, lengths, table, ws, out, B, H, Hk, cap, maxb,
                                    lead, paged, nsplit, sm_scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool PAGED>
int attributes(int kernel, int* out) {
  if (kernel == 0)
    return func_attributes(decode_partial_kernel<T, D, PAGED>, Smem<T, D>::kBytes, out);
  if (kernel == 1) return func_attributes(decode_combine_kernel<T, D>, 0, out);
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

// Dense (paged == 0): k, v are [B, cap, Hk, D] (lead = B), table is unused.
// Paged (paged == 1): k, v are [lead, Hk, cap, D] (cap = block size, lead =
// the pool's blocks) and table is [B, maxb] int32.  q and out are
// [B, 1, H, D]; lengths is [B] int32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, const void* table, void* ws,
                                       void* out, int B, int H, int Hk, int D, int cap,
                                       int maxb, int lead, int paged, int nsplit,
                                       float sm_scale, int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || H / Hk > kMaxRep || cap <= 0 || nsplit <= 0 || lead <= 0 ||
      (paged && maxb <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(q, k, v, lengths, table, ws, out, B, H, Hk, D, cap, maxb, lead,
                               paged, nsplit, sm_scale, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(q, k, v, lengths, table, ws, out, B, H, Hk, D, cap,
                                       maxb, lead, paged, nsplit, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
