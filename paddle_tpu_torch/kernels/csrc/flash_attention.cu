// Flash attention forward and backward for Hopper, over [B, S, H, D] read
// through strides, with grouped-query heads indexed natively.
//
// Replaces four Pallas kernels of paddle_tpu/kernels/flash_attention.py:
//   forward:  _flash_fwd_impl (K/V resident) and _flash_fwd_stream (K/V paged)
//   backward: _flash_bwd_impl (resident) and _flash_bwd_stream (paged)
// The resident/streamed split exists only for the TPU's VMEM; here every CTA
// walks its tiles through shared memory, so one kernel covers any length
// (S = 2048 at `base`, S = 16384 at `longctx`) with no change.
//
// Forward (flash_fwd_kernel): o = softmax(q k^T * scale) v with the online
// softmax in fp32, and lse = m + log(max(l, 1e-30)) fp32 [B, H, Sq].
// Backward, two passes as in _flash_bwd_impl, deterministic (no atomics):
//   dK/dV pass (flash_bwd_dkdv_kernel), one CTA per (batch, kv-head, k-tile),
//     loops over the H/Hk query heads of its group and over q-tiles from the
//     causal lower bound, so the group sum that jnp.repeat's transpose does in
//     the JAX package happens in the CTA's fp32 accumulators;
//   dQ pass (flash_bwd_dq_kernel), one CTA per (batch, head, q-tile), walks
//     k-tiles up to the causal diagonal.
// Both recompute p = exp(s - lse) in fp32; delta = sum(do * o) over D is a
// small torch op in the wrapper, computed before the passes.
//
// Causal masking follows the Pallas kernels: the diagonal is offset by
// Sk - Sq, masked scores are -1e30 and k-tiles past the diagonal (past
// _causal_hi) are skipped; in the dK/dV pass q-tiles before _causal_lo are.
// Ragged tiles are masked: keys at or past Sk weigh exactly 0, rows at or
// past Sq are neither stored nor counted.
//
// Bound: operations.  At `base` (B 3, S 2048, H 16, D 128, causal) the
// forward does 51.5 GFLOP against 76 MB of q/k/v/o, far above the card's
// ~295 flop/byte balance point; the backward about 2.5x the forward's
// operations.
// Design (first kernels, right before fast): tiles of BM x BM (64 for
// D <= 128, 32 for D = 256) are staged in shared memory; 256 threads as a
// 16 x 16 grid each own a TM x TM block of the score tile, where masking,
// the online softmax and the recompute from lse run in fp32, with row
// statistics reduced across the 16 threads of a row by shuffles.
//   fp32 inputs: every product is an fp32 FMA on CUDA cores over fp32 tiles
//     with a one-float skew (conflict-free column reads), so fp32 is true
//     fp32 (no TF32), and each thread also owns a TM x D/16 output block;
//   bf16 inputs: the tile products run on tensor cores (wmma 16x16x16, fp32
//     accumulators) over bf16 tiles; see the second half of this file.
// wgmma, TMA staging and overlapping loads with math are work for later.
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;       // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;   // the Pallas kernels' mask value

template <int D>
struct Tile {
  // rows of a q-tile and of a k-tile: -D defines from _build.GEOMETRY
  static constexpr int BM = D == 32 ? FLASH_TILE_ROWS_D32 : D == 64 ? FLASH_TILE_ROWS_D64
                          : D == 128 ? FLASH_TILE_ROWS_D128 : FLASH_TILE_ROWS_D256;
  static constexpr int TM = BM / 16;             // score rows (cols) a thread owns
  static constexpr int TD = D / 16;              // head-dim columns a thread owns
  static constexpr int LD = D + 1;               // row stride of a [BM, D] tile (skew)
  static constexpr int LS = BM + 1;              // row stride of a [BM, BM] tile
  static constexpr int kRows = BM * LD;          // floats of a [BM, D] tile
  static constexpr int kScores = BM * LS;        // floats of a [BM, BM] tile
  static constexpr int kFwdBytes = (3 * kRows + kScores) * 4;
  static constexpr int kDkdvBytes = (4 * kRows + 2 * kScores + 2 * BM) * 4;
  static constexpr int kDqBytes = (4 * kRows + kScores) * 4;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;          // forward: o [B, Sq, H, D]; backward: dq [B, Sq, H, D]
  void* dk;           // [B, Sk, Hk, D]
  void* dv;
  float* lse;         // [B, H, Sq]
  const float* delta; // [B, H, Sq]
  long long q_sb, q_ss, q_sh;   // element strides: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int B, H, Hk, Sq, Sk, causal;
  float scale;
};

// rows r0 .. r0+BM-1 of a [S, D] slab (row stride `rs` elements, rows
// 16-byte aligned) into a shared tile of U with row stride LDS; rows at or
// past `rows` read as 0.  Every thread issues all its 16-byte loads before
// its first store, so the tile's loads are in flight together.
template <typename T, typename U, int D, int LDS>
__device__ __forceinline__ void load_tile(U* dst, const T* src, long long rs, int r0,
                                          int rows) {
  constexpr int E = 16 / sizeof(T);                     // elements per 16 bytes
  constexpr int CPR = D / E;                            // 16-byte chunks a row
  constexpr int N = Tile<D>::BM * CPR / kThreads;       // chunks a thread
  static_assert(N >= 1 && Tile<D>::BM * CPR % kThreads == 0, "tile split");
  uint4 buf[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int r = r0 + c / CPR;
    buf[n] = r < rows ? *reinterpret_cast<const uint4*>(src + r * rs + (c % CPR) * E)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = threadIdx.x + n * kThreads;
    U* row = dst + (c / CPR) * LDS + (c % CPR) * E;
    if constexpr (std::is_same<T, U>::value && LDS * sizeof(U) % 16 == 0) {
      *reinterpret_cast<uint4*>(row) = buf[n];
    } else {                                            // a skewed or widened row
      const T* v = reinterpret_cast<const T*>(&buf[n]);
#pragma unroll
      for (int j = 0; j < E; ++j) row[j] = to_float(v[j]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int r0,
                                          int rows) {
  load_tile<T, float, D, Tile<D>::LD>(dst, src, rs, r0, rows);
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, both skewed [BM, D] tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[Tile<D>::TM][Tile<D>::TM],
                                         const float* A, const float* Bt, int ty, int tx) {
  using C = Tile<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TM; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[C::TM], b[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) a[i] = A[(ty + 16 * i) * C::LD + d];
#pragma unroll
    for (int j = 0; j < C::TM; ++j) b[j] = Bt[(tx + 16 * j) * C::LD + d];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TM; ++j) s[i][j] += a[i] * b[j];
  }
}

// max and sum across the 16 threads (tx = 0..15) that share a score row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// k-tiles a q-tile starting at q0 must visit (_causal_hi)
__device__ __forceinline__ int kv_tiles(int q0, int BM, const Params& p) {
  const int n_k = (p.Sk + BM - 1) / BM;
  if (!p.causal) return n_k;
  const int last = min(q0 + BM, p.Sq) - 1 + (p.Sk - p.Sq);  // last key its last row sees
  if (last < 0) return 0;
  return min(last / BM + 1, n_k);
}

// the scaled, masked score of (query row qr, key kc): -1e30 above the
// causal diagonal, -inf (weight exactly 0) past the keys
__device__ __forceinline__ float masked(float s, int qr, int kc, const Params& p) {
  if (kc >= p.Sk) return -INFINITY;
  s *= p.scale;
  if (p.causal && qr + (p.Sk - p.Sq) < kc) return kNegInf;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using C = Tile<D>;
  constexpr int BM = C::BM, TM = C::TM, TD = C::TD, LD = C::LD, LS = C::LS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + C::kRows;
  float* Vs = Ks + C::kRows;
  float* Ps = Vs + C::kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.Hk);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  load_rows<T, D>(Qs, q, p.q_ss, q0, p.Sq);
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  const int nkt = kv_tiles(q0, BM, p);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows<T, D>(Ks, k, p.k_ss, k0, p.Sk);
    load_rows<T, D>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();
    float s[TM][TM];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[i][j] = masked(s[i][j], qr, k0 + tx + 16 * j, p);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        Ps[(ty + 16 * i) * LS + tx + 16 * j] = s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BM; ++kk) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < TD; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Sq + qr) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] / l_safe);
    if (tx == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qr] = m[i] + logf(l_safe);
  }
}

// p and ds of one (q-tile, k-tile) pair, each thread its TM x TM block:
// s = q . k, dp = do . v; p = exp(masked(s) - lse), ds = p (dp - delta) scale
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    float (&pr)[Tile<D>::TM][Tile<D>::TM], float (&ds)[Tile<D>::TM][Tile<D>::TM],
    const float* Qs, const float* Ks, const float* dOs, const float* Vs,
    const float* lse_row, const float* delta_row, int q0, int k0, int ty, int tx,
    const Params& p) {
  using C = Tile<D>;
  tile_dot<D>(pr, Qs, Ks, ty, tx);
  tile_dot<D>(ds, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qr = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::TM; ++j) {
      const float pij = expf(masked(pr[i][j], qr, k0 + tx + 16 * j, p) - lse_row[i]);
      pr[i][j] = pij;
      ds[i][j] = pij * (ds[i][j] - delta_row[i]) * p.scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  using C = Tile<D>;
  constexpr int BM = C::BM, TM = C::TM, TD = C::TD, LD = C::LD, LS = C::LS;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::kRows;
  float* Qs = Vs + C::kRows;
  float* dOs = Qs + C::kRows;
  float* Ps = dOs + C::kRows;
  float* dSs = Ps + C::kScores;
  float* lse_s = dSs + C::kScores;
  float* delta_s = lse_s + BM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.Hk;
  const int g = blockIdx.y % p.Hk;
  const int rep = p.H / p.Hk;
  const int off = p.Sk - p.Sq;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  load_rows<T, D>(Ks, k, p.k_ss, k0, p.Sk);
  load_rows<T, D>(Vs, v, p.v_ss, k0, p.Sk);

  // key rows ty + 16 a, head-dim columns tx + 16 c
  float dk[TM][TD], dv[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk[a][c] = dv[a][c] = 0.f;

  const int n_q = (p.Sq + BM - 1) / BM;
  const int lo = p.causal ? max(k0 - off, 0) / BM : 0;  // _causal_lo
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = lo; qt < n_q; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the previous q-tile's Q, dO, P and dS are consumed
      load_rows<T, D>(Qs, q, p.q_ss, q0, p.Sq);
      load_rows<T, D>(dOs, dout, p.do_ss, q0, p.Sq);
      for (int i = tid; i < BM; i += kThreads) {
        const bool live = q0 + i < p.Sq;
        lse_s[i] = live ? lse[q0 + i] : INFINITY;  // rows past Sq weigh 0
        delta_s[i] = live ? delta[q0 + i] : 0.f;
      }
      __syncthreads();
      float lse_row[TM], delta_row[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        lse_row[i] = lse_s[ty + 16 * i];
        delta_row[i] = delta_s[ty + 16 * i];
      }
      float pr[TM][TM], ds[TM][TM];
      probs_and_dscores<D>(pr, ds, Qs, Ks, dOs, Vs, lse_row, delta_row, q0, k0, ty, tx, p);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          Ps[(ty + 16 * i) * LS + tx + 16 * j] = pr[i][j];
          dSs[(ty + 16 * i) * LS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 2
      for (int ii = 0; ii < BM; ++ii) {
        float pa[TM], da[TM], dov[TD], qv[TD];
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          pa[a] = Ps[ii * LS + ty + 16 * a];
          da[a] = dSs[ii * LS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          dov[c] = dOs[ii * LD + tx + 16 * c];
          qv[c] = Qs[ii * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            dv[a][c] += pa[a] * dov[c];
            dk[a][c] += da[a] * qv[c];
          }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int kr = k0 + ty + 16 * a;
    if (kr >= p.Sk) continue;
    const long long row = ((static_cast<long long>(b) * p.Sk + kr) * p.Hk + g) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      dkp[row + tx + 16 * c] = from_float<T>(dk[a][c]);
      dvp[row + tx + 16 * c] = from_float<T>(dv[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  using C = Tile<D>;
  constexpr int BM = C::BM, TM = C::TM, TD = C::TD, LD = C::LD, LS = C::LS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kRows;
  float* Ks = dOs + C::kRows;
  float* Vs = Ks + C::kRows;
  float* dSs = Vs + C::kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.Hk);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
  load_rows<T, D>(Qs, q, p.q_ss, q0, p.Sq);
  load_rows<T, D>(dOs, dout, p.do_ss, q0, p.Sq);
  float lse_row[TM], delta_row[TM], dq[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    lse_row[i] = qr < p.Sq ? lse[qr] : INFINITY;
    delta_row[i] = qr < p.Sq ? delta[qr] : 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) dq[i][c] = 0.f;
  }

  const int nkt = kv_tiles(q0, BM, p);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows<T, D>(Ks, k, p.k_ss, k0, p.Sk);
    load_rows<T, D>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();
    float pr[TM][TM], ds[TM][TM];
    probs_and_dscores<D>(pr, ds, Qs, Ks, dOs, Vs, lse_row, delta_row, q0, k0, ty, tx, p);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) dSs[(ty + 16 * i) * LS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int jj = 0; jj < BM; ++jj) {
      float dsv[TM], kv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = dSs[(ty + 16 * i) * LS + jj];
#pragma unroll
      for (int c = 0; c < TD; ++c) kv[c] = Ks[jj * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) dq[i][c] += dsv[i] * kv[c];
    }
  }

  T* dqp = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Sq) continue;
    T* row = dqp + ((static_cast<long long>(b) * p.Sq + qr) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) row[tx + 16 * c] = from_float<T>(dq[i][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same kernels with the tile products on tensor cores (wmma
// 16x16x16, bf16 inputs, fp32 accumulators).  Tiles are kept in shared
// memory as bf16; the score tiles land in fp32 shared memory, where the
// 16 x 16 thread grid runs the same masking, online softmax and
// recompute-from-lse arithmetic as above.  P and dS, computed in fp32, enter
// the products that consume them (P.V, P^T.dO, dS^T.Q, dS.K) as two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi), so they keep ~16 mantissa bits
// where one bf16 would keep 8 (one rounding of P moved outputs near 0 by
// 2 bf16 ulps of V's scale); the inputs are bf16 already, so each product
// is then as exact as the fp32 plain version's up to the sum order.  The
// backward's dK, dV and dQ accumulate across the loop in each warp's
// fragments.
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

template <int D>
struct TileTC {
  static constexpr int BM = Tile<D>::BM;
  static constexpr int TM = BM / 16;
  static constexpr int TD = D / 16;
  static constexpr int LH = D + 8;        // bf16 row stride of a [BM, D] tile
  static constexpr int LSF = BM + 4;      // fp32 row stride of a [BM, BM] tile
  static constexpr int LSH = BM + 8;      // bf16 row stride of a [BM, BM] tile
  static constexpr int LOF = D + 4;       // fp32 row stride of a [BM, D] tile
  static constexpr int kRowsH = BM * LH * 2;    // bytes; every size is a multiple of
  static constexpr int kScoresF = BM * LSF * 4; // 32, so each region stays aligned
  static constexpr int kScoresH = BM * LSH * 2; // for wmma's 256-bit loads
  static constexpr int kOutF = BM * LOF * 4;
  static constexpr int kFwdBytes = 3 * kRowsH + kScoresF + 2 * kScoresH + kOutF;
  static constexpr int kDkdvBytes = 4 * kRowsH + 2 * kScoresF + 4 * kScoresH + kOutF + 2 * BM * 4;
  static constexpr int kDqBytes = 4 * kRowsH + 2 * kScoresF + 2 * kScoresH + kOutF;
  static constexpr int kFragsScore = TM * TM;      // 16 x 16 fragments of a score tile
  static constexpr int kFragsOut = TM * TD;        // ... of a [BM, D] tile
  static constexpr int kOutPerWarp = (kFragsOut + kWarps - 1) / kWarps;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
__device__ __forceinline__ void load_rows_h(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long rs, int r0, int rows) {
  load_tile<__nv_bfloat16, __nv_bfloat16, D, TileTC<D>::LH>(dst, src, rs, r0, rows);
}

// S[BM, BM] = A[BM, D] . B[BM, D]^T, both padded bf16 tiles, into fp32 `out`
template <int D>
__device__ __forceinline__ void mma_abt(float* out, const __nv_bfloat16* A,
                                        const __nv_bfloat16* Bm, int warp) {
  using C = TileTC<D>;
  for (int f = warp; f < C::kFragsScore; f += kWarps) {
    const int fm = f / C::TM, fn = f % C::TM;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < C::TD; ++kk) {
      FragA a;
      FragBt b;
      wmma::load_matrix_sync(a, A + fm * 16 * C::LH + kk * 16, C::LH);
      wmma::load_matrix_sync(b, Bm + fn * 16 * C::LH + kk * 16, C::LH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + fm * 16 * C::LSF + fn * 16, acc, C::LSF, wmma::mem_row_major);
  }
}

// acc[f] += X . Y for this warp's fragments f of a [BM, D] output, X a
// [BM, BM] score tile held as bf16 hi and lo tiles (transposed when XT), Y a
// [BM, D] bf16 tile
template <int D, bool XT>
__device__ __forceinline__ void mma_xy(FragC (&acc)[TileTC<D>::kOutPerWarp],
                                       const __nv_bfloat16* X, const __nv_bfloat16* Xlo,
                                       const __nv_bfloat16* Y, int warp) {
  using C = TileTC<D>;
#pragma unroll
  for (int t = 0; t < C::kOutPerWarp; ++t) {
    const int f = warp + t * kWarps;
    if (f >= C::kFragsOut) break;
    const int fm = f / C::TD, fn = f % C::TD;
#pragma unroll
    for (int kk = 0; kk < C::TM; ++kk) {
      FragB y;
      wmma::load_matrix_sync(y, Y + kk * 16 * C::LH + fn * 16, C::LH);
      if (XT) {
        // X^T[fm, kk] = X[kk, fm] read column-major
        const int at = kk * 16 * C::LSH + fm * 16;
        FragAt x;
        wmma::load_matrix_sync(x, X + at, C::LSH);
        wmma::mma_sync(acc[t], x, y, acc[t]);
        wmma::load_matrix_sync(x, Xlo + at, C::LSH);
        wmma::mma_sync(acc[t], x, y, acc[t]);
      } else {
        const int at = fm * 16 * C::LSH + kk * 16;
        FragA x;
        wmma::load_matrix_sync(x, X + at, C::LSH);
        wmma::mma_sync(acc[t], x, y, acc[t]);
        wmma::load_matrix_sync(x, Xlo + at, C::LSH);
        wmma::mma_sync(acc[t], x, y, acc[t]);
      }
    }
  }
}

// x as the bf16 pair hi + lo at `at` of two score tiles
__device__ __forceinline__ void split_store(__nv_bfloat16* hi, __nv_bfloat16* lo, int at,
                                            float x) {
  const __nv_bfloat16 h = __float2bfloat16(x);
  hi[at] = h;
  lo[at] = __float2bfloat16(x - __bfloat162float(h));
}

template <int D>
__device__ __forceinline__ void store_frags(float* out, FragC (&acc)[TileTC<D>::kOutPerWarp],
                                            int warp) {
  using C = TileTC<D>;
#pragma unroll
  for (int t = 0; t < C::kOutPerWarp; ++t) {
    const int f = warp + t * kWarps;
    if (f >= C::kFragsOut) break;
    const int fm = f / C::TD, fn = f % C::TD;
    wmma::store_matrix_sync(out + fm * 16 * C::LOF + fn * 16, acc[t], C::LOF,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void zero_frags(FragC (&acc)[TileTC<D>::kOutPerWarp]) {
#pragma unroll
  for (int t = 0; t < TileTC<D>::kOutPerWarp; ++t) wmma::fill_fragment(acc[t], 0.f);
}

// rows r0 + i of a [BM, D] fp32 tile into bf16 rows of a [S, H(k), D]-strided
// output with element offset `base` and row stride `rs`, rows below `rows`
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst, long long rs, const float* src,
                                           int r0, int rows) {
  using C = TileTC<D>;
  for (int idx = threadIdx.x; idx < C::BM * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx % D;
    if (r0 + i < rows) dst[(r0 + i) * rs + d] = __float2bfloat16(src[i * C::LOF + d]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(Params p) {
  using C = TileTC<D>;
  constexpr int BM = C::BM, TM = C::TM, TD = C::TD;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __nv_bfloat16* Qh = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Kh = Qh + BM * C::LH;
  __nv_bfloat16* Vh = Kh + BM * C::LH;
  float* Ss = reinterpret_cast<float*>(Vh + BM * C::LH);
  __nv_bfloat16* Ph = reinterpret_cast<__nv_bfloat16*>(Ss + BM * C::LSF);
  __nv_bfloat16* Pl = Ph + BM * C::LSH;
  float* Os = reinterpret_cast<float*>(Pl + BM * C::LSH);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.Hk);
  using T = __nv_bfloat16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  load_rows_h<D>(Qh, q, p.q_ss, q0, p.Sq);
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  const int nkt = kv_tiles(q0, BM, p);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();  // the previous tile's K, V, P and p.V are consumed
    load_rows_h<D>(Kh, k, p.k_ss, k0, p.Sk);
    load_rows_h<D>(Vh, v, p.v_ss, k0, p.Sk);
    __syncthreads();
    mma_abt<D>(Ss, Qh, Kh, warp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + ty + 16 * i;
      float s[TM], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[j] = masked(Ss[(ty + 16 * i) * C::LSF + tx + 16 * j], qr, k0 + tx + 16 * j, p);
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[j] = expf(s[j] - m_new);
        rs += s[j];
        split_store(Ph, Pl, (ty + 16 * i) * C::LSH + tx + 16 * j, s[j]);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    FragC pv[C::kOutPerWarp];
    zero_frags<D>(pv);
    mma_xy<D, false>(pv, Ph, Pl, Vh, warp);
    store_frags<D>(Os, pv, warp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] += Os[(ty + 16 * i) * C::LOF + tx + 16 * c];
  }

  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Sq + qr) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) orow[tx + 16 * c] = __float2bfloat16(acc[i][c] / l_safe);
    if (tx == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qr] = m[i] + logf(l_safe);
  }
}

// p and ds of one (q-tile, k-tile) pair from the fp32 score tiles s = q.k
// and dp = do.v, written as bf16 hi and lo tiles (ds only when Ph is null)
template <int D>
__device__ __forceinline__ void probs_and_dscores_tc(
    __nv_bfloat16* Ph, __nv_bfloat16* Pl, __nv_bfloat16* dSh, __nv_bfloat16* dSl,
    const float* Ss, const float* dPs,
    const float* lse_row, const float* delta_row, int q0, int k0, int ty, int tx,
    const Params& p) {
  using C = TileTC<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qr = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::TM; ++j) {
      const int at = (ty + 16 * i) * C::LSF + tx + 16 * j;
      const float pij = expf(masked(Ss[at], qr, k0 + tx + 16 * j, p) - lse_row[i]);
      const float ds = pij * (dPs[at] - delta_row[i]) * p.scale;
      const int ah = (ty + 16 * i) * C::LSH + tx + 16 * j;
      if (Ph != nullptr) split_store(Ph, Pl, ah, pij);
      split_store(dSh, dSl, ah, ds);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_tc_kernel(Params p) {
  using C = TileTC<D>;
  constexpr int BM = C::BM, TM = C::TM;
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  T* Kh = reinterpret_cast<T*>(smem_tc);
  T* Vh = Kh + BM * C::LH;
  T* Qh = Vh + BM * C::LH;
  T* dOh = Qh + BM * C::LH;
  float* Ss = reinterpret_cast<float*>(dOh + BM * C::LH);
  float* dPs = Ss + BM * C::LSF;
  T* Ph = reinterpret_cast<T*>(dPs + BM * C::LSF);
  T* Pl = Ph + BM * C::LSH;
  T* dSh = Pl + BM * C::LSH;
  T* dSl = dSh + BM * C::LSH;
  float* Os = reinterpret_cast<float*>(dSl + BM * C::LSH);
  float* lse_s = Os + BM * C::LOF;
  float* delta_s = lse_s + BM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.Hk;
  const int g = blockIdx.y % p.Hk;
  const int rep = p.H / p.Hk;
  const int off = p.Sk - p.Sq;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  load_rows_h<D>(Kh, k, p.k_ss, k0, p.Sk);
  load_rows_h<D>(Vh, v, p.v_ss, k0, p.Sk);
  FragC dk[C::kOutPerWarp], dv[C::kOutPerWarp];
  zero_frags<D>(dk);
  zero_frags<D>(dv);

  const int n_q = (p.Sq + BM - 1) / BM;
  const int lo = p.causal ? max(k0 - off, 0) / BM : 0;  // _causal_lo
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = lo; qt < n_q; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the previous q-tile's tiles are consumed
      load_rows_h<D>(Qh, q, p.q_ss, q0, p.Sq);
      load_rows_h<D>(dOh, dout, p.do_ss, q0, p.Sq);
      for (int i = tid; i < BM; i += kThreads) {
        const bool live = q0 + i < p.Sq;
        lse_s[i] = live ? lse[q0 + i] : INFINITY;  // rows past Sq weigh 0
        delta_s[i] = live ? delta[q0 + i] : 0.f;
      }
      __syncthreads();
      mma_abt<D>(Ss, Qh, Kh, warp);
      mma_abt<D>(dPs, dOh, Vh, warp);
      __syncthreads();
      float lse_row[TM], delta_row[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        lse_row[i] = lse_s[ty + 16 * i];
        delta_row[i] = delta_s[ty + 16 * i];
      }
      probs_and_dscores_tc<D>(Ph, Pl, dSh, dSl, Ss, dPs, lse_row, delta_row, q0, k0, ty,
                              tx, p);
      __syncthreads();
      mma_xy<D, true>(dv, Ph, Pl, dOh, warp);    // dV += P^T dO
      mma_xy<D, true>(dk, dSh, dSl, Qh, warp);   // dK += dS^T Q
    }
  }

  T* dkp = static_cast<T*>(p.dk) + (static_cast<long long>(b) * p.Sk * p.Hk + g) * D;
  T* dvp = static_cast<T*>(p.dv) + (static_cast<long long>(b) * p.Sk * p.Hk + g) * D;
  const long long rs = static_cast<long long>(p.Hk) * D;
  __syncthreads();
  store_frags<D>(Os, dk, warp);
  __syncthreads();
  write_rows<D>(dkp, rs, Os, k0, p.Sk);
  __syncthreads();
  store_frags<D>(Os, dv, warp);
  __syncthreads();
  write_rows<D>(dvp, rs, Os, k0, p.Sk);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(Params p) {
  using C = TileTC<D>;
  constexpr int BM = C::BM, TM = C::TM;
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  T* Qh = reinterpret_cast<T*>(smem_tc);
  T* dOh = Qh + BM * C::LH;
  T* Kh = dOh + BM * C::LH;
  T* Vh = Kh + BM * C::LH;
  float* Ss = reinterpret_cast<float*>(Vh + BM * C::LH);
  float* dPs = Ss + BM * C::LSF;
  T* dSh = reinterpret_cast<T*>(dPs + BM * C::LSF);
  T* dSl = dSh + BM * C::LSH;
  float* Os = reinterpret_cast<float*>(dSl + BM * C::LSH);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.Hk);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
  load_rows_h<D>(Qh, q, p.q_ss, q0, p.Sq);
  load_rows_h<D>(dOh, dout, p.do_ss, q0, p.Sq);
  float lse_row[TM], delta_row[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    lse_row[i] = qr < p.Sq ? lse[qr] : INFINITY;
    delta_row[i] = qr < p.Sq ? delta[qr] : 0.f;
  }
  FragC dq[C::kOutPerWarp];
  zero_frags<D>(dq);

  const int nkt = kv_tiles(q0, BM, p);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows_h<D>(Kh, k, p.k_ss, k0, p.Sk);
    load_rows_h<D>(Vh, v, p.v_ss, k0, p.Sk);
    __syncthreads();
    mma_abt<D>(Ss, Qh, Kh, warp);
    mma_abt<D>(dPs, dOh, Vh, warp);
    __syncthreads();
    probs_and_dscores_tc<D>(nullptr, nullptr, dSh, dSl, Ss, dPs, lse_row, delta_row, q0, k0,
                            ty, tx, p);
    __syncthreads();
    mma_xy<D, false>(dq, dSh, dSl, Kh, warp);   // dQ += dS K
  }

  __syncthreads();
  store_frags<D>(Os, dq, warp);
  __syncthreads();
  T* dqp = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  write_rows<D>(dqp, static_cast<long long>(p.H) * D, Os, q0, p.Sq);
}

// dynamic shared memory above 48 KB must be granted once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename K>
cudaError_t launch_one(K kernel, int bytes, bool& ready, dim3 grid, const Params& p,
                       cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, bytes, ready);
  if (e != cudaSuccess) return e;
  if (grid.x > 0 && grid.y > 0) kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  static bool ready = false;
  const dim3 grid((p.Sq + Tile<D>::BM - 1) / Tile<D>::BM, p.B * p.H);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_one(flash_fwd_tc_kernel<D>, TileTC<D>::kFwdBytes, ready, grid, p, stream);
  else
    return launch_one(flash_fwd_kernel<T, D>, Tile<D>::kFwdBytes, ready, grid, p, stream);
}

template <typename T, int D>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  static bool ready_kv = false, ready_q = false;
  const dim3 grid_kv((p.Sk + Tile<D>::BM - 1) / Tile<D>::BM, p.B * p.Hk);
  const dim3 grid_q((p.Sq + Tile<D>::BM - 1) / Tile<D>::BM, p.B * p.H);
  cudaError_t e;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    e = launch_one(flash_bwd_dkdv_tc_kernel<D>, TileTC<D>::kDkdvBytes, ready_kv, grid_kv, p,
                   stream);
    if (e != cudaSuccess) return e;
    return launch_one(flash_bwd_dq_tc_kernel<D>, TileTC<D>::kDqBytes, ready_q, grid_q, p,
                      stream);
  } else {
    e = launch_one(flash_bwd_dkdv_kernel<T, D>, Tile<D>::kDkdvBytes, ready_kv, grid_kv, p,
                   stream);
    if (e != cudaSuccess) return e;
    return launch_one(flash_bwd_dq_kernel<T, D>, Tile<D>::kDqBytes, ready_q, grid_q, p,
                      stream);
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, bool backward, cudaStream_t s) {
  switch (D) {
    case 32: return backward ? launch_bwd<T, 32>(p, s) : launch_fwd<T, 32>(p, s);
    case 64: return backward ? launch_bwd<T, 64>(p, s) : launch_fwd<T, 64>(p, s);
    case 128: return backward ? launch_bwd<T, 128>(p, s) : launch_fwd<T, 128>(p, s);
    case 256: return backward ? launch_bwd<T, 256>(p, s) : launch_fwd<T, 256>(p, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run(Params& p, const long long* strides, int n_strides, int D, int dtype,
                bool backward, void* stream) {
  if (p.Hk <= 0 || p.H % p.Hk != 0 || p.Sq < 0 || p.Sk < 0 || p.B < 0)
    return cudaErrorInvalidValue;
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.do_sb, &p.do_ss, &p.do_sh};
  for (int i = 0; i < n_strides; ++i) *dst[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch<float>(p, D, backward, s);
    case kBFloat16: return dispatch<__nv_bfloat16>(p, D, backward, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
int attributes(int kernel, int* out) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (kernel) {
      case 0: return func_attributes(flash_fwd_tc_kernel<D>, TileTC<D>::kFwdBytes, out);
      case 1: return func_attributes(flash_bwd_dkdv_tc_kernel<D>, TileTC<D>::kDkdvBytes, out);
      case 2: return func_attributes(flash_bwd_dq_tc_kernel<D>, TileTC<D>::kDqBytes, out);
    }
  } else {
    switch (kernel) {
      case 0: return func_attributes(flash_fwd_kernel<T, D>, Tile<D>::kFwdBytes, out);
      case 1: return func_attributes(flash_bwd_dkdv_kernel<T, D>, Tile<D>::kDkdvBytes, out);
      case 2: return func_attributes(flash_bwd_dq_kernel<T, D>, Tile<D>::kDqBytes, out);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes_d(int kernel, int D, int* out) {
  switch (D) {
    case 32: return attributes<T, 32>(kernel, out);
    case 64: return attributes<T, 64>(kernel, out);
    case 128: return attributes<T, 128>(kernel, out);
    case 256: return attributes<T, 256>(kernel, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// kernel 0: the forward, 1: the dK/dV pass, 2: the dQ pass (the tensor-core
// kernels for bf16, the CUDA-core ones for fp32); <dtype, a = D>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int* out) {
  switch (dtype) {
    case kFloat32: return attributes_d<float>(kernel, a, out);
    case kBFloat16: return attributes_d<__nv_bfloat16>(kernel, a, out);
  }
  return cudaErrorInvalidValue;
}

// q [B, Sq, H, D], k and v [B, Sk, Hk, D], each read through its (batch,
// seq, head) element strides in `strides` (9 values; the last dim is
// contiguous).  Writes o [B, Sq, H, D] contiguous and lse [B, H, Sq] fp32.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, const long long* strides,
                                          int B, int H, int Hk, int Sq, int Sk, int D,
                                          int causal, float scale, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  return run(p, strides, 9, D, dtype, false, stream);
}

// The two backward passes.  q, k, v and dout through `strides` (12 values:
// q, k, v, dout); lse and delta [B, H, Sq] fp32.  Writes dq [B, Sq, H, D],
// dk and dv [B, Sk, Hk, D], all contiguous and of q's dtype.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, void* dk, void* dv,
                                          const long long* strides, int B, int H, int Hk,
                                          int Sq, int Sk, int D, int causal, float scale,
                                          int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  return run(p, strides, 12, D, dtype, true, stream);
}

DEFINE_ERROR_STRING
