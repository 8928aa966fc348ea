// Flash attention forward and backward for Hopper, over [B, S, H, D] read
// through strides, with grouped-query heads indexed natively: query head h
// reads kv-head h / (H / Hk).
//
// Replaces four Pallas kernels of paddle_tpu/kernels/flash_attention.py:
//   forward:  _flash_fwd_impl (K/V resident) and _flash_fwd_stream (K/V paged)
//   backward: _flash_bwd_impl (resident) and _flash_bwd_stream (paged)
// The resident/streamed split exists only for the TPU's VMEM; here every CTA
// walks its tiles through shared memory, so one kernel covers any length
// (S = 2048 at `base`, S = 16384 at `longctx`) with no change.
//
// Forward: o = softmax(q k^T * scale) v with the online softmax in fp32, and
// lse = m + log(max(l, 1e-30)) fp32 [B, H, Sq].
// Backward, two passes as in _flash_bwd_impl, deterministic (no atomics):
//   dK/dV pass, one CTA per (batch, kv-head, k-tile), loops over the H/Hk
//     query heads of its group and over q-tiles from the causal lower bound,
//     so the group sum that jnp.repeat's transpose does in the JAX package
//     happens in the CTA's fp32 accumulators;
//   dQ pass, one CTA per (batch, head, q-tile), walks k-tiles up to the
//     causal diagonal.
// Both recompute p = exp(s - lse) in fp32; delta = sum(do * o) over D is a
// small torch op in the wrapper, computed before the passes.
//
// Causal masking follows the Pallas kernels: the diagonal is offset by
// Sk - Sq, masked scores are -1e30 and k-tiles past the diagonal (past
// _causal_hi) are skipped; in the dK/dV pass q-tiles before _causal_lo are.
// With Sq > Sk the first Sq - Sk query rows see no key: every score of such a
// row is -1e30, they tie, and the row takes the mean of all of V, as the
// one-shot softmax of _attention_reference gives it.  So a q-tile holding
// such a row walks every k-tile (its other rows stay masked: exp(-1e30 - m)
// is 0 for a finite m), the dK/dV pass starts at q-tile 0, and in the
// backward such a row weighs every key 1 / Sk in dV and passes no gradient
// to its scores (dS = 0), as autograd of that softmax gives.
// Ragged tiles are masked: keys at or past Sk weigh exactly 0, rows at or
// past Sq are neither stored nor counted.
//
// Bound: operations.  At `base` (B 3, S 2048, H 16, D 128, causal) the
// forward does 51.5 GFLOP against 76 MB of q/k/v/o, far above the card's
// ~295 flop/byte balance point; the backward about 2.5x the forward's
// operations.
//
// fp32 inputs (the parity path): tiles of BM x BM (64 for D <= 128, 32 for
// D = 256) staged in shared memory; 256 threads as a 16 x 16 grid each own a
// TM x TM block of the score tile and a TM x D/16 block of the output; every
// product is an fp32 FMA on CUDA cores over tiles with a one-float skew, so
// fp32 is true fp32 (no TF32).
// bf16 inputs: register-resident tensor-core kernels; see the second half of
// this file.
#include <cuda.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;       // the fp32 kernels: a 16 x 16 thread grid
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
// 16-byte aligned) into a skewed fp32 tile (row stride Tile<D>::LD); rows at
// or past `rows` read as 0.  Every thread issues all its 16-byte loads
// before its first store, so the tile's loads are in flight together.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int r0,
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
    float* row = dst + (c / CPR) * Tile<D>::LD + (c % CPR) * E;
    const T* v = reinterpret_cast<const T*>(&buf[n]);
#pragma unroll
    for (int j = 0; j < E; ++j) row[j] = to_float(v[j]);
  }
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

// k-tiles of BK keys a q-tile of BQ rows starting at q0 must visit
// (_causal_hi); every one when its first row sees no key (Sq > Sk)
__device__ __forceinline__ int kv_tiles(int q0, int BQ, int BK, const Params& p) {
  const int n_k = (p.Sk + BK - 1) / BK;
  if (!p.causal || q0 + (p.Sk - p.Sq) < 0) return n_k;
  const int last = min(q0 + BQ, p.Sq) - 1 + (p.Sk - p.Sq);  // last key its last row sees
  return min(last / BK + 1, n_k);
}

// a causal row that sees no key (Sq > Sk): its scores tie at -1e30
__device__ __forceinline__ bool sees_no_key(int qr, const Params& p) {
  return p.causal && qr + (p.Sk - p.Sq) < 0;
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

  const int nkt = kv_tiles(q0, BM, BM, p);
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
// s = q . k, dp = do . v; p = exp(masked(s) - lse), ds = p (dp - delta) scale;
// a row that sees no key weighs each key 1 / Sk and has ds = 0
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
    const bool blind = sees_no_key(qr, p);
#pragma unroll
    for (int j = 0; j < C::TM; ++j) {
      const int kc = k0 + tx + 16 * j;
      if (blind) {
        pr[i][j] = kc < p.Sk ? 1.f / p.Sk : 0.f;
        ds[i][j] = 0.f;
        continue;
      }
      const float pij = expf(masked(pr[i][j], qr, kc, p) - lse_row[i]);
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
  const int lo = p.causal && off >= 0 ? max(k0 - off, 0) / BM : 0;  // _causal_lo
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

  const int nkt = kv_tiles(q0, BM, BM, p);
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
// bf16: warp-specialised tensor-core kernels (wgmma + TMA), register
// resident.
//
// A CTA has one producer warp and consumer warpgroups of 64 rows.  The
// producer issues TMA loads of whole tiles into shared memory, each landing
// on an mbarrier; the tiles it streams go through a ring of stages that the
// consumers release on a second barrier, so the next tiles' loads are in
// flight while the current ones are multiplied.  Each consumer warpgroup
// runs its products as wgmma (m64 x N x k16) and keeps them in the
// accumulator registers for the whole walk: the scores S, the probabilities
// P and the output O (or the gradients) never touch shared memory.  An
// accumulator of S is, pair by pair of n8 column blocks, the A operand of
// the next product (P.V, P^T.dO, dS^T.Q, dS.K): the softmax runs in the
// registers where S landed, its row max and sum reduced across the four
// threads of a row by __shfl_xor.  P and dS, computed in fp32, enter their
// products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), two wgmma
// on the same B tile: they keep ~16 mantissa bits where one bf16 would keep
// 8 (one rounding of P moved outputs near 0 by 2 bf16 ulps of V's scale),
// so each product is as exact as the fp32 plain version's up to the sum
// order.  Tiles sit in shared memory as TMA lays them with 128-byte
// swizzling (64-byte at D 32): a [rows][D] tile is D / E chunks of [rows][E]
// columns, E the swizzle span in elements, each chunk 1024-byte aligned;
// the wgmma descriptors read a tile K-major (its rows are the product's M or
// N, its columns the depth) or MN-major (transposed: its rows are the
// depth).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// the value of a per-head-dim geometry constant (-D defines from
// _build.GEOMETRY) at head dim D
constexpr int per_d(int D, int d32, int d64, int d128, int d256) {
  return D == 32 ? d32 : D == 64 ? d64 : D == 128 ? d128 : d256;
}

// x, y as the bf16 pair hi + lo (each packed two to a register)
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // round to nearest even
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&r);
}

// a bf16 pair at (row, col) of a [rows, .] output with row stride rs
__device__ __forceinline__ void store_pair(bf16* base, long long rs, int row, int rows, int col,
                                           float x, float y) {
  if (row < rows)
    *reinterpret_cast<__nv_bfloat162*>(base + row * rs + col) = __floats2bfloat162_rn(x, y);
}

// p and ds at (query row qr, key kc) from the raw score s = q.k and dp =
// do.v, in place; `check` off where the caller knows the pair is inside
// both sequences and on or below the diagonal.  Selects, no branches: the
// values feed a wgmma, which a divergent path would serialise
__device__ __forceinline__ void prob_ds(float& s, float& dp, int qr, int kc, float lse,
                                        float delta, bool check, const Params& p) {
  const bool inside = qr < p.Sq && kc < p.Sk;
  const bool blind = inside && sees_no_key(qr, p);   // its scores tie: each key weighs 1 / Sk
  const bool live = !check || (inside && !blind && !(p.causal && kc > qr + (p.Sk - p.Sq)));
  const float pr = exp2f((s * p.scale - lse) * kLog2e);
  dp = live ? pr * (dp - delta) * p.scale : 0.f;
  s = live ? pr : (check && blind ? 1.f / p.Sk : 0.f);
}

// ---------------------------------------------------------------------------
// bf16 forward.  A CTA owns BQ = 64 x CONSUMERS query rows of one (batch,
// head); the producer loads its Q tile once, then the K and V tiles of its
// kv-head into the ring, each on its own barrier (K and V apart, so S = Q
// K^T can start before V lands).  Each consumer warpgroup: S = Q K^T with
// both operands in shared memory (K-major), the mask and the online softmax
// in the accumulators, O rescaled in registers, O += P V with P from
// registers and V read MN-major; a tile's softmax runs while the previous
// tile's P V is in flight (the first tile is peeled off the loop, so every
// step of it waits for its groups the same way).
// ---------------------------------------------------------------------------

template <int D>
struct FwdWG {
  static constexpr int BQ = per_d(D, FLASH_FWD_Q_ROWS_D32, FLASH_FWD_Q_ROWS_D64,
      FLASH_FWD_Q_ROWS_D128, FLASH_FWD_Q_ROWS_D256);   // query rows of a CTA
  static constexpr int BK = per_d(D, FLASH_FWD_K_ROWS_D32, FLASH_FWD_K_ROWS_D64,
      FLASH_FWD_K_ROWS_D128, FLASH_FWD_K_ROWS_D256);   // keys of a k-tile
  static constexpr int ST = FLASH_FWD_STAGES;
  static constexpr int CONSUMERS = BQ / 64;                  // warpgroups of 64 rows
  static constexpr int NT = 128 * (CONSUMERS + 1);           // and the producer's
  static constexpr int SW = D >= 64 ? 128 : 64;              // swizzle span, bytes
  static constexpr int E = SW / 2;                           // its elements
  static constexpr int CH = D / E;                           // chunks of a row
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;    // bytes of a tile
  static constexpr int kBars = 8 * (1 + 3 * ST);             // q, k[ST], v[ST], empty[ST]
  static constexpr int kBytes = 1024 + kQ + 2 * ST * kKV + kBars;   // 1024: alignment slack
  static_assert(BQ % 64 == 0 && BK % 16 == 0 && ST >= 2 && kBytes <= 232448, "geometry");
  static_assert(CONSUMERS == 2, "the register split assumes two consumer warpgroups");
};

// the tensor maps of q, k, v and the launch's parameters, one kernel argument
struct FwdArgs {
  CUtensorMap q, k, v;
  Params p;
};

template <int D>
__global__ void __launch_bounds__(FwdWG<D>::NT, 1)
flash_fwd_tc_kernel(const __grid_constant__ FwdArgs a) {
  using C = FwdWG<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, SW = C::SW, E = C::E, CH = C::CH;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                          // [CH][BQ][E]
  unsigned char* Ks = Qs + C::kQ;                    // [ST][CH][BK][E]
  unsigned char* Vs = Ks + ST * C::kKV;              // [ST][CH][BK][E]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + ST * C::kKV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;       // the longest causal walks launch first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, g = h / (p.H / p.Hk);
  const int nkt = kv_tiles(q0, BQ, BK, p);
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(k_full + s, 1);
      bar_init(v_full + s, 1);
      bar_init(empty + s, 128 * C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::CONSUMERS) {                  // the producer warpgroup: one thread
    producer_registers();
    if (warp == 4 * C::CONSUMERS && lane == 0) {
      bar_expect(q_full, C::kQ);
      for (int c = 0; c < CH; ++c) tma_load(Qs + c * BQ * SW, &a.q, c * E, h, q0, b, q_full);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % ST, round = kt / ST;
        bar_wait(empty + s, (round & 1) ^ 1);       // the consumers released the stage
        unsigned char* kd = Ks + s * C::kKV;
        unsigned char* vd = Vs + s * C::kKV;
        bar_expect(k_full + s, C::kKV);
        for (int c = 0; c < CH; ++c) tma_load(kd + c * BK * SW, &a.k, c * E, g, kt * BK, b, k_full + s);
        bar_expect(v_full + s, C::kKV);
        for (int c = 0; c < CH; ++c) tma_load(vd + c * BK * SW, &a.v, c * E, g, kt * BK, b, v_full + s);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 cw .. 64 cw + 63 of the tile
  consumer_registers();
  const int cw = warp >> 2;
  const int wq = q0 + 64 * cw + 16 * (warp & 3);     // the warp's first row
  const int r0 = wq + (lane >> 2), r1 = r0 + 8;
  const int tq = lane & 3;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's share
  float sc[BK / 2];
  unsigned ph[BK / 16][4], pl[BK / 16][4];          // the last tile's P, hi and lo
  bar_wait(q_full, 0);

  // S = Q K^T of tile kt into sc, issued and committed
  auto s_tile = [&](int kt) {
    const unsigned char* Kt = Ks + (kt % ST) * C::kKV;
    bar_wait(k_full + kt % ST, (kt / ST) & 1);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const int c = kk / E, off = (kk % E) * 2;
      Wgmma<BK>::ss(sc, wg_desc<SW>(Qs + c * BQ * SW + cw * 64 * SW + off, 16, 8 * SW),
                    wg_desc<SW>(Kt + c * BK * SW + off, 16, 8 * SW), kk > 0);
    }
    wg_commit();
  };
  // O += P V of tile kt, P from registers, issued and committed
  auto pv_tile = [&](int kt) {
    const unsigned char* Vt = Vs + (kt % ST) * C::kKV;
    bar_wait(v_full + kt % ST, (kt / ST) & 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = wg_desc<SW>(Vt + kk * 16 * SW, BK * SW, 8 * SW);
      Wgmma<D>::rs_tb(o, ph[kk], dv, 1);
      Wgmma<D>::rs_tb(o, pl[kk], dv, 1);
    }
    wg_commit();
  };
  // tile kt's mask and online softmax over sc: P in sc, the rescale of the
  // rows' earlier sums in al0 / al1, this tile's sums in rs0 / rs1
  float al0, al1, rs0, rs1;
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    // scale and mask: only a tile past Sk or crossing the warp's diagonal
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wq + (p.Sk - p.Sq));
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * tq + e;
        float& x0 = sc[4 * j + e];
        float& x1 = sc[4 * j + 2 + e];
        x0 = edge ? masked(x0, r0, kc, p) : x0 * p.scale;
        x1 = edge ? masked(x1, r1, kc, p) : x1 * p.scale;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {           // the four threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = exp2f((m0 - mn0) * kLog2e);
    al1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    rs0 = rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f((sc[4 * j + e] - mn0) * kLog2e);
        sc[4 * j + 2 + e] = exp2f((sc[4 * j + 2 + e] - mn1) * kLog2e);
        rs0 += sc[4 * j + e];
        rs1 += sc[4 * j + 2 + e];
      }
  };
  // fold the tile's sums in, rescale O, and P as the next A operands
  auto fold = [&]() {
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
  };

  // Tile kt's S is issued with tile kt - 1's P V behind it, and kt's softmax
  // runs while that P V is in flight; the O rescale waits for it
  if (nkt > 0) {
    wg_fence();
    s_tile(0);
    wg_wait<0>();
    wg_fence_regs(sc);
    softmax(0);
    fold();
  }
  for (int kt = 1; kt < nkt; ++kt) {
    wg_fence();
    s_tile(kt);
    pv_tile(kt - 1);
    wg_wait<1>();                                   // S has landed
    wg_fence_regs(sc);
    softmax(kt);
    wg_wait<0>();                                   // tile kt - 1's P V is done
    wg_fence_regs(o);
    bar_arrive(empty + (kt - 1) % ST);              // this thread is done with its stage
    fold();
  }
  if (nkt > 0) {
    wg_fence();
    pv_tile(nkt - 1);
    wg_wait<0>();
    wg_fence_regs(o);
    bar_arrive(empty + (nkt - 1) % ST);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = static_cast<bf16*>(p.out) + (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const long long ors = static_cast<long long>(p.H) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    store_pair(ob, ors, r0, p.Sq, 8 * j + 2 * tq, o[4 * j] * i0, o[4 * j + 1] * i0);
    store_pair(ob, ors, r1, p.Sq, 8 * j + 2 * tq, o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  if (tq == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    if (r0 < p.Sq) lse[r0] = m0 + logf(l0);
    if (r1 < p.Sq) lse[r1] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, two deterministic passes (no atomics):
//   dK/dV pass: a CTA owns BK keys of one (batch, kv-head), each consumer
//     warpgroup 64 of them (at D 256 two warpgroups share 64 keys, each
//     summing half the head dim); its K and V tiles load once, then the Q
//     and dO tiles of each step (a query head of the group, BQ rows of it)
//     stream through the ring.  S^T = K Q^T and dP^T = V dO^T with both
//     operands in shared memory, so P^T and dS^T land in registers as the A
//     operands of dV += P^T dO and dK += dS^T Q, whose B operands are the
//     same Q and dO tiles read MN-major;
//   dQ pass: a CTA owns BQ query rows of one (batch, head); its Q and dO
//     tiles load once, the K and V tiles of its kv-head stream.  S = Q K^T
//     and dP = dO V^T from shared memory, dS in registers, dQ += dS K with
//     K read MN-major.
// ---------------------------------------------------------------------------

template <int D>
struct DkdvWG {
  static constexpr int CONSUMERS = 2;                        // warpgroups
  static constexpr int DSPLIT = D == 256 ? 2 : 1;            // warpgroups sharing 64 keys
  static constexpr int BK = per_d(D, FLASH_DKDV_K_ROWS_D32, FLASH_DKDV_K_ROWS_D64,
      FLASH_DKDV_K_ROWS_D128, FLASH_DKDV_K_ROWS_D256);   // keys of a CTA
  static constexpr int BQ = per_d(D, FLASH_DKDV_Q_ROWS_D32, FLASH_DKDV_Q_ROWS_D64,
      FLASH_DKDV_Q_ROWS_D128, FLASH_DKDV_Q_ROWS_D256);   // query rows of a step
  static constexpr int ST = FLASH_BWD_STAGES;
  static constexpr int DW = D / DSPLIT;                      // head dims a warpgroup sums
  static constexpr int NT = 128 * (CONSUMERS + 1);
  static constexpr int SW = D >= 64 ? 128 : 64, E = SW / 2, CH = D / E;
  static constexpr int kKV = BK * D * 2, kQ = BQ * D * 2;    // bytes of a tile
  static constexpr int kBars = 8 * (1 + 3 * ST);             // kv; q[ST], do[ST], empty[ST]
  static constexpr int kBytes = 1024 + 2 * kKV + 2 * ST * kQ + kBars;
  static_assert(BK * DSPLIT == 64 * CONSUMERS && BQ % 16 == 0 && DW % E == 0 && ST >= 2 &&
                kBytes <= 232448, "geometry");
};

template <int D>
struct DqWG {
  static constexpr int BQ = per_d(D, FLASH_DQ_Q_ROWS_D32, FLASH_DQ_Q_ROWS_D64,
      FLASH_DQ_Q_ROWS_D128, FLASH_DQ_Q_ROWS_D256);       // query rows of a CTA
  static constexpr int BK = per_d(D, FLASH_DQ_K_ROWS_D32, FLASH_DQ_K_ROWS_D64,
      FLASH_DQ_K_ROWS_D128, FLASH_DQ_K_ROWS_D256);       // keys of a step
  static constexpr int ST = FLASH_BWD_STAGES;
  static constexpr int CONSUMERS = BQ / 64;
  static constexpr int NT = 128 * (CONSUMERS + 1);
  static constexpr int SW = D >= 64 ? 128 : 64, E = SW / 2, CH = D / E;
  static constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;
  static constexpr int kBars = 8 * (1 + 3 * ST);             // q and do; k[ST], v[ST], empty[ST]
  static constexpr int kBytes = 1024 + 2 * kQ + 2 * ST * kKV + kBars;
  static_assert(BQ % 64 == 0 && BK % 16 == 0 && ST >= 2 && kBytes <= 232448, "geometry");
  static_assert(CONSUMERS == 2, "the register split assumes two consumer warpgroups");
};

// the tensor maps of q, k, v and dout and the launch's parameters
struct BwdArgs {
  CUtensorMap q, k, v, dout;
  Params p;
};

// the dynamic shared memory's first 1024-byte boundary (TMA's swizzle
// pattern follows the address bits)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(DkdvWG<D>::NT, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ BwdArgs a) {
  using C = DkdvWG<D>;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::ST, SW = C::SW, E = C::E, CH = C::CH;
  constexpr int DW = C::DW;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = aligned_smem(smem_raw);       // [CH][BK][E]
  unsigned char* Vs = Ks + C::kKV;                  // [CH][BK][E]
  unsigned char* Qs = Vs + C::kKV;                  // [ST][CH][BQ][E]
  unsigned char* dOs = Qs + ST * C::kQ;             // [ST][CH][BQ][E]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dOs + ST * C::kQ);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + ST;
  uint64_t* empty = do_full + ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * BK;                   // the longest causal walks launch first
  const int b = blockIdx.x / p.Hk, g = blockIdx.x % p.Hk;
  const int rep = p.H / p.Hk, off = p.Sk - p.Sq;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  // _causal_lo; from q-tile 0 when rows that see no key (Sq > Sk) see every key
  const int lo = p.causal && off >= 0 ? max(k0 - off, 0) / BQ : 0;
  const int nqt = max(n_q - lo, 0), n_it = rep * nqt;
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(q_full + s, 1);
      bar_init(do_full + s, 1);
      bar_init(empty + s, 128 * C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::CONSUMERS) {                  // the producer warpgroup: one thread
    producer_registers();
    if (warp == 4 * C::CONSUMERS && lane == 0) {
      bar_expect(kv_full, 2 * C::kKV);
      for (int c = 0; c < CH; ++c) {
        tma_load(Ks + c * BK * SW, &a.k, c * E, g, k0, b, kv_full);
        tma_load(Vs + c * BK * SW, &a.v, c * E, g, k0, b, kv_full);
      }
      for (int it = 0; it < n_it; ++it) {          // step it: head g rep + it / nqt, a q-tile
        const int s = it % ST, h = g * rep + it / nqt, q0 = (lo + it % nqt) * BQ;
        bar_wait(empty + s, ((it / ST) & 1) ^ 1);
        bar_expect(q_full + s, C::kQ);
        for (int c = 0; c < CH; ++c)
          tma_load(Qs + s * C::kQ + c * BQ * SW, &a.q, c * E, h, q0, b, q_full + s);
        bar_expect(do_full + s, C::kQ);
        for (int c = 0; c < CH; ++c)
          tma_load(dOs + s * C::kQ + c * BQ * SW, &a.dout, c * E, h, q0, b, do_full + s);
      }
    }
    return;
  }

  consumer_registers();
  const int cw = warp >> 2;
  const int kw = (cw / C::DSPLIT) * 64;             // the warpgroup's first key in the tile
  const int cd = (cw % C::DSPLIT) * (DW / E);       // and its first head-dim chunk
  const int kr0 = k0 + kw + 16 * (warp & 3) + (lane >> 2), kr1 = kr0 + 8;
  const int tq = lane & 3;
  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;
  bar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST, parity = (it / ST) & 1;
    const int h = g * rep + it / nqt, q0 = (lo + it % nqt) * BQ;
    const unsigned char* Qt = Qs + s * C::kQ;
    const unsigned char* dOt = dOs + s * C::kQ;
    const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
    float st[BQ / 2], dpt[BQ / 2];                  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    bar_wait(q_full + s, parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const int c = kk / E, o2 = (kk % E) * 2;
      Wgmma<BQ>::ss(st, wg_desc<SW>(Ks + c * BK * SW + kw * SW + o2, 16, 8 * SW),
                    wg_desc<SW>(Qt + c * BQ * SW + o2, 16, 8 * SW), kk > 0);
    }
    bar_wait(do_full + s, parity);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const int c = kk / E, o2 = (kk % E) * 2;
      Wgmma<BQ>::ss(dpt, wg_desc<SW>(Vs + c * BK * SW + kw * SW + o2, 16, 8 * SW),
                    wg_desc<SW>(dOt + c * BQ * SW + o2, 16, 8 * SW), kk > 0);
    }
    wg_commit();
    wg_wait();
    wg_fence_regs(st);
    wg_fence_regs(dpt);
    // P^T and dS^T; checks only where the step holds rows past Sq, keys past
    // Sk or pairs above the diagonal (rows that see no key included)
    const int wk = k0 + kw + 16 * (warp & 3);       // the warp's first key
    const bool check = q0 + BQ > p.Sq || wk + 16 > p.Sk || (p.causal && wk + 15 > q0 + off);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = q0 + 8 * n + 2 * tq + e;
        const int qc = min(qr, p.Sq - 1);           // rows past Sq are masked by prob_ds
        const float l = lse[qc], d = delta[qc];
        prob_ds(st[4 * n + e], dpt[4 * n + e], qr, kr0, l, d, check, p);
        prob_ds(st[4 * n + 2 + e], dpt[4 * n + 2 + e], qr, kr1, l, d, check, p);
      }
    unsigned ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split2(st[8 * kq + 2 * i], st[8 * kq + 2 * i + 1], ph[kq][i], pl[kq][i]);
        split2(dpt[8 * kq + 2 * i], dpt[8 * kq + 2 * i + 1], sh[kq][i], sl[kq][i]);
      }
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {          // dV += P^T dO, dK += dS^T Q
      const uint64_t bo = wg_desc<SW>(dOt + cd * BQ * SW + kq * 16 * SW, BQ * SW, 8 * SW);
      const uint64_t bq = wg_desc<SW>(Qt + cd * BQ * SW + kq * 16 * SW, BQ * SW, 8 * SW);
      Wgmma<DW>::rs_tb(dv, ph[kq], bo, 1);
      Wgmma<DW>::rs_tb(dv, pl[kq], bo, 1);
      Wgmma<DW>::rs_tb(dk, sh[kq], bq, 1);
      Wgmma<DW>::rs_tb(dk, sl[kq], bq, 1);
    }
    wg_commit();
    wg_wait();
    wg_fence_regs(dv);
    wg_fence_regs(dk);
    bar_arrive(empty + s);
  }

  const long long base = (static_cast<long long>(b) * p.Sk * p.Hk + g) * D + cd * E;
  const long long rs = static_cast<long long>(p.Hk) * D;
  bf16* dkp = static_cast<bf16*>(p.dk) + base;
  bf16* dvp = static_cast<bf16*>(p.dv) + base;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    store_pair(dkp, rs, kr0, p.Sk, 8 * n + 2 * tq, dk[4 * n], dk[4 * n + 1]);
    store_pair(dkp, rs, kr1, p.Sk, 8 * n + 2 * tq, dk[4 * n + 2], dk[4 * n + 3]);
    store_pair(dvp, rs, kr0, p.Sk, 8 * n + 2 * tq, dv[4 * n], dv[4 * n + 1]);
    store_pair(dvp, rs, kr1, p.Sk, 8 * n + 2 * tq, dv[4 * n + 2], dv[4 * n + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(DqWG<D>::NT, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ BwdArgs a) {
  using C = DqWG<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, SW = C::SW, E = C::E, CH = C::CH;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);       // [CH][BQ][E]
  unsigned char* dOs = Qs + C::kQ;                  // [CH][BQ][E]
  unsigned char* Ks = dOs + C::kQ;                  // [ST][CH][BK][E]
  unsigned char* Vs = Ks + ST * C::kKV;             // [ST][CH][BK][E]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * C::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;       // the longest causal walks launch first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, g = h / (p.H / p.Hk);
  const int nkt = kv_tiles(q0, BQ, BK, p);
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(k_full + s, 1);
      bar_init(v_full + s, 1);
      bar_init(empty + s, 128 * C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::CONSUMERS) {                  // the producer warpgroup: one thread
    producer_registers();
    if (warp == 4 * C::CONSUMERS && lane == 0) {
      bar_expect(q_full, 2 * C::kQ);
      for (int c = 0; c < CH; ++c) {
        tma_load(Qs + c * BQ * SW, &a.q, c * E, h, q0, b, q_full);
        tma_load(dOs + c * BQ * SW, &a.dout, c * E, h, q0, b, q_full);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % ST;
        bar_wait(empty + s, ((kt / ST) & 1) ^ 1);
        bar_expect(k_full + s, C::kKV);
        for (int c = 0; c < CH; ++c)
          tma_load(Ks + s * C::kKV + c * BK * SW, &a.k, c * E, g, kt * BK, b, k_full + s);
        bar_expect(v_full + s, C::kKV);
        for (int c = 0; c < CH; ++c)
          tma_load(Vs + s * C::kKV + c * BK * SW, &a.v, c * E, g, kt * BK, b, v_full + s);
      }
    }
    return;
  }

  consumer_registers();
  const int cw = warp >> 2;
  const int wq = q0 + 64 * cw + 16 * (warp & 3);
  const int r0 = wq + (lane >> 2), r1 = r0 + 8;
  const int tq = lane & 3;
  const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
  const int rc0 = min(r0, p.Sq - 1), rc1 = min(r1, p.Sq - 1);   // rows past Sq: masked
  const float lse0 = lse[rc0], lse1 = lse[rc1], dl0 = delta[rc0], dl1 = delta[rc1];
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  bar_wait(q_full, 0);

  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % ST, parity = (kt / ST) & 1;
    const unsigned char* Kt = Ks + s * C::kKV;
    const unsigned char* Vt = Vs + s * C::kKV;
    const int k0 = kt * BK;
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    bar_wait(k_full + s, parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {           // S = Q K^T
      const int c = kk / E, o2 = (kk % E) * 2;
      Wgmma<BK>::ss(sc, wg_desc<SW>(Qs + c * BQ * SW + cw * 64 * SW + o2, 16, 8 * SW),
                    wg_desc<SW>(Kt + c * BK * SW + o2, 16, 8 * SW), kk > 0);
    }
    bar_wait(v_full + s, parity);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {           // dP = dO V^T
      const int c = kk / E, o2 = (kk % E) * 2;
      Wgmma<BK>::ss(dp, wg_desc<SW>(dOs + c * BQ * SW + cw * 64 * SW + o2, 16, 8 * SW),
                    wg_desc<SW>(Vt + c * BK * SW + o2, 16, 8 * SW), kk > 0);
    }
    wg_commit();
    wg_wait();
    wg_fence_regs(sc);
    wg_fence_regs(dp);
    const bool check = k0 + BK > p.Sk || wq + 16 > p.Sq ||
                       (p.causal && k0 + BK - 1 > wq + (p.Sk - p.Sq));
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * tq + e;
        prob_ds(sc[4 * j + e], dp[4 * j + e], r0, kc, lse0, dl0, check, p);
        prob_ds(sc[4 * j + 2 + e], dp[4 * j + 2 + e], r1, kc, lse1, dl1, check, p);
      }
    unsigned sh[BK / 16][4], sl[BK / 16][4];        // dS as the A operand, hi and lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split2(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1], sh[kk][i], sl[kk][i]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {         // dQ += dS K, dS from registers
      const uint64_t bk = wg_desc<SW>(Kt + kk * 16 * SW, BK * SW, 8 * SW);
      Wgmma<D>::rs_tb(dq, sh[kk], bk, 1);
      Wgmma<D>::rs_tb(dq, sl[kk], bk, 1);
    }
    wg_commit();
    wg_wait();
    wg_fence_regs(dq);
    bar_arrive(empty + s);
  }

  bf16* dqp = static_cast<bf16*>(p.out) + (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const long long rs = static_cast<long long>(p.H) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    store_pair(dqp, rs, r0, p.Sq, 8 * j + 2 * tq, dq[4 * j], dq[4 * j + 1]);
    store_pair(dqp, rs, r1, p.Sq, 8 * j + 2 * tq, dq[4 * j + 2], dq[4 * j + 3]);
  }
}

template <typename K>
cudaError_t launch_one(K kernel, int threads, int bytes, bool& ready, dim3 grid,
                       const Params& p, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, bytes, ready);
  if (e != cudaSuccess) return e;
  if (grid.x > 0 && grid.y > 0) kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The TMA map of a [B, S, heads, D] bf16 tensor read through its element
// strides (batch, seq, head; 16-byte multiples), boxes of `rows` rows by SW
// bytes of columns, SW-byte swizzled; rows past S read as 0
template <int SW>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
                     long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S > 0 ? S : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {SW / 2, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd_tc(const Params& p, cudaStream_t stream) {
  using C = FwdWG<D>;
  static bool ready = false;
  if (p.B == 0 || p.Sq == 0) return cudaGetLastError();
  FwdArgs a;
  a.p = p;
  cudaError_t e = make_map<C::SW>(&a.q, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, C::BQ);
  if (e == cudaSuccess)
    e = make_map<C::SW>(&a.k, p.k, p.B, p.Sk, p.Hk, D, p.k_sb, p.k_ss, p.k_sh, C::BK);
  if (e == cudaSuccess)
    e = make_map<C::SW>(&a.v, p.v, p.B, p.Sk, p.Hk, D, p.v_sb, p.v_ss, p.v_sh, C::BK);
  if (e == cudaSuccess) e = allow_smem(flash_fwd_tc_kernel<D>, C::kBytes, ready);
  if (e != cudaSuccess) return e;
  flash_fwd_tc_kernel<D><<<dim3(p.B * p.H, (p.Sq + C::BQ - 1) / C::BQ), C::NT, C::kBytes,
                           stream>>>(a);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd_tc<D>(p, stream);
  } else {
    static bool ready = false;
    const dim3 grid((p.Sq + Tile<D>::BM - 1) / Tile<D>::BM, p.B * p.H);
    return launch_one(flash_fwd_kernel<T, D>, kThreads, Tile<D>::kFwdBytes, ready, grid, p,
                      stream);
  }
}

template <int D>
cudaError_t launch_bwd_tc(const Params& p, cudaStream_t stream) {
  using KV = DkdvWG<D>;
  using Q = DqWG<D>;
  static bool ready_kv = false, ready_q = false;
  if (p.B == 0 || p.Sq == 0 || p.Sk == 0) return cudaGetLastError();
  BwdArgs a;
  a.p = p;
  // the dK/dV pass: K and V boxes of its keys, Q and dO boxes of its steps
  cudaError_t e = make_map<KV::SW>(&a.q, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, KV::BQ);
  if (e == cudaSuccess)
    e = make_map<KV::SW>(&a.dout, p.dout, p.B, p.Sq, p.H, D, p.do_sb, p.do_ss, p.do_sh, KV::BQ);
  if (e == cudaSuccess)
    e = make_map<KV::SW>(&a.k, p.k, p.B, p.Sk, p.Hk, D, p.k_sb, p.k_ss, p.k_sh, KV::BK);
  if (e == cudaSuccess)
    e = make_map<KV::SW>(&a.v, p.v, p.B, p.Sk, p.Hk, D, p.v_sb, p.v_ss, p.v_sh, KV::BK);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkdv_tc_kernel<D>, KV::kBytes, ready_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_tc_kernel<D><<<dim3(p.B * p.Hk, (p.Sk + KV::BK - 1) / KV::BK), KV::NT,
                                KV::kBytes, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the dQ pass: Q and dO boxes of its rows, K and V boxes of its steps
  e = make_map<Q::SW>(&a.q, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, Q::BQ);
  if (e == cudaSuccess)
    e = make_map<Q::SW>(&a.dout, p.dout, p.B, p.Sq, p.H, D, p.do_sb, p.do_ss, p.do_sh, Q::BQ);
  if (e == cudaSuccess)
    e = make_map<Q::SW>(&a.k, p.k, p.B, p.Sk, p.Hk, D, p.k_sb, p.k_ss, p.k_sh, Q::BK);
  if (e == cudaSuccess)
    e = make_map<Q::SW>(&a.v, p.v, p.B, p.Sk, p.Hk, D, p.v_sb, p.v_ss, p.v_sh, Q::BK);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_tc_kernel<D>, Q::kBytes, ready_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_tc_kernel<D><<<dim3(p.B * p.H, (p.Sq + Q::BQ - 1) / Q::BQ), Q::NT, Q::kBytes,
                              stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_bwd_tc<D>(p, stream);
  } else {
    static bool ready_kv = false, ready_q = false;
    constexpr int BM = Tile<D>::BM;
    const cudaError_t e = launch_one(flash_bwd_dkdv_kernel<T, D>, kThreads, Tile<D>::kDkdvBytes,
                                     ready_kv, dim3((p.Sk + BM - 1) / BM, p.B * p.Hk), p, stream);
    if (e != cudaSuccess) return e;
    return launch_one(flash_bwd_dq_kernel<T, D>, kThreads, Tile<D>::kDqBytes, ready_q,
                      dim3((p.Sq + BM - 1) / BM, p.B * p.H), p, stream);
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
    case kBFloat16: return dispatch<bf16>(p, D, backward, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
int attributes(int kernel, int* out) {
  if constexpr (std::is_same<T, bf16>::value) {
    switch (kernel) {
      case 0: return func_attributes(flash_fwd_tc_kernel<D>, FwdWG<D>::kBytes, out);
      case 1: return func_attributes(flash_bwd_dkdv_tc_kernel<D>, DkdvWG<D>::kBytes, out);
      case 2: return func_attributes(flash_bwd_dq_tc_kernel<D>, DqWG<D>::kBytes, out);
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
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  switch (dtype) {
    case kFloat32: return attributes_d<float>(kernel, a, out);
    case kBFloat16: return attributes_d<bf16>(kernel, a, out);
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
