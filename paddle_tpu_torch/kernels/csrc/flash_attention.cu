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
// Backward (bf16), two passes as in _flash_bwd_impl, deterministic (no atomics):
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
// fp32 inputs (ERNIE's attention, the parity path): CUDA-core kernels in
// exact fp32 with register-blocked tiles, float4 operands from padded
// shared tiles and cp.async loads overlapping the arithmetic; their backward
// does five products (a dK/dV pass that also forms each k-tile's share of
// dQ, then a fixed-order sum of the shares).  See the last part of this
// file.
// bf16 inputs: register-resident tensor-core kernels; see the second part.
#include <cuda.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernels' mask value

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

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernels in exact fp32.  Every product is an fp32 FMA
// (fmaf) on the CUDA cores: no TF32, no mma or wgmma, no float atomics.
//
// What bounds them: the card's fp32 rate (67 TFLOP/s, 128 FMAs a clock on an
// SM).  Behind it, shared memory serves one 128-byte wavefront a clock while
// the SM issues four warp-wide FFMAs, and a warp's FFMAs wait on its loads.
// So each product is register-blocked: a thread owns a block of the output
// (at D 64, 4 x 4 scores of S and 4 x 8 of O in the forward; 8 x 4 of S
// and dP, 4 x 8 each of dK and dV and 4 x 4 of the dQ share in the
// backward) and reads its operands as 16-byte float4, so a load feeds 8 to
// 16 FMAs, not 2.  Tiles are row-major with each row padded by one 16-byte
// chunk (at), in place of a one-float skew that would rule float4 out: the
// rows or the chunks a warp reads at once fall in distinct bank groups, and
// every operand's address is a base plus a constant.  Products read their
// operands in one of three orders (gemm_nt: both along the depth, S = Q K^T
// and dP = dO V^T; gemm_nn: A along the depth, B along its columns, O += P V
// and dS K; gemm_tn2: both along their columns, dV += P^T dO and dK += dS^T
// Q), each summing every output in a fixed order, with FLASH32_FWD_UNROLL
// (FLASH32_DKDV_UNROLL) steps of its loop unrolled so a step's loads are in
// flight under the last one's FMAs.
//
// Loads overlap the arithmetic: the tiles a CTA walks over (K and V in the
// forward, Q, dO, lse and delta in the backward) come by cp.async, as they
// are, into a ring of FLASH32_STAGES stages; a tile's loads are issued a
// stage ahead, right after the barrier that frees its stage, so they land
// while the current tile is multiplied.  Rows past
// the sequence are zero-filled by the copy and read nothing.
//
// Forward (flash_fwd_kernel): a CTA owns BQ query rows of one (batch,
// head), 8 warps of BQ / 8 rows; its Q tile stays in shared memory.  Per
// k-tile of BK keys: S = Q K^T in registers, the online softmax in base 2
// (the score scaled by scale * log2 e; a row's max across its lanes by
// shuffles, its sum kept per lane until the end), P into the warp's own
// rows of a [BQ][BK] tile (a __syncwarp, no CTA barrier), O += P V.  One
// CTA barrier a k-tile, for the ring.  At D 64: 128 rows, 32-key tiles, 88
// KB of shared memory and at most 128 registers, so two CTAs share an SM.
//
// Backward: five products, against seven for a dK/dV pass beside a dQ pass
// that recomputes S and dP.  flash_bwd_dkdv_kernel: a CTA owns BK keys of
// one (batch, kv-head), K and V resident, 8 warps of BK / 8 keys; it walks
// the group's query heads and the q-tiles from _causal_lo in steps of BQ
// rows.  Per step: S and dP for the warp's keys, P = exp2(s c - lse c) and
// dS = P (dP - delta) scale in registers, both into [BQ][BK] tiles, one
// barrier, then dV += P^T dO and dK += dS^T Q for the warp's keys (the group
// sum in the accumulators), and the step's share of dQ, dS K over the CTA's
// keys, stored to its slot of the dQ workspace.  At D 64: 128 keys, steps
// of 64 rows, 203 KB of shared memory, one CTA an SM.  flash_bwd_dq_kernel
// then forms dq = the slots' sum, slot by slot in k-tile order: a fixed
// order, so the result is the same bits on every launch.  The workspace
// holds FLASH32_DQ_SLOTS k-tiles' shares at most (ERNIE-base's B 32, S 512,
// H 12, D 64 uses 4, 50 MB each); a longer Sk runs the pair of launches
// once for each group of that many k-tiles, the later groups adding to dq,
// still in k-tile order.  The group count, ceil(k-tiles / FLASH32_DQ_SLOTS),
// is a function of the shape alone.  The slots of q-tiles a causal walk
// skips (before _causal_lo) are written as zeros.
// ---------------------------------------------------------------------------

constexpr int kWarps32 = 8;                    // warps of an fp32 CTA
constexpr int kThreads32 = 32 * kWarps32;
constexpr int kStages32 = FLASH32_STAGES;      // stages of a cp.async ring
constexpr int kDqSlots = FLASH32_DQ_SLOTS;     // k-tiles' dQ shares a workspace holds
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the mask value, base-2 exponent units

// element (r, c) of a [rows][W] fp32 tile whose rows are padded by one
// 16-byte chunk: row r starts r chunks further round the 32 banks, so eight
// consecutive rows read at one column fall in eight bank groups, a row's
// consecutive chunks do too, and a float4 at a column that is a multiple of
// 4 stays whole.  An operand's address is a base plus a constant offset
template <int W>
__device__ __forceinline__ int at(int r, int c) {
  static_assert(W % 32 == 0, "a row spans a multiple of the 32 banks");
  return r * (W + 4) + c;
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 16 (4) bytes from global `src` to shared `dst` by cp.async, zero-filled
// and nothing read when !live
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 of a [S, D] fp32 slab (row stride rs elements,
// rows 16-byte aligned) into a padded [ROWS][D] tile; rows at or past
// `rows` are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long rs, int r0,
                                           int rows) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % kThreads32 == 0, "tile split");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / kThreads32; ++n) {
    const int c = threadIdx.x + n * kThreads32;
    const int r = c / CPR, ch = c % CPR;
    const bool live = r0 + r < rows;
    cp_async16_zfill(dst + at<D>(r, 4 * ch), live ? src + (r0 + r) * rs + 4 * ch : src, live);
  }
}

// entries r0 .. r0 + ROWS - 1 of a row of statistics; past `rows`, 0
template <int ROWS>
__device__ __forceinline__ void stage_stats(float* dst, const float* src, int r0, int rows) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads32) {
    const bool live = r0 + i < rows;
    cp_async4_zfill(dst + i, live ? src + r0 + i : src, live);
  }
}

// s[i][j] += A[ra + LA i] . B[rb + LB j] over the D columns of two padded
// [rows][D] tiles: a step of 4 columns reads TM + TN float4 for 4 TM TN
// FMAs, holding the smaller side's float4 in registers; U steps unrolled
template <int D, int TM, int TN, int LA, int LB, int U>
__device__ __forceinline__ void gemm_nt(float (&s)[TM][TN], const float* A, const float* B,
                                        int ra, int rb) {
#pragma unroll (U)
  for (int c = 0; c < D; c += 4) {
    if constexpr (TM <= TN) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(A + at<D>(ra + LA * i, c));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = ld4(B + at<D>(rb + LB * j, c));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    } else {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(B + at<D>(rb + LB * j, c));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = ld4(A + at<D>(ra + LA * i, c));
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }
  }
}

// acc[i][4 t + e] += sum over k < K of A[ra + LA i][k] B[k][4 cb + 4 LB t +
// e]: A a padded [rows][K] tile (P, dS), B a padded [K][W] tile (V, K)
template <int K, int W, int TM, int TD, int LA, int LB, int U>
__device__ __forceinline__ void gemm_nn(float (&acc)[TM][TD], const float* A, const float* B,
                                        int ra, int cb) {
#pragma unroll (U)
  for (int k = 0; k < K; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(A + at<K>(ra + LA * i, k));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 b[TD / 4];
#pragma unroll
      for (int t = 0; t < TD / 4; ++t) b[t] = ld4(B + at<W>(k + e, 4 * cb + 4 * LB * t));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = lane_of(a[i], e);
#pragma unroll
        for (int t = 0; t < TD / 4; ++t) {
          acc[i][4 * t] = fmaf(x, b[t].x, acc[i][4 * t]);
          acc[i][4 * t + 1] = fmaf(x, b[t].y, acc[i][4 * t + 1]);
          acc[i][4 * t + 2] = fmaf(x, b[t].z, acc[i][4 * t + 2]);
          acc[i][4 * t + 3] = fmaf(x, b[t].w, acc[i][4 * t + 3]);
        }
      }
    }
  }
}

// dv[a][4 t + e] += sum over rows r < R of P[r][ka + a] dO[r][4 dg + 4 LD t
// + e], and dk likewise from dS and Q: P, dS padded [R][BK] tiles (ka a
// multiple of 4), dO, Q padded [R][D] tiles
template <int R, int BK, int D, int TD, int LD, int U>
__device__ __forceinline__ void gemm_tn2(float (&dv)[4][TD], float (&dk)[4][TD], const float* P,
                                         const float* dS, const float* dO, const float* Q,
                                         int ka, int dg) {
#pragma unroll (U)
  for (int r = 0; r < R; ++r) {
    const float4 pa = ld4(P + at<BK>(r, ka));
    const float4 da = ld4(dS + at<BK>(r, ka));
    float4 o[TD / 4], q[TD / 4];
#pragma unroll
    for (int t = 0; t < TD / 4; ++t) {
      o[t] = ld4(dO + at<D>(r, 4 * dg + 4 * LD * t));
      q[t] = ld4(Q + at<D>(r, 4 * dg + 4 * LD * t));
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x = lane_of(pa, a), y = lane_of(da, a);
#pragma unroll
      for (int t = 0; t < TD / 4; ++t) {
        dv[a][4 * t] = fmaf(x, o[t].x, dv[a][4 * t]);
        dv[a][4 * t + 1] = fmaf(x, o[t].y, dv[a][4 * t + 1]);
        dv[a][4 * t + 2] = fmaf(x, o[t].z, dv[a][4 * t + 2]);
        dv[a][4 * t + 3] = fmaf(x, o[t].w, dv[a][4 * t + 3]);
        dk[a][4 * t] = fmaf(y, q[t].x, dk[a][4 * t]);
        dk[a][4 * t + 1] = fmaf(y, q[t].y, dk[a][4 * t + 1]);
        dk[a][4 * t + 2] = fmaf(y, q[t].z, dk[a][4 * t + 2]);
        dk[a][4 * t + 3] = fmaf(y, q[t].w, dk[a][4 * t + 3]);
      }
    }
  }
}

// the forward's geometry at head dim D (-D defines from _build.GEOMETRY)
template <int D>
struct Fwd32 {
  static constexpr int BQ = per_d(D, FLASH32_FWD_Q_ROWS_D32, FLASH32_FWD_Q_ROWS_D64,
                                  FLASH32_FWD_Q_ROWS_D128, FLASH32_FWD_Q_ROWS_D256);
  static constexpr int BK = per_d(D, FLASH32_FWD_K_ROWS_D32, FLASH32_FWD_K_ROWS_D64,
                                  FLASH32_FWD_K_ROWS_D128, FLASH32_FWD_K_ROWS_D256);
  static constexpr int U = FLASH32_FWD_UNROLL;   // steps of a product's loop unrolled
  static constexpr int WQ = BQ / kWarps32;     // query rows of a warp
  static constexpr int LR = WQ >= 16 ? 4 : 2;  // its lanes along rows
  static constexpr int LC = 32 / LR;           // ... and along keys and head-dim columns
  static constexpr int TM = WQ / LR;           // rows of a thread
  static constexpr int TN = BK / LC;           // keys of a thread
  static constexpr int TD = D / LC;            // head-dim columns of a thread
  static constexpr int kQ = BQ * (D + 4), kKV = BK * (D + 4);   // floats of a padded tile
  // Q, the ring's K and V tiles, P
  static constexpr int kBytes = (kQ + 2 * kStages32 * kKV + BQ * (BK + 4)) * 4;
  // CTAs an SM, its registers budgeted for: two where two fit in the SM's
  // 228 KB of shared memory (each with the 1 KB the runtime keeps a CTA)
  static constexpr int CTAS = 2 * (kBytes + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(WQ % LR == 0 && BK % LC == 0 && TD % 4 == 0 && BK % 32 == 0 && kStages32 >= 2,
                "fp32 forward geometry");
};

// thread (warp w, lane) owns rows w WQ + lane / LC + LR i of the q-tile,
// keys lane % LC + LC j of each k-tile and head-dim columns 4 (lane % LC) +
// 4 LC t + e of O
template <int D>
__global__ void __launch_bounds__(kThreads32, Fwd32<D>::CTAS) flash_fwd_kernel(Params p) {
  using G = Fwd32<D>;
  constexpr int BQ = G::BQ, BK = G::BK, LR = G::LR, LC = G::LC;
  constexpr int TM = G::TM, TN = G::TN, TD = G::TD;
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);   // [BQ][D]
  float* ring = Qs + G::kQ;                          // stage s: K, then V, [BK][D] each
  float* Ps = ring + 2 * kStages32 * G::kKV;         // [BQ][BK], a warp its own rows
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * G::WQ + lane / LC;
  const int col = lane % LC;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.Hk);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + g * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + g * p.v_sh;
  const int nkt = kv_tiles(q0, BQ, BK, p);
  const int off = p.Sk - p.Sq;
  const float c2 = p.scale * kLog2e;   // a raw score to a base-2 exponent

  stage_rows<BQ, D>(Qs, q, p.q_ss, q0, p.Sq);   // lands with the first stage's group
#pragma unroll
  for (int s = 0; s < kStages32 - 1; ++s) {
    if (s < nkt) {
      stage_rows<BK, D>(ring + 2 * s * G::kKV, k, p.k_ss, s * BK, p.Sk);
      stage_rows<BK, D>(ring + (2 * s + 1) * G::kKV, v, p.v_ss, s * BK, p.Sk);
    }
    cp_async_commit();
  }

  float m[TM], l[TM], acc[TM][TD];   // m in base-2 units; l this lane's share
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf2;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < TD; ++d) acc[i][d] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages32 - 2>();   // this thread's copies of tile kt have landed
    __syncthreads();                   // ... every thread's; tile kt - 1's stage is free
    {
      const int nt = kt + kStages32 - 1;
      if (nt < nkt) {
        float* st = ring + 2 * (nt % kStages32) * G::kKV;
        stage_rows<BK, D>(st, k, p.k_ss, nt * BK, p.Sk);
        stage_rows<BK, D>(st + G::kKV, v, p.v_ss, nt * BK, p.Sk);
      }
      cp_async_commit();
    }
    const float* Ks = ring + 2 * (kt % kStages32) * G::kKV;
    const float* Vs = Ks + G::kKV;
    const int k0 = kt * BK;
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    gemm_nt<D, TM, TN, LR, LC, G::U>(s, Qs, Ks, row0, col);

    // a pair of the tile is masked: keys past Sk, or above the diagonal
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + row0 + LR * i;
      float mx = kNegInf2;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float t = s[i][j] * c2;
        if (edge) {
          const int kc = k0 + col + LC * j;
          t = kc >= p.Sk ? -INFINITY : (p.causal && kc > qr + off ? kNegInf2 : t);
        }
        s[i][j] = t;
        mx = fmaxf(mx, t);
      }
#pragma unroll
      for (int o = LC / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pj = exp2f(s[i][j] - m_new);
        rs += pj;
        Ps[at<BK>(row0 + LR * i, col + LC * j)] = pj;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < TD; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();   // the warp's P rows are written
    gemm_nn<BK, D, TM, TD, LR, LC, G::U>(acc, Ps, Vs, row0, col);
  }
  cp_async_wait<0>();   // no copy outlives the CTA (the empty groups, Q when nkt is 0)

  float lsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    lsum[i] = l[i];
#pragma unroll
    for (int o = LC / 2; o > 0; o >>= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], o);
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + row0 + LR * i;
    if (qr >= p.Sq) continue;
    const float l_safe = fmaxf(lsum[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * p.Sq + qr) * p.H + h) * D;
#pragma unroll
    for (int t = 0; t < TD / 4; ++t)
      *reinterpret_cast<float4*>(orow + 4 * col + 4 * LC * t) =
          make_float4(acc[i][4 * t] / l_safe, acc[i][4 * t + 1] / l_safe,
                      acc[i][4 * t + 2] / l_safe, acc[i][4 * t + 3] / l_safe);
    if (col == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qr] = m[i] * kLn2 + logf(l_safe);
  }
}

// the backward's geometry at head dim D
template <int D>
struct Bwd32 {
  static constexpr int BK = per_d(D, FLASH32_DKDV_K_ROWS_D32, FLASH32_DKDV_K_ROWS_D64,
                                  FLASH32_DKDV_K_ROWS_D128, FLASH32_DKDV_K_ROWS_D256);
  static constexpr int BQ = per_d(D, FLASH32_DKDV_Q_ROWS_D32, FLASH32_DKDV_Q_ROWS_D64,
                                  FLASH32_DKDV_Q_ROWS_D128, FLASH32_DKDV_Q_ROWS_D256);
  static constexpr int U = FLASH32_DKDV_UNROLL;   // steps of a product's loop unrolled
  static constexpr int WK = BK / kWarps32;     // keys of a warp, 4 a lane
  static constexpr int LK = WK / 4;           // the warp's lanes along keys
  // S and dP: [BQ] rows x the warp's keys, LQ lanes along rows, TQ rows a lane
  static constexpr int LQ = 32 / LK, TQ = BQ / LQ;
  // dK and dV: the warp's keys x D, LD lanes along columns, TD columns a lane
  static constexpr int LD = 32 / LK, TD = D / LD;
  // the step's dQ share: BQ / 8 rows a warp x D, LQ3 lanes along rows, LD3
  // along columns
  static constexpr int LD3 = D >= 256 ? 32 : (D / 4 < 16 ? D / 4 : 16);
  static constexpr int LQ3 = 32 / LD3, TQ3 = BQ / kWarps32 / LQ3, TD3 = D / LD3;
  static constexpr int kQ = BQ * (D + 4), kKV = BK * (D + 4), kP = BQ * (BK + 4);
  static constexpr int kStage = 2 * kQ + 2 * BQ;   // Q, dO, lse, delta
  // K, V, the ring, P, dS
  static constexpr int kBytes = (2 * kKV + kStages32 * kStage + 2 * kP) * 4;
  static_assert(WK % 4 == 0 && 32 % LK == 0 && BQ % LQ == 0 && TD % 4 == 0 && TQ3 >= 1 &&
                    TD3 % 4 == 0 && BK % 32 == 0 && BQ % 4 == 0 && kStages32 >= 2,
                "fp32 backward geometry");
};

// the tiles of one backward step (query head h, rows q0 ..) into a stage
template <int D, int BQ>
__device__ __forceinline__ void stage_step(float* st, const Params& p, int b, int h, int q0) {
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.Sq;
  constexpr int kQ = BQ * (D + 4);
  stage_rows<BQ, D>(st, q, p.q_ss, q0, p.Sq);
  stage_rows<BQ, D>(st + kQ, dout, p.do_ss, q0, p.Sq);
  stage_stats<BQ>(st + 2 * kQ, p.lse + row, q0, p.Sq);
  stage_stats<BQ>(st + 2 * kQ + BQ, p.delta + row, q0, p.Sq);
}

// a CTA per (k-tile kt0 + blockIdx.x, batch x kv-head).  Its steps walk the
// group's heads r and the q-tiles lo .. n_q - 1.  Lanes: S and dP at rows
// qg + LQ i and keys wk0 + kg + LK c; dK and dV at keys wk0 + 4 kg2 + a
// and columns 4 dg + 4 LD t + e; the dQ share at rows w BQ / 8 + qg3 + LQ3
// i and columns 4 dg3 + 4 LD3 t + e.  A row past Sq is zero in Q, dO, lse
// and delta, so its P is 1 or 0 and every product it enters adds 0.
template <int D>
__global__ void __launch_bounds__(kThreads32, 1)
    flash_bwd_dkdv_kernel(Params p, float* dq_work, int kt0) {
  using G = Bwd32<D>;
  constexpr int BK = G::BK, BQ = G::BQ, LK = G::LK, LQ = G::LQ, TQ = G::TQ;
  constexpr int LD = G::LD, TD = G::TD, LQ3 = G::LQ3, LD3 = G::LD3;
  extern __shared__ float4 smem_f32[];
  float* Ks = reinterpret_cast<float*>(smem_f32);   // [BK][D]
  float* Vs = Ks + G::kKV;
  float* ring = Vs + G::kKV;                         // stages of Q, dO [BQ][D], lse, delta [BQ]
  float* Ps = ring + kStages32 * G::kStage;          // [BQ][BK]
  float* dSs = Ps + G::kP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk0 = warp * G::WK;
  const int qg = lane / LK, kg = lane % LK;
  const int kg2 = lane / LD, dg = lane % LD;
  const int qg3 = lane / LD3, dg3 = lane % LD3;
  const int slot = blockIdx.x;
  const int k0 = (kt0 + slot) * BK;
  const int b = blockIdx.y / p.Hk;
  const int g = blockIdx.y % p.Hk;
  const int rep = p.H / p.Hk;
  const int off = p.Sk - p.Sq;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + g * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + g * p.v_sh;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int lo = p.causal && off >= 0 ? max(k0 - off, 0) / BQ : 0;   // _causal_lo
  const int walk = n_q - lo;
  const int steps = rep * walk;
  const float c2 = p.scale * kLog2e;

  stage_rows<BK, D>(Ks, k, p.k_ss, k0, p.Sk);   // land with the first stage's group
  stage_rows<BK, D>(Vs, v, p.v_ss, k0, p.Sk);
#pragma unroll
  for (int s = 0; s < kStages32 - 1; ++s) {
    if (s < steps) stage_step<D, BQ>(ring + s * G::kStage, p, b, g * rep + s / walk,
                                     (lo + s % walk) * BQ);
    cp_async_commit();
  }

  float dk[4][TD], dv[4][TD];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < TD; ++d) dk[a][d] = dv[a][d] = 0.f;

  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kStages32 - 2>();
    __syncthreads();   // step st's stage has landed; step st - 1's P, dS and stage are free
    {
      const int nx = st + kStages32 - 1;
      if (nx < steps)
        stage_step<D, BQ>(ring + (nx % kStages32) * G::kStage, p, b, g * rep + nx / walk,
                          (lo + nx % walk) * BQ);
      cp_async_commit();
    }
    const int h = g * rep + st / walk;
    const int q0 = (lo + st % walk) * BQ;
    const float* Qs = ring + (st % kStages32) * G::kStage;
    const float* dOs = Qs + G::kQ;
    const float* lse_s = dOs + G::kQ;
    const float* delta_s = lse_s + BQ;
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + off);

    float pr[TQ][4], dp[TQ][4];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pr[i][c] = dp[i][c] = 0.f;
    gemm_nt<D, TQ, 4, LQ, LK, G::U>(pr, Qs, Ks, qg, wk0 + kg);
    gemm_nt<D, TQ, 4, LQ, LK, G::U>(dp, dOs, Vs, qg, wk0 + kg);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = qg + LQ * i;
      const int qr = q0 + r;
      const float lse2 = lse_s[r] * kLog2e;
      const float dl = delta_s[r];
      const bool blind = sees_no_key(qr, p);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = wk0 + kg + LK * c;
        const int kc = k0 + kk;
        float x = exp2f(fmaf(pr[i][c], c2, -lse2));
        if (edge && (kc >= p.Sk || (p.causal && kc > qr + off))) x = 0.f;
        if (blind) x = kc < p.Sk ? 1.f / p.Sk : 0.f;
        Ps[at<BK>(r, kk)] = x;
        dSs[at<BK>(r, kk)] = blind ? 0.f : x * (dp[i][c] - dl) * p.scale;
      }
    }
    __syncthreads();   // P and dS of every warp's keys
    gemm_tn2<BQ, BK, D, TD, LD, G::U>(dv, dk, Ps, dSs, dOs, Qs, wk0 + 4 * kg2, dg);

    // the step's share of dQ over the CTA's keys, into the workspace slot
    float dq[G::TQ3][G::TD3];
#pragma unroll
    for (int i = 0; i < G::TQ3; ++i)
#pragma unroll
      for (int d = 0; d < G::TD3; ++d) dq[i][d] = 0.f;
    const int rq = warp * (BQ / kWarps32) + qg3;
    gemm_nn<BK, D, G::TQ3, G::TD3, LQ3, LD3, G::U>(dq, dSs, Ks, rq, dg3);
#pragma unroll
    for (int i = 0; i < G::TQ3; ++i) {
      const int qr = q0 + rq + LQ3 * i;
      if (qr >= p.Sq) continue;
      float* row = dq_work + (((static_cast<long long>(slot) * p.B + b) * p.Sq + qr) * p.H + h) * D;
#pragma unroll
      for (int t = 0; t < G::TD3 / 4; ++t)
        *reinterpret_cast<float4*>(row + 4 * dg3 + 4 * LD3 * t) =
            make_float4(dq[i][4 * t], dq[i][4 * t + 1], dq[i][4 * t + 2], dq[i][4 * t + 3]);
    }
  }
  cp_async_wait<0>();   // no copy outlives the CTA

  // the slot's rows of the q-tiles the walk skipped hold no share
  if (lo > 0) {
    const int rows = min(lo * BQ, p.Sq);
    const long long per_head = static_cast<long long>(rows) * (D / 4);
    for (long long x = threadIdx.x; x < rep * per_head; x += kThreads32) {
      const int r = static_cast<int>(x / per_head);
      const int qr = static_cast<int>(x % per_head / (D / 4));
      const int c4 = static_cast<int>(x % (D / 4));
      float* row = dq_work +
                   (((static_cast<long long>(slot) * p.B + b) * p.Sq + qr) * p.H + g * rep + r) * D;
      *reinterpret_cast<float4*>(row + 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kr = k0 + wk0 + 4 * kg2 + a;
    if (kr >= p.Sk) continue;
    const long long row = ((static_cast<long long>(b) * p.Sk + kr) * p.Hk + g) * D;
#pragma unroll
    for (int t = 0; t < TD / 4; ++t) {
      const int c = 4 * dg + 4 * LD * t;
      *reinterpret_cast<float4*>(dkp + row + c) =
          make_float4(dk[a][4 * t], dk[a][4 * t + 1], dk[a][4 * t + 2], dk[a][4 * t + 3]);
      *reinterpret_cast<float4*>(dvp + row + c) =
          make_float4(dv[a][4 * t], dv[a][4 * t + 1], dv[a][4 * t + 2], dv[a][4 * t + 3]);
    }
  }
}

constexpr int kDqThreads = FLASH32_DQ_THREADS;   // a dQ CTA's threads, a float4 each

// dq = (add ? dq : 0) + the workspace's `slots` shares, slot by slot: n4
// float4 of dq, slot s at work + 4 s n4
__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_kernel(float* dq, const float* work, long long n4, int slots, int add) {
  const long long i = static_cast<long long>(blockIdx.x) * kDqThreads + threadIdx.x;
  if (i >= n4) return;
  const float4* w = reinterpret_cast<const float4*>(work);
  float4* out = reinterpret_cast<float4*>(dq);
  float4 a = add ? out[i] : w[i];
  for (int s = add ? 0 : 1; s < slots; ++s) {
    const float4 x = w[s * n4 + i];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  out[i] = a;
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
// bytes of columns, SW-byte padded; rows past S read as 0
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
    using G = Fwd32<D>;
    static bool ready = false;
    return launch_one(flash_fwd_kernel<D>, kThreads32, G::kBytes, ready,
                      dim3((p.Sq + G::BQ - 1) / G::BQ, p.B * p.H), p, stream);
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

// fp32: for each group of up to kDqSlots k-tiles, the dK/dV pass (which
// writes the group's dQ shares into `work`, a slot a k-tile) and then the dQ
// sum over the group's slots, the later groups adding to dq; with no key, dq
// is 0
template <int D>
cudaError_t launch_bwd_f32(const Params& p, float* work, cudaStream_t stream) {
  using G = Bwd32<D>;
  static bool ready = false;
  if (p.B == 0 || p.H == 0) return cudaGetLastError();
  const long long n4 = static_cast<long long>(p.B) * p.Sq * p.H * D / 4;   // dq's float4
  const int n_kt = (p.Sk + G::BK - 1) / G::BK;
  if (n_kt == 0) return cudaMemsetAsync(p.out, 0, n4 * 16, stream);
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<D>, G::kBytes, ready);
  if (e != cudaSuccess) return e;
  for (int kt0 = 0; kt0 < n_kt; kt0 += kDqSlots) {
    const int slots = n_kt - kt0 < kDqSlots ? n_kt - kt0 : kDqSlots;
    flash_bwd_dkdv_kernel<D><<<dim3(slots, p.B * p.Hk), kThreads32, G::kBytes, stream>>>(
        p, work, kt0);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (n4 > 0) {
      flash_bwd_dq_kernel<<<static_cast<unsigned>((n4 + kDqThreads - 1) / kDqThreads),
                            kDqThreads, 0, stream>>>(static_cast<float*>(p.out), work, n4, slots,
                                                     kt0 > 0);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_bwd(const Params& p, float* work, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_bwd_tc<D>(p, stream);
  } else {
    return launch_bwd_f32<D>(p, work, stream);
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, bool backward, float* work, cudaStream_t s) {
  switch (D) {
    case 32: return backward ? launch_bwd<T, 32>(p, work, s) : launch_fwd<T, 32>(p, s);
    case 64: return backward ? launch_bwd<T, 64>(p, work, s) : launch_fwd<T, 64>(p, s);
    case 128: return backward ? launch_bwd<T, 128>(p, work, s) : launch_fwd<T, 128>(p, s);
    case 256: return backward ? launch_bwd<T, 256>(p, work, s) : launch_fwd<T, 256>(p, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run(Params& p, const long long* strides, int n_strides, int D, int dtype,
                bool backward, float* work, void* stream) {
  if (p.Hk <= 0 || p.H % p.Hk != 0 || p.Sq < 0 || p.Sk < 0 || p.B < 0)
    return cudaErrorInvalidValue;
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.do_sb, &p.do_ss, &p.do_sh};
  for (int i = 0; i < n_strides; ++i) *dst[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch<float>(p, D, backward, work, s);
    case kBFloat16: return dispatch<bf16>(p, D, backward, work, s);
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
      case 0: return func_attributes(flash_fwd_kernel<D>, Fwd32<D>::kBytes, out);
      case 1: return func_attributes(flash_bwd_dkdv_kernel<D>, Bwd32<D>::kBytes, out);
      case 2: return func_attributes(flash_bwd_dq_kernel, 0, out);
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
// kernels for bf16; for fp32 the CUDA-core ones, the dQ pass being the sum
// of the dK/dV pass's dQ shares); <dtype, a = D>
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
  return run(p, strides, 9, D, dtype, false, nullptr, stream);
}

// The two backward passes.  q, k, v and dout through `strides` (12 values:
// q, k, v, dout); lse and delta [B, H, Sq] fp32.  Writes dq [B, Sq, H, D],
// dk and dv [B, Sk, Hk, D], all contiguous and of q's dtype.  fp32 also
// takes `work`, fp32 [min(k-tiles, FLASH32_DQ_SLOTS), B, Sq, H, D] for the
// dQ shares (the k-tiles of FLASH32_DKDV_K_ROWS keys); bf16 ignores it.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, void* dk, void* dv,
                                          void* work, const long long* strides, int B, int H,
                                          int Hk, int Sq, int Sk, int D, int causal,
                                          float scale, int dtype, void* stream) {
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
  return run(p, strides, 12, D, dtype, true, static_cast<float*>(work), stream);
}

DEFINE_ERROR_STRING
