// Chunked SSD scan for Hopper: the backward.
//
// The JAX package takes the VJP of its plain scan (paddle_tpu/kernels/
// ssd_scan.py:226 _ssd_scan_diff_bwd, jax.vjp of ssd_scan_reference, which
// XLA compiles into one program); this is the same VJP in closed form.  Per
// chunk k, with S_k the state entering it (saved by the forward), cum the
// chunk's inclusive log-decay sums, e_t = exp(cum_t), w_s = exp(cum_{L-1} -
// cum_s), a_k = exp(cum_{L-1}), M and C B^T as in the forward, and G_{k+1}
// the gradient of the state leaving the chunk (G_nc = ds):
//
//   G_k   = a_k G_{k+1} + C^T (e . dy)               (the reverse state pass)
//   dx    = M^T dy + (B . w) G_{k+1}
//   dCB   = mask(s <= t) . (dy x^T) . exp(cum_t - cum_s)
//   dC    = dCB B + e . (dy S_k^T)
//   dB    = dCB^T C + w . (x G_{k+1}^T)
//   dcum  = rowsum(C . dC) - rowsum(B . dB)
//           + [t = L-1] (sum B . w . (x G_{k+1}^T) + a_k sum G_{k+1} . S_k)
//   dla   = the reverse cumulative sum of dcum inside the chunk
//
// (the rows of dM . M that move cum_t and cum_s are C . (dCB B) and B .
// (dCB^T C), so no [L, L] product of dcum is formed; the pairs of terms in
// dcum that cancel exactly, dCB's diagonal and row L-1's w term, are left
// out of it, see ssd_dcb_kernel).  The backward's prefix sums run in fp64
// (ssd_tile.cuh chunk_cumsum).  Inputs x, b, c [G,
// T, ...], la [G, T], states [G, nc + 1, N, P], dy [G, T, P], ds [G, N, P];
// outputs dx, db, dc, dla; fp32, contiguous.
//
// Bound.  A chunk needs 3 L (L + 1) N (C B^T for M, dCB B, dCB^T C) + 2 L (L
// + 1) P (M^T dy, dy x^T) + 8 L N P (C^T (e dy), (B w) G, dy S^T, x G^T)
// flops; the bytes are the inputs and outputs once each, the saved states
// included.  At the 8B widths (L 128, N 128, P 64): ~58 flops a byte, held
// by operations on the CUDA cores and, at three TF32 products a product,
// about balanced on the tensor cores.
//
// Design: the forward's three phases in reverse, four launches:
//   (a) ssd::chunk_state_kernel<false>, one CTA a (g, chunk, column block):
//       Q_k = (C . e)^T dy into states_grad[k], and tot_k = cum_{L-1};
//   (b) ssd::state_pass_kernel<true>: G_nc = ds, G_k = exp(tot_k) G_{k+1} +
//       Q_k in place, sequential over chunks, parallel over the state;
//   (c1) ssd::chunk_apply_kernel<true>, one CTA a (g, chunk, column
//       block): C B^T and M in the CTA, dx = M^T dy + w . (B G_{k+1}), the
//       forward's chunk-scan kernel with the operands of the backward;
//   (c2) ssd_dcb_kernel, one CTA a (g, chunk): dy x^T over P in column
//       blocks of PB (dy and x tiles streamed; at P = PB they stay), dCB
//       into shared memory once; then N in blocks of NB columns, in turn:
//       dy S_k^T and x G_{k+1}^T for the block's columns, dC = dCB B + e
//       (dy S^T) and dB = dCB^T C + w (x G^T), and the block's share of
//       dcum by row, summed in shared memory; last, the chunk-end terms and
//       dla, dcum's reverse prefix sum, by one warp.
// Every product is split TF32 on the tensor cores (ssd_tile.cuh), and every
// sum runs in one fixed order (no atomics): two runs give the same bits.
// (c2) computes dCB once a chunk, not once an N block: its [L, L] product
// and the dy and x tiles are the kernel's largest work and traffic.
#include "ssd_tile.cuh"

using namespace ssd;

#ifndef SSD_BWD_NB
#define SSD_BWD_NB 32
#endif

namespace {

constexpr int kNB = SSD_BWD_NB;   // state columns a CTA of (c2)
// (c2)'s [L, NB] products hold one 32 x 16 unit a warp (Acc<1>): at chunk
// 128 that is 4 row units times NB / 16 column units, at most kWarps; NB is
// a whole number of n8 tiles and, N being a power of two, one too
static_assert(kNB >= 8 && kNB % 8 == 0 && (kNB & (kNB - 1)) == 0 &&
                  (128 / kUnitRows) * ((kNB + kUnitCols - 1) / kUnitCols) <= kWarps,
              "SSD_BWD_NB must be 8, 16 or 32");

// (c2): dCB [L][ld(L)]; the dy and x column blocks [L][ld(PB)]; S_k's and
// G_{k+1}'s rows of an N block, one column block [NB][ld(PB)]; B's and C's
// columns of the N block [L][ldk(NB)]; cum [L] in fp64; e, w [L]; dCB's
// diagonal [L]; an N block's per-row shares of the dC and dB row sums and
// of the chunk-end w term, one a 16-column unit [L][NB / 16]; dcum and the
// w terms by row, summed over the N blocks [L] each; a warp's partial of
// G . S [kWarps]
struct DcbLayout {
  int L, NB, PB;
  __host__ __device__ int ncu() const { return cdiv(NB, kUnitCols); }
  __host__ __device__ int dcb() const { return 0; }
  __host__ __device__ int dys() const { return L * ld(L); }
  __host__ __device__ int xs() const { return dys() + L * ld(PB); }
  __host__ __device__ int sc() const { return xs() + L * ld(PB); }
  __host__ __device__ int gc() const { return sc() + NB * ld(PB); }
  __host__ __device__ int bn() const { return gc() + NB * ld(PB); }
  __host__ __device__ int cn() const { return bn() + L * ldk(NB); }
  __host__ __device__ int cum() const { return cn() + L * ldk(NB); }
  __host__ __device__ int ev() const { return cum() + 2 * L; }
  __host__ __device__ int wv() const { return ev() + L; }
  __host__ __device__ int dg() const { return wv() + L; }
  __host__ __device__ int partc() const { return dg() + L; }
  __host__ __device__ int partb() const { return partc() + L * ncu(); }
  __host__ __device__ int partw() const { return partb() + L * ncu(); }
  __host__ __device__ int dcum() const { return partw() + L * ncu(); }
  __host__ __device__ int wrow() const { return dcum() + L; }
  __host__ __device__ int red() const { return wrow() + L; }
  __host__ __device__ int floats() const { return red() + kWarps; }
  __host__ __device__ size_t bytes() const { return sizeof(float) * floats(); }
};

__host__ __device__ inline int nblock(int N) { return min(npad(N), kNB); }

// the sum of this warp's unit row values over its 16 columns: lanes t = 0..3
// of a row hold 2 columns each of two n8 tiles
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the row shares of f(row, col, u, i, j, q) over each unit's 16 columns,
// stored at part[row * ncu + c0 / 16] (one writer each)
template <int U, class F>
__device__ __forceinline__ void unit_row_sums(const Units& un, float* part, int ncu, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int r0, c0;
    if (!un.get(warp + kWarps * u, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + g + 8 * h;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * j + 2 * t + e;
            if (row < un.R && col < un.C) v += f(row, col, u, i, j, 2 * h + e);
          }
        v = quad_sum(v);
        if (t == 0 && row < un.R) part[row * ncu + c0 / kUnitCols] = v;
      }
  }
}

// dCB's diagonal is kept apart (dg) and left out of the tile: its share of
// dcum_t comes in with + (C . dC) and - (B . dB) and cancels exactly, so
// neither row sum takes it; dC and dB add it back as dg_t B_t and dg_s C_s.
// Likewise row L-1's w term, whose pair (- at row L-1, + at the chunk's
// end) cancels exactly.  At a log-decay near -20 a token the true dcum is
// ~1e-7 against diagonal terms of ~100: formed and subtracted, they would
// leave fp32 rounding of the large terms where the small ones should be.
template <bool K2>
__global__ void __launch_bounds__(kThreads)
ssd_dcb_kernel(const float* __restrict__ x, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ la,
               const float* __restrict__ states, const float* __restrict__ gstates,
               const float* __restrict__ dy, float* __restrict__ db, float* __restrict__ dc,
               float* __restrict__ dla, int T, int P, int N, int L, int PB) {
  extern __shared__ float4 smem4[];
  const int NB = nblock(N);
  const DcbLayout lay{L, NB, PB};
  const int ncu = lay.ncu();
  float* sm = reinterpret_cast<float*>(smem4);
  float* dcb = sm + lay.dcb();
  float* dys = sm + lay.dys();
  float* xs = sm + lay.xs();
  float* sc = sm + lay.sc();
  float* gc = sm + lay.gc();
  float* bn = sm + lay.bn();
  float* cn = sm + lay.cn();
  double* cum = reinterpret_cast<double*>(sm + lay.cum());
  float* ev = sm + lay.ev();
  float* wv = sm + lay.wv();
  float* dg = sm + lay.dg();
  float* partc = sm + lay.partc();
  float* partb = sm + lay.partb();
  float* partw = sm + lay.partw();
  float* dcum = sm + lay.dcum();
  float* wrow = sm + lay.wrow();
  float* red = sm + lay.red();
  const int nc = T / L;
  const int g = blockIdx.x / nc, k = blockIdx.x % nc;
  const size_t t0 = static_cast<size_t>(g) * T + static_cast<size_t>(k) * L;
  const size_t s_in = (static_cast<size_t>(g) * (nc + 1) + k) * N * P;   // S_k
  const size_t g_out = s_in + static_cast<size_t>(N) * P;                // G_{k+1}
  const bool resident = P == PB;   // the dy and x tiles stay from the dM sweep

  if (threadIdx.x < 32) chunk_cumsum(la + t0, cum, L, threadIdx.x);
  __syncthreads();
  for (int s = threadIdx.x; s < L; s += kThreads) {
    ev[s] = expf(static_cast<float>(cum[s]));
    wv[s] = expf(static_cast<float>(cum[L - 1] - cum[s]));
    dcum[s] = 0.f;
    wrow[s] = 0.f;
  }

  // dM = dy x^T, summed over P's column blocks; then dCB without its
  // diagonal, the diagonal apart
  const Units tri{L, L, true};
  {
    Acc<3> dm;
    zero_acc<3>(dm);
    for (int q0 = 0; q0 < P; q0 += PB) {
      load_tile(dys, ld(PB), dy + t0 * P + q0, P, L, PB);
      load_tile(xs, ld(PB), x + t0 * P + q0, P, L, PB);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_units<3, K2>(dm, tri, View{dys, ld(PB), 1}, View{xs, 1, ld(PB)}, KAll{PB});
      __syncthreads();   // the next column block overwrites the tiles
    }
    for_each_acc<3>(tri, [&](int t, int s, int u, int i, int j, int q) {
      const float v = dm[u][i][j][q];
      if (s == t) dg[t] = v;                     // exp(0) = 1
      dcb[t * ld(L) + s] = s < t ? v * expf(static_cast<float>(cum[t] - cum[s])) : 0.f;
    });
  }

  // the N blocks in turn: dC, dB of its columns and its shares of dcum
  const Units un{L, NB, false};
  float gsum = 0.f;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const int nw = min(NB, N - n0);            // real columns of the block (N 4: 4 of 8)
    load_tile(bn, ldk(NB), b + t0 * N + n0, N, L, nw);
    load_tile(cn, ldk(NB), c + t0 * N + n0, N, L, nw);
    cp_async_commit();
    zero_tile(bn, ldk(NB), 0, L, nw, NB);
    zero_tile(cn, ldk(NB), 0, L, nw, NB);
    // dy S_k^T and x G_{k+1}^T for the block's columns, and G_{k+1} . S_k
    Acc<1> dys_acc, xg_acc;
    zero_acc<1>(dys_acc);
    zero_acc<1>(xg_acc);
    for (int q0 = 0; q0 < P; q0 += PB) {
      if (!resident) {
        load_tile(dys, ld(PB), dy + t0 * P + q0, P, L, PB);
        load_tile(xs, ld(PB), x + t0 * P + q0, P, L, PB);
      }
      load_tile(sc, ld(PB), states + s_in + static_cast<size_t>(n0) * P + q0, P, nw, PB);
      load_tile(gc, ld(PB), gstates + g_out + static_cast<size_t>(n0) * P + q0, P, nw, PB);
      cp_async_commit();
      zero_tile(sc, ld(PB), nw, NB, 0, PB);
      zero_tile(gc, ld(PB), nw, NB, 0, PB);
      cp_async_wait<0>();
      __syncthreads();
      mma_units<1, K2>(dys_acc, un, View{dys, ld(PB), 1}, View{sc, 1, ld(PB)}, KAll{PB});
      mma_units<1, K2>(xg_acc, un, View{xs, ld(PB), 1}, View{gc, 1, ld(PB)}, KAll{PB});
      const int sh = log2i(PB);
      for (int i = threadIdx.x; i < NB << sh; i += kThreads) {
        const int o = (i >> sh) * ld(PB) + (i & (PB - 1));
        gsum = fmaf(gc[o], sc[o], gsum);
      }
      __syncthreads();   // the next column block overwrites the tiles
    }

    // dC = dCB B + dg B + e (dy S_k^T); its rows' C . (dCB B + e dy S^T)
    {
      Acc<1> acc;
      zero_acc<1>(acc);
      mma_units<1, K2>(acc, un, View{dcb, ld(L), 1}, View{bn, ldk(NB), 1}, KUpTo{L});
      for_each_acc<1>(un, [&](int t, int n, int u, int i, int j, int q) {
        acc[u][i][j][q] += ev[t] * dys_acc[u][i][j][q];
      });
      unit_row_sums<1>(un, partc, ncu, [&](int t, int n, int u, int i, int j, int q) {
        return cn[t * ldk(NB) + n] * acc[u][i][j][q];
      });
      for_each_acc<1>(un, [&](int t, int n, int u, int i, int j, int q) {
        if (n < nw) dc[(t0 + t) * N + n0 + n] = acc[u][i][j][q] + dg[t] * bn[t * ldk(NB) + n];
      });
    }
    // dB = dCB^T C + dg C + w (x G_{k+1}^T); its rows' B . dCB^T C and
    // the w term B . w (x G^T)
    {
      Acc<1> acc;
      zero_acc<1>(acc);
      mma_units<1, K2>(acc, un, View{dcb, 1, ld(L)}, View{cn, ldk(NB), 1}, KFrom{L});
      for_each_acc<1>(un, [&](int s, int n, int u, int i, int j, int q) {
        xg_acc[u][i][j][q] *= wv[s];
      });
      unit_row_sums<1>(un, partb, ncu, [&](int s, int n, int u, int i, int j, int q) {
        return bn[s * ldk(NB) + n] * acc[u][i][j][q];
      });
      unit_row_sums<1>(un, partw, ncu, [&](int s, int n, int u, int i, int j, int q) {
        return bn[s * ldk(NB) + n] * xg_acc[u][i][j][q];
      });
      for_each_acc<1>(un, [&](int s, int n, int u, int i, int j, int q) {
        if (n < nw)
          db[(t0 + s) * N + n0 + n] =
              acc[u][i][j][q] + dg[s] * cn[s * ldk(NB) + n] + xg_acc[u][i][j][q];
      });
    }
    __syncthreads();
    // the block's share of dcum by row (row L-1 without its w term, which
    // goes to the chunk-end terms with the w terms of rows 0 .. L-2)
    for (int r = threadIdx.x; r < L; r += kThreads) {
      float sc_ = 0.f, sb = 0.f, sw = 0.f;
      for (int u = 0; u < ncu; ++u) {
        sc_ += partc[r * ncu + u];
        sb += partb[r * ncu + u];
        sw += partw[r * ncu + u];
      }
      const bool last = r == L - 1;
      dcum[r] += last ? sc_ - sb : (sc_ - sb) - sw;
      if (!last) wrow[r] += sw;
    }
    __syncthreads();   // the next block overwrites B's and C's columns and the shares
  }

  // the chunk-end terms: the w terms and a . sum G S; then dla, the reverse
  // prefix sum of dcum, by warp 0: lane l holds ceil(L / 32) consecutive t,
  // sums them from its last and adds the lanes above by a warp scan
  gsum = warp_sum(gsum);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = gsum;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v = 0.f;
    for (int r = lane; r < L; r += 32) v += wrow[r];
    v = warp_sum(v);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[w];
    const float end = v + expf(static_cast<float>(cum[L - 1])) * a;
    const int E = cdiv(L, 32);
    float e4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * E + e;
      e4[e] = e < E && t < L ? dcum[t] + (t == L - 1 ? end : 0.f) : 0.f;
    }
    float run = 0.f;   // the lane's own entries, summed from its last
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      run += e4[e];
      e4[e] = run;
    }
    float incl = run;  // the lanes at and above, summed
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += u;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * E + e;
      if (e < E && t < L) dla[t0 + t] = after + e4[e];
    }
  }
}

}  // namespace

// kernel 0: chunk_state_kernel (backward), 1: state_pass_kernel (reverse),
// 2: chunk_apply_kernel (backward: dx), 3: ssd_dcb_kernel, each at <a =
// column block PB, b = N, c = L>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (!shape_ok(b, c) || (a != 8 && a != 32 && a != 64)) return cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
      return func_attributes(chunk_state_kernel<false>,
                             static_cast<int>(ChunkStateLayout{c, npad(b), a, true}.bytes()), out);
    case 1:
      return func_attributes(state_pass_kernel<true>, 0, out);
    case 2:
      return func_attributes(chunk_apply_kernel<true>,
                             static_cast<int>(ApplyLayout{c, npad(b), a, true}.bytes()), out);
    case 3: {
      const size_t bytes = DcbLayout{c, nblock(b), a}.bytes();
      const int dyn = static_cast<int>(bytes);
      return wide_smem(bytes) ? func_attributes(ssd_dcb_kernel<true>, dyn, out)
                              : func_attributes(ssd_dcb_kernel<false>, dyn, out);
    }
  }
  return cudaErrorInvalidValue;
}

// The forward's shapes.  gstates [G, nc + 1, N, P] and tot [G, nc, P / PB]
// are scratch.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* b, const void* c, const void* la,
                                   const void* states, const void* dy, const void* ds, void* dx,
                                   void* db, void* dc, void* dla, void* gstates, void* tot,
                                   int G, int T, int P, int N, int L, void* stream) {
  if (L <= 0 || T % L != 0 || !shape_ok(N, L)) return cudaErrorInvalidValue;
  const int pb = column_block(P);
  if (pb == 0) return cudaErrorInvalidValue;
  const int nc = T / L;
  if (G == 0 || nc == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunkStateLayout ql{L, npad(N), pb, true};
  const ApplyLayout xl{L, npad(N), pb, true};
  const int NB = nblock(N);
  const DcbLayout bl{L, NB, pb};
  cudaError_t err = allow_smem(chunk_state_kernel<false>, ql.bytes());
  if (err == cudaSuccess) err = allow_smem(chunk_apply_kernel<true>, xl.bytes());
  const bool dcb_alone = wide_smem(bl.bytes());
  if (err == cudaSuccess)
    err = dcb_alone ? allow_smem(ssd_dcb_kernel<true>, bl.bytes())
                    : allow_smem(ssd_dcb_kernel<false>, bl.bytes());
  if (err != cudaSuccess) return err;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  const auto* lf = static_cast<const float*>(la);
  const auto* dyf = static_cast<const float*>(dy);
  auto* gs = static_cast<float*>(gstates);
  const int chunks = G * nc * (P / pb);   // (g, chunk, column block), blocks adjacent
  chunk_state_kernel<false><<<chunks, kThreads, ql.bytes(), st>>>(
      cf, dyf, lf, gs, static_cast<float*>(tot), T, P, N, L, pb, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_kernel<true><<<G * cdiv(N * P, 4 * kThreads), kThreads, 0, st>>>(
      gs, static_cast<const float*>(tot), static_cast<const float*>(ds), nullptr, nc, N * P,
      P / pb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_apply_kernel<true><<<chunks, kThreads, xl.bytes(), st>>>(
      cf, bf, lf, dyf, gs, static_cast<float*>(dx), T, P, N, L, pb, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dcbk = dcb_alone ? ssd_dcb_kernel<true> : ssd_dcb_kernel<false>;
  dcbk<<<G * nc, kThreads, bl.bytes(), st>>>(
      xf, bf, cf, lf, static_cast<const float*>(states), gs, dyf, static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(dla), T, P, N, L, pb);
  return cudaGetLastError();
}

DEFINE_ERROR_STRING
