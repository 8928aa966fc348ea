// Building blocks of the SSD scan's kernels (ssd_scan.cu, the forward;
// ssd_scan_bwd.cu, the backward): asynchronous tile copies, the chunk's
// log-decay prefix sum, split-TF32 products on the tensor cores, and the
// warp tiling every product of those kernels runs on.
//
// Split TF32.  A TF32 product keeps 11 significant bits of each operand, ~3
// decimal digits: too few for the scan's limit (1e-5 of the output's
// scale).  Each fp32 operand v is split into hi = tf32(v), rounded to
// nearest (ties away, as cvt.rna.tf32.f32, by two integer operations), and
// lo = v - hi (exact), whose low 13 bits the mma ignores: v = hi + lo to
// 2^-21 of |v|.  A product is three mma.sync m16n8k8 TF32 products, lo.hi +
// hi.lo + hi.hi (the small terms first), accumulated in fp32: an error of
// the order of fp32 rounding, with the lo.lo term (2^-22 of the product)
// left out.  Every operand comes from shared memory, fp32, through a
// strided view, so one layout serves a product and its transpose.
//
// Warp tiling.  A CTA has 8 warps.  An output of R rows x C columns is cut
// into units of 32 x 16 (2 x 2 mma tiles), dealt to the warps in turn: unit
// j goes to warp j % 8, in its slot j / 8.  An [L, L] product under
// the causal mask takes only the units that reach the diagonal or below
// it (Units::lower).  Rows past R and columns past C read zeros and are
// never stored, so N 4 and column blocks of 8 run on the same tiles.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ssd {


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// true where a CTA's shared memory leaves no room for a second on its SM
inline bool wide_smem(size_t bytes) { return bytes > 232448 / 2 - 1024; }
constexpr int kUnitRows = 32, kUnitCols = 16;

// row stride of a shared tile of `cols` floats, 16-byte aligned rows.  A
// fragment load reads 8 rows x 4 columns (lanes g, t) of a tile whose rows
// are the fragment's rows (ld: 4 floats of padding put row g at bank 4 g)
// or 4 rows x 8 columns of one whose rows are the k index (ldk: 8 floats
// put row t at bank 8 t); either way the 32 lanes hit 32 banks
__host__ __device__ constexpr int ld(int cols) { return cols + 4; }
__host__ __device__ constexpr int ldk(int cols) { return cols + 8; }
// N padded to the mma's depth of 8 (N 4: four zero columns)
__host__ __device__ constexpr int npad(int n) { return n < 8 ? 8 : n; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most `n` of this thread's committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// log2 of a power of two
__device__ __forceinline__ int log2i(int n) { return __ffs(n) - 1; }

// rows x cols floats (cols / 4 a power of two, 16-byte aligned rows) from
// global memory (row stride gld) into shared memory (row stride sld), by
// 16-byte cp.async copies
__device__ __forceinline__ void load_tile(float* dst, int sld, const float* src, size_t gld,
                                          int rows, int cols) {
  const int sh = log2i(cols / 4);
  for (int i = threadIdx.x; i < rows << sh; i += blockDim.x) {
    const int r = i >> sh, c = 4 * (i & ((1 << sh) - 1));
    cp_async16(dst + r * sld + c, src + r * gld + c);
  }
}

// each of rows x cols (cols a power of two) of a shared tile times the
// row's weight
__device__ __forceinline__ void scale_rows(float* dst, int sld, const float* w, int rows,
                                           int cols) {
  const int sh = log2i(cols);
  for (int i = threadIdx.x; i < rows << sh; i += blockDim.x)
    dst[(i >> sh) * sld + (i & (cols - 1))] *= w[i >> sh];
}
// zero the rows [r0, r1) x columns [c0, c1) of a shared tile
__device__ __forceinline__ void zero_tile(float* dst, int sld, int r0, int r1, int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += blockDim.x)
    dst[(r0 + i / w) * sld + c0 + i % w] = 0.f;
}

// Inclusive prefix sum of a chunk's log-decay (L <= 128 entries of lg) into
// cum, by one warp: lane l sums its ceil(L / 32) consecutive entries, then
// a warp scan adds the lanes below.  Every kernel of the scan forms cum by
// this one function, so all of them see the same bits.  The forward sums
// in fp32, as its plain version does.  The backward sums in fp64 (T =
// double): there the sums of up to 128 fp32 terms are exact, or all but,
// in any order, so cum_t - cum_s rounds to the same fp32 segment sum as
// the plain version's; in fp32, at a log-decay near -20 a token, cum
// reaches -2560, the segment sums of neighbours lose 2^-12 of their ~-20,
// and the gradient of the log-decay, made of exactly those terms, would
// move by 1e-4 of its scale between two orders of summation.
template <class T>
__device__ __forceinline__ void chunk_cumsum(const float* lg, T* cum, int L, int lane) {
  const int E = cdiv(L, 32);
  T v[4];
  T run = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * E + e;
    if (e < E && t < L) run += lg[t];
    v[e] = run;
  }
  T incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  T before = __shfl_up_sync(0xffffffffu, incl, 1);       // the lanes below, summed
  if (lane == 0) before = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * E + e;
    if (e < E && t < L) cum[t] = before + v[e];
  }
}

// ---------------------------------------------------------------------------
// split-TF32 products
// ---------------------------------------------------------------------------

// hi: v rounded to 10 stored mantissa bits, half away from zero (the
// magnitude's bits plus half of the dropped part, then cut); lo: the rest,
// exact in fp32, which the mma reads to its top 10 mantissa bits
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// not volatile: the compiler may interleave the independent products of a
// k step (a product waits only for the one before it on its accumulator)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The CTA's recurrence g, chunk k and block b (of P's columns, or of N's)
// in a grid of G * nc * nb CTAs, the blocks of one chunk adjacent: they
// read the same tiles, which they then find in L2.
struct Cta {
  int g, k, b;
};
__device__ __forceinline__ Cta cta_of(int nc, int nb) {
  const int gk = blockIdx.x / nb;
  return {gk / nc, gk % nc, static_cast<int>(blockIdx.x % nb)};
}

// a shared-memory operand: element (i, j) at p[i * si + j * sj]
struct View {
  const float* p;
  int si, sj;
  __device__ __forceinline__ float operator()(int i, int j) const { return p[i * si + j * sj]; }
};

// The units of an R x C output and which of them a warp's slot holds.
struct Units {
  int R, C;
  bool lower;   // only the units that reach the diagonal (R == C, causal)
  __device__ __forceinline__ bool get(int j, int& r0, int& c0) const {
    const int ncu = cdiv(C, kUnitCols), nru = cdiv(R, kUnitRows);
    if (!lower) {
      if (j >= ncu * nru) return false;
      r0 = (j / ncu) * kUnitRows;
      c0 = (j % ncu) * kUnitCols;
      return true;
    }
    for (int rb = 0; rb < nru; ++rb) {
      const int cnt = min(2 * rb + 2, ncu);   // units c0 <= r0 + 31
      if (j < cnt) {
        r0 = rb * kUnitRows;
        c0 = j * kUnitCols;
        return true;
      }
      j -= cnt;
    }
    return false;
  }
};

// accumulators of a warp's U slots: [slot][m16 tile][n8 tile][4]
template <int U>
using Acc = float[U][2][2][4];

template <int U>
__device__ __forceinline__ void zero_acc(Acc<U>& acc) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][i][j][q] = 0.f;
}

// One k step of a unit's fragments, split: A's 2 m16 tiles x 8 k, B's 8 k x
// 2 n8 tiles (rows past R and columns past C read 0).
struct Frag {
  uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
};

__device__ __forceinline__ void load_frag(Frag& f, const Units& un, const View& a,
                                          const View& b, int r0, int c0, int k, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * i + g;
    split_tf32(r < un.R ? a(r, k + t) : 0.f, f.ah[i][0], f.al[i][0]);
    split_tf32(r + 8 < un.R ? a(r + 8, k + t) : 0.f, f.ah[i][1], f.al[i][1]);
    split_tf32(r < un.R ? a(r, k + t + 4) : 0.f, f.ah[i][2], f.al[i][2]);
    split_tf32(r + 8 < un.R ? a(r + 8, k + t + 4) : 0.f, f.ah[i][3], f.al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = c0 + 8 * j + g;
    split_tf32(n < un.C ? b(k + t, n) : 0.f, f.bh[j][0], f.bl[j][0]);
    split_tf32(n < un.C ? b(k + t + 4, n) : 0.f, f.bh[j][1], f.bl[j][1]);
  }
}

// the products of one k step, each pass over the four tiles first (lo.hi,
// then hi.lo, then hi.hi): four independent products between two on one
// accumulator
__device__ __forceinline__ void mma_frag(float (&acc)[2][2][4], const Frag& f, bool m1,
                                         bool n1) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && !m1) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !n1) continue;
        mma_tf32(acc[i][j], pass == 0 ? f.al[i] : f.ah[i], pass == 1 ? f.bl[j] : f.bh[j]);
      }
    }
}

// acc += A B over this warp's units: A(row, k), B(k, col), k over
// krange(r0, k0, k1) for the unit at rows r0.. (k0, k1 multiples of 8).
// With K2, two k steps' fragments are loaded ahead of their products: more
// loads in flight, ~24 more registers a thread, so only where a CTA holds
// its SM alone anyway (measured: 4% faster there; where two or three CTAs
// fit, it costs them their room and is slower)
template <int U, bool K2 = false, class KRange>
__device__ __forceinline__ void mma_units(Acc<U>& acc, const Units& un, const View a,
                                          const View b, KRange krange) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int r0, c0;
    if (!un.get(warp + kWarps * u, r0, c0)) continue;   // warp-uniform
    int k0, k1;
    krange(r0, k0, k1);
    const bool m1 = r0 + 16 < un.R, n1 = c0 + 8 < un.C;
    int k = k0;
    if (K2) {
      for (; k + 8 < k1; k += 16) {
        Frag f0, f1;
        load_frag(f0, un, a, b, r0, c0, k, g, t);
        load_frag(f1, un, a, b, r0, c0, k + 8, g, t);
        mma_frag(acc[u], f0, m1, n1);
        mma_frag(acc[u], f1, m1, n1);
      }
    }
    for (; k < k1; k += 8) {
      Frag f;
      load_frag(f, un, a, b, r0, c0, k, g, t);
      mma_frag(acc[u], f, m1, n1);
    }
  }
}

// f(row, col, u, i, j, q) for every element of this warp's units inside R x C
template <int U, class F>
__device__ __forceinline__ void for_each_acc(const Units& un, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int r0, c0;
    if (!un.get(warp + kWarps * u, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = r0 + 16 * i + g + 8 * (q >> 1);
          const int col = c0 + 8 * j + 2 * t + (q & 1);
          if (row < un.R && col < un.C) f(row, col, u, i, j, q);
        }
  }
}

// k ranges: all of K; the causal rows' (k <= the unit's last row); the
// transposed causal rows' (k >= the unit's first row)
struct KAll {
  int K;
  __device__ __forceinline__ void operator()(int, int& k0, int& k1) const { k0 = 0; k1 = K; }
};
struct KUpTo {
  int L;
  __device__ __forceinline__ void operator()(int r0, int& k0, int& k1) const {
    k0 = 0;
    k1 = min(L, r0 + kUnitRows);
  }
};
struct KFrom {
  int L;
  __device__ __forceinline__ void operator()(int r0, int& k0, int& k1) const {
    k0 = r0;
    k1 = L;
  }
};

// The chunk-parallel phase (a) of both directions: one CTA a (g, chunk,
// column block) forms  out = (R . d)^T V  ([N, PB]: the rows operand R [L,
// N] weighted by the chunk's decay d [L], against the column block of V
// [L, P]) and the chunk's total log-decay.  Forward: R = B, V = x, d_s =
// exp(cum_{L-1} - cum_s), out = the chunk's state increment, stored at
// states[k + 1].  Backward: R = C, V = dy, d_t = exp(cum_t), out = the
// chunk's Q_k = C^T (e . dy), stored at states_grad[k] (cum in fp64, see
// chunk_cumsum).  Every column block stores its own copy of the total, tot
// [G, nc, P / PB], so no two CTAs write one place.
struct ChunkStateLayout {
  int L, NP, PB;
  bool dbl;     // cum in fp64
  __host__ __device__ int rw() const { return 0; }                     // [L][ldk(NP)]
  __host__ __device__ int vs() const { return L * ldk(NP); }           // [L][ldk(PB)]
  __host__ __device__ int cum() const { return vs() + L * ldk(PB); }   // [L] float or double
  __host__ __device__ int dec() const { return cum() + L * (dbl ? 2 : 1); }   // [L]
  __host__ __device__ int floats() const { return dec() + L; }
  __host__ __device__ size_t bytes() const { return sizeof(float) * floats(); }
};

template <bool FROM_END>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const float* __restrict__ rows, const float* __restrict__ vals,
                   const float* __restrict__ la, float* __restrict__ out,
                   float* __restrict__ tot, int T, int P, int N, int L, int PB, int offset) {
  using CumT = typename std::conditional<FROM_END, float, double>::type;
  extern __shared__ float4 smem4[];
  const ChunkStateLayout lay{L, npad(N), PB, !FROM_END};
  float* sm = reinterpret_cast<float*>(smem4);
  float* rw = sm + lay.rw();
  float* vs = sm + lay.vs();
  CumT* cum = reinterpret_cast<CumT*>(sm + lay.cum());
  float* dec = sm + lay.dec();
  const int NP = lay.NP;
  const int nc = T / L, nb = P / PB;
  const Cta cta = cta_of(nc, nb);
  const int g = cta.g, k = cta.k;
  const int p0 = cta.b * PB;
  const size_t t0 = static_cast<size_t>(g) * T + static_cast<size_t>(k) * L;

  load_tile(rw, ldk(NP), rows + t0 * N, N, L, N);
  load_tile(vs, ldk(PB), vals + t0 * P + p0, P, L, PB);
  cp_async_commit();
  zero_tile(rw, ldk(NP), 0, L, N, NP);
  if (threadIdx.x < 32) chunk_cumsum(la + t0, cum, L, threadIdx.x);
  __syncthreads();
  for (int s = threadIdx.x; s < L; s += kThreads)
    dec[s] = expf(static_cast<float>(FROM_END ? cum[L - 1] - cum[s] : cum[s]));
  if (threadIdx.x == 0)
    tot[(static_cast<size_t>(g) * nc + k) * nb + cta.b] =
        static_cast<float>(cum[L - 1]);
  cp_async_wait<0>();
  __syncthreads();
  scale_rows(rw, ldk(NP), dec, L, N);
  __syncthreads();

  const Units un{NP, PB, false};
  Acc<2> acc;
  zero_acc<2>(acc);
  mma_units<2>(acc, un, View{rw, 1, ldk(NP)}, View{vs, ldk(PB), 1}, KAll{L});
  float* og = out + ((static_cast<size_t>(g) * (nc + 1) + k + offset) * N) * P + p0;
  for_each_acc<2>(un, [&](int n, int p, int u, int i, int j, int q) {
    if (n < N) og[static_cast<size_t>(n) * P + p] = acc[u][i][j][q];
  });
}

// Phase (b) of both directions: the state pass, sequential over chunks and
// parallel over (g, 4-float groups of the [N, P] state).  Forward: S_0 = 0,
// S_{k+1} = exp(tot_k) S_k + U_k, with U_k read from states[k + 1] and
// replaced by S_{k+1}; s_final = S_nc.  Backward (REVERSE): G_nc = ds,
// G_k = exp(tot_k) G_{k+1} + Q_k, with Q_k read from states_grad[k].  Each
// thread carries its four entries in registers and reads its next kDepth
// increments before it needs them.  tot_k is column block 0's copy.
template <bool REVERSE>
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ st, const float* __restrict__ tot,
                  const float* __restrict__ init, float* __restrict__ fin, int nc, int NPsz,
                  int nb) {
  constexpr int kDepth = 8;
  const int tiles = cdiv(NPsz, 4 * kThreads);
  const int g = blockIdx.x / tiles;
  const int e = 4 * ((blockIdx.x % tiles) * kThreads + threadIdx.x);
  if (e >= NPsz) return;
  const size_t base = static_cast<size_t>(g) * (nc + 1) * NPsz + e;
  const float* tg = tot + static_cast<size_t>(g) * nc * nb;
  float4 s = REVERSE ? *reinterpret_cast<const float4*>(init + static_cast<size_t>(g) * NPsz + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(st + base + static_cast<size_t>(REVERSE ? nc : 0) * NPsz) = s;
  for (int b0 = 0; b0 < nc; b0 += kDepth) {
    float4 inc[kDepth];
    float dec[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (b0 + d < nc) {
        const int k = REVERSE ? nc - 1 - (b0 + d) : b0 + d;
        inc[d] = *reinterpret_cast<const float4*>(
            st + base + static_cast<size_t>(REVERSE ? k : k + 1) * NPsz);
        dec[d] = expf(tg[static_cast<size_t>(k) * nb]);
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (b0 + d < nc) {
        const int k = REVERSE ? nc - 1 - (b0 + d) : b0 + d;
        s.x = fmaf(dec[d], s.x, inc[d].x);
        s.y = fmaf(dec[d], s.y, inc[d].y);
        s.z = fmaf(dec[d], s.z, inc[d].z);
        s.w = fmaf(dec[d], s.w, inc[d].w);
        *reinterpret_cast<float4*>(st + base + static_cast<size_t>(REVERSE ? k : k + 1) * NPsz) = s;
      }
    }
  }
  if (!REVERSE) *reinterpret_cast<float4*>(fin + static_cast<size_t>(g) * NPsz + e) = s;
}

// Phase (c) of both directions, one CTA a (g, chunk, column block), all
// parallel.  Forward: y = M x + e . (C S_k); backward: dx = M^T dy + w .
// (B G_{k+1}); M = mask . (C B^T) . exp(cum_t - cum_s) in both.  N is
// streamed in blocks of NK = min(N, 32) columns through two buffers (the
// next block's C, B and state rows load while the current one's products
// run): C B^T accumulates over the causal units, and C S_k (forward) or B
// G_{k+1} (backward) over the [L, PB] units.  Then M goes to shared memory
// over the buffers, the x (dy) block arrives behind it, the [L, PB]
// accumulators take their row weights (e, w) and M x (M^T dy) adds to
// them.  The tiles take ~108 KB at chunk 128, so two CTAs share an SM and
// one's loads overlap the other's products.
struct ApplyLayout {
  int L, NP, PB;
  bool bwd;     // M read transposed (ldk), cum in fp64
  __host__ __device__ int nk() const { return NP < 32 ? NP : 32; }
  __host__ __device__ int stage() const { return 2 * L * ld(nk()) + nk() * ldk(PB); }
  __host__ __device__ int ldm() const { return bwd ? ldk(L) : ld(L); }
  __host__ __device__ int xs() const { return L * ldm(); }       // after M, over the stages
  __host__ __device__ int un() const {
    const int a = 2 * stage(), b = xs() + L * ldk(PB);
    return a > b ? a : b;
  }
  __host__ __device__ int cum() const { return un(); }
  __host__ __device__ int dec() const { return cum() + L * (bwd ? 2 : 1); }
  __host__ __device__ int floats() const { return dec() + L; }
  __host__ __device__ size_t bytes() const { return sizeof(float) * floats(); }
};

template <bool BWD>
__global__ void __launch_bounds__(kThreads, 2)
chunk_apply_kernel(const float* __restrict__ c, const float* __restrict__ b,
                   const float* __restrict__ la, const float* __restrict__ vals,
                   const float* __restrict__ st, float* __restrict__ out, int T, int P, int N,
                   int L, int PB, int st_offset) {
  using CumT = typename std::conditional<BWD, double, float>::type;
  extern __shared__ float4 smem4[];
  const ApplyLayout lay{L, npad(N), PB, BWD};
  const int NP = lay.NP, NK = lay.nk();
  float* sm = reinterpret_cast<float*>(smem4);
  float* m = sm;                                  // M, after the N sweep
  float* xs = sm + lay.xs();                      // the x (dy) block, after the N sweep
  CumT* cum = reinterpret_cast<CumT*>(sm + lay.cum());
  float* dec = sm + lay.dec();
  const int nc = T / L;
  const Cta cta = cta_of(nc, P / PB);
  const int g = cta.g, k = cta.k;
  const int p0 = cta.b * PB;
  const size_t t0 = static_cast<size_t>(g) * T + static_cast<size_t>(k) * L;
  const float* sg = st + (static_cast<size_t>(g) * (nc + 1) + k + st_offset) * N * P + p0;

  // stage s: C's and B's NK columns [L][ld(NK)], the state's NK rows [NK][ldk(PB)]
  auto cs = [&](int s) { return sm + s * lay.stage(); };
  auto bs = [&](int s) { return sm + s * lay.stage() + L * ld(NK); };
  auto vs = [&](int s) { return sm + s * lay.stage() + 2 * L * ld(NK); };
  auto issue = [&](int s, int n0) {
    const int nw = min(NK, N - n0);               // real columns (N 4: 4 of 8)
    load_tile(cs(s), ld(NK), c + t0 * N + n0, N, L, nw);
    load_tile(bs(s), ld(NK), b + t0 * N + n0, N, L, nw);
    load_tile(vs(s), ldk(PB), sg + static_cast<size_t>(n0) * P, P, nw, PB);
    cp_async_commit();
    zero_tile(cs(s), ld(NK), 0, L, nw, NK);
    zero_tile(bs(s), ld(NK), 0, L, nw, NK);
    zero_tile(vs(s), ldk(PB), nw, NK, 0, PB);
  };

  issue(0, 0);
  if (threadIdx.x < 32) chunk_cumsum(la + t0, cum, L, threadIdx.x);
  const Units tri{L, L, true};
  const Units un{L, PB, false};
  Acc<3> cb;
  Acc<2> acc;
  zero_acc<3>(cb);
  zero_acc<2>(acc);
  const int steps = NP / NK;
  for (int i = 0; i < steps; ++i) {
    const int s = i & 1;
    if (i + 1 < steps) {
      issue(s ^ 1, (i + 1) * NK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_units<3>(cb, tri, View{cs(s), ld(NK), 1}, View{bs(s), 1, ld(NK)}, KAll{NK});
    mma_units<2>(acc, un, View{BWD ? bs(s) : cs(s), ld(NK), 1}, View{vs(s), ldk(PB), 1},
                 KAll{NK});
    __syncthreads();   // the buffer is refilled two steps on, and M and x go over both
  }

  // the x (dy) block behind M; the row weights e_t (forward) or w_s
  // (backward); M over the buffers
  load_tile(xs, ldk(PB), vals + t0 * P + p0, P, L, PB);
  cp_async_commit();
  for (int r = threadIdx.x; r < L; r += kThreads)
    dec[r] = expf(static_cast<float>(BWD ? cum[L - 1] - cum[r] : cum[r]));
  const int ldm = lay.ldm();
  for_each_acc<3>(tri, [&](int t, int s, int u, int i, int j, int q) {
    m[t * ldm + s] = s <= t ? cb[u][i][j][q] * expf(static_cast<float>(cum[t] - cum[s])) : 0.f;
  });
  cp_async_wait<0>();
  __syncthreads();
  for_each_acc<2>(un, [&](int r, int p, int u, int i, int j, int q) { acc[u][i][j][q] *= dec[r]; });
  if (BWD)
    mma_units<2>(acc, un, View{m, 1, ldm}, View{xs, ldk(PB), 1}, KFrom{L});
  else
    mma_units<2>(acc, un, View{m, ldm, 1}, View{xs, ldk(PB), 1}, KUpTo{L});
  float* og = out + t0 * P + p0;
  for_each_acc<2>(un, [&](int r, int p, int u, int i, int j, int q) {
    og[static_cast<size_t>(r) * P + p] = acc[u][i][j][q];
  });
}

// the column block of P: the widest of 64, 32, 8 that divides it (0: none)
inline int column_block(int P) {
  if (P <= 0) return 0;
  return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : P % 8 == 0 ? 8 : 0;
}

// the shapes the kernels take: N a power of two in 4 .. 128, L in 16 .. 128
inline bool shape_ok(int N, int L) {
  const bool n = N == 4 || N == 8 || N == 16 || N == 32 || N == 64 || N == 128;
  const bool l = L == 16 || L == 32 || L == 64 || L == 128;
  return n && l;
}

template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ssd
