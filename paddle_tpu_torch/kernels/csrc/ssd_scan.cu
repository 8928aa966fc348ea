// Chunked SSD (state-space duality) scan for Hopper.
//
// Replaces the Pallas kernel paddle_tpu/kernels/ssd_scan.py (_ssd_scan_call).
// For each of G independent (batch, head) recurrences over T tokens, in
// chunks of L tokens with the [N, P] state S carried from chunk to chunk:
//
//   cum   = cumsum(la)                          (inclusive, over the chunk)
//   M     = mask(s <= t) . (C B^T) . exp(cum_t - cum_s)
//   y     = M x + exp(cum_t) (C S)              (S entering the chunk)
//   S    <- exp(cum_{L-1}) S + (B . exp(cum_{L-1} - cum))^T x
//
// x [G,T,P], b/c [G,T,N], la [G,T] in; y [G,T,P], s [G,N,P] out; all fp32,
// contiguous.  The masked entries never reach exp: exp is taken only of
// cum_t - cum_s for s <= t and of cum_{L-1} - cum_s, both <= 0 for la <= 0,
// so a strongly negative log-decay underflows to 0 and never gives inf or
// 0/0.
//
// Bound: operations.  A chunk needs L (L + 1) N (C B^T over the L (L + 1) / 2
// entries with s <= t) + L (L + 1) P (M x over the same entries) +
// 2 L N P (C S) + 2 L N P (state) flops against 4 L (P + 2N + 1) bytes of
// input: at the 8B widths (L 128, N 128, P 64) about 45 flops a byte, above
// the fp32 CUDA-core balance point (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design: one CTA of 256 threads per (g row, column block), the blocks of
// one g adjacent in the grid: the P columns
// of x, y and S split into blocks of PB = 64, 32 or 8 columns, each its own
// CTA (the recurrence is independent across columns; the C B^T mask product
// is shared by them, so each CTA forms it again).  The shared-memory
// footprint then depends on the column block, not on P: every (PB, N, L)
// with N in {4 .. 128} and L in {16 .. 128} fits the card's 232,448 B, and
// P 128 runs as two CTAs a recurrence.  The chunk loop runs inside the CTA
// (the Pallas grid's "arbitrary" axis), with the block's columns of S
// resident in shared memory.  All of a chunk's x columns and B sit in shared
// memory (B rows padded by one float so a warp reading one column of it hits
// 32 banks); C is read a tile of RT rows at a time.  For each row tile the
// CTA forms the tile's rows of M (only the columns up to the tile's last
// row: the tiles above the diagonal are skipped), then the tile's y rows from
// M, x, C and the S entering the chunk.  Only after the last tile does S
// take the chunk's update, so every y row reads the entering state.  Every
// product is a register-blocked loop over shared memory: a thread owns a few
// rows and strided columns of the output (rows past a small tile are idle:
// N 4 with PB 8 keeps 32 threads on the state), the row operand is a warp
// broadcast and the column operand one bank a lane.  Sums run in one fixed
// order that does not depend on T or on the column block, so zero rows (x =
// b = c = 0, la = 0) are exact no-ops on every other row and on S.  The
// log-decay prefix sum is one warp scan a chunk.  fp32 on CUDA cores; tensor
// cores (TF32 or bf16 wgmma) and TMA loads are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int L, int N, int PB>
struct Shape {
  static constexpr int RT = L < 32 ? L : 32;      // rows of a t tile
  static constexpr int BS = N + 1;                 // padded shared row of B
  static constexpr int TCL = L < 32 ? L : 32;      // threads across the columns of M
  static constexpr int TRL = kThreads / TCL;
  static constexpr int TCP = PB < 32 ? PB : 32;    // threads across the block's columns
  static constexpr int TRP = kThreads / TCP;
  static constexpr int MR = cdiv(RT, TRL), MJ = L / TCL;   // M tile rows, column groups
  static constexpr int YR = cdiv(RT, TRP), PJ = PB / TCP;  // y tile rows, column groups
  static constexpr int SR = cdiv(N, TRP);                  // state rows
  // shared floats, each region a multiple of 4 so float4 stores stay aligned
  static constexpr int kX = L * PB, kC = RT * N, kM = RT * L, kS = N * PB, kB = L * BS;
  static constexpr size_t kBytes = sizeof(float) * (kX + kC + kM + kS + kB + 2 * L);
  static_assert(L % RT == 0 && L % TCL == 0 && PB % TCP == 0, "tiling");
  static_assert(PB % 4 == 0 && N % 4 == 0, "16-byte rows");
  static_assert(kX % 4 == 0 && kC % 4 == 0 && kM % 4 == 0 && kS % 4 == 0, "alignment");
  static_assert(kBytes <= 232448, "shared memory");
};

template <int L, int N, int PB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ la,
                float* __restrict__ y, float* __restrict__ s_out, int T, int P) {
  using S = Shape<L, N, PB>;
  constexpr int RT = S::RT, BS = S::BS;
  constexpr int MR = S::MR, MJ = S::MJ, YR = S::YR, PJ = S::PJ, SR = S::SR;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [L][PB]  the chunk's x columns
  float* cs = xs + S::kX;                        // [RT][N]  a row tile of C
  float* ms = cs + S::kC;                        // [RT][L]  the tile's rows of M
  float* ss = ms + S::kM;                        // [N][PB]  the carried state's columns
  float* bs = ss + S::kS;                        // [L][BS]  the chunk's B, padded
  float* cum = bs + S::kB;                       // [L]      inclusive log-decay sums
  float* wv = cum + L;                           // [L]      exp(cum_{L-1} - cum_s)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nb = P / PB;                         // column blocks of a recurrence
  const size_t g = blockIdx.x / nb;
  const int p0 = (blockIdx.x % nb) * PB;         // the block's first column
  const float* xg = x + g * T * P + p0;
  const float* bg = b + g * T * N;
  const float* cg = c + g * T * N;
  const float* lg = la + g * T;
  float* yg = y + g * T * P + p0;

  for (int i = tid; i < S::kS; i += kThreads) ss[i] = 0.f;

  // thread layouts: over M's [RT][L] tile and over [rows][PB] outputs; a
  // row index past its tile is clamped for reads and skipped for writes
  const int mc = tid % S::TCL, mr = tid / S::TCL;
  const int pc = tid % S::TCP, pr = tid / S::TCP;

  const int nchunks = T / L;
  for (int ch = 0; ch < nchunks; ++ch) {
    const size_t t_base = static_cast<size_t>(ch) * L;
    {   // the chunk's x columns and B into shared memory
      float4* xs4 = reinterpret_cast<float4*>(xs);
      for (int v = tid; v < L * PB / 4; v += kThreads) {
        const int row = v / (PB / 4), col = 4 * (v % (PB / 4));
        xs4[v] = *reinterpret_cast<const float4*>(xg + (t_base + row) * P + col);
      }
      const float4* b4 = reinterpret_cast<const float4*>(bg + t_base * N);
      for (int v = tid; v < L * N / 4; v += kThreads) {
        const float4 q = b4[v];
        const int row = (4 * v) / N, col = (4 * v) % N;
        float* dst = bs + row * BS + col;
        dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
      }
    }
    if (tid < 32) {   // inclusive prefix sum of the chunk's log-decay: one warp
      constexpr int E = (L + 31) / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        run += t < L ? lg[t_base + t] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);   // the lanes below, summed
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        if (t < L) cum[t] = before + v[e];
      }
    }
    __syncthreads();
    if (tid < L) wv[tid] = expf(cum[L - 1] - cum[tid]);

    for (int t0 = 0; t0 < L; t0 += RT) {
      {   // the tile's rows of C
        const float4* c4 = reinterpret_cast<const float4*>(cg + (t_base + t0) * N);
        float4* cs4 = reinterpret_cast<float4*>(cs);
        for (int v = tid; v < RT * N / 4; v += kThreads) cs4[v] = c4[v];
      }
      __syncthreads();
      const int s_lim = t0 + RT;               // columns past the tile's last row are 0
      const int mj = s_lim / S::TCL;
      {   // M[i][s] = (s <= t) ? (C_t . B_s) exp(cum_t - cum_s) : 0
        float acc[MR][MJ];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int j = 0; j < MJ; ++j) acc[r][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float a[MR];
#pragma unroll
          for (int r = 0; r < MR; ++r) a[r] = cs[min(mr + S::TRL * r, RT - 1) * N + n];
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            if (j < mj) {
              const float bv = bs[(mc + S::TCL * j) * BS + n];
#pragma unroll
              for (int r = 0; r < MR; ++r) acc[r][j] = fmaf(a[r], bv, acc[r][j]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const int i = mr + S::TRL * r;
          if (i >= RT) continue;
          const int t = t0 + i;
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            if (j < mj) {
              const int s = mc + S::TCL * j;
              ms[i * L + s] = s <= t ? acc[r][j] * expf(cum[t] - cum[s]) : 0.f;
            }
          }
        }
      }
      __syncthreads();
      {   // y[t] = sum_s M[i][s] x[s] + exp(cum_t) (C_t . S)
        float intra[YR][PJ], inter[YR][PJ];
#pragma unroll
        for (int r = 0; r < YR; ++r)
#pragma unroll
          for (int j = 0; j < PJ; ++j) intra[r][j] = inter[r][j] = 0.f;
        for (int s = 0; s < s_lim; ++s) {
          float a[YR], xv[PJ];
#pragma unroll
          for (int r = 0; r < YR; ++r) a[r] = ms[min(pr + S::TRP * r, RT - 1) * L + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[s * PB + pc + S::TCP * j];
#pragma unroll
          for (int r = 0; r < YR; ++r)
#pragma unroll
            for (int j = 0; j < PJ; ++j) intra[r][j] = fmaf(a[r], xv[j], intra[r][j]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float a[YR], sv[PJ];
#pragma unroll
          for (int r = 0; r < YR; ++r) a[r] = cs[min(pr + S::TRP * r, RT - 1) * N + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) sv[j] = ss[n * PB + pc + S::TCP * j];
#pragma unroll
          for (int r = 0; r < YR; ++r)
#pragma unroll
            for (int j = 0; j < PJ; ++j) inter[r][j] = fmaf(a[r], sv[j], inter[r][j]);
        }
#pragma unroll
        for (int r = 0; r < YR; ++r) {
          const int i = pr + S::TRP * r;
          if (i >= RT) continue;
          const int t = t0 + i;
          const float decay = expf(cum[t]);
          float* yrow = yg + (t_base + t) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j) yrow[pc + S::TCP * j] = intra[r][j] + decay * inter[r][j];
        }
      }
      __syncthreads();   // cs and ms are rewritten by the next tile
    }

    {   // S <- exp(total) S + sum_s (B_s w_s) x_s^T, each thread its own entries
      float acc[SR][PJ];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[r][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float w = wv[s];
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * PB + pc + S::TCP * j];
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const float a = bs[s * BS + min(pr + S::TRP * r, N - 1)] * w;
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[r][j] = fmaf(a, xv[j], acc[r][j]);
        }
      }
      const float keep = expf(cum[L - 1]);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const int n = pr + S::TRP * r;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          float* e = ss + n * PB + pc + S::TCP * j;
          *e = keep * *e + acc[r][j];
        }
      }
    }
    __syncthreads();   // the next chunk overwrites xs, bs, cum and wv
  }

  float* sg = s_out + g * N * P + p0;
  for (int i = tid; i < S::kS; i += kThreads) sg[(i / PB) * P + i % PB] = ss[i];
}

// The (PB, N, L) instantiations: runtime sizes to template arguments.  Op
// has `template <int L, int N, int PB> int run() const`.
template <int PB, int N, class Op>
int with_l(int L, const Op& op) {
  switch (L) {
    case 16: return op.template run<16, N, PB>();
    case 32: return op.template run<32, N, PB>();
    case 64: return op.template run<64, N, PB>();
    case 128: return op.template run<128, N, PB>();
  }
  return cudaErrorInvalidValue;
}

template <int PB, class Op>
int with_n(int N, int L, const Op& op) {
  switch (N) {
    case 4: return with_l<PB, 4>(L, op);
    case 8: return with_l<PB, 8>(L, op);
    case 16: return with_l<PB, 16>(L, op);
    case 32: return with_l<PB, 32>(L, op);
    case 64: return with_l<PB, 64>(L, op);
    case 128: return with_l<PB, 128>(L, op);
  }
  return cudaErrorInvalidValue;
}

template <class Op>
int with_shape(int PB, int N, int L, const Op& op) {
  switch (PB) {
    case 8: return with_n<8>(N, L, op);
    case 32: return with_n<32>(N, L, op);
    case 64: return with_n<64>(N, L, op);
  }
  return cudaErrorInvalidValue;
}

// the column block of P: the widest of 64, 32, 8 that divides it (0: none)
int column_block(int P) {
  if (P <= 0) return 0;
  return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : P % 8 == 0 ? 8 : 0;
}

struct Launch {
  const void *x, *b, *c, *la;
  void *y, *s;
  int G, T, P;
  cudaStream_t stream;
  template <int L, int N, int PB>
  int run() const {
    using S = Shape<L, N, PB>;
    auto kernel = ssd_scan_kernel<L, N, PB>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
    if (err != cudaSuccess) return err;
    if (G > 0)
      kernel<<<G * (P / PB), kThreads, S::kBytes, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(b),
          static_cast<const float*>(c), static_cast<const float*>(la),
          static_cast<float*>(y), static_cast<float*>(s), T, P);
    return cudaGetLastError();
  }
};

struct Attributes {
  int* out;
  template <int L, int N, int PB>
  int run() const {
    return func_attributes(ssd_scan_kernel<L, N, PB>,
                           static_cast<int>(Shape<L, N, PB>::kBytes), out);
  }
};

}  // namespace

// kernel 0: ssd_scan_kernel at <a = column block PB, b = N, c = L>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel != 0) return cudaErrorInvalidValue;
  return with_shape(a, b, c, Attributes{out});
}

// Any P that is a multiple of 8 (column blocks of 64, 32 or 8 columns, one
// CTA each), N in {4, 8, 16, 32, 64, 128}, L in {16, 32, 64, 128}, T a
// multiple of L; every operand 16-byte aligned.  Any other shape is refused.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c, const void* la,
                               void* y, void* s, int G, int T, int P, int N, int L,
                               void* stream) {
  if (L <= 0 || T % L != 0) return cudaErrorInvalidValue;
  const int pb = column_block(P);
  if (pb == 0) return cudaErrorInvalidValue;
  return with_shape(pb, N, L,
                    Launch{x, b, c, la, y, s, G, T, P, static_cast<cudaStream_t>(stream)});
}

DEFINE_ERROR_STRING
