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
// Design: one CTA of 256 threads per g row (the Pallas grid's "parallel"
// axis); the chunk loop runs inside the CTA (its "arbitrary" axis), with S
// resident in shared memory.  All of a chunk's x and B sit in shared memory
// (B rows padded by one float so a warp reading one column of it hits 32
// banks); C is read a tile of RT rows at a time.  For each row tile the CTA
// forms the tile's rows of M (only the columns up to the tile's last row:
// the tiles above the diagonal are skipped), then the tile's y rows from M,
// x, C and the S entering the chunk.  Only after the last tile does S take
// the chunk's update, so every y row reads the entering state.  Every
// product is a register-blocked loop over shared memory: a thread owns a
// few rows and strided columns of the output, the row operand is a warp
// broadcast and the column operand one bank a lane.  Sums run in one fixed
// order that does not depend on T, so zero rows (x = b = c = 0, la = 0)
// are exact no-ops on every other row and on S.  The log-decay prefix sum
// is one warp scan a chunk.  fp32 on CUDA cores; tensor cores (TF32 or
// bf16 wgmma) and TMA loads are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int L, int N, int P>
struct Shape {
  static constexpr int RT = L < 32 ? L : 32;      // rows of a t tile
  static constexpr int BS = N + 1;                 // padded shared row of B
  static constexpr int TCL = L < 32 ? L : 32;      // threads across the columns of M
  static constexpr int TRL = kThreads / TCL;
  static constexpr int TCP = P < 32 ? P : 32;      // threads across the P columns
  static constexpr int TRP = kThreads / TCP;
  // shared floats, each region a multiple of 4 so float4 stores stay aligned
  static constexpr int kX = L * P, kC = RT * N, kM = RT * L, kS = N * P, kB = L * BS;
  static constexpr size_t kBytes = sizeof(float) * (kX + kC + kM + kS + kB + 2 * L);
  static_assert(L % RT == 0 && RT % TRL == 0 && RT % TRP == 0 && N % TRP == 0, "tiling");
  static_assert(L % TCL == 0 && P % TCP == 0 && P % 4 == 0 && N % 4 == 0, "tiling");
  static_assert(kX % 4 == 0 && kC % 4 == 0 && kM % 4 == 0 && kS % 4 == 0, "alignment");
  static_assert(kBytes <= 232448, "shared memory");
};

template <int L, int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ la,
                float* __restrict__ y, float* __restrict__ s_out, int T) {
  using S = Shape<L, N, P>;
  constexpr int RT = S::RT, BS = S::BS;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [L][P]   the chunk's x
  float* cs = xs + S::kX;                        // [RT][N]  a row tile of C
  float* ms = cs + S::kC;                        // [RT][L]  the tile's rows of M
  float* ss = ms + S::kM;                        // [N][P]   the carried state
  float* bs = ss + S::kS;                        // [L][BS]  the chunk's B, padded
  float* cum = bs + S::kB;                       // [L]      inclusive log-decay sums
  float* wv = cum + L;                           // [L]      exp(cum_{L-1} - cum_s)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t g = blockIdx.x;
  const float* xg = x + g * T * P;
  const float* bg = b + g * T * N;
  const float* cg = c + g * T * N;
  const float* lg = la + g * T;
  float* yg = y + g * T * P;

  for (int i = tid; i < S::kS; i += kThreads) ss[i] = 0.f;

  // thread layouts: over M's [RT][L] tile and over [rows][P] outputs
  const int mc = tid % S::TCL, mr = tid / S::TCL;
  const int pc = tid % S::TCP, pr = tid / S::TCP;
  constexpr int MR = RT / S::TRL, MJ = L / S::TCL;      // M tile rows, column groups
  constexpr int YR = RT / S::TRP, PJ = P / S::TCP;      // y tile rows, P groups
  constexpr int SR = N / S::TRP;                        // state rows

  const int nchunks = T / L;
  for (int ch = 0; ch < nchunks; ++ch) {
    const size_t t_base = static_cast<size_t>(ch) * L;
    {   // the chunk's x and B into shared memory
      const float4* x4 = reinterpret_cast<const float4*>(xg + t_base * P);
      float4* xs4 = reinterpret_cast<float4*>(xs);
      for (int v = tid; v < L * P / 4; v += kThreads) xs4[v] = x4[v];
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
          for (int r = 0; r < MR; ++r) a[r] = cs[(mr + S::TRL * r) * N + n];
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
          for (int r = 0; r < YR; ++r) a[r] = ms[(pr + S::TRP * r) * L + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + pc + S::TCP * j];
#pragma unroll
          for (int r = 0; r < YR; ++r)
#pragma unroll
            for (int j = 0; j < PJ; ++j) intra[r][j] = fmaf(a[r], xv[j], intra[r][j]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float a[YR], sv[PJ];
#pragma unroll
          for (int r = 0; r < YR; ++r) a[r] = cs[(pr + S::TRP * r) * N + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) sv[j] = ss[n * P + pc + S::TCP * j];
#pragma unroll
          for (int r = 0; r < YR; ++r)
#pragma unroll
            for (int j = 0; j < PJ; ++j) inter[r][j] = fmaf(a[r], sv[j], inter[r][j]);
        }
#pragma unroll
        for (int r = 0; r < YR; ++r) {
          const int t = t0 + pr + S::TRP * r;
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
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + pc + S::TCP * j];
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const float a = bs[s * BS + pr + S::TRP * r] * w;
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[r][j] = fmaf(a, xv[j], acc[r][j]);
        }
      }
      const float keep = expf(cum[L - 1]);
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          float* e = ss + (pr + S::TRP * r) * P + pc + S::TCP * j;
          *e = keep * *e + acc[r][j];
        }
    }
    __syncthreads();   // the next chunk overwrites xs, bs, cum and wv
  }

  float* sg = s_out + g * N * P;
  for (int i = tid; i < S::kS; i += kThreads) sg[i] = ss[i];
}

template <int L, int N, int P>
cudaError_t launch(const void* x, const void* b, const void* c, const void* la, void* y,
                   void* s, int G, int T, cudaStream_t stream) {
  using S = Shape<L, N, P>;
  auto kernel = ssd_scan_kernel<L, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  if (G > 0)
    kernel<<<G, kThreads, S::kBytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const float*>(la),
        static_cast<float*>(y), static_cast<float*>(s), T);
  return cudaGetLastError();
}

}  // namespace

// kernel 0: ssd_scan_kernel at <a = P, b = L> (N follows: 128 for P 64, 16 for P 32)
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int* out) {
  if (kernel != 0) return cudaErrorInvalidValue;
  if (a == 64 && b == 128)
    return func_attributes(ssd_scan_kernel<128, 128, 64>,
                           static_cast<int>(Shape<128, 128, 64>::kBytes), out);
  if (a == 32 && b == 16)
    return func_attributes(ssd_scan_kernel<16, 16, 32>,
                           static_cast<int>(Shape<16, 16, 32>::kBytes), out);
  return cudaErrorInvalidValue;
}

// The (P, N, L) of the port's SSD configs: ssd_8b_config (64, 128, 128) and
// ssd_tiny_config (32, 16, 16).  Any other shape is refused.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c, const void* la,
                               void* y, void* s, int G, int T, int P, int N, int L,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || T % L != 0) return cudaErrorInvalidValue;
  if (P == 64 && N == 128 && L == 128) return launch<128, 128, 64>(x, b, c, la, y, s, G, T, st);
  if (P == 32 && N == 16 && L == 16) return launch<16, 16, 32>(x, b, c, la, y, s, G, T, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING
