// The fusion sites' matrix products for Hopper, with their prologues and
// epilogues.
//
// Replaces the matrix products inside the emitted Pallas kernels of
// paddle_tpu/kernels/emit.py: _row_block_call (a site's forward, the jnp
// reference traced on row blocks with the weights resident) and
// _single_block_call (its backward, jax.vjp of the reference recomputed from
// the primals).  kernels/emit.py composes the sites from the launches here
// and in add_rms_norm.cu:
//   fuse_swiglu_mlp    fwd  gate_up (SwiGLU epilogue) -> down
//                      bwd  d_act = dY Wd^T; gate_up again (SwiGLU-backward
//                           epilogue: d_gu and act); dWd = act^T dY;
//                           dX = d_gu Wgu^T; dWgu = X^T d_gu
//   fuse_rms_norm_head fwd  row_rms; logits = (RMS prologue X) W
//                      bwd  d_normed = dL W^T; row_rms; dW = normed^T dL
//                           (RMS prologue on the transposed operand); the
//                           norm's backward in add_rms_norm.cu
//
// C[M, N] = A[M, K] B[K, N] over stored operands: A is K-contiguous (row
// major) or M-contiguous (a transposed view), B is N-contiguous or
// K-contiguous, so one source covers NN (X W), NT (dY W^T, the tied head
// X E^T), TN (X^T dY, the weight gradients) and TT.  Every operand's
// contiguous dimension is a multiple of 8; the row count of the model
// (batch x sequence) is always an outer dimension, so it may be ragged.
//
// Rounding follows torch's autograd of the plain site references exactly:
// an fp32 weight is rounded to the compute dtype before its product (the
// reference's .to(hidden.dtype)); every product is summed in fp32 and
// rounded once to the compute dtype; a weight gradient is that bf16 product
// widened to fp32 (the gradient of the cast); SwiGLU rounds gate, up,
// silu(gate) and the product each to the compute dtype, as the separate
// torch ops do; the RMS prologue scales a row by its fp32 inverse RMS and
// then by the norm weight, and rounds, as _rms_rows does.
//
// Bound: operations.  At `base` (6144 rows, hidden 2048, intermediate 5632,
// vocab 32000) every product is far above the card's ~295 flop/byte balance
// point: the head's product does 805 GFLOP against ~420 MB.
//
// bf16 (the training path), three kernels:
//   prep_kernel: the operands as the main loop reads them, each written
//     once to device memory in bf16: an fp32 weight rounded (round to
//     nearest even, the bits of .to(torch.bfloat16)), or the RMS prologue's
//     normed rows.  Byte-bound passes, so the GEMM's loop moves no operand
//     through registers.
//   gemm_tc_kernel: one CTA an output tile of 128 rows x 256 columns
//     (SwiGLU: 128 output columns, read as a gate box and an up box), warp
//     specialised: a producer warpgroup (one thread) issues TMA loads of
//     64-deep K steps into a ring of GEMM_TC_STAGES shared-memory stages,
//     128-byte swizzled, gated by full / empty mbarrier pairs; two consumer
//     warpgroups each run wgmma m64 x 256 x 16 (SwiGLU: two m64 x 128 chains,
//     gate and up, into two accumulator arrays, so element i of one and of
//     the other are the same output) on 64 of the rows, with the operands'
//     orientation given by wgmma's transpose immediates: K-major tiles are
//     one TMA box of [rows][64], MN-major ones boxes of [64 K rows][64].
//     The producer gives its registers to the consumers (setmaxnreg).  The
//     epilogue runs on the accumulators in registers: rounding, SwiGLU and
//     its backward pairwise per thread, then the four lanes that share a
//     row exchange pairs by shuffles so that each stores (and, for the
//     SwiGLU backward, loads d_act as) 16 contiguous bytes, masked at M
//     and N.
//   row_rms_kernel: the RMS prologue's fp32 row statistic (also fp32).
// fp32 (the parity path): the CUDA-core kernel gemm_kernel, CTA tile 128 x
// 128, K step 32, 256 threads each owning an 8 x 8 block of fp32 FMAs (true
// fp32, no TF32); the next K tile is loaded into registers (16-byte loads,
// a bf16 B widened, the prologue applied) while the current one is
// multiplied out of shared memory, double buffered, one barrier a step; the
// accumulators pass through shared memory to an epilogue that writes 8
// consecutive outputs a thread.
// Every output element has one writer and each CTA sums its K range in one
// order, so two launches are bit-equal.
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Epilogue { kStore = 0, kSwiglu = 1, kSwigluBwd = 2 };

struct Params {
  const void* a;
  const void* b;
  void* c;           // kStore: C [M, N]; kSwiglu / kSwigluBwd: act [M, N]
  void* c2;          // kSwigluBwd: d_gu [M, 2N]
  const void* aux;   // kSwigluBwd: d_act [M, N]
  const float* rs;   // RMS prologue (fp32 kernel): inverse RMS of each source row (or null)
  const float* cs;   // RMS prologue: norm weight of each source column
  int M, N, K;       // dual epilogues: N = I, and B has 2I columns
  long long lda, ldb, ldc;
  int pro_on_b;      // the prologue scales B instead of A
  int epi;
  int c_dtype;       // kStore: dtype of C
  int m_fast;        // blockIdx.x walks the M tiles (B is the larger operand)
};

__device__ __forceinline__ float round_bf16(float v) { return to_float(from_float<bf16>(v)); }

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename TS>
__device__ __forceinline__ void load8(const TS* p, float (&f)[8]);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(v[j]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
template <>
__device__ __forceinline__ void store8<bf16>(bf16* p, const float (&f)[8]) {
  uint4 u;
  bf16* v = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------

// geometry: -D defines from _build.GEOMETRY
constexpr int BM = GEMM_BM, BN = GEMM_BN, BK = GEMM_BK, NT = 256;
constexpr int LDC = GEMM_LDC;   // fp32 staging tile of the epilogue

// 8 consecutive fp32 values held in registers
struct Chunk {
  float4 a, b;
  __device__ __forceinline__ void set(const float (&f)[8]) {
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ __forceinline__ void copy(const float* src) {
    a = reinterpret_cast<const float4*>(src)[0];
    b = reinterpret_cast<const float4*>(src)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void put(float* dst) const {
    reinterpret_cast<float4*>(dst)[0] = a;
    reinterpret_cast<float4*>(dst)[1] = b;
  }
};

// One operand tile [OUTER][INNER] in the source's orientation, held in
// shared memory with rows padded by 16 bytes.  Each thread moves chunks of
// 8 inner elements: global -> registers (widened to fp32, the prologue
// applied) -> shared.  DUAL splits the inner range in two halves read from
// columns i0 .. and n_inner + i0 .. (the gate and up halves of gate_up).
template <typename TS, int OUTER, int INNER, bool DUAL>
struct Stage {
  static constexpr int LD = INNER + 4;
  static constexpr int SIZE = OUTER * LD;
  static constexpr int PER = OUTER * INNER / 8 / NT;
  static_assert(PER * NT * 8 == OUTER * INNER, "tile not covered");
  Chunk v[PER];

  __device__ __forceinline__ void load(const TS* src, long long ld, int o0, int i0, int n_outer,
                                       int n_inner, const float* rs, const float* cs) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * NT;
      const int o = c / (INNER / 8);
      const int t = (c % (INNER / 8)) * 8;
      const int go = o0 + o;
      int gi, col;
      if (DUAL) {
        const int half = t >= INNER / 2;
        col = i0 + t - half * (INNER / 2);
        gi = col + half * n_inner;
      } else {
        col = gi = i0 + t;
      }
      if (go >= n_outer || col >= n_inner) {
        v[p].zero();
        continue;
      }
      const TS* at = src + static_cast<long long>(go) * ld + gi;
      if (std::is_same<TS, float>::value && rs == nullptr) {
        v[p].copy(reinterpret_cast<const float*>(at));
        continue;
      }
      float f[8];
      load8<TS>(at, f);
      if (rs != nullptr) {
        const float r = rs[go];
        float w[8];
        load8<float>(cs + gi, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = f[j] * r * w[j];
      }
      v[p].set(f);
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * NT;
      v[p].put(dst + (c / (INNER / 8)) * LD + (c % (INNER / 8)) * 8);
    }
  }
};

template <bool AK> struct ATile {   // A(m, k): K-contiguous [BM][BK] or M-contiguous [BK][BM]
  static constexpr int OUTER = AK ? BM : BK, INNER = AK ? BK : BM;
};
template <bool BNC> struct BTile {  // B(k, n): N-contiguous [BK][BN] or K-contiguous [BN][BK]
  static constexpr int OUTER = BNC ? BK : BN, INNER = BNC ? BN : BK;
};

template <typename TB, bool AK, bool BNC, bool DUAL>
struct Gemm {
  using SA = Stage<float, ATile<AK>::OUTER, ATile<AK>::INNER, false>;
  using SB = Stage<TB, BTile<BNC>::OUTER, BTile<BNC>::INNER, DUAL>;
  static constexpr int STAGE_BYTES = 2 * (SA::SIZE + SB::SIZE) * 4;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES;
  static_assert(SA::SIZE * 4 % 128 == 0 && SB::SIZE * 4 % 128 == 0,
                "stage buffers must keep 128-byte alignment");
};

// k-tile kt of each operand: outer/inner origin and extents
template <bool AK>
__device__ __forceinline__ void a_coords(int m0, int kt, int M, int K, int& o0, int& i0,
                                         int& no, int& ni) {
  if (AK) { o0 = m0; i0 = kt * BK; no = M; ni = K; }
  else    { o0 = kt * BK; i0 = m0; no = K; ni = M; }
}
template <bool BNC>
__device__ __forceinline__ void b_coords(int n0, int kt, int N, int K, int& o0, int& i0,
                                         int& no, int& ni) {
  if (BNC) { o0 = kt * BK; i0 = n0; no = K; ni = N; }
  else     { o0 = n0; i0 = kt * BK; no = N; ni = K; }
}

// fp32 tile product: thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
template <bool AK, bool BNC>
__device__ __forceinline__ void fma_tile(const float* As, const float* Bs, int LDA, int LDB,
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      a[i] = AK ? As[m * LDA + kk] : As[kk * LDA + m];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      b[j] = BNC ? Bs[kk * LDB + n] : Bs[n * LDB + kk];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The epilogue over the fp32 tile Cs [BM][LDC]; 8 consecutive outputs a thread.
template <bool DUAL>
__device__ __forceinline__ void epilogue(const float* Cs, const Params& p, int m0, int n0) {
  constexpr int COLS = DUAL ? BN / 2 : BN;
  for (int idx = threadIdx.x; idx < BM * COLS / 8; idx += NT) {
    const int r = idx / (COLS / 8);
    const int c = (idx % (COLS / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= p.M || gn >= p.N) continue;
    const float* cr = Cs + r * LDC + c;
    const long long off = static_cast<long long>(gm) * p.ldc + gn;
    float v[8];
    if constexpr (!DUAL) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = cr[j];
      if (p.c_dtype == kFloat32) store8<float>(static_cast<float*>(p.c) + off, v);
      else store8<bf16>(static_cast<bf16*>(p.c) + off, v);
    } else {
      float g[8], u[8], s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        g[j] = cr[j];
        u[j] = cr[j + BN / 2];
        s[j] = silu(g[j]);
        v[j] = s[j] * u[j];
      }
      store8<float>(static_cast<float*>(p.c) + off, v);
      if (p.epi == kSwigluBwd) {
        float da[8], dg[8], du[8];
        load8<float>(static_cast<const float*>(p.aux) + off, da);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ds = da[j] * u[j];
          du[j] = da[j] * s[j];
          const float sig = 1.f / (1.f + expf(-g[j]));
          dg[j] = ds * sig * (1.f + g[j] * (1.f - sig));
        }
        float* dgu = static_cast<float*>(p.c2) + static_cast<long long>(gm) * 2 * p.N + gn;
        store8<float>(dgu, dg);
        store8<float>(dgu + p.N, du);
      }
    }
  }
}

template <typename TB, bool AK, bool BNC, bool DUAL>
__global__ void __launch_bounds__(NT, 1) gemm_kernel(Params p) {
  using G = Gemm<TB, AK, BNC, DUAL>;
  using SA = typename G::SA;
  using SB = typename G::SB;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + SA::SIZE};
  float* Bs[2] = {As[1] + SA::SIZE, As[1] + SA::SIZE + SB::SIZE};

  const int m0 = (p.m_fast ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (p.m_fast ? blockIdx.y : blockIdx.x) * (DUAL ? BN / 2 : BN);
  const float* ars = p.pro_on_b ? nullptr : p.rs;
  const float* brs = p.pro_on_b ? p.rs : nullptr;
  const float* A = static_cast<const float*>(p.a);
  const TB* B = static_cast<const TB*>(p.b);
  SA sa;
  SB sb;
  int o0, i0, no, ni;
  auto load = [&](int kt) {
    a_coords<AK>(m0, kt, p.M, p.K, o0, i0, no, ni);
    sa.load(A, p.lda, o0, i0, no, ni, ars, p.cs);
    b_coords<BNC>(n0, kt, p.N, p.K, o0, i0, no, ni);
    sb.load(B, p.ldb, o0, i0, no, ni, brs, p.cs);
  };
  const int nk = (p.K + BK - 1) / BK;
  load(0);
  sa.store(As[0]);
  sb.store(Bs[0]);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
    fma_tile<AK, BNC>(As[cur], Bs[cur], SA::LD, SB::LD, ty, tx, acc);
    if (kt + 1 < nk) {
      sa.store(As[cur ^ 1]);
      sb.store(Bs[cur ^ 1]);
    }
    __syncthreads();
  }

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
#ifdef KERNEL_GATE_EMIT_RACE
  // the kernel gate's seeded defect (a build variant, never the real
  // library): every CTA stores its tile to output tile (0, 0)
  epilogue<DUAL>(Cs, p, 0, 0);
#else
  epilogue<DUAL>(Cs, p, m0, n0);
#endif
}

// Consecutive CTAs share the tile of the operand they walk along: with the
// M tiles fastest, a column tile of B serves every row tile while it is in
// L2 and A stays there whole, so the larger operand (an fp32 weight of 92 or
// 262 MB at `base`, against 25 MB of rows) streams from HBM once.
template <typename TB, bool AK, bool BNC, bool DUAL>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int smem = Gemm<TB, AK, BNC, DUAL>::SMEM;
  auto kernel = gemm_kernel<TB, AK, BNC, DUAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int cols = DUAL ? BN / 2 : BN;
  const int mt = (p.M + BM - 1) / BM, nt = (p.N + cols - 1) / cols;
  const double a_bytes = static_cast<double>(p.M) * p.K * 4;
  const double b_bytes = static_cast<double>(p.N) * (DUAL ? 2 : 1) * p.K * sizeof(TB);
  p.m_fast = b_bytes > a_bytes;
  const dim3 grid = p.m_fast ? dim3(mt, nt) : dim3(nt, mt);
  if (p.M > 0 && p.N > 0) kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch_layout(const Params& p, int a_kcontig, int b_ncontig, cudaStream_t s) {
  if (p.epi != kStore) {   // the SwiGLU epilogues: X [M, H] times gate_up [H, 2I]
    if (!a_kcontig || !b_ncontig) return cudaErrorInvalidValue;
    return launch<TB, true, true, true>(p, s);
  }
  if (a_kcontig) {
    return b_ncontig ? launch<TB, true, true, false>(p, s) : launch<TB, true, false, false>(p, s);
  }
  return b_ncontig ? launch<TB, false, true, false>(p, s) : launch<TB, false, false, false>(p, s);
}

template <typename TB>
int gemm_attributes(int layout, int* out) {
#define GEMM_ATTR(AK, BNC, DUAL)                                                          \
  case (AK) | (BNC) << 1 | (DUAL) << 2:                                                   \
    return func_attributes(gemm_kernel<TB, AK, BNC, DUAL>, Gemm<TB, AK, BNC, DUAL>::SMEM, out);
  switch (layout) {
    GEMM_ATTR(true, true, false)
    GEMM_ATTR(true, false, false)
    GEMM_ATTR(false, true, false)
    GEMM_ATTR(false, false, false)
    GEMM_ATTR(true, true, true)
  }
#undef GEMM_ATTR
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = GEMM_TC_BM;       // rows of a CTA tile: two consumer warpgroups of 64
constexpr int BN = GEMM_TC_BN;       // columns of B a CTA reads (SwiGLU: BN / 2 gate + BN / 2 up)
constexpr int BK = GEMM_TC_BK;       // depth of a K step: 128 bytes of bf16, one swizzle span
constexpr int ST = GEMM_TC_STAGES;   // stages of the ring
constexpr int NT = 384;              // two consumer warpgroups, then the producer's
constexpr int SW = 128;              // swizzle span, bytes
constexpr int CH = SW / 2;           // its elements: the width of an MN-major box
constexpr int kChunk = CH * BK * 2;  // bytes of an MN-major box: [BK rows][CH]
constexpr int kA = BM * BK * 2, kB = BN * BK * 2;   // bytes of a stage's A and B tiles
constexpr int kStage = kA + kB;
constexpr int kBytes = 1024 + ST * kStage + 2 * ST * 8;   // 1024: alignment slack; full, empty
static_assert(BM == 128 && BK == CH && BN % (2 * CH) == 0 && ST >= 2 && kBytes <= 232448,
              "geometry");
}  // namespace tc

// the tensor maps of A and B (the gate half and the up half of gate_up for
// the SwiGLU epilogues: two maps, each clipped at column I, so a box past I
// is zero-filled and never reads the other half) and the launch's
// parameters, one kernel argument
struct TcArgs {
  CUtensorMap a, b, b2;
  Params p;
};

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // round to nearest even
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The accumulators give a lane columns 8 j + 2 t, + 1 (t = lane % 4) of its
// rows.  For a group of four j, x[jj] holding the pair of j = 4 q + jj, the
// four lanes of a quad exchange their pairs (a 4 x 4 transpose, its own
// inverse) so that lane t ends with the 8 columns 8 (4 q + t) .. + 7, in
// order: one 16-byte access a lane, 64 contiguous bytes a row.  Every lane
// of the warp must take part (shuffles): mask the accesses, not the call.
__device__ __forceinline__ uint4 quad_swap(const unsigned (&x)[4], int lane) {
  const int t = lane & 3;
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // lane s sends its pair of j = (s - k) & 3; lane t takes it from s = (t + k) & 3
    const int i = (t - k) & 3, s = (t + k) & 3;
    const unsigned mine = i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
    const unsigned got = k == 0 ? mine : __shfl_sync(0xffffffffu, mine, (lane & ~3) | s);
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = r == s ? got : w[r];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void quad_unswap(uint4 v, int lane, unsigned (&x)[4]) {
  const unsigned in[4] = {v.x, v.y, v.z, v.w};
  const uint4 o = quad_swap(in, lane);
  x[0] = o.x; x[1] = o.y; x[2] = o.z; x[3] = o.w;
}

__device__ __forceinline__ void store16(void* base, long long off_elems, uint4 v) {
  *reinterpret_cast<uint4*>(static_cast<bf16*>(base) + off_elems) = v;
}

// The SwiGLU epilogues on the pair (g, u) of accumulators: act's pair, and
// for kSwigluBwd with d_act's pair `da`, d_gate's and d_up's
template <int EPI>
__device__ __forceinline__ void swiglu_pair(float g0, float g1, float u0, float u1, unsigned da,
                                            unsigned& act, unsigned& dgate, unsigned& dup) {
  const float g[2] = {round_bf16(g0), round_bf16(g1)};
  const float u[2] = {round_bf16(u0), round_bf16(u1)};
  float s[2], v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s[e] = round_bf16(silu(g[e]));
    v[e] = round_bf16(s[e] * u[e]);
  }
  act = pack_bf16(v[0], v[1]);
  if (EPI == kSwigluBwd) {
    const float2 df = unpack_bf16(da);
    const float d[2] = {df.x, df.y};
    float dg[2], du[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ds = round_bf16(d[e] * u[e]);
      du[e] = round_bf16(d[e] * s[e]);
      const float sig = 1.f / (1.f + expf(-g[e]));
      dg[e] = round_bf16(ds * sig * (1.f + g[e] * (1.f - sig)));
    }
    dgate = pack_bf16(dg[0], dg[1]);
    dup = pack_bf16(du[0], du[1]);
  }
}

// TA: A is M-contiguous (MN-major); TB: B is N-contiguous (MN-major)
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(tc::NT, 1) gemm_tc_kernel(const __grid_constant__ TcArgs args) {
  constexpr int BM = tc::BM, BN = tc::BN, BK = tc::BK, ST = tc::ST, SW = tc::SW, CH = tc::CH;
  constexpr int kChunk = tc::kChunk, kA = tc::kA, kStage = tc::kStage;
  constexpr int WN = EPI == kStore ? BN : BN / 2;   // columns of each wgmma: output columns
  constexpr int NACC = EPI == kStore ? 1 : 2;       // accumulator arrays: C, or gate and up
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * kStage);
  uint64_t* empty = full + ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (p.m_fast ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (p.m_fast ? blockIdx.y : blockIdx.x) * WN;
  const int nk = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                                 // the producer warpgroup: one thread
    producer_registers();
    if (warp == 8 && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST, k0 = kt * BK;
        bar_wait(empty + s, ((kt / ST) & 1) ^ 1);   // the consumers released the stage
        unsigned char* As = base + s * kStage;
        unsigned char* Bs = As + kA;
        bar_expect(full + s, kStage);               // whole boxes, clipped or not
        if (TA) {
#pragma unroll
          for (int c = 0; c < BM / CH; ++c) tma_load_2d(As + c * kChunk, &args.a, m0 + c * CH, k0, full + s);
        } else {
          tma_load_2d(As, &args.a, k0, m0, full + s);
        }
        if (EPI != kStore) {                        // gate boxes, then up boxes
#pragma unroll
          for (int c = 0; c < WN / CH; ++c) {
            tma_load_2d(Bs + c * kChunk, &args.b, n0 + c * CH, k0, full + s);
            tma_load_2d(Bs + (WN / CH + c) * kChunk, &args.b2, n0 + c * CH, k0, full + s);
          }
        } else if (TB) {
#pragma unroll
          for (int c = 0; c < BN / CH; ++c) tma_load_2d(Bs + c * kChunk, &args.b, n0 + c * CH, k0, full + s);
        } else {
          tma_load_2d(Bs, &args.b, k0, n0, full + s);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 cw .. 64 cw + 63 of the tile
  consumer_registers();
  const int cw = warp >> 2;
  float acc[NACC][WN / 2];
#pragma unroll
  for (int h = 0; h < NACC; ++h)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[h][i] = 0.f;

  // one K step's wgmma group is kept in flight: step kt's stage is released
  // once step kt + 1's group is issued and step kt's has completed
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    bar_wait(full + s, (kt / ST) & 1);
    const unsigned char* As = base + s * kStage;
    const unsigned char* Bs = As + kA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: [rows][64] rows of 128 bytes, k16 = 32 bytes along the row;
      // MN-major: [64 K rows][64] boxes, k16 = 16 rows, LBO = the box stride
      const uint64_t da = TA ? wg_desc<SW>(As + cw * kChunk + kk * 16 * SW, kChunk, 8 * SW)
                             : wg_desc<SW>(As + cw * 64 * SW + kk * 32, 16, 8 * SW);
#pragma unroll
      for (int h = 0; h < NACC; ++h) {
        const unsigned char* Bh = Bs + h * (WN / CH) * kChunk;
        const uint64_t db = TB ? wg_desc<SW>(Bh + kk * 16 * SW, kChunk, 8 * SW)
                               : wg_desc<SW>(Bh + kk * 32, 16, 8 * SW);
        WgmmaSS<WN, TA, TB>::ss(acc[h], da, db, 1);
      }
    }
    wg_commit();
    wg_wait<1>();
    if (kt > 0) bar_arrive(empty + (kt - 1) % ST);
  }
  wg_wait<0>();
#pragma unroll
  for (int h = 0; h < NACC; ++h) wg_fence_regs(acc[h]);

  // accumulator 4 j + 2 e + {0, 1}: row lane / 4 + 8 e of the warp's 16,
  // columns 8 j + 2 (lane % 4) + {0, 1}
#ifdef KERNEL_GATE_EMIT_RACE
  // the kernel gate's seeded defect (a build variant, never the real
  // library): every CTA stores its tile to output tile (0, 0)
  const int r0 = cw * 64 + (warp & 3) * 16 + (lane >> 2), c0 = 0;
#else
  const int r0 = m0 + cw * 64 + (warp & 3) * 16 + (lane >> 2), c0 = n0;
#endif
  const int t = lane & 3;
  if (EPI == kStore && p.c_dtype == kFloat32) {   // a weight gradient: 8-byte pairs
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + 8 * e;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t, i = 4 * j + 2 * e;
        if (col < p.N)
          *reinterpret_cast<float2*>(static_cast<float*>(p.c) + static_cast<long long>(row) * p.ldc + col) =
              make_float2(round_bf16(acc[0][i]), round_bf16(acc[0][i + 1]));
      }
    }
    return;
  }
  // bf16 outputs: a group of four j a 16-byte access (quad_swap).
  // kSwigluBwd: every d_act access of the thread is issued before the first
  // store (the compiler cannot move a load above a store that may alias it)
  uint4 dl[2][WN / 32] = {};
  if constexpr (EPI == kSwigluBwd) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < WN / 32; ++q) {
        const int row = r0 + 8 * e, col = c0 + 8 * (4 * q + t);
        if (row < p.M && col < p.N)
          dl[e][q] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.aux) +
                                                          static_cast<long long>(row) * p.N + col));
      }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + 8 * e;
#pragma unroll
    for (int q = 0; q < WN / 32; ++q) {
      const int col = c0 + 8 * (4 * q + t);
      const bool ok = row < p.M && col < p.N;
      unsigned v[4], dg[4], du[4], da[4];
      if constexpr (EPI == kSwigluBwd) quad_unswap(dl[e][q], lane, da);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * (4 * q + jj) + 2 * e;
        if constexpr (EPI == kStore)
          v[jj] = pack_bf16(acc[0][i], acc[0][i + 1]);
        else
          swiglu_pair<EPI>(acc[0][i], acc[0][i + 1], acc[1][i], acc[1][i + 1],
                           EPI == kSwigluBwd ? da[jj] : 0u, v[jj], dg[jj], du[jj]);
      }
      const uint4 out = quad_swap(v, lane);
      if (ok) store16(p.c, static_cast<long long>(row) * p.ldc + col, out);
      if constexpr (EPI == kSwigluBwd) {
        const uint4 g4 = quad_swap(dg, lane), u4 = quad_swap(du, lane);
        const long long off = static_cast<long long>(row) * 2 * p.N + col;
        if (ok) {
          store16(p.c2, off, g4);
          store16(p.c2, off + p.N, u4);
        }
      }
    }
  }
}

// The TMA map of a row-major bf16 matrix [rows, cols] with row stride ld
// elements: boxes of box_rows rows by 64 columns (one 128-byte swizzle
// span), 128-byte swizzled; elements past either edge read as 0
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {tc::CH, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One CTA an output tile, rasterised as the fp32 launch's: the larger
// operand's tile is shared by consecutive CTAs (no split-K, no persistent
// loop: every element has one writer and one sum order)
template <bool TA, bool TB, int EPI>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int BM = tc::BM, BN = tc::BN, BK = tc::BK;
  constexpr int WN = EPI == kStore ? BN : BN / 2;
  static bool ready = false;
  if (p.M == 0 || p.N == 0) return cudaGetLastError();
  TcArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  // A: [M, K] boxes of BM rows, or stored [K, M] boxes of BK rows (no maps
  // for K = 0: the kernel loads nothing and stores zeros)
  cudaError_t e = p.K == 0 ? cudaSuccess
                  : TA     ? make_map(&a.a, p.a, p.K, p.M, p.lda, BK)
                           : make_map(&a.a, p.a, p.M, p.K, p.lda, BM);
  if (e == cudaSuccess && p.K > 0) {
    if (EPI != kStore) {   // gate_up [K, 2N]: the gate half and the up half at column N
      e = make_map(&a.b, p.b, p.K, p.N, p.ldb, BK);
      if (e == cudaSuccess)
        e = make_map(&a.b2, static_cast<const bf16*>(p.b) + p.N, p.K, p.N, p.ldb, BK);
    } else {               // B: stored [K, N] boxes of BK rows, or [N, K] boxes of BN rows
      e = TB ? make_map(&a.b, p.b, p.K, p.N, p.ldb, BK) : make_map(&a.b, p.b, p.N, p.K, p.ldb, BN);
      a.b2 = a.b;
    }
  }
  if (e == cudaSuccess) e = allow_smem(gemm_tc_kernel<TA, TB, EPI>, tc::kBytes, ready);
  if (e != cudaSuccess) return e;
  const int mt = (p.M + BM - 1) / BM, nt = (p.N + WN - 1) / WN;
  a.p.m_fast = static_cast<double>(p.N) * (EPI == kStore ? 1 : 2) > static_cast<double>(p.M);
  const dim3 grid = a.p.m_fast ? dim3(mt, nt) : dim3(nt, mt);
  gemm_tc_kernel<TA, TB, EPI><<<grid, tc::NT, tc::kBytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const Params& p, int a_kcontig, int b_ncontig, cudaStream_t s) {
  if (p.epi == kSwiglu || p.epi == kSwigluBwd) {
    if (!a_kcontig || !b_ncontig) return cudaErrorInvalidValue;
    return p.epi == kSwiglu ? launch_tc<false, true, kSwiglu>(p, s)
                            : launch_tc<false, true, kSwigluBwd>(p, s);
  }
  if (a_kcontig)
    return b_ncontig ? launch_tc<false, true, kStore>(p, s) : launch_tc<false, false, kStore>(p, s);
  return b_ncontig ? launch_tc<true, true, kStore>(p, s) : launch_tc<true, false, kStore>(p, s);
}

int tc_attributes(int variant, int* out) {
#define TC_ATTR(TA, TB, EPI) \
  case (TA) | (TB) << 1 | (EPI) << 2: return func_attributes(gemm_tc_kernel<TA, TB, EPI>, tc::kBytes, out);
  switch (variant) {
    TC_ATTR(false, true, kStore)
    TC_ATTR(false, false, kStore)
    TC_ATTR(true, true, kStore)
    TC_ATTR(true, false, kStore)
    TC_ATTR(false, true, kSwiglu)
    TC_ATTR(false, true, kSwigluBwd)
  }
#undef TC_ATTR
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the row passes
// ---------------------------------------------------------------------------

// out = bf16(x), or with SCALE bf16((x * rs[row]) * cs[col]): an fp32 weight
// rounded, or the RMS prologue's normed operand; one CTA a block of
// GEMM_PREP_ROWS rows, 8 elements (16-byte vectors) a thread at a time
template <typename TS, bool SCALE>
__global__ void __launch_bounds__(256) prep_kernel(const TS* __restrict__ x,
                                                   const float* __restrict__ rs,
                                                   const float* __restrict__ cs,
                                                   bf16* __restrict__ out, int rows, int cols) {
  const int r0 = blockIdx.x * GEMM_PREP_ROWS;
  const int per_row = cols / 8;
  const int n = min(GEMM_PREP_ROWS, rows - r0) * per_row;
  const long long base = static_cast<long long>(r0) * cols;
#pragma unroll 4
  for (int c = threadIdx.x; c < n; c += 256) {
    const long long off = base + static_cast<long long>(c) * 8;
    float f[8];
    load8<TS>(x + off, f);
    if (SCALE) {
      const float r = rs[r0 + c / per_row];
      float w[8];
      load8<float>(cs + (c % per_row) * 8, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = f[j] * r * w[j];
    }
    store8<bf16>(out + off, f);
  }
}

template <typename TS, bool SCALE>
cudaError_t launch_prep(const void* x, const void* rs, const void* cs, void* out, int rows,
                        int cols, cudaStream_t s) {
  if (rows > 0)
    prep_kernel<TS, SCALE><<<(rows + GEMM_PREP_ROWS - 1) / GEMM_PREP_ROWS, 256, 0, s>>>(
        static_cast<const TS*>(x), static_cast<const float*>(rs), static_cast<const float*>(cs),
        static_cast<bf16*>(out), rows, cols);
  return cudaGetLastError();
}

// inverse RMS of each row: one warp a row, 16-byte loads
template <typename T>
__global__ void row_rms_kernel(const T* __restrict__ x, float* __restrict__ r, int rows, int d,
                               float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<long long>(row) * d;
  float ss = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    float f[8];
    load8<T>(xr + i, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
  }
  ss = warp_sum(ss);
  if (lane == 0) r[row] = rsqrtf(ss / static_cast<float>(d) + eps);
}

}  // namespace

// kernel 0: gemm_kernel (fp32 compute) <a = B's dtype, b = AK | BNC << 1 | DUAL << 2>;
// kernel 1: row_rms_kernel<dtype>;
// kernel 2: gemm_tc_kernel (bf16 compute) <b = TA | TB << 1 | epilogue << 2>;
// kernel 3: prep_kernel<dtype = the source's, a = SCALE>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (kernel == 1) {
    if (dtype == kFloat32) return func_attributes(row_rms_kernel<float>, 0, out);
    if (dtype == kBFloat16) return func_attributes(row_rms_kernel<bf16>, 0, out);
    return cudaErrorInvalidValue;
  }
  if (kernel == 2 && dtype == kBFloat16) return tc_attributes(b, out);
  if (kernel == 3) {
    if (dtype == kFloat32) {
      return a ? func_attributes(prep_kernel<float, true>, 0, out)
               : func_attributes(prep_kernel<float, false>, 0, out);
    }
    if (dtype == kBFloat16 && a) return func_attributes(prep_kernel<bf16, true>, 0, out);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0 || dtype != kFloat32) return cudaErrorInvalidValue;
  if (a == kFloat32) return gemm_attributes<float>(b, out);
  if (a == kBFloat16) return gemm_attributes<bf16>(b, out);
  return cudaErrorInvalidValue;
}

// C = A B with the selected prologue and epilogue; see Params.  Dtypes:
// A and the compute dtype are `dtype` (fp32 or bf16), B is `b_dtype` (fp32:
// an fp32 or bf16 B, widened as it is loaded; bf16: bf16 only, and no
// prologue: prep_launch rounds and normalises first), C is `c_dtype` for
// kStore (the product is rounded to the compute dtype first) and the compute
// dtype otherwise.  Every pointer 16-byte aligned, every leading dimension
// and the inner extent of each operand a multiple of 8 (checked by the
// wrapper).
extern "C" int fused_gemm_launch(const void* a, const void* b, void* c, void* c2,
                                 const void* aux, const void* rs, const void* cs, int M, int N,
                                 int K, long long lda, long long ldb, long long ldc,
                                 int a_kcontig, int b_ncontig, int pro_on_b, int epi,
                                 int dtype, int b_dtype, int c_dtype, void* stream) {
  Params p{a, b, c, c2, aux, static_cast<const float*>(rs), static_cast<const float*>(cs),
           M, N, K, lda, ldb, ldc, pro_on_b, epi, c_dtype, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == kStore && c_dtype != kFloat32 && c_dtype != kBFloat16) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    if (b_dtype == kFloat32) return dispatch_layout<float>(p, a_kcontig, b_ncontig, s);
    if (b_dtype == kBFloat16) return dispatch_layout<bf16>(p, a_kcontig, b_ncontig, s);
  } else if (dtype == kBFloat16 && b_dtype == kBFloat16 && rs == nullptr) {
    return dispatch_tc(p, a_kcontig, b_ncontig, s);
  }
  return cudaErrorInvalidValue;
}

// out [rows, cols] bf16 = x rounded (rs, cs null) or bf16((x * rs[row]) *
// cs[col]); x fp32 or bf16 (bf16 only with the scales), cols a multiple of 8
extern "C" int prep_launch(const void* x, const void* rs, const void* cs, void* out, int rows,
                           int cols, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scale = rs != nullptr;
  if (x_dtype == kFloat32)
    return scale ? launch_prep<float, true>(x, rs, cs, out, rows, cols, s)
                 : launch_prep<float, false>(x, rs, cs, out, rows, cols, s);
  if (x_dtype == kBFloat16 && scale) return launch_prep<bf16, true>(x, rs, cs, out, rows, cols, s);
  return cudaErrorInvalidValue;
}

// r[row] = rsqrt(mean(x[row]^2) + eps) in fp32: the RMS prologue's row
// statistic (d a multiple of 8, rows 16-byte aligned)
extern "C" int row_rms_launch(const void* x, void* r, int rows, int d, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + 7) / 8;
  if (rows <= 0) return cudaGetLastError();
  if (dtype == kFloat32)
    row_rms_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                 static_cast<float*>(r), rows, d, eps);
  else if (dtype == kBFloat16)
    row_rms_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x),
                                                static_cast<float*>(r), rows, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

DEFINE_ERROR_STRING
