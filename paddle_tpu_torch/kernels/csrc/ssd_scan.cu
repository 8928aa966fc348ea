// Chunked SSD (state-space duality) scan for Hopper: the forward.
//
// Replaces the Pallas kernel paddle_tpu/kernels/ssd_scan.py (_ssd_scan_call).
// For each of G independent (batch, head) recurrences over T tokens, in
// chunks of L tokens with the [N, P] state S carried from chunk to chunk:
//
//   cum   = cumsum(la)                          (inclusive, over the chunk)
//   M     = mask(s <= t) . (C B^T) . exp(cum_t - cum_s)
//   y     = M x + exp(cum_t) (C S_k)            (S_k: the state entering chunk k)
//   S_k+1 = exp(cum_{L-1}) S_k + (B . exp(cum_{L-1} - cum))^T x
//
// x [G,T,P], b/c [G,T,N], la [G,T] in; y [G,T,P], s [G,N,P] and every state
// entering a chunk, states [G, nc + 1, N, P] (states[0] = 0, states[nc] =
// s), out; all fp32, contiguous.  The backward (ssd_scan_bwd.cu) reads the
// states, so it repeats nothing serial.  exp is taken only of cum_t - cum_s
// for s <= t, of cum_{L-1} - cum_s and of cum_t, all <= 0 for la <= 0: a
// strongly negative log-decay underflows to 0 and never gives inf or 0/0.
//
// Bound.  A chunk needs L (L + 1) N (C B^T over the L (L + 1) / 2 entries
// with s <= t) + L (L + 1) P (M x over the same entries) + 2 L N P (C S) +
// 2 L N P (the state increment) flops against 4 L (P + 2N + 1) bytes of
// input: at the 8B widths (L 128, N 128, P 64) about 45 flops a byte, above
// the fp32 CUDA-core balance point (67 TFLOP/s over 3.35 TB/s = 20) but
// below the TF32 tensor cores' (three products a product: 495 / 3 over
// 3.35 = 49), so on tensor cores the scan is held by its bytes.
//
// Design: the shape of the public Mamba-2 SSD kernels ("chunk state, state
// passing, chunk scan"), three launches on the stream:
//   (a) ssd::chunk_state_kernel, one CTA a (g, chunk, column block), all
//       parallel: the chunk's state increment U_k = (B . w)^T x [N, PB] into
//       states[k + 1], and its total log-decay cum_{L-1} into tot [G, nc,
//       P / PB];
//   (b) ssd::state_pass_kernel, sequential over chunks, parallel over (g,
//       4-float groups of the state): S_k+1 = exp(tot_k) S_k + U_k in place;
//   (c) ssd::chunk_apply_kernel<false>, one CTA a (g, chunk, column
//       block), all parallel: C B^T and M in the CTA, y = M x + exp(cum) .
//       (C S_k); N swept through two buffers (two CTAs share an SM).
// The tiles arrive by 16-byte cp.async copies.  Every product is split
// TF32 on the tensor cores (ssd_tile.cuh).  P runs in column blocks of PB =
// 64, 32 or 8 columns, one CTA each, the blocks of a chunk adjacent in the
// grid; C B^T is formed again by each column block of a recurrence (P 128:
// twice).  Sums run in one fixed order that does not depend on T: a
// chunk's outputs read nothing of later chunks, and a chunk of zero rows (x
// = b = c = 0, la = 0) adds exactly zero to S with a decay of exactly 1, so
// zero rows are exact no-ops on every other row and on S.
#include "ssd_tile.cuh"

using namespace ssd;

// kernel 0: chunk_state_kernel (forward), 1: state_pass_kernel (forward),
// 2: chunk_apply_kernel (forward), each at <a = column block PB, b = N,
// c = L>
extern "C" int kernel_attributes(int kernel, int dtype, int a, int b, int c, int* out) {
  if (!shape_ok(b, c) || (a != 8 && a != 32 && a != 64)) return cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
      return func_attributes(chunk_state_kernel<true>,
                             static_cast<int>(ChunkStateLayout{c, npad(b), a, false}.bytes()), out);
    case 1:
      return func_attributes(state_pass_kernel<false>, 0, out);
    case 2:
      return func_attributes(chunk_apply_kernel<false>,
                             static_cast<int>(ApplyLayout{c, npad(b), a, false}.bytes()), out);
  }
  return cudaErrorInvalidValue;
}

// Any P that is a multiple of 8 (column blocks of 64, 32 or 8 columns, one
// CTA each), N in {4, 8, 16, 32, 64, 128}, L in {16, 32, 64, 128}, T a
// multiple of L; every operand 16-byte aligned.  Any other shape is refused.
// tot [G, T / L, P / PB] is scratch.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c, const void* la,
                               void* y, void* s, void* states, void* tot, int G, int T, int P,
                               int N, int L, void* stream) {
  if (L <= 0 || T % L != 0 || !shape_ok(N, L)) return cudaErrorInvalidValue;
  const int pb = column_block(P);
  if (pb == 0) return cudaErrorInvalidValue;
  const int nc = T / L;
  if (G == 0 || nc == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunkStateLayout sl{L, npad(N), pb, false};
  const ApplyLayout cl{L, npad(N), pb, false};
  cudaError_t err = allow_smem(chunk_state_kernel<true>, sl.bytes());
  if (err == cudaSuccess) err = allow_smem(chunk_apply_kernel<false>, cl.bytes());
  if (err != cudaSuccess) return err;
  const int chunks = G * nc * (P / pb);   // (g, chunk, column block), blocks adjacent
  chunk_state_kernel<true><<<chunks, kThreads, sl.bytes(), st>>>(
      static_cast<const float*>(b), static_cast<const float*>(x), static_cast<const float*>(la),
      static_cast<float*>(states), static_cast<float*>(tot), T, P, N, L, pb, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_kernel<false><<<G * cdiv(N * P, 4 * kThreads), kThreads, 0, st>>>(
      static_cast<float*>(states), static_cast<const float*>(tot), nullptr,
      static_cast<float*>(s), nc, N * P, P / pb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_apply_kernel<false><<<chunks, kThreads, cl.bytes(), st>>>(
      static_cast<const float*>(c), static_cast<const float*>(b), static_cast<const float*>(la),
      static_cast<const float*>(x), static_cast<const float*>(states), static_cast<float*>(y),
      T, P, N, L, pb, 0);
  return cudaGetLastError();
}

DEFINE_ERROR_STRING
