"""Write ``csrc/wgmma.cuh``: Hopper's ``wgmma.mma_async`` as inline PTX.

A ``wgmma`` names every accumulator register of the warpgroup's m64 x N
tile (N / 2 fp32 values a thread), which C++ cannot spell as an array, so
the wrappers are written out here for each N the kernels use::

    python -m paddle_tpu_torch.kernels._wgmma_gen > paddle_tpu_torch/kernels/csrc/wgmma.cuh

``tests/test_torch_kernels.py`` holds the header to this output.
"""

from __future__ import annotations

import sys

SS_N = (32, 64, 128)          # both operands from shared memory, both K-major
RS_N = (32, 64, 128, 256)     # A from registers, B transposed (MN-major)
# both operands from shared memory, each K-major or MN-major (the fused
# GEMM's four operand layouts): every (trans A, trans B) pair at these N
SS_T_N = (128, 256)
TRANS = ((0, 0), (0, 1), (1, 0), (1, 1))

HEADER = """\
// Hopper warpgroup matrix multiply (wgmma.mma_async), bf16 in, fp32
// accumulators, for the m64 x N x k16 shapes the kernels use.  Written by
// paddle_tpu_torch/kernels/_wgmma_gen.py; do not edit by hand.
//
// Wgmma<N>::ss(d, desc_a, desc_b, scale_d): d (+)= A B with A [64 x 16]
//   and B [N x 16] both K-major in shared memory, read through their
//   matrix descriptors;
// Wgmma<N>::rs_tb(d, a, desc_b, scale_d): d (+)= A B with A [64 x 16] in
//   registers (four b32 of bf16 pairs a thread, the m16n8k16 A-fragment
//   layout per warp) and B [16 x N] MN-major (N contiguous) in shared memory.
// WgmmaSS<N, TA, TB>::ss(d, desc_a, desc_b, scale_d): d (+)= A B with both
//   in shared memory, A [64 x 16] MN-major (M contiguous) when TA and
//   K-major otherwise, B [16 x N] MN-major (N contiguous) when TB and
//   K-major otherwise: wgmma's transpose immediates.
// scale_d = 0 overwrites d.  d holds the thread's N / 2 accumulators in the
// layout of m16n8 accumulators per warp: warp w of the group owns rows
// 16 w .. 16 w + 15, and d[4 j .. 4 j + 3] are columns 8 j + 2 (lane % 4)
// (+ 1) of rows lane / 4 and lane / 4 + 8.
#pragma once

#include <stdint.h>

template <int N>
struct Wgmma;

template <int N, int TA, int TB>
struct WgmmaSS;
"""


def _outs(regs):
    return ", ".join(f"%{i}" for i in range(regs))


def _cons(regs):
    lines, row = [], []
    for i in range(regs):
        row.append(f'"+f"(d[{i}])')
        if len(row) == 8:
            lines.append(", ".join(row))
            row = []
    if row:
        lines.append(", ".join(row))
    return (",\n" + " " * 8).join(lines)


def _ss(n, trans_a=0, trans_b=0):
    r = n // 2
    return f"""  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{_outs(r)}}}, "
        "%{r}, %{r + 1}, p, 1, 1, {trans_a}, {trans_b};\\n}}\\n"
        : {_cons(r)}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
"""


def _rs(n):
    r = n // 2
    return f"""  static __device__ __forceinline__ void rs_tb(float (&d)[{r}], const unsigned (&a)[4],
                                               uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{_outs(r)}}}, "
        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {_cons(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }}
"""


def header() -> str:
    parts = [HEADER]
    for n in sorted(set(SS_N) | set(RS_N)):
        body = (_ss(n) if n in SS_N else "") + (_rs(n) if n in RS_N else "")
        parts.append(f"\ntemplate <>\nstruct Wgmma<{n}> {{\n{body}}};\n")
    for n in SS_T_N:
        for ta, tb in TRANS:
            parts.append(f"\ntemplate <>\nstruct WgmmaSS<{n}, {ta}, {tb}> {{\n{_ss(n, ta, tb)}}};\n")
    return "".join(parts)


if __name__ == "__main__":
    sys.stdout.write(header())
