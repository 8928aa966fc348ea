"""The fusion sites' matrix products (``csrc/fused_gemm.cu``).

The products inside the emitted Pallas kernels of
``paddle_tpu/kernels/emit.py`` (``_row_block_call`` forwards,
``_single_block_call`` backwards) run here as one hand-written tiled GEMM
with the sites' prologues and epilogues; :mod:`.emit` composes the sites
from these calls.  Each function launches the kernel on CUDA tensors and
runs its plain PyTorch version (``*_reference``) on CPU tensors.

Operands are given as stored (contiguous, 16-byte aligned) with ``a_t`` /
``b_t`` naming a transposed use, so ``matmul(x, w)`` is X W,
``matmul(dy, w, b_t=True)`` is dY Wᵀ and ``matmul(x, dy, a_t=True)`` is
Xᵀ dY.  The compute dtype is ``a``'s (fp32 or bf16); ``b`` may be an fp32
weight, rounded to the compute dtype as it is loaded.  Every product is
summed in fp32 and rounded once to the compute dtype, then stored as
``out_dtype`` (a weight gradient: the bf16 product widened to fp32).  Every
contiguous (last) dimension must be a multiple of 8; row counts are free.

:func:`gemm_spec` and :func:`row_rms_spec` declare the two kernels'
launches for the verifier (:mod:`..analysis.kernel_lint`); :mod:`.emit`
lists them in each site's registry entry.  ``lib`` names the library to
launch from: the source's own, or a build variant (the kernel gate's
seeded ``fused_gemm_emit_race``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics, itemsize
from . import _build

__all__ = ["matmul", "matmul_reference", "swiglu_gate_up", "swiglu_gate_up_reference",
           "swiglu_gate_up_bwd", "swiglu_gate_up_bwd_reference", "row_rms", "row_rms_reference"]

_EPI_STORE, _EPI_SWIGLU, _EPI_SWIGLU_BWD = 0, 1, 2
_DTYPES = (torch.float32, torch.bfloat16)


def _stored(t: torch.Tensor, trans: bool) -> torch.Tensor:
    return t.T if trans else t


def _rms_scaled(x: torch.Tensor, rms) -> torch.Tensor:
    """The RMS prologue's plain version: each row of the stored ``x`` times
    its inverse RMS, then the norm weight, rounded to ``x``'s dtype."""
    r, w = rms[0], rms[1]
    return ((x.to(torch.float32) * r[:, None]) * w.to(torch.float32)).to(x.dtype)


def matmul_reference(a, b, *, a_t=False, b_t=False, out_dtype=None, rms=None):
    """Plain version of :func:`matmul`."""
    dt = a.dtype
    if rms is not None:
        if rms[2] == "a":
            a = _rms_scaled(a, rms)
        else:
            b = _rms_scaled(b, rms)
    c = _stored(a, a_t) @ _stored(b, b_t).to(dt)
    return c.to(out_dtype or dt)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(*tensors: torch.Tensor, dtypes=_DTYPES) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"fused_gemm: operands on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"fused_gemm takes {dtypes}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"fused_gemm: operands must be contiguous 2-D, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.shape[1] % 8 or t.data_ptr() % 16:
            raise ValueError(f"fused_gemm: the contiguous dim must be a multiple of 8 and "
                             f"rows 16-byte aligned, got {tuple(t.shape)}")


def _launch(a, b, c, *, a_t=False, b_t=False, c2=None, aux=None, rms=None, epi=_EPI_STORE,
            lib="fused_gemm"):
    M, K = _stored(a, a_t).shape
    N = c.shape[1]
    rs = cs = None
    pro_on_b = 0
    if rms is not None:
        rs, cs, pro_on_b = rms[0], rms[1], int(rms[2] == "b")
    lib = _build.load(lib)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_gemm_launch(
            _ptr(a), _ptr(b), _ptr(c), _ptr(c2), _ptr(aux), _ptr(rs), _ptr(cs), M, N, K,
            a.shape[1], b.shape[1], c.shape[1], int(not a_t), int(not b_t), pro_on_b, epi,
            _build.dtype_code(a.dtype), _build.dtype_code(b.dtype),
            _build.dtype_code(c.dtype), stream)
    _build.check(lib, err, "fused_gemm")


def _rms_operand(rms, x):
    """Checked fp32 (r, w, side) of an RMS prologue over the stored ``x``."""
    r, w, side = rms
    if side not in ("a", "b"):
        raise ValueError(f"fused_gemm: the prologue goes on 'a' or 'b', got {side!r}")
    r = r.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    if r.shape != (x.shape[0],) or w.shape != (x.shape[1],):
        raise ValueError(f"fused_gemm: prologue r {tuple(r.shape)} / w {tuple(w.shape)} do "
                         f"not fit {tuple(x.shape)}")
    if r.device != x.device or w.device != x.device or w.data_ptr() % 16:
        raise ValueError(f"fused_gemm: prologue operands must lie on {x.device}, the weight "
                         f"16-byte aligned")
    return r, w, side


def matmul(a: torch.Tensor, b: torch.Tensor, *, a_t: bool = False, b_t: bool = False,
           out_dtype: Optional[torch.dtype] = None,
           rms: Optional[Tuple[torch.Tensor, torch.Tensor, str]] = None,
           lib: str = "fused_gemm") -> torch.Tensor:
    """``op(a) @ op(b)`` with ``op`` a transpose where ``a_t`` / ``b_t``.
    ``rms = (r, w, side)`` scales the stored operand ``side`` (``"a"`` or
    ``"b"``) row by row by ``r`` and column by column by ``w`` first (the
    RMS prologue: the normed rows are never stored)."""
    if a.device.type == "cpu":
        return matmul_reference(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype, rms=rms)
    if a.device.type != "cuda":
        raise ValueError(f"fused_gemm: unsupported device {a.device}")
    _check(a, b)
    if rms is not None:
        rms = _rms_operand(rms, a if rms[2] == "a" else b)
    M, K = _stored(a, a_t).shape
    K2, N = _stored(b, b_t).shape
    if K != K2:
        raise ValueError(f"fused_gemm: inner dims {K} and {K2} differ")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"fused_gemm stores {_DTYPES}, got {out_dtype}")
    c = torch.empty(M, N, dtype=out_dtype, device=a.device)
    _check(c)
    _launch(a, b, c, a_t=a_t, b_t=b_t, rms=rms, lib=lib)
    return c


def swiglu_gate_up_reference(x, w_gate_up, intermediate_size):
    """Plain version of :func:`swiglu_gate_up`: ``silu(gate) * up`` of
    ``x @ w_gate_up``, each op rounding to the compute dtype."""
    gu = x @ w_gate_up.to(x.dtype)
    gate, up = torch.split(gu, [intermediate_size, intermediate_size], dim=-1)
    return F.silu(gate) * up


def _check_swiglu(x, w_gate_up, intermediate_size):
    _check(x, w_gate_up)
    if w_gate_up.shape != (x.shape[1], 2 * intermediate_size):
        raise ValueError(f"swiglu: gate_up {tuple(w_gate_up.shape)} does not fit x "
                         f"{tuple(x.shape)} and intermediate {intermediate_size}")


def swiglu_gate_up(x: torch.Tensor, w_gate_up: torch.Tensor,
                   intermediate_size: int, lib: str = "fused_gemm") -> torch.Tensor:
    """``act = silu(gate) * up`` with ``[gate, up] = x @ w_gate_up``: both
    halves in one CTA, so ``gu`` is never stored."""
    if x.device.type == "cpu":
        return swiglu_gate_up_reference(x, w_gate_up, intermediate_size)
    _check_swiglu(x, w_gate_up, intermediate_size)
    act = torch.empty(x.shape[0], intermediate_size, dtype=x.dtype, device=x.device)
    _check(act)
    _launch(x, w_gate_up, act, epi=_EPI_SWIGLU, lib=lib)
    return act


def swiglu_gate_up_bwd_reference(x, w_gate_up, d_act, intermediate_size):
    """Plain version of :func:`swiglu_gate_up_bwd`: autograd of the plain
    ``silu(gate) * up`` on the recomputed ``gu``."""
    gu = (x @ w_gate_up.to(x.dtype)).detach().requires_grad_()
    with torch.enable_grad():
        gate, up = torch.split(gu, [intermediate_size, intermediate_size], dim=-1)
        act = F.silu(gate) * up
    (d_gu,) = torch.autograd.grad(act, gu, d_act)
    return act.detach(), d_gu


def swiglu_gate_up_bwd(x: torch.Tensor, w_gate_up: torch.Tensor, d_act: torch.Tensor,
                       intermediate_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gu = x @ w_gate_up`` recomputed; returns ``act`` (for the down
    weight's gradient) and ``d_gu``, the gradient of ``silu(gate) * up``
    for the cotangent ``d_act``."""
    if x.device.type == "cpu":
        return swiglu_gate_up_bwd_reference(x, w_gate_up, d_act, intermediate_size)
    _check_swiglu(x, w_gate_up, intermediate_size)
    _check(d_act)
    if d_act.shape != (x.shape[0], intermediate_size) or d_act.dtype != x.dtype:
        raise ValueError(f"swiglu bwd: d_act {tuple(d_act.shape)} {d_act.dtype} does not fit")
    act = torch.empty_like(d_act)
    d_gu = torch.empty(x.shape[0], 2 * intermediate_size, dtype=x.dtype, device=x.device)
    _check(act, d_gu)
    _launch(x, w_gate_up, act, c2=d_gu, aux=d_act, epi=_EPI_SWIGLU_BWD)
    return act, d_gu


def row_rms_reference(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    return torch.rsqrt(torch.mean(torch.square(x.to(torch.float32)), dim=-1) + epsilon)


def row_rms(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """fp32 ``rsqrt(mean(x^2) + eps)`` of each row of ``x`` [rows, d]: the
    RMS prologue's row statistic."""
    if x.device.type == "cpu":
        return row_rms_reference(x, epsilon)
    _check(x)
    r = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lib = _build.load("fused_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.row_rms_launch(x.data_ptr(), r.data_ptr(), x.shape[0], x.shape[1],
                                 float(epsilon), _build.dtype_code(x.dtype), stream)
    _build.check(lib, err, "row_rms")
    return r


# ---------------------------------------------------------------------------
# the launches' specs (for kernels.registry; see analysis.kernel_lint)
# ---------------------------------------------------------------------------

def gemm_spec(label: str, M: int, N: int, K: int, dtype, *, b_dtype=None, c_dtype=None,
              a_t: bool = False, b_t: bool = False, epi: int = _EPI_STORE,
              rms_side: Optional[str] = None, lib: str = "fused_gemm") -> KernelSpec:
    """``gemm_kernel``'s launch for ``op(A) [M, K] @ op(B) [K, N]`` as
    :func:`_launch` makes it: CTA tiles of BM x BN (BN / 2 output columns
    for the SwiGLU epilogues, whose CTA reads the gate and the up columns),
    the grid's axes swapped by ``m_fast`` exactly as the launch swaps them
    (the larger operand streams once), and the K loop as an in-CTA axis.
    Operand tiles are masked past every edge.  The two shared stages of A
    and B are reused by the epilogue's fp32 tile."""
    geo = _build.GEOMETRY["fused_gemm"]
    BM, BN, BK, LDC = (geo[n] for n in ("GEMM_BM", "GEMM_BN", "GEMM_BK", "GEMM_LDC"))
    b_dtype = b_dtype or dtype
    c_dtype = c_dtype or dtype
    dual = epi != _EPI_STORE
    ak, bnc = not a_t, not b_t
    cols = BN // 2 if dual else BN
    mt, nt, nk = -(-M // BM), -(-N // cols), -(-K // BK)
    m_fast = N * (2 if dual else 1) * K * itemsize(b_dtype) > M * K * itemsize(dtype)
    grid = (mt, nt, nk) if m_fast else (nt, mt, nk)

    def tiles(x, y):
        return (x, y) if m_fast else (y, x)        # -> (m tile, n tile)

    def blk(name, shape, dt, block, fn):
        return BlockUse(shape, dt, block, lambda x, y, k: fn(*tiles(x, y), k), name=name,
                        masked=True)

    a_use = (blk("a", (M, K), dtype, (BM, BK), lambda m, n, k: (m, k)) if ak else
             blk("a", (K, M), dtype, (BK, BM), lambda m, n, k: (k, m)))
    if dual:       # gate columns [n0, n0 + cols) and up columns [N + n0, ...)
        b_use = blk("b", (K, 2, N), b_dtype, (BK, 2, cols), lambda m, n, k: (k, 0, n))
    elif bnc:
        b_use = blk("b", (K, N), b_dtype, (BK, BN), lambda m, n, k: (k, n))
    else:
        b_use = blk("b", (N, K), b_dtype, (BN, BK), lambda m, n, k: (n, k))
    inputs = [a_use, b_use]
    if rms_side is not None:    # the prologue's per-row r and per-column w of the stored operand
        stored_rows = {("a", True): (M, BM, 0), ("a", False): (K, BK, 2),
                       ("b", True): (K, BK, 2), ("b", False): (N, BN, 1)}
        stored_cols = {("a", True): (K, BK, 2), ("a", False): (M, BM, 0),
                       ("b", True): (N, BN, 1), ("b", False): (K, BK, 2)}
        side = (rms_side, ak if rms_side == "a" else bnc)
        for name, (extent, block, which) in (("rms_r", stored_rows[side]),
                                             ("rms_w", stored_cols[side])):
            inputs.append(blk(name, (extent,), torch.float32, (block,),
                              lambda m, n, k, w=which: ((m, n, k)[w],)))
    outputs = [blk("c", (M, N), c_dtype if not dual else dtype, (BM, cols),
                   lambda m, n, k: (m, n))]
    if epi == _EPI_SWIGLU_BWD:
        inputs.append(blk("d_act", (M, N), dtype, (BM, cols), lambda m, n, k: (m, n)))
        outputs.append(blk("d_gu", (M, 2, N), dtype, (BM, 2, cols), lambda m, n, k: (m, 0, n)))
    pad = 16 // itemsize(dtype)                         # Stage::LD: rows padded by 16 bytes
    a_outer, a_inner = (BM, BK) if ak else (BK, BM)
    b_outer, b_inner = (BK, BN) if bnc else (BN, BK)
    stages = [ScratchUse((2, a_outer, a_inner + pad), dtype),
              ScratchUse((2, b_outer, b_inner + pad), dtype)]
    extra = BM * LDC * 4 - sum(s.nbytes() for s in stages)
    if extra > 0:                                   # the epilogue tile outgrows the stages
        stages.append(ScratchUse((extra,), torch.uint8))
    return KernelSpec(
        f"gemm_kernel[{label}]", grid=grid, inputs=inputs, outputs=outputs,
        scratch=stages + [ScratchUse((BM, BN), torch.float32, "registers")],
        dimension_semantics=cuda_semantics(2, 1),
        carried_scratch=[(len(stages), frozenset({2}))],    # the accumulators, over K
        cuda=(lib, 0, _build.dtype_code(dtype), _build.dtype_code(b_dtype),
              int(ak) | int(bnc) << 1 | int(dual) << 2))


def row_rms_spec(rows: int, d: int, dtype) -> KernelSpec:
    """``row_rms_kernel``'s launch: one warp a row, 8 rows a CTA."""
    return KernelSpec(
        "row_rms_kernel", grid=(-(-rows // 8),),
        inputs=[BlockUse((rows, d), dtype, (8, d), lambda i: (i, 0), name="x", masked=True)],
        outputs=[BlockUse((rows,), torch.float32, (8,), lambda i: (i,), name="r", masked=True)],
        dimension_semantics=cuda_semantics(1),
        cuda=("fused_gemm", 1, _build.dtype_code(dtype), 0, 0))
