"""The fusion sites' matrix products (``csrc/fused_gemm.cu``).

The products inside the emitted Pallas kernels of
``paddle_tpu/kernels/emit.py`` (``_row_block_call`` forwards,
``_single_block_call`` backwards) run here as hand-written GEMMs with the
sites' prologues and epilogues; :mod:`.emit` composes the sites from these
calls.  Each function launches the kernels on CUDA tensors and runs its
plain PyTorch version (``*_reference``) on CPU tensors.

Operands are given as stored (contiguous, 16-byte aligned) with ``a_t`` /
``b_t`` naming a transposed use, so ``matmul(x, w)`` is X W,
``matmul(dy, w, b_t=True)`` is dY Wᵀ and ``matmul(x, dy, a_t=True)`` is
Xᵀ dY.  The compute dtype is ``a``'s (fp32 or bf16); ``b`` may be an fp32
weight, rounded to the compute dtype first.  Every product is summed in fp32
and rounded once to the compute dtype, then stored as ``out_dtype`` (a
weight gradient: the bf16 product widened to fp32).  Every contiguous (last)
dimension must be a multiple of 8; row counts are free.

bf16 runs the warp-specialised tensor-core kernel (``gemm_tc_kernel``: TMA
into a ring of shared-memory stages, ``wgmma``, the epilogues in
registers), which reads bf16 operands only: an fp32 weight is rounded
(:func:`to_compute`) and the RMS prologue's normed operand written by the
preparation pass (``prep_kernel``) first.  fp32 runs the CUDA-core kernel
(``gemm_kernel``), which widens a bf16 B and applies the prologue as it
loads.

:func:`gemm_spec`, :func:`prep_spec`, :func:`row_rms_spec` and
:func:`matmul_specs` declare the launches for the verifier
(:mod:`..analysis.kernel_lint`); :mod:`.emit` lists them in each site's
registry entry.  ``lib`` names the library to launch the GEMM from: the
source's own, or a build variant (the kernel gate's seeded
``fused_gemm_emit_race``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics, itemsize
from . import _build

__all__ = ["matmul", "matmul_reference", "swiglu_gate_up", "swiglu_gate_up_reference",
           "swiglu_gate_up_bwd", "swiglu_gate_up_bwd_reference", "row_rms", "row_rms_reference",
           "to_compute"]

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


def _prep(x: torch.Tensor, rms=None) -> torch.Tensor:
    """``prep_kernel``: the stored ``x`` in bf16, rounded, or with ``rms =
    (r, w, side)`` its rows scaled by ``r`` and its columns by ``w`` first
    (the RMS prologue's normed operand)."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    rs, cs = (None, None) if rms is None else rms[:2]
    lib = _build.load("fused_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prep_launch(x.data_ptr(), _ptr(rs), _ptr(cs), out.data_ptr(), x.shape[0],
                              x.shape[1], _build.dtype_code(x.dtype), stream)
    _build.check(lib, err, "fused_gemm prep")
    return out


def to_compute(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w`` as the products of compute ``dtype`` read it: an fp32 weight
    under bf16 compute rounded to bf16 (to nearest even: the bits of
    ``.to(torch.bfloat16)``), by the preparation pass on a CUDA tensor;
    anything else is ``w`` itself (the fp32 kernel reads a bf16 B as it
    is).  The sites call it once per weight and site call."""
    if w.dtype != torch.float32 or dtype != torch.bfloat16:
        return w
    if w.device.type == "cpu":
        return w.to(dtype)
    _check(w)
    return _prep(w)


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
    if a.dtype == torch.bfloat16:     # the tensor-core kernel reads bf16 operands only
        if rms is not None:
            if rms[2] == "a":
                a = _prep(a, rms)
            else:
                b = _prep(b, rms)
            rms = None
        b = to_compute(b, a.dtype)
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
    w_gate_up = to_compute(w_gate_up, x.dtype)
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
    w_gate_up = to_compute(w_gate_up, x.dtype)
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

def _affine(*dims):
    """An affine index map: each block dim is a grid axis (an int) or the
    constant block ``("const", c)``."""
    return ("affine", tuple(d if isinstance(d, tuple) else ("axis", d) for d in dims))


def tc_grid(M: int, N: int, epi: int = _EPI_STORE):
    """``gemm_tc_kernel``'s grid and rasterisation, as ``launch_tc`` makes
    them: ``(grid (x, y), m_fast, output columns a CTA)``.  With ``m_fast``
    blockIdx.x walks the row tiles, so consecutive CTAs share B's column
    tile (B is the larger operand: every operand is bf16 there)."""
    geo = _build.GEOMETRY["fused_gemm"]
    cols = geo["GEMM_TC_BN"] // (1 if epi == _EPI_STORE else 2)
    mt, nt = -(-M // geo["GEMM_TC_BM"]), -(-N // cols)
    m_fast = N * (1 if epi == _EPI_STORE else 2) > M
    return ((mt, nt) if m_fast else (nt, mt)), m_fast, cols


def tc_boxes(M: int, N: int, K: int, *, a_t: bool = False, b_t: bool = False,
             epi: int = _EPI_STORE):
    """The TMA maps of a ``gemm_tc_kernel`` launch and the boxes its
    producer loads, as ``launch_tc`` encodes them: ``maps = {name: (first
    stored column, (columns, rows), box (columns, rows))}`` over the stored
    operands (row-major, a box clipped at the map's edges and zero-filled
    past them), and ``boxes(m tile, n tile, k step) -> [(map, (column,
    row)), ...]``, each box's origin in its map."""
    geo = _build.GEOMETRY["fused_gemm"]
    BM, BN, BK = geo["GEMM_TC_BM"], geo["GEMM_TC_BN"], geo["GEMM_TC_BK"]
    CH = 64                                        # one 128-byte swizzle span of bf16
    _, _, cols = tc_grid(M, N, epi)
    maps = {"a": (0, (M, K), (CH, BK)) if a_t else (0, (K, M), (CH, BM))}
    if epi != _EPI_STORE:                          # gate_up [K, 2N]: two maps, each N wide
        maps.update(gate=(0, (N, K), (CH, BK)), up=(N, (N, K), (CH, BK)))
    else:
        maps["b"] = (0, (N, K), (CH, BK)) if not b_t else (0, (K, N), (CH, BN))

    def boxes(mt, nt, kt):
        m0, n0, k0 = mt * BM, nt * cols, kt * BK
        out = ([("a", (m0 + c * CH, k0)) for c in range(BM // CH)] if a_t else [("a", (k0, m0))])
        if epi != _EPI_STORE:
            out += [(h, (n0 + c * CH, k0)) for h in ("gate", "up") for c in range(cols // CH)]
        elif not b_t:
            out += [("b", (n0 + c * CH, k0)) for c in range(BN // CH)]
        else:
            out.append(("b", (k0, n0)))
        return out

    return maps, boxes


def gemm_spec(label: str, M: int, N: int, K: int, dtype, *, b_dtype=None, c_dtype=None,
              a_t: bool = False, b_t: bool = False, epi: int = _EPI_STORE,
              rms_side: Optional[str] = None, lib: str = "fused_gemm") -> KernelSpec:
    """The GEMM's launch for ``op(A) [M, K] @ op(B) [K, N]`` as
    :func:`_launch` makes it: CTA tiles over the output (half the columns
    for the SwiGLU epilogues, whose CTA reads the gate and the up columns),
    the grid's axes swapped by ``m_fast`` exactly as the launch swaps them
    (the larger operand streams once), and the K loop as an in-CTA axis;
    operand tiles masked past every edge (TMA zero-fills them on bf16).
    bf16 (``gemm_tc_kernel``) takes bf16 operands without a prologue
    (:func:`matmul_specs` adds the preparation passes); its shared memory is
    the ring's stages and their full / empty barriers.  fp32
    (``gemm_kernel``): the two shared stages of A and B, reused by the
    epilogue's fp32 tile."""
    b_dtype = b_dtype or dtype
    c_dtype = c_dtype or dtype
    dual = epi != _EPI_STORE
    ak, bnc = not a_t, not b_t
    geo = _build.GEOMETRY["fused_gemm"]
    if dtype == torch.bfloat16:
        if b_dtype != torch.bfloat16 or rms_side is not None:
            raise ValueError("gemm_tc_kernel reads bf16 operands without a prologue: "
                             "see matmul_specs")
        BM, BN, BK, ST = (geo[n] for n in ("GEMM_TC_BM", "GEMM_TC_BN", "GEMM_TC_BK",
                                            "GEMM_TC_STAGES"))
        (gx, gy), m_fast, cols = tc_grid(M, N, epi)
        grid = (gx, gy, -(-K // BK))
        m, n = (0, 1) if m_fast else (1, 0)        # the grid axes of the row and column tiles
        stages = [ScratchUse((1024,), torch.uint8),             # alignment slack
                  ScratchUse((ST, BM, BK), torch.bfloat16),     # the ring: A tiles
                  ScratchUse((ST, BN, BK), torch.bfloat16),     # B tiles (gate + up)
                  ScratchUse((2 * ST,), torch.int64)]           # full and empty barriers
        name = "gemm_tc_kernel"
        cuda = (lib, 2, _build.dtype_code(dtype), 0, int(a_t) | int(bnc) << 1 | epi << 2)
    else:
        BM, BN, BK, LDC = (geo[n] for n in ("GEMM_BM", "GEMM_BN", "GEMM_BK", "GEMM_LDC"))
        cols = BN // 2 if dual else BN
        mt, nt = -(-M // BM), -(-N // cols)
        m_fast = N * (2 if dual else 1) * K * itemsize(b_dtype) > M * K * itemsize(dtype)
        grid = ((mt, nt) if m_fast else (nt, mt)) + (-(-K // BK),)
        m, n = (0, 1) if m_fast else (1, 0)
        pad = 16 // itemsize(dtype)                     # Stage::LD: rows padded by 16 bytes
        a_outer, a_inner = (BM, BK) if ak else (BK, BM)
        b_outer, b_inner = (BK, BN) if bnc else (BN, BK)
        stages = [ScratchUse((2, a_outer, a_inner + pad), dtype),
                  ScratchUse((2, b_outer, b_inner + pad), dtype)]
        extra = BM * LDC * 4 - sum(s.nbytes() for s in stages)
        if extra > 0:                                   # the epilogue tile outgrows the stages
            stages.append(ScratchUse((extra,), torch.uint8))
        name = "gemm_kernel"
        cuda = (lib, 0, _build.dtype_code(dtype), _build.dtype_code(b_dtype),
                int(ak) | int(bnc) << 1 | int(dual) << 2)

    def blk(bname, shape, dt, block, *dims):
        return BlockUse(shape, dt, block, _affine(*dims), name=bname, masked=True)

    a_use = (blk("a", (M, K), dtype, (BM, BK), m, 2) if ak else
             blk("a", (K, M), dtype, (BK, BM), 2, m))
    if dual:       # gate columns [n0, n0 + cols) and up columns [N + n0, ...)
        b_use = blk("b", (K, 2, N), b_dtype, (BK, 2, cols), 2, ("const", 0), n)
    elif bnc:
        b_use = blk("b", (K, N), b_dtype, (BK, BN), 2, n)
    else:
        b_use = blk("b", (N, K), b_dtype, (BN, BK), n, 2)
    inputs = [a_use, b_use]
    if rms_side is not None:    # the prologue's per-row r and per-column w of the stored operand
        stored_rows = {("a", True): (M, BM, m), ("a", False): (K, BK, 2),
                       ("b", True): (K, BK, 2), ("b", False): (N, BN, n)}
        stored_cols = {("a", True): (K, BK, 2), ("a", False): (M, BM, m),
                       ("b", True): (N, BN, n), ("b", False): (K, BK, 2)}
        side = (rms_side, ak if rms_side == "a" else bnc)
        for rname, (extent, block, axis) in (("rms_r", stored_rows[side]),
                                             ("rms_w", stored_cols[side])):
            inputs.append(blk(rname, (extent,), torch.float32, (block,), axis))
    outputs = [blk("c", (M, N), c_dtype if not dual else dtype, (BM, cols), m, n)]
    if epi == _EPI_SWIGLU_BWD:
        inputs.append(blk("d_act", (M, N), dtype, (BM, cols), m, n))
        outputs.append(blk("d_gu", (M, 2, N), dtype, (BM, 2, cols), m, ("const", 0), n))
    return KernelSpec(
        f"{name}[{label}]", grid=grid, inputs=inputs, outputs=outputs,
        scratch=stages + [ScratchUse((BM, BN), torch.float32, "registers")],
        dimension_semantics=cuda_semantics(2, 1),
        carried_scratch=[(len(stages), frozenset({2}))],    # the accumulators, over K
        cuda=cuda)


def prep_spec(label: str, rows: int, cols: int, dtype, scale: bool = False) -> KernelSpec:
    """``prep_kernel``'s launch over a stored [rows, cols] ``dtype``
    operand: one CTA a block of ``GEMM_PREP_ROWS`` whole rows, into a bf16
    copy (with ``scale``, rows times the RMS prologue's r and columns times
    its w)."""
    R = _build.GEOMETRY["fused_gemm"]["GEMM_PREP_ROWS"]
    rows_blk = (R, cols)
    inputs = [BlockUse((rows, cols), dtype, rows_blk, _affine(0, ("const", 0)), name="x",
                       masked=True)]
    if scale:
        inputs += [BlockUse((rows,), torch.float32, (R,), _affine(0), name="rms_r", masked=True),
                   BlockUse((cols,), torch.float32, (cols,), _affine(("const", 0)), name="rms_w")]
    return KernelSpec(
        f"prep_kernel[{label}]", grid=(-(-rows // R),), inputs=inputs,
        outputs=[BlockUse((rows, cols), torch.bfloat16, rows_blk, _affine(0, ("const", 0)),
                          name="out", masked=True)],
        dimension_semantics=cuda_semantics(1),
        cuda=("fused_gemm", 3, _build.dtype_code(dtype), int(scale), 0))


def matmul_specs(label: str, M: int, N: int, K: int, dtype, *, b_dtype=None, c_dtype=None,
                 a_t: bool = False, b_t: bool = False, epi: int = _EPI_STORE,
                 rms_side: Optional[str] = None, lib: str = "fused_gemm") -> list:
    """Every launch of :func:`matmul` (``epi`` store) or
    :func:`swiglu_gate_up` / :func:`swiglu_gate_up_bwd`, in order: on bf16
    the preparation passes (the RMS prologue's normed operand, an fp32 B
    rounded) and then the tensor-core GEMM; on fp32 the one GEMM."""
    b_dtype = b_dtype or dtype
    if dtype != torch.bfloat16:
        return [gemm_spec(label, M, N, K, dtype, b_dtype=b_dtype, c_dtype=c_dtype, a_t=a_t,
                          b_t=b_t, epi=epi, rms_side=rms_side, lib=lib)]
    a_stored = (K, M) if a_t else (M, K)
    b_stored = ((K, 2 * N) if epi != _EPI_STORE else (N, K) if b_t else (K, N))
    specs = []
    if rms_side == "a":
        specs.append(prep_spec(f"{label}: normed a", *a_stored, dtype, scale=True))
    elif rms_side == "b":
        specs.append(prep_spec(f"{label}: normed b", *b_stored, b_dtype, scale=True))
        b_dtype = torch.bfloat16
    if b_dtype == torch.float32:
        specs.append(prep_spec(f"{label}: b rounded", *b_stored, b_dtype))
    return specs + [gemm_spec(label, M, N, K, dtype, c_dtype=c_dtype, a_t=a_t, b_t=b_t,
                              epi=epi, lib=lib)]


def row_rms_spec(rows: int, d: int, dtype) -> KernelSpec:
    """``row_rms_kernel``'s launch: one warp a row, 8 rows a CTA."""
    return KernelSpec(
        "row_rms_kernel", grid=(-(-rows // 8),),
        inputs=[BlockUse((rows, d), dtype, (8, d), lambda i: (i, 0), name="x", masked=True)],
        outputs=[BlockUse((rows,), torch.float32, (8,), lambda i: (i,), name="r", masked=True)],
        dimension_semantics=cuda_semantics(1),
        cuda=("fused_gemm", 1, _build.dtype_code(dtype), 0, 0))
