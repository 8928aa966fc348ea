"""Residual add + RMSNorm forward and backward (``csrc/add_rms_norm.cu``).

The ``fuse_add_rms_norm`` site of ``paddle_tpu/kernels/emit.py``, the
norm half of the ``fuse_rms_norm_head`` site's backward, and the stock
RMSNorm's backward (:func:`.rms_norm.rms_norm_backward`, through
:func:`norm_bwd`); :mod:`.emit` composes the sites from these calls.  Each
function launches the kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors.  :func:`bwd_plan` picks the backward's kernel and
its geometry; :func:`fwd_spec` and :func:`bwd_specs` declare the launches
for the verifier (:mod:`..analysis.kernel_lint`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics, itemsize
from . import _build
from .rms_norm import rms_norm_reference

__all__ = ["add_rms_norm_fwd", "add_rms_norm_fwd_reference", "add_rms_norm_bwd",
           "add_rms_norm_bwd_reference", "bwd_plan", "norm_bwd"]

_X_DTYPES = (torch.float32, torch.bfloat16)
_GEO = _build.GEOMETRY["add_rms_norm"]
_GROUPS = _GEO["ADD_RMS_NORM_GROUPS"]      # most row groups of the wide backward's dw
H100_SMS = 132                             # the SM count the registry's specs assume
MAX_ROW_VECTORS = 4096                     # 16-byte vectors a row: the forward's limit


def add_rms_norm_fwd_reference(x, h, w, epsilon):
    s = x + h
    return s, rms_norm_reference(s, w, epsilon)


def add_rms_norm_bwd_reference(x, h, w, d_s, d_normed, epsilon):
    """Autograd of the plain ``(s, rms(s) w)`` with ``s = x + h`` (``s = x``
    when ``h`` is None; ``d_s`` None adds nothing): ``(dx, dh, dw)``, ``dh``
    None without ``h``."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        hs = None if h is None else h.detach().requires_grad_()
        ws = w.detach().requires_grad_()
        s = xs if hs is None else xs + hs
        normed = rms_norm_reference(s, ws, epsilon)
        outs, cts = [normed], [d_normed]
        if d_s is not None:
            outs.append(s)
            cts.append(d_s)
        inputs = [xs, ws] if hs is None else [xs, hs, ws]
        grads = torch.autograd.grad(outs, inputs, cts)
    if hs is None:
        return grads[0], None, grads[1]
    return grads


def _check(x, w, *others, w_dtypes=None):
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"add_rms_norm takes {_X_DTYPES}, got {x.dtype}")
    w_dtypes = (torch.float32, x.dtype) if w_dtypes is None else w_dtypes
    if w.dtype not in w_dtypes:
        raise TypeError(f"add_rms_norm weight must be one of {w_dtypes}, got {w.dtype}")
    d = x.shape[-1]
    if x.dim() != 2 or d % 8 or w.shape != (d,):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)} must be 2-D with a width that is "
                         f"a multiple of 8, w {tuple(w.shape)} of that width")
    for t in (x, w, *others):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("add_rms_norm: operands must be contiguous and 16-byte aligned "
                             f"on {x.device}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"add_rms_norm: {tuple(t.shape)} {t.dtype} does not match x")


def add_rms_norm_fwd(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                     epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + h`` and ``normed = rms_norm(s) w`` over rows ``[rows, d]``
    in one pass."""
    if x.device.type == "cpu":
        return add_rms_norm_fwd_reference(x, h, w, epsilon)
    _check(x, w, h)
    s, y = torch.empty_like(x), torch.empty_like(x)
    lib = _build.load("add_rms_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.add_rms_norm_fwd_launch(
            x.data_ptr(), h.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), x.shape[0],
            x.shape[1], float(epsilon), _build.dtype_code(x.dtype),
            _build.dtype_code(w.dtype), stream)
    _build.check(lib, err, "add_rms_norm forward")
    return s, y


# ---------------------------------------------------------------------------
# the backward's plan: the ring kernel, or the wide kernel past it
# ---------------------------------------------------------------------------

class BwdPlan(NamedTuple):
    """The backward's launch.  ``kind`` ``"ring"``: ``add_rms_norm_bwd_ring_
    kernel`` on ``ctas`` CTAs, ``teams`` teams of ``warps`` warps a row and a
    ring of ``slots`` row slots; ``"wide"``: ``add_rms_norm_bwd_kernel`` over
    ``ctas`` row groups (``warps``, ``teams``, ``slots`` 0).  ``smem_bytes``:
    the dynamic shared memory a CTA."""
    kind: str
    warps: int
    teams: int
    slots: int
    ctas: int
    smem_bytes: int


def bwd_plan(rows: int, d: int, dtype, *, with_h: bool = True, with_ds: bool = True,
             sms: int = H100_SMS) -> BwdPlan:
    """The backward kernel for ``rows`` rows of ``d`` (``dtype`` rows; ``h``
    and ``d_s`` given or not) on a card of ``sms`` SMs.  A row of ``nv``
    16-byte vectors takes ``ceil(nv / (32 ARN_LANE_VECTORS))`` warps; the
    ring kernel runs where that is at most ``ARN_CONSUMER_WARPS`` and two
    row slots (a row of each tensor a slot) fit ``ARN_RING_BYTES``: as many
    slots as fit, up to ``ARN_MAX_SLOTS``, and as many teams as the consumer
    warps hold, up to the slots; ``ARN_CTAS_PER_SM`` CTAs an SM, at most one
    a row.  Wider rows, up to the forward's ``MAX_ROW_VECTORS``, take the
    wide kernel; past that :class:`ValueError`."""
    size = itemsize(dtype)
    nv = d * size // 16
    if d <= 0 or d % 8 or nv > MAX_ROW_VECTORS:
        raise ValueError(f"add_rms_norm backward: a row of {d} {dtype} values; the kernels take "
                         f"widths that are a multiple of 8, at most {MAX_ROW_VECTORS} 16-byte "
                         "vectors a row (the RMSNorm forward's limit)")
    warps = -(-nv // (32 * _GEO["ARN_LANE_VECTORS"]))
    slot_bytes = (2 + bool(with_h) + bool(with_ds)) * d * size
    slots = min(_GEO["ARN_MAX_SLOTS"], _GEO["ARN_RING_BYTES"] // slot_bytes)
    if warps <= _GEO["ARN_CONSUMER_WARPS"] and slots >= 2:
        teams = min(_GEO["ARN_CONSUMER_WARPS"] // warps, slots)
        return BwdPlan("ring", warps, teams, slots, min(rows, sms * _GEO["ARN_CTAS_PER_SM"]),
                       slots * slot_bytes)
    groups = 0
    if rows > 0:
        per = -(-rows // min(rows, _GROUPS))
        groups = -(-rows // per)
    return BwdPlan("wide", 0, 0, 0, groups, d * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_launch(x, h, w, d_s, d_normed, epsilon, stock):
    """Launch the backward (``stock``: under the stock RMSNorm's kernel
    names): ``(dx, dw)``."""
    rows, d = x.shape
    plan = bwd_plan(rows, d, x.dtype, with_h=h is not None, with_ds=d_s is not None,
                    sms=_sm_count(x.device.index if x.device.index is not None
                                  else torch.cuda.current_device()))
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty(max(1, plan.ctas), d, dtype=torch.float32, device=x.device)
    lib = _build.load("add_rms_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.add_rms_norm_bwd_launch(
            x.data_ptr(), None if h is None else h.data_ptr(), w.data_ptr(),
            None if d_s is None else d_s.data_ptr(), d_normed.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), rows, d, float(epsilon),
            _build.dtype_code(x.dtype), _build.dtype_code(w.dtype), plan.warps, plan.teams,
            plan.slots, plan.ctas, int(stock), stream)
    _build.check(lib, err, "rms_norm backward" if stock else "add_rms_norm backward")
    return dx, dw


def add_rms_norm_bwd(x: torch.Tensor, h: Optional[torch.Tensor], w: torch.Tensor,
                     d_s: Optional[torch.Tensor], d_normed: torch.Tensor, epsilon: float):
    """The gradients ``(dx, dh, dw)`` of ``(s, rms_norm(s) w)``, ``s = x +
    h``, recomputed from the primals, for the cotangents ``d_s`` and
    ``d_normed``.  Without ``h`` (the head's final norm) ``s = x`` and
    ``dh`` is None; without ``d_s`` only ``normed`` is differentiated.
    ``dx`` and ``dh`` are equal, as autograd of ``x + h`` gives both the
    gradient of ``s``: the kernel stores it once and both are that tensor.
    ``dw`` is summed in a fixed order (deterministic)."""
    if x.device.type == "cpu":
        return add_rms_norm_bwd_reference(x, h, w, d_s, d_normed, epsilon)
    others = [t for t in (h, d_s, d_normed) if t is not None]
    _check(x, w, *others)
    dx, dw = _bwd_launch(x, h, w, d_s, d_normed, epsilon, stock=False)
    return dx, None if h is None else dx, dw


def norm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
             epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``rms_norm(x) w`` over CUDA rows ``[rows, d]`` for the
    cotangent ``dy``: the backward's norm-only mode under the stock
    RMSNorm's kernel names (``rms_norm_bwd_*``), ``w`` of any dtype the
    RMSNorm forward takes and ``dw`` in it.  Counted and admitted by its
    caller, :func:`.rms_norm.rms_norm_backward`."""
    _check(x, w, dy, w_dtypes=(torch.float32, torch.bfloat16, torch.float16))
    return _bwd_launch(x, None, w, None, dy, epsilon, stock=True)


# ---------------------------------------------------------------------------
# the launches' specs (for kernels.registry; see analysis.kernel_lint)
# ---------------------------------------------------------------------------

# block_sum2's fp32 (a, b) partial of each warp, static shared memory
_PARTIALS = ScratchUse((32, 2), torch.float32)


def fwd_spec(rows: int, d: int, dtype, w_dtype) -> KernelSpec:
    """``add_rms_norm_fwd_kernel``: one CTA a row."""
    def row(name):
        return BlockUse((rows, d), dtype, (1, d), lambda i: (i, 0), name=name)

    return KernelSpec(
        "add_rms_norm_fwd_kernel", grid=(rows,),
        inputs=[row("x"), row("h"), BlockUse((d,), w_dtype, (d,), lambda i: (0,), name="w")],
        outputs=[row("s"), row("normed")], scratch=[_PARTIALS],
        dimension_semantics=cuda_semantics(1),
        cuda=("add_rms_norm", 0, _build.dtype_code(dtype), _build.dtype_code(w_dtype), 0))


def bwd_specs(rows: int, d: int, dtype, w_dtype, with_h: bool, with_ds: bool,
              stock: bool = False):
    """The backward's two launches as :func:`bwd_plan` picks them (on an
    H100's SMs).  The ring kernel: grid (CTAs, rows a CTA), CTA ``c``
    walking its contiguous rows in order (a CTA with a row fewer reads its
    last again), its dw columns carried in registers over that walk, its
    partial row written once; shared memory the ring (the teams' dw rows
    over it at the end), the mbarriers and the row sums of a team's warps.
    Or the wide kernel: grid (groups, rows a group), the group's dw partial
    row in shared memory.  Then ``dw_reduce_kernel`` adding the partial
    rows, 32 columns a CTA, in order.  ``stock``: the stock RMSNorm's
    norm-only launches under their own names (inputs x, w, dy)."""
    plan = bwd_plan(rows, d, dtype, with_h=with_h, with_ds=with_ds)
    codes = (_build.dtype_code(dtype), _build.dtype_code(w_dtype))
    groups = plan.ctas
    per = -(-rows // groups)                  # most rows a CTA
    if plan.kind == "ring":
        def row_of(c, j):
            return min(c * rows // groups + j, (c + 1) * rows // groups - 1)
    else:
        def row_of(c, j):
            return min(c * per + j, rows - 1)

    def row(name):
        return BlockUse((rows, d), dtype, (1, d), lambda c, j: (row_of(c, j), 0), name=name)

    weight = BlockUse((d,), w_dtype, (d,), lambda c, j: (0,), name="w")
    inputs = [row("x")] + ([row("h")] if with_h else []) + [weight] + (
        [row("d_s")] if with_ds else []) + [row("dy" if stock else "d_normed")]
    outputs = [row("dx"), BlockUse((groups, d), torch.float32, (1, d), lambda c, j: (c, 0),
                                   name="partial")]
    if plan.kind == "ring":
        mode = int(with_h) | int(with_ds) << 1
        main = KernelSpec(
            "rms_norm_bwd_ring_kernel" if stock else "add_rms_norm_bwd_ring_kernel",
            grid=(groups, per), inputs=inputs, outputs=outputs,
            scratch=[ScratchUse((plan.smem_bytes,), torch.uint8),          # the ring
                     ScratchUse((2 * _GEO["ARN_MAX_SLOTS"],), torch.int64),  # full, empty
                     ScratchUse((2 * _GEO["ARN_CONSUMER_WARPS"], 2), torch.float32),  # row sums
                     ScratchUse((plan.teams, d), torch.float32, "registers")],  # dw by team
            dimension_semantics=cuda_semantics(1, 1),
            carried_scratch=[(3, frozenset({1}))],    # dw of the CTA's rows so far
            cuda=("add_rms_norm", 4 if stock else 3, *codes, d, plan.slots * 4 + mode))
    else:
        main = KernelSpec(
            "rms_norm_bwd_wide_kernel" if stock else "add_rms_norm_bwd_kernel",
            grid=(groups, per), inputs=inputs, outputs=outputs,
            scratch=[ScratchUse((d,), torch.float32), _PARTIALS],
            dimension_semantics=cuda_semantics(1, 1),
            carried_scratch=[(0, frozenset({1}))],      # dw of the group's rows so far
            cuda=("add_rms_norm", 5 if stock else 1, *codes, d))
    reduce = KernelSpec(
        "rms_norm_bwd_dw_kernel" if stock else "dw_reduce_kernel", grid=(-(-d // 32),),
        inputs=[BlockUse((groups, d), torch.float32, (groups, 32), lambda c: (0, c),
                         name="partial", masked=True)],
        outputs=[BlockUse((d,), w_dtype, (32,), lambda c: (c,), name="dw", masked=True)],
        scratch=[ScratchUse((8, 33), torch.float32)],
        dimension_semantics=cuda_semantics(1),
        cuda=("add_rms_norm", 6 if stock else 2, *codes, 0))
    return [main, reduce]
