"""Residual add + RMSNorm forward and backward (``csrc/add_rms_norm.cu``).

The ``fuse_add_rms_norm`` site of ``paddle_tpu/kernels/emit.py`` and the
norm half of the ``fuse_rms_norm_head`` site's backward; :mod:`.emit`
composes the sites from these calls.  Each function launches the kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors.
:func:`fwd_spec` and :func:`bwd_specs` declare the launches for the
verifier (:mod:`..analysis.kernel_lint`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics
from . import _build
from .rms_norm import rms_norm_reference

__all__ = ["add_rms_norm_fwd", "add_rms_norm_fwd_reference", "add_rms_norm_bwd",
           "add_rms_norm_bwd_reference"]

_X_DTYPES = (torch.float32, torch.bfloat16)
_GROUPS = _build.GEOMETRY["add_rms_norm"]["ADD_RMS_NORM_GROUPS"]   # most row groups of dw's first stage


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


def _check(x, w, *others):
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"add_rms_norm takes {_X_DTYPES}, got {x.dtype}")
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"add_rms_norm weight must be fp32 or {x.dtype}, got {w.dtype}")
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
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty(max(1, min(x.shape[0], _GROUPS)), x.shape[1], dtype=torch.float32,
                          device=x.device)
    lib = _build.load("add_rms_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.add_rms_norm_bwd_launch(
            x.data_ptr(), None if h is None else h.data_ptr(), w.data_ptr(),
            None if d_s is None else d_s.data_ptr(), d_normed.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dw.data_ptr(),
            x.shape[0], x.shape[1], float(epsilon), _build.dtype_code(x.dtype),
            _build.dtype_code(w.dtype), stream)
    _build.check(lib, err, "add_rms_norm backward")
    return dx, None if h is None else dx, dw


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


def bwd_specs(rows: int, d: int, dtype, w_dtype, with_h: bool, with_ds: bool):
    """``add_rms_norm_bwd_kernel``, grid (groups,) walking its group's rows
    in order with the group's dw partial row in shared memory (carried
    over that walk only), then ``dw_reduce_kernel`` adding the groups'
    partials, 32 columns a CTA, in group order."""
    want = min(rows, _GROUPS)
    per = -(-rows // want)
    groups = -(-rows // per)
    codes = (_build.dtype_code(dtype), _build.dtype_code(w_dtype))

    def row(name):
        return BlockUse((rows, d), dtype, (1, d),
                        lambda g, r: (min(g * per + r, rows - 1), 0), name=name)

    inputs = [row("x")] + ([row("h")] if with_h else []) + [
        BlockUse((d,), w_dtype, (d,), lambda g, r: (0,), name="w")] + (
        [row("d_s")] if with_ds else []) + [row("d_normed")]
    bwd = KernelSpec(
        "add_rms_norm_bwd_kernel", grid=(groups, per), inputs=inputs,
        outputs=[row("dx"), BlockUse((groups, d), torch.float32, (1, d),
                                     lambda g, r: (g, 0), name="partial")],
        scratch=[ScratchUse((d,), torch.float32), _PARTIALS],
        dimension_semantics=cuda_semantics(1, 1),
        carried_scratch=[(0, frozenset({1}))],      # dw of the group's rows so far
        cuda=("add_rms_norm", 1, *codes, d))
    reduce = KernelSpec(
        "dw_reduce_kernel", grid=(-(-d // 32),),
        inputs=[BlockUse((groups, d), torch.float32, (groups, 32), lambda c: (0, c),
                         name="partial", masked=True)],
        outputs=[BlockUse((d,), w_dtype, (32,), lambda c: (c,), name="dw", masked=True)],
        scratch=[ScratchUse((8, 33), torch.float32)],
        dimension_semantics=cuda_semantics(1),
        cuda=("add_rms_norm", 2, *codes, 0))
    return [bwd, reduce]
