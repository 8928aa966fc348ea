"""RMSNorm (port of ``paddle_tpu/kernels/rms_norm.py``).

:func:`rms_norm` is differentiable through :class:`_RMSNorm`, a
``torch.autograd.Function``.  Its forward launches the hand-written kernels
of ``csrc/rms_norm.cu`` (the counterpart of the Pallas
``_rms_norm_fwd_kernel_call``; :func:`plan` picks one from the row count and
width) on a CUDA tensor and runs
:func:`rms_norm_reference`, the plain version with the same fp32-statistics
expression as ``_rms_norm_ref``, on a CPU tensor.  Its backward is
:func:`rms_norm_backward`, the port of ``_rms_bwd_rule`` (which the JAX
package computes in XLA outside any Pallas kernel): on a CUDA tensor the
hand-written add + RMSNorm backward of ``csrc/add_rms_norm.cu`` in its
norm-only mode (:func:`.add_rms_norm.norm_bwd`), on a CPU tensor
:func:`rms_norm_backward_reference`, the plain fp32 expression.

Registered in :mod:`.registry` as ``rms_norm`` (the JAX registry's name,
presets and example shape) and ``rms_norm_bwd`` (the port's own: the JAX
package's backward has no kernel); :func:`rms_norm` and
:func:`rms_norm_backward` are admitted there first when
``FLAGS_kernel_admission`` is on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis.kernel_lint import (BlockUse, KernelSpec, ScratchUse, cuda_semantics, itemsize,
                                    tabulated)
from ..framework.dispatch import shape_inference, tls
from . import _build, export_ops, registry

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_backward", "rms_norm_backward_reference"]

_X_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.float32, torch.bfloat16, torch.float16)   # fp32 params, bf16 compute


def rms_norm_reference(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                       epsilon: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.to(torch.float32)
    return out.to(x.dtype)


def rms_norm_backward_reference(x, weight, dy, epsilon: float = 1e-6):
    """``(dx, dw)`` of ``y = rms_norm(x, weight)``: with ``r = rsqrt(mean(x^2)
    + eps)``, ``x_hat = x r`` and ``g = dy w``, ``dx = r (g - x_hat mean(g
    x_hat))`` and ``dw = sum(dy x_hat)`` over all rows, in fp32; ``dx`` in
    x's dtype, ``dw`` in the weight's."""
    x32 = x.to(torch.float32)
    dy32 = dy.to(torch.float32)
    w32 = weight.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    r = torch.rsqrt(var + epsilon)
    x_hat = x32 * r
    g = dy32 * w32
    dx = r * (g - x_hat * torch.mean(g * x_hat, dim=-1, keepdim=True))
    dw = torch.sum(dy32 * x_hat, dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dw.to(weight.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    loads and 1-D TMA copies need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rms_norm_backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                      epsilon: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``y = rms_norm(x, weight)`` for the cotangent ``dy``:
    on CUDA tensors the add + RMSNorm backward kernel in its norm-only mode
    (rows ``x.reshape(-1, d)``; ``dw`` in the weight's dtype, summed in a
    fixed order), on CPU tensors :func:`rms_norm_backward_reference`."""
    registry.ensure_admitted("rms_norm_bwd", x.device,
                             registry.dtype_key(x.dtype, weight.dtype))
    if x.device.type == "cpu":
        return rms_norm_backward_reference(x, weight, dy, epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_backward: unsupported device {x.device}")
    from .add_rms_norm import norm_bwd

    if dy.shape != x.shape:
        raise ValueError(f"rms_norm backward: dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    dx, dw = norm_bwd(_aligned(x.reshape(-1, d)), _aligned(weight), _aligned(dy.reshape(-1, d)),
                      epsilon)
    rms_norm_backward.launches += 1
    return dx.view(x.shape), dw


rms_norm_backward.launches = 0


_GEO = _build.GEOMETRY["rms_norm"]
# fewer rows finish sooner a CTA a row, a vector a thread: on an H100 at
# D 4096 bf16 the CTA kernel leads at 256 rows and the row kernel from 384
# (`kernel_ab.py rms_plan`, PERF.md); the Engine's prefill forwards give
# 256-2048 rows (n same-bucket prompts, n in 4/2/1), a decode step 8
_ROW_KERNEL_MIN_ROWS = 384


def plan(rows: int, d: int, x_dtype) -> Tuple[str, int]:
    """The kernel the launcher runs for ``rows`` rows of ``d``: ``("rows",
    nv)`` where the row is at most 32 groups of 32 16-byte vectors (16 KB)
    and there are ``_ROW_KERNEL_MIN_ROWS`` rows or more: ``nv`` is the groups
    rounded up to a power of two, at least ``RMS_LANE_VECTORS``, and a row
    takes ``nv / RMS_LANE_VECTORS`` warps; else ``("cta", 0)``, a CTA a row."""
    groups = -(-(d // (16 // itemsize(x_dtype))) // 32)     # 32-vector groups a row
    if rows >= _ROW_KERNEL_MIN_ROWS and 0 < groups <= 32:
        return "rows", max(_GEO["RMS_LANE_VECTORS"], 1 << (groups - 1).bit_length())
    return "cta", 0


def _launch(x: torch.Tensor, w: torch.Tensor, epsilon: float) -> torch.Tensor:
    d = x.shape[-1]
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"rms_norm kernel takes {_X_DTYPES}, got {x.dtype}")
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"rms_norm kernel weight takes {_W_DTYPES}, got {w.dtype}")
    if d % 8 != 0 or d // (16 // x.element_size()) > 4096:
        raise ValueError(f"rms_norm kernel needs hidden % 8 == 0 and at most "
                         f"4096 16-byte vectors a row; got hidden={d}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rms_norm weight must be [{d}] on {x.device}")
    x = x.contiguous()
    w = w.contiguous()
    if w.data_ptr() % 16:          # the kernels read the weight as 16-byte vectors
        w = w.clone()
    y = torch.empty_like(x)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned rows")
    rows = x.numel() // d
    lib = _build.load("rms_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rms_norm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  rows, d, float(epsilon),
                                  _build.dtype_code(x.dtype),
                                  _build.dtype_code(w.dtype), plan(rows, d, x.dtype)[1],
                                  stream)
    _build.check(lib, err, "rms_norm")
    rms_norm.launches += 1
    return y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        if x.device.type != "cuda":     # the CPU, or a recording's shape inference
            return rms_norm_reference(x, weight, epsilon)
        return _launch(x, weight, epsilon)

    @staticmethod
    def backward(ctx, dy):
        # the kernel's norm-only mode on the card, the plain version on the CPU
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, dy, ctx.epsilon)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, differentiable in ``x`` and ``weight``: the
    CUDA kernel for a CUDA ``x``, the plain version for a CPU ``x`` (and for
    the meta ``x`` of a recording's shape inference: it moves no data).  Under
    ``export_ops.export_trace`` the call is the custom op
    ``paddle_tpu_torch::rms_norm``."""
    registry.ensure_admitted("rms_norm", x.device, registry.dtype_key(
        x.dtype, x.dtype if weight is None else weight.dtype))
    if x.device.type not in ("cpu", "cuda") and not shape_inference(x):
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if weight is None:
        weight = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    if tls.exporting:
        return export_ops.rms_norm_op(x, weight, float(epsilon))
    return _RMSNorm.apply(x, weight, float(epsilon))


rms_norm.launches = 0


# ---------------------------------------------------------------------------
# kernel-registry entry (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def kernel_spec(rows: int, d: int, x_dtype, w_dtype) -> KernelSpec:
    """The launch :func:`plan` picks, one CTA a row: ``rms_norm_rows_kernel``,
    ``nv / RMS_LANE_VECTORS`` warps holding the row in registers and its
    group sums in static shared memory; or ``rms_norm_kernel``, the fp32
    warp partials and the row's inverse RMS in static shared memory."""
    kind, nv = plan(rows, d, x_dtype)
    codes = (_build.dtype_code(x_dtype), _build.dtype_code(w_dtype))
    row_of_cta = ("affine", (("axis", 0), ("const", 0)))   # any grid size
    x = BlockUse((rows, d), x_dtype, (1, d), row_of_cta, name="x")
    y = BlockUse((rows, d), x_dtype, (1, d), row_of_cta, name="y")
    weight = BlockUse((d,), w_dtype, (d,), ("affine", (("const", 0),)), name="w")
    if kind == "rows":
        return KernelSpec(
            "rms_norm_rows_kernel", grid=(rows,), inputs=[x, weight], outputs=[y],
            scratch=[ScratchUse((nv,), torch.float32),                     # group sums
                     ScratchUse((32 * nv, 16), torch.uint8, "registers")],  # the row
            dimension_semantics=cuda_semantics(1),
            cuda=("rms_norm", 1, *codes, nv))
    return KernelSpec(
        "rms_norm_kernel", grid=(rows,), inputs=[x, weight], outputs=[y],
        scratch=[ScratchUse((32,), torch.float32), ScratchUse((1,), torch.float32)],
        dimension_semantics=cuda_semantics(1),
        cuda=("rms_norm", 0, *codes, 0))


# the main path's shapes beside the JAX registry's [64, 256]: the Engine's
# largest prefill forward (4 same-bucket prompts of 512 tokens) at
# Llama-3-8B's width (bf16 weight), and a `base` training step's rows over
# its fp32 weight
_SHAPES = {"": (64, 256), "serve": (4 * 512, 4096), "base": (3 * 2048, 2048)}


def _registry_example(dtype="bfloat16"):
    """The JAX registry's [64, 256] bf16, or x and weight in ``dtype``
    (``"x+w"``: the train path's bf16 rows over an fp32 weight; ``@serve``
    / ``@base``: at that path's shape)."""
    names, _, at = dtype.partition("@")
    rows, d = _SHAPES[at]
    names = names.split("+")
    x_dt, w_dt = getattr(torch, names[0]), getattr(torch, names[-1])

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (torch.randn(rows, d, generator=g).to(x_dt).to(device),
                torch.randn(d, generator=g).to(w_dt).to(device))

    return ([kernel_spec(rows, d, x_dt, w_dt)], lambda x, w: rms_norm(x, w),
            lambda x, w: rms_norm_reference(x, w), args)


_BF16_TOL = (1e-3, 1.6e-2, None)     # two bf16 ulps of the plain value
registry.register(
    "rms_norm", _registry_example,
    presets=("tiny", "small", "base", "longctx", "moe", "ocr"),
    description="fused RMSNorm forward: row statistics kept in VMEM",
    dtypes=("bfloat16", "float32", "bfloat16+float32", "bfloat16@serve",
            "bfloat16+float32@base"),
    tol={"bfloat16": _BF16_TOL, "float32": (1e-5, 1e-5, None), "bfloat16+float32": _BF16_TOL,
         "bfloat16@serve": _BF16_TOL, "bfloat16+float32@base": _BF16_TOL})


# the backward (``rms_norm_bwd``): the JAX registry's [64, 256] at every
# (rows, weight) dtype pair the forward's kernels take, and bf16 rows over
# an fp32 weight at the training paths' shapes (`base`: batch 3 x 2048 rows
# of 2048; `longctx`: 16384 rows; `ssd_train`: batch 2 x 4096 rows of 4096)
# and at a ragged one (1037 rows of 264: 33 vectors a row)
_BWD_SHAPES = {"": (64, 256), "base": (3 * 2048, 2048), "longctx": (16384, 2048),
               "ssd_train": (2 * 4096, 4096), "ragged": (1037, 264)}
_BWD_DTYPES = ("bfloat16", "float32", "bfloat16+float32", "bfloat16+float16",
               "float32+bfloat16", "float32+float16", "bfloat16+float32@base",
               "bfloat16+float32@longctx", "bfloat16+float32@ssd_train",
               "bfloat16+float32@ragged")


def _bwd_registry_example(dtype="bfloat16"):
    """The norm-only backward's launches (:func:`.add_rms_norm.bwd_specs`
    under the stock names) at ``dtype``'s example, with x, w and dy."""
    from .add_rms_norm import bwd_specs

    names, _, at = dtype.partition("@")
    rows, d = _BWD_SHAPES[at]
    names = names.split("+")
    x_dt, w_dt = getattr(torch, names[0]), getattr(torch, names[-1])

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (torch.randn(rows, d, generator=g).to(x_dt).to(device),
                (1 + 0.1 * torch.randn(d, generator=g)).to(w_dt).to(device),
                torch.randn(rows, d, generator=g).to(x_dt).to(device))

    return (tabulated(bwd_specs(rows, d, x_dt, w_dt, False, False, stock=True)),
            lambda x, w, dy: rms_norm_backward(x, w, dy),
            lambda x, w, dy: rms_norm_backward_reference(x, w, dy), args)


# dw in fp32: atol 1e-5 of its largest |value|.  The kernel sums a column's
# rows in another order (a lane's rows, its CTA's teams, the CTAs) than
# torch's reduction, each order rounding at ~1e-7 of the running sum; 1e-5
# keeps a 100x margin at 16384 rows.  A 2-byte dw: two ulps (_BF16_TOL)
_DW_TOL = (1e-5, 0.0, 1e-30)
_FP32_TOL = (1e-5, 1e-5, None)


def _bwd_tol(dtype: str):
    x_dt, _, w_dt = dtype.partition("@")[0].partition("+")
    dx = _FP32_TOL if x_dt == "float32" else _BF16_TOL
    return dx, _DW_TOL if (w_dt or x_dt) == "float32" else _BF16_TOL


registry.register(
    "rms_norm_bwd", _bwd_registry_example,
    presets=("tiny", "small", "base", "longctx", "moe", "ocr"),
    description="RMSNorm backward (_rms_bwd_rule): the add + RMSNorm backward kernel "
                "in its norm-only mode",
    dtypes=_BWD_DTYPES, tol={dt: _bwd_tol(dt) for dt in _BWD_DTYPES})
