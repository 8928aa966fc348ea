"""Fused single-pass AdamW / Adam update (port of ``paddle_tpu/kernels/adamw.py``).

:func:`adamw_update` updates one leaf: on CUDA tensors it launches the
hand-written kernel of ``csrc/adamw.cu`` (the counterpart of the Pallas
``_adamw_fused_call``), on CPU tensors it runs :func:`adamw_reference`, the
JAX package's reference ported expression for expression.  Both update
``p32``, ``m`` and ``v`` in place, as the Pallas kernel does through
``input_output_aliases``.

The per-step scalars are computed once, in fp32, the way the reference
computes them (``lr`` and ``t = step`` as fp32, ``c1 = 1 - beta1 ** t``,
``c2 = 1 - beta2 ** t``, ``decay = 1 - lr * weight_decay``); Python's
double arithmetic cast to fp32 could differ by an ulp.  The kernel rounds
every operation on its own, so on the same inputs it gives the plain
version's bits.

Registered in :mod:`.registry` as ``adamw_fused``: ``p32``, ``m`` and ``v``
are declared in-place pairs, as the Pallas call's ``input_output_aliases``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import to_dtype
from ..analysis.kernel_lint import BlockUse, KernelSpec, cuda_semantics
from . import _build, registry

__all__ = ["adamw_reference", "adamw_update"]


def _f32(x) -> torch.Tensor:
    """A Python number or tensor as an fp32 0-d tensor (a CPU scalar for a
    number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32)


def adamw_reference(p32, g32, m, v, lr, step, *, beta1, beta2, epsilon,
                    weight_decay=0.0, decoupled=True, apply_decay=True):
    """The update the kernel must bit-match; returns ``(p_new, m_new,
    v_new)`` and leaves its inputs untouched."""
    lr = _f32(lr)
    t = _f32(step)
    if weight_decay and not decoupled:
        g32 = g32 + weight_decay * p32
    if weight_decay and decoupled and apply_decay:
        p32 = p32 * (1.0 - lr * weight_decay)
    m_new = beta1 * m + (1 - beta1) * g32
    v_new = beta2 * v + (1 - beta2) * torch.square(g32)
    # the divisors live on the data's device: PyTorch's CUDA division by a
    # CPU scalar multiplies by its reciprocal, one rounding more
    m_hat = m_new / (1 - beta1 ** t).to(m.device)
    v_hat = v_new / (1 - beta2 ** t).to(m.device)
    p_new = p32 - lr * m_hat / (torch.sqrt(v_hat) + epsilon)
    return p_new, m_new, v_new


def _scalars(lr, step, beta1, beta2, weight_decay, decoupled, apply_decay):
    lr = _f32(lr).cpu()
    t = _f32(step).cpu()
    c1 = 1 - beta1 ** t
    c2 = 1 - beta2 ** t
    if weight_decay and decoupled and apply_decay:
        decay = 1.0 - lr * weight_decay
    else:
        decay = torch.tensor(1.0)
    return float(lr), float(c1), float(c2), float(decay)


def adamw_update(p32, g32, m, v, lr, step, *, beta1, beta2, epsilon,
                 weight_decay=0.0, decoupled=True, apply_decay=True,
                 out_dtype=None) -> Tuple[torch.Tensor, ...]:
    """One Adam/AdamW step over one leaf; ``p32``, ``g32``, ``m``, ``v`` are
    fp32 tensors of one shape.  ``p32``, ``m`` and ``v`` are updated IN
    PLACE.  Returns ``(p32, m, v, p_out)``, where ``p_out`` is the
    ``out_dtype`` copy of the new ``p32`` written in the same pass
    (``p_out is p32`` when no cast is asked for).  ``lr`` and ``step`` are
    Python numbers or 0-d tensors."""
    out_dtype = None if out_dtype is None else to_dtype(out_dtype)
    cast = out_dtype is not None and out_dtype != torch.float32
    registry.ensure_admitted("adamw_fused", p32.device, out_dtype if cast else torch.float32)
    with torch.no_grad():
        if p32.device.type == "cpu":
            p_new, m_new, v_new = adamw_reference(
                p32, g32, m, v, lr, step, beta1=beta1, beta2=beta2, epsilon=epsilon,
                weight_decay=weight_decay, decoupled=decoupled, apply_decay=apply_decay)
            p32.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            return p32, m, v, (p32.to(out_dtype) if cast else p32)
        if p32.device.type != "cuda":
            raise ValueError(f"adamw_update: unsupported device {p32.device}")
        for name, x in (("p32", p32), ("g32", g32), ("m", m), ("v", v)):
            if x.dtype != torch.float32 or x.shape != p32.shape or x.device != p32.device:
                raise ValueError(f"adamw_update: {name} must be fp32 {tuple(p32.shape)} on "
                                 f"{p32.device}; got {x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"adamw_update: {name} must be contiguous")
        if cast and out_dtype != torch.bfloat16:
            raise TypeError(f"adamw_update kernel casts to bfloat16 only, not {out_dtype}")
        out = torch.empty(p32.shape, dtype=out_dtype, device=p32.device) if cast else None
        ptrs = [x.data_ptr() for x in (p32, g32, m, v)]
        vec = all(a % 16 == 0 for a in ptrs) and (out is None or out.data_ptr() % 8 == 0)
        lr32, c1, c2, decay = _scalars(lr, step, beta1, beta2, weight_decay, decoupled,
                                       apply_decay)
        coupled = bool(weight_decay) and not decoupled
        lib = _build.load("adamw")
        with torch.cuda.device(p32.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.adamw_launch(
                *ptrs, None if out is None else out.data_ptr(), p32.numel(),
                lr32, c1, c2, decay, float(beta1), float(1 - beta1), float(beta2),
                float(1 - beta2), float(epsilon), float(weight_decay), int(coupled),
                _build.dtype_code(out_dtype) if cast else -1, int(vec), stream)
        _build.check(lib, err, "adamw_update")
        adamw_update.launches += 1
        return p32, m, v, (out if cast else p32)


adamw_update.launches = 0


# ---------------------------------------------------------------------------
# kernel-registry entry (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def kernel_spec(n: int, cast: bool, vec: bool = True) -> KernelSpec:
    """``adamw_kernel``'s launch: a grid-stride loop, here a grid of
    ``blocks`` CTAs and the loop's steps as an in-CTA axis; each (CTA,
    step) updates one block of a float4 (or one value) a thread.  p, m and
    v are written in place through the blocks they are read through."""
    geo = _build.GEOMETRY["adamw"]
    per = geo["ADAMW_THREADS"] * (4 if vec else 1)
    blocks = min(-(-n // per), geo["ADAMW_MAX_BLOCKS"])
    steps = -(-n // (per * blocks))
    f32 = torch.float32

    def at(b, s):
        return (s * blocks + b,)

    def leaf(name, dtype=f32):
        return BlockUse((n,), dtype, (per,), at, name=name, masked=True)

    outs = [leaf("p"), leaf("m"), leaf("v")] + ([leaf("out", torch.bfloat16)] if cast else [])
    return KernelSpec(
        "adamw_kernel", grid=(blocks, steps),
        inputs=[leaf("p"), leaf("g"), leaf("m"), leaf("v")], outputs=outs,
        aliases={0: 0, 2: 1, 3: 2}, dimension_semantics=cuda_semantics(1, 1),
        cuda=("adamw", 0, 0, int(cast), int(vec)))


_HYPER = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01, decoupled=True,
              apply_decay=True)


def _registry_example(dtype="bfloat16"):
    """The JAX registry's 2048 fp32 leaves with the bf16 cast epilogue, or
    without it (``dtype`` ``"float32"``: the copy out is the fp32 leaf)."""
    n, lr, step = 2048, 3e-4, 3
    cast = dtype == "bfloat16"

    def args(device):
        g = torch.Generator().manual_seed(0)
        p, grad, m = (torch.randn(n, generator=g).to(device) for _ in range(3))
        v = torch.rand(n, generator=g).to(device) * 1e-3
        return p, grad, 0.1 * m, v

    def launch(p, grad, m, v):
        out = adamw_update(p, grad, m, v, lr, step, out_dtype=dtype, **_HYPER)
        return out if cast else out[:3]

    def plain(p, grad, m, v):
        p_new, m_new, v_new = adamw_reference(p, grad, m, v, lr, step, **_HYPER)
        return (p_new, m_new, v_new) + ((p_new.to(torch.bfloat16),) if cast else ())

    return [kernel_spec(n, cast=cast)], launch, plain, args


registry.register(
    "adamw_fused", _registry_example,
    presets=("tiny", "small", "base", "longctx", "moe", "ocr"),
    description="single-pass fused AdamW: p/m/v aliased in place + bf16 "
                "cast epilogue",
    dtypes=("bfloat16", "float32"))     # bitwise: the kernel rounds as the plain version
