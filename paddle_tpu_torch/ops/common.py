"""Shared helpers of the op namespace (port of ``paddle_tpu/ops/common.py``).

Each op is a thin wrapper, as in the JAX package: normalise the arguments,
then run the torch expression through :func:`apply` under the op's JAX
name.  :func:`apply` unwraps Tensors (and takes plain ``torch.Tensor`` s
and numpy arrays), casts under ``amp.auto_cast`` by that name
(``framework.dispatch.amp_cast``), runs the expression (autograd is
torch's), checks the outputs under ``FLAGS_check_nan_inf`` and wraps them.
It is one of the recording seam's two entries: while a recorder is active
a call holding a Tensor is recorded instead of run (``jit.subgraph``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.dispatch import amp_cast, checked, tls
from ..framework.lazy import EAGER
from ..framework.tensor import Tensor, _to_torch

__all__ = ["apply", "data_of", "ensure_tensor", "binary_op", "unary_op", "axis_or_none",
           "int_list"]


def data_of(x, ref: torch.Tensor = None) -> torch.Tensor:
    """``x`` as a torch tensor: a Tensor's storage, a torch tensor itself,
    anything else converted under the JAX policy (on ``ref``'s device)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _to_torch(x, None, None if ref is None else ref.device)


def ensure_tensor(x, ref=None) -> Tensor:
    """A Tensor of ``x``; a Python scalar takes ``ref``'s dtype, as the JAX
    ``ensure_tensor``."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    r = None if ref is None else data_of(ref)
    if isinstance(x, (bool, int, float)) and r is not None:
        return Tensor._wrap(torch.tensor(x, dtype=r.dtype, device=r.device))
    return Tensor._wrap(data_of(x, r))


def _wrap_out(name, out):
    checked(name, out)
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, (tuple, list)):
        return type(out)(Tensor._wrap(o) if isinstance(o, torch.Tensor) else o for o in out)
    return out


def apply(name: str, fn, *tensors):
    """``fn(*datas)`` over the storages of ``tensors``, cast for op
    ``name`` under AMP; returns Tensors (a tuple for a tuple)."""
    ref = next((t for t in tensors if isinstance(t, (Tensor, torch.Tensor))), None)
    rec = tls.recorder
    if rec is not None and any(isinstance(t, Tensor) for t in tensors):
        r = data_of(ref)
        out = rec.record_op(name, fn, tuple(t if isinstance(t, (Tensor, torch.Tensor))
                                            else data_of(t, r) for t in tensors))
        if out is not EAGER:
            return out
    ref = None if ref is None else data_of(ref)
    datas = amp_cast(name, tuple(data_of(t, ref) for t in tensors))
    return _wrap_out(name, fn(*datas))


def _scalar_like(v, other: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of the dtype ``other op v`` takes
    (weak typing: ``int32 + 2.5`` is fp32, ``bf16 + 2.0`` stays bf16)."""
    dt = torch.result_type(other, v)
    if dt == torch.int64 and other.dtype != torch.int64:
        dt = torch.int32          # JAX's weak int never widens to int64
    return torch.tensor(v, dtype=dt, device=other.device)


def binary_op(name, fn, x, y):
    """Binary op; a Python scalar side is a weakly typed constant, not an
    input."""
    if isinstance(y, (bool, int, float)) and not isinstance(x, (bool, int, float)):
        return apply(name, lambda a: fn(a, _scalar_like(y, a)), x)
    if isinstance(x, (bool, int, float)) and not isinstance(y, (bool, int, float)):
        return apply(name, lambda b: fn(_scalar_like(x, b), b), y)
    if not isinstance(x, (Tensor, torch.Tensor)):
        x = ensure_tensor(x, y)
    if not isinstance(y, (Tensor, torch.Tensor)):
        y = ensure_tensor(y, x)
    return apply(name, fn, x, y)


unary_op = apply


def axis_or_none(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in axis.numpy().reshape(-1))
    return int(axis)


def int_list(v):
    if v is None:
        return None
    if isinstance(v, Tensor):
        return [int(a) for a in v.numpy().reshape(-1)]
    if isinstance(v, (list, tuple)):
        return [int(a.item()) if isinstance(a, Tensor) else int(a) for a in v]
    return [int(v)]


def dims(axis, ndim):
    """A reduction's ``dim`` argument: every axis for None."""
    if axis is None:
        return tuple(range(ndim))
    return axis if isinstance(axis, tuple) else (axis,)


def np_of(x):
    """A host numpy copy of ``x`` (Tensor, torch tensor or array-like)."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)
