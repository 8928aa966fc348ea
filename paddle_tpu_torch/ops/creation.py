"""Tensor creation ops (port of ``paddle_tpu/ops/creation.py``).

New tensors land on the current device (``set_device``); integer ranges
and index tables are int32, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.device import default_device
from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.tensor import Tensor, to_tensor
from .common import apply, data_of, unary_op

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye", "tril", "triu",
    "meshgrid", "diag", "diagflat", "assign", "clone", "complex", "polar",
    "tril_indices", "triu_indices", "one_hot",
]


def _dt(dtype, default=None) -> torch.dtype:
    if dtype is None:
        return convert_dtype(default or get_default_dtype())
    return convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s) for s in shape)


def _val(v):
    return v.item() if isinstance(v, Tensor) else v


def _new(t: torch.Tensor) -> Tensor:
    return Tensor._wrap(t)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=_dt(dtype), device=default_device()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=_dt(dtype), device=default_device()))


def full(shape, fill_value, dtype=None, name=None):
    return _new(torch.full(_shape(shape), _val(fill_value), dtype=_dt(dtype),
                           device=default_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x):
    d = data_of(x)
    return d.shape, d.dtype, d.device


def zeros_like(x, dtype=None, name=None):
    shape, dt, dev = _like(x)
    return _new(torch.zeros(shape, dtype=_dt(dtype, dt), device=dev))


def ones_like(x, dtype=None, name=None):
    shape, dt, dev = _like(x)
    return _new(torch.ones(shape, dtype=_dt(dtype, dt), device=dev))


def full_like(x, fill_value, dtype=None, name=None):
    shape, dt, dev = _like(x)
    return _new(torch.full(shape, _val(fill_value), dtype=_dt(dtype, dt), device=dev))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer)) for v in (start, end, step))
        dtype = "int64" if ints else get_default_dtype()
    d = convert_dtype(dtype)
    if d == torch.int64:
        d = torch.int32
    return _new(torch.arange(start, end, step, dtype=d, device=default_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_val(start), _val(stop), int(_val(num)), dtype=_dt(dtype),
                               device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_val(start), _val(stop), int(_val(num)), base=_val(base),
                               dtype=_dt(dtype), device=default_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(torch.eye(n, m, dtype=_dt(dtype), device=default_device()))


def tril(x, diagonal=0, name=None):
    return unary_op("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return unary_op("triu", lambda a: torch.triu(a, diagonal), x)


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply("meshgrid", lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                      *args))


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        if a.dim() == 1 and padding_value != 0:
            n = a.shape[0] + abs(offset)
            base = torch.full((n, n), padding_value, dtype=a.dtype, device=a.device)
            return base + torch.diag(a - torch.tensor(padding_value, dtype=a.dtype), offset)
        return torch.diag(a, offset)

    return unary_op("diag", f, x)


def diagflat(x, offset=0, name=None):
    return unary_op("diagflat", lambda a: torch.diagflat(a, offset), x)


def assign(x, output=None, name=None):
    val = x if isinstance(x, Tensor) else Tensor(np.asarray(x))
    if output is not None:
        output._set_data(val._data)
        return output
    return unary_op("assign", torch.clone, val)


def clone(x, name=None):
    return unary_op("clone", torch.clone, x)


def complex(real, imag, name=None):
    return apply("complex", torch.complex, real, imag)


def polar(abs_t, angle_t, name=None):
    return apply("polar", torch.polar, abs_t, angle_t)


def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return _new(torch.tril_indices(row, col, offset, dtype=torch.int32,
                                   device=default_device()))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return _new(torch.triu_indices(row, row if col is None else col, offset,
                                   dtype=torch.int32, device=default_device()))


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows; an index outside ``[0, num_classes)`` gives a row
    of zeros, as ``jax.nn.one_hot``."""
    def f(a):
        a = a.long()
        return (a[..., None] == torch.arange(num_classes, device=a.device)).to(torch.float32)

    return unary_op("one_hot", f, x)
