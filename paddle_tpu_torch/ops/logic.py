"""Comparison, logical and bitwise ops (port of ``paddle_tpu/ops/logic.py``)."""

from __future__ import annotations

import torch

from ..framework.tensor import Tensor
from .common import binary_op, data_of, unary_op

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than", "less_equal",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "bitwise_left_shift", "bitwise_right_shift",
    "isclose", "allclose", "equal_all", "is_empty", "is_tensor",
]


def equal(x, y, name=None):
    return binary_op("equal", torch.eq, x, y)


def not_equal(x, y, name=None):
    return binary_op("not_equal", torch.ne, x, y)


def greater_than(x, y, name=None):
    return binary_op("greater_than", torch.gt, x, y)


def greater_equal(x, y, name=None):
    return binary_op("greater_equal", torch.ge, x, y)


def less_than(x, y, name=None):
    return binary_op("less_than", torch.lt, x, y)


def less_equal(x, y, name=None):
    return binary_op("less_equal", torch.le, x, y)


def logical_and(x, y, out=None, name=None):
    return binary_op("logical_and", torch.logical_and, x, y)


def logical_or(x, y, out=None, name=None):
    return binary_op("logical_or", torch.logical_or, x, y)


def logical_not(x, out=None, name=None):
    return unary_op("logical_not", torch.logical_not, x)


def logical_xor(x, y, out=None, name=None):
    return binary_op("logical_xor", torch.logical_xor, x, y)


def bitwise_and(x, y, out=None, name=None):
    return binary_op("bitwise_and", torch.bitwise_and, x, y)


def bitwise_or(x, y, out=None, name=None):
    return binary_op("bitwise_or", torch.bitwise_or, x, y)


def bitwise_not(x, out=None, name=None):
    return unary_op("bitwise_not", torch.bitwise_not, x)


def bitwise_xor(x, y, out=None, name=None):
    return binary_op("bitwise_xor", torch.bitwise_xor, x, y)


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return binary_op("bitwise_left_shift", torch.bitwise_left_shift, x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    return binary_op("bitwise_right_shift", torch.bitwise_right_shift, x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return binary_op("isclose", lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol,
                                                           atol=atol, equal_nan=equal_nan), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return binary_op("allclose",
                     lambda a, b: torch.tensor(torch.allclose(a, b.to(a.dtype), rtol=rtol,
                                                              atol=atol, equal_nan=equal_nan),
                                               device=a.device), x, y)


def equal_all(x, y, name=None):
    return binary_op("equal_all", lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(a, b.to(a.dtype))), device=a.device), x, y)


def is_empty(x, name=None):
    d = data_of(x)
    return Tensor._wrap(torch.tensor(d.numel() == 0, device=d.device))


def is_tensor(x):
    return isinstance(x, Tensor)
