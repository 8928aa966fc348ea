"""The long tail of the ``paddle.*`` op namespace (port of
``paddle_tpu/ops/extras.py``): stacking and splitting helpers, special
functions (the gamma family, scaled Bessel functions), distances, scatter
variants, dtype and introspection helpers.

Torch expressions of the JAX package's jnp ones, op for op, through
:func:`.common.apply` under the JAX op names.  The special functions are
``torch.special``'s and ``torch.mvlgamma`` (XLA computes them by other
series, so they agree to a few fp32 ulps, not bits); ``cdist`` / ``pdist``
are the JAX package's broadcast differences, not torch's matmul form.
``set_grad_enabled`` is :func:`..framework.autograd.set_grad_enabled`.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np
import torch

from ..framework.autograd import set_grad_enabled
from ..framework.dtype import convert_dtype
from ..framework.tensor import Tensor
from .common import apply, binary_op, data_of, unary_op
from .manipulation import rebind_

__all__ = [
    # linear algebra / math
    "addmm", "mm", "block_diag", "cdist", "pdist", "vander",
    "logcumsumexp", "reduce_as", "trapezoid", "cumulative_trapezoid",
    "sinc", "frexp", "isin",
    # special functions
    "gammaln", "gammainc", "gammaincc", "multigammaln", "i0e", "i1e",
    # stacking / splitting / rearrange
    "hstack", "vstack", "dstack", "column_stack", "row_stack",
    "hsplit", "vsplit", "dsplit", "cartesian_prod", "combinations",
    "reverse", "diagonal_scatter", "slice_scatter", "take",
    # predicates / introspection
    "isneginf", "isposinf", "isreal", "is_complex", "is_floating_point",
    "is_integer", "broadcast_shape", "histogram_bin_edges", "rank", "shape",
    "tolist", "finfo", "iinfo",
    # misc
    "increment", "shard_index", "floor_mod", "set_printoptions",
    "set_grad_enabled", "where_",
]

# this module's ops that get in-place variants too
INPLACE_BASES = ("sinc", "gammaln", "gammainc", "gammaincc", "multigammaln", "addmm",
                 "floor_mod")


# -- linear algebra / math ---------------------------------------------------

def mm(input, mat2, name=None):
    return binary_op("mm", torch.matmul, input, mat2)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm", lambda i, a, b: beta * i + alpha * (a @ b), input, x, y)


def block_diag(inputs, name=None):
    def f(*mats):
        return torch.block_diag(*mats).to(mats[0].dtype)

    return apply("block_diag", f, *inputs)


def _pnorm(d, p):
    if p == 2.0:
        return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=0.0))
    if p == float("inf"):
        return torch.amax(torch.abs(d), -1)
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary", name=None):
    """Pairwise p-norm distances ``[..., N, M]``."""
    return binary_op("cdist", lambda a, b: _pnorm(a[..., :, None, :] - b[..., None, :, :], p),
                     x, y)


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of the rows of ``[N, D]``."""
    def f(a):
        iu, ju = torch.triu_indices(a.shape[0], a.shape[0], 1, device=a.device)
        return _pnorm(a[iu] - a[ju], p)

    return unary_op("pdist", f, x)


def vander(x, n=None, increasing=False, name=None):
    def f(a):
        powers = torch.arange(a.shape[0] if n is None else int(n), device=a.device)
        return a[:, None] ** (powers if increasing else powers.flip(0))[None, :]

    return unary_op("vander", f, x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def f(a):
        out = torch.logcumsumexp(a.reshape(-1) if axis is None else a,
                                 0 if axis is None else axis)
        return out.to(convert_dtype(dtype)) if dtype else out

    return unary_op("logcumsumexp", f, x)


def reduce_as(x, target, name=None):
    """Sum ``x`` down to ``target``'s shape (the broadcast's transpose)."""
    tgt = tuple(target.shape)

    def f(a):
        extra = a.dim() - len(tgt)
        if extra:
            a = a.sum(dim=tuple(range(extra)))
        axes = tuple(i for i, (s, t) in enumerate(zip(a.shape, tgt)) if s != t and t == 1)
        return a.sum(dim=axes, keepdim=True) if axes else a

    return unary_op("reduce_as", f, x)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply("trapezoid", lambda a, xs: torch.trapezoid(a, xs, dim=axis), y, x)
    return unary_op("trapezoid", lambda a: torch.trapezoid(a, dx=1.0 if dx is None else dx,
                                                          dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(a, *rest):
        n = a.shape[axis]
        a1, a0 = a.narrow(axis, 1, n - 1), a.narrow(axis, 0, n - 1)
        if rest:
            xs = rest[0]
            widths = xs.narrow(axis, 1, n - 1) - xs.narrow(axis, 0, n - 1)
        else:
            widths = dx if dx is not None else 1.0
        return torch.cumsum((a0 + a1) / 2.0 * widths, dim=axis)

    return apply("cumulative_trapezoid", f, *((y,) if x is None else (y, x)))


def sinc(x, name=None):
    return unary_op("sinc", torch.sinc, x)


def frexp(x, name=None):
    def f(a):
        m, e = torch.frexp(a)
        return m, e.to(torch.int32)

    return apply("frexp", f, x)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return binary_op("isin", lambda a, b: torch.isin(a, b, invert=invert), x, test_x)


# -- special functions -------------------------------------------------------

def gammaln(x, name=None):
    return unary_op("gammaln", torch.lgamma, x)


def gammainc(x, y, name=None):
    return binary_op("gammainc", torch.special.gammainc, x, y)


def gammaincc(x, y, name=None):
    return binary_op("gammaincc", torch.special.gammaincc, x, y)


def multigammaln(x, p, name=None):
    return unary_op("multigammaln", lambda a: torch.mvlgamma(a, int(p)), x)


def i0e(x, name=None):
    return unary_op("i0e", torch.special.i0e, x)


def i1e(x, name=None):
    return unary_op("i1e", torch.special.i1e, x)


# -- stacking / splitting ----------------------------------------------------

def hstack(x, name=None):
    return apply("hstack", lambda *a: torch.hstack(a), *x)


def vstack(x, name=None):
    return apply("vstack", lambda *a: torch.vstack(a), *x)


def dstack(x, name=None):
    return apply("dstack", lambda *a: torch.dstack(a), *x)


def column_stack(x, name=None):
    return apply("column_stack", lambda *a: torch.column_stack(a), *x)


def row_stack(x, name=None):
    return apply("row_stack", lambda *a: torch.vstack(a), *x)


def _split_list(name, fn, x, arg):
    return list(apply(name, lambda a: tuple(fn(a, arg)), x))


def hsplit(x, num_or_indices, name=None):
    return _split_list("hsplit", torch.hsplit, x, num_or_indices)


def vsplit(x, num_or_indices, name=None):
    return _split_list("vsplit", torch.vsplit, x, num_or_indices)


def dsplit(x, num_or_indices, name=None):
    return _split_list("dsplit", torch.dsplit, x, num_or_indices)


def cartesian_prod(x, name=None):
    def f(*arrs):
        grids = torch.meshgrid(*arrs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)

    return apply("cartesian_prod", f, *x)


def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    gen = itertools.combinations_with_replacement if with_replacement else itertools.combinations
    idx = np.asarray(list(gen(range(n), r)), dtype=np.int64).reshape(-1, r)
    return unary_op("combinations", lambda a: a[torch.as_tensor(idx, device=a.device)], x)


def reverse(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return unary_op("reverse", lambda a: torch.flip(a, ax), x)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    def f(a, b):
        k = b.shape[-1]
        i = torch.arange(k, device=a.device)
        moved = a.movedim((axis1, axis2), (-2, -1)).clone()
        moved[..., i + max(-offset, 0), i + max(offset, 0)] = torch.broadcast_to(
            b, moved.shape[:-2] + (k,)).to(moved.dtype)
        return moved.movedim((-2, -1), (axis1, axis2))

    return binary_op("diagonal_scatter", f, x, y)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(a, v):
        idx = [slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            idx[ax] = slice(int(s), int(e), int(st))
        out = a.clone()
        out[tuple(idx)] = v.to(a.dtype)
        return out

    return binary_op("slice_scatter", f, x, value)


def take(x, index, mode="raise", name=None):
    def f(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        ii = i.long()
        if mode == "wrap":
            ii = ii % n
        elif mode == "clip":
            ii = ii.clamp(0, n - 1)
        else:
            ii = torch.where(ii < 0, ii + n, ii)     # raise mode: negatives wrap once
        return flat[ii]

    return binary_op("take", f, x, index)


# -- predicates / introspection ---------------------------------------------

def isneginf(x, name=None):
    return unary_op("isneginf", torch.isneginf, x)


def isposinf(x, name=None):
    return unary_op("isposinf", torch.isposinf, x)


def isreal(x, name=None):
    return unary_op("isreal", torch.isreal, x)


def is_complex(x) -> bool:
    return data_of(x).is_complex()


def is_floating_point(x) -> bool:
    return data_of(x).is_floating_point()


def is_integer(x) -> bool:
    d = data_of(x).dtype
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def broadcast_shape(x_shape, y_shape) -> List[int]:
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    def f(a):
        lo, hi = float(min), float(max)
        if lo == 0 and hi == 0:
            lo, hi = float(a.detach().min()), float(a.detach().max())
        return torch.linspace(lo, hi, int(bins) + 1, device=a.device, dtype=torch.float32)

    return unary_op("histogram_bin_edges", f, input)


def rank(input) -> Tensor:
    d = data_of(input)
    return Tensor._wrap(torch.tensor(d.dim(), dtype=torch.int32, device=d.device))


def shape(input) -> Tensor:
    d = data_of(input)
    return Tensor._wrap(torch.tensor(list(d.shape), dtype=torch.int32, device=d.device))


def tolist(x):
    return x.tolist() if isinstance(x, Tensor) else data_of(x).tolist()


class finfo:
    """Float dtype limits (``paddle.finfo``), each a value of the dtype as
    the JAX one's (``resolution`` 1e-6 is float32's nearest)."""

    def __init__(self, dtype):
        dt = convert_dtype(dtype)
        info = torch.finfo(dt)

        def of(v):
            return float(torch.tensor(v, dtype=dt))

        self.dtype = str(info.dtype)
        self.bits = info.bits
        self.eps = of(info.eps)
        self.min = of(info.min)
        self.max = of(info.max)
        self.tiny = of(info.tiny)
        self.smallest_normal = of(info.tiny)
        self.resolution = of(info.resolution)


class iinfo:
    """Integer dtype limits (``paddle.iinfo``)."""

    def __init__(self, dtype):
        info = torch.iinfo(convert_dtype(dtype))
        self.dtype = str(info.dtype)
        self.bits = info.bits
        self.min = int(info.min)
        self.max = int(info.max)


# -- misc --------------------------------------------------------------------

def increment(x, value=1.0, name=None):
    """``x += value`` (``x`` rebound to the sum)."""
    return rebind_(x, binary_op("increment", torch.add, x, value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids to the ids local to shard ``shard_id`` (``ignore_value``
    elsewhere), ``ceil(index_num / nshards)`` ids a shard."""
    size = (index_num + nshards - 1) // nshards
    return unary_op("shard_index", lambda a: torch.where(
        a // size == shard_id, a % size, torch.full((), ignore_value, dtype=a.dtype,
                                                    device=a.device)), input)


def floor_mod(x, y, name=None):
    return binary_op("floor_mod", torch.remainder, x, y)


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None,
                     linewidth=None):
    """Tensor print formatting: numpy's print options (a Tensor prints
    through numpy)."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def where_(condition, x, y, name=None):
    """``x`` rebound to ``where(condition, x, y)``."""
    from .manipulation import where

    return rebind_(x, where(condition, x, y))
