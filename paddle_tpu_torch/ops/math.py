"""Elementwise and scalar math ops (port of ``paddle_tpu/ops/math.py``).

Torch expressions of the JAX package's jnp ones, op for op; where the two
libraries differ the JAX definition is kept (``cumsum`` without an axis
flattens, ``cummax`` / ``cummin`` return int32 indices of the last
extremum, ``lcm`` / ``gcd`` of the absolute values)."""

from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from ..framework.tensor import Tensor
from .common import apply, axis_or_none, binary_op, data_of, dims, unary_op

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder", "mod",
    "pow", "float_power", "sqrt", "rsqrt", "exp", "expm1", "log", "log2", "log10", "log1p",
    "abs", "neg", "sign", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "atan2", "hypot", "deg2rad", "rad2deg",
    "reciprocal", "square", "maximum", "minimum", "fmax", "fmin",
    "clip", "scale", "lerp", "erf", "erfinv", "logit", "stanh", "multiplex",
    "isnan", "isinf", "isfinite", "nan_to_num", "cumsum", "cumprod", "cummax", "cummin",
    "add_n", "logaddexp", "logsumexp", "trace", "diagonal", "kron", "inner", "outer",
    "heaviside", "gcd", "lcm", "digamma", "lgamma", "polygamma", "i0", "i1",
    "angle", "conj", "real", "imag", "sgn", "ldexp", "copysign", "nextafter",
    "renorm", "diff", "signbit",
]


def _float(a):
    """Integer and bool inputs of a float-valued op become fp32, as jnp
    promotes them."""
    return a if a.is_floating_point() or a.is_complex() else a.to(torch.float32)


def add(x, y, name=None):
    return binary_op("add", torch.add, x, y)


def subtract(x, y, name=None):
    return binary_op("subtract", torch.sub, x, y)


def multiply(x, y, name=None):
    return binary_op("multiply", torch.mul, x, y)


def divide(x, y, name=None):
    return binary_op("divide", torch.true_divide, x, y)


def floor_divide(x, y, name=None):
    return binary_op("floor_divide", torch.floor_divide, x, y)


def remainder(x, y, name=None):
    return binary_op("remainder", torch.remainder, x, y)


mod = remainder


def pow(x, y, name=None):
    return binary_op("pow", torch.pow, x, y)


float_power = pow


def sqrt(x, name=None):
    return unary_op("sqrt", torch.sqrt, x)


def rsqrt(x, name=None):
    return unary_op("rsqrt", torch.rsqrt, x)


def exp(x, name=None):
    return unary_op("exp", torch.exp, x)


def expm1(x, name=None):
    return unary_op("expm1", torch.expm1, x)


def log(x, name=None):
    return unary_op("log", torch.log, x)


def log2(x, name=None):
    return unary_op("log2", torch.log2, x)


def log10(x, name=None):
    return unary_op("log10", torch.log10, x)


def log1p(x, name=None):
    return unary_op("log1p", torch.log1p, x)


def abs(x, name=None):
    return unary_op("abs", torch.abs, x)


def neg(x, name=None):
    return unary_op("neg", torch.neg, x)


def sign(x, name=None):
    return unary_op("sign", torch.sign, x)


def floor(x, name=None):
    return unary_op("floor", torch.floor, x)


def ceil(x, name=None):
    return unary_op("ceil", torch.ceil, x)


def round(x, decimals=0, name=None):
    """Half to even, as ``jnp.round``."""
    if decimals:
        return unary_op("round", lambda a: torch.round(a, decimals=decimals), x)
    return unary_op("round", torch.round, x)


def trunc(x, name=None):
    return unary_op("trunc", torch.trunc, x)


def frac(x, name=None):
    return unary_op("frac", lambda a: a - torch.trunc(a), x)


def sin(x, name=None):
    return unary_op("sin", torch.sin, x)


def cos(x, name=None):
    return unary_op("cos", torch.cos, x)


def tan(x, name=None):
    return unary_op("tan", torch.tan, x)


def asin(x, name=None):
    return unary_op("asin", torch.asin, x)


def acos(x, name=None):
    return unary_op("acos", torch.acos, x)


def atan(x, name=None):
    return unary_op("atan", torch.atan, x)


def sinh(x, name=None):
    return unary_op("sinh", torch.sinh, x)


def cosh(x, name=None):
    return unary_op("cosh", torch.cosh, x)


def tanh(x, name=None):
    return unary_op("tanh", torch.tanh, x)


def asinh(x, name=None):
    return unary_op("asinh", torch.asinh, x)


def acosh(x, name=None):
    return unary_op("acosh", torch.acosh, x)


def atanh(x, name=None):
    return unary_op("atanh", torch.atanh, x)


def atan2(x, y, name=None):
    return binary_op("atan2", lambda a, b: torch.atan2(_float(a), _float(b)), x, y)


def hypot(x, y, name=None):
    return binary_op("hypot", lambda a, b: torch.hypot(_float(a), _float(b)), x, y)


def deg2rad(x, name=None):
    return unary_op("deg2rad", lambda a: torch.deg2rad(_float(a)), x)


def rad2deg(x, name=None):
    return unary_op("rad2deg", lambda a: torch.rad2deg(_float(a)), x)


def reciprocal(x, name=None):
    return unary_op("reciprocal", torch.reciprocal, x)


def square(x, name=None):
    return unary_op("square", torch.square, x)


def maximum(x, y, name=None):
    return binary_op("maximum", torch.maximum, x, y)


def minimum(x, y, name=None):
    return binary_op("minimum", torch.minimum, x, y)


def fmax(x, y, name=None):
    return binary_op("fmax", torch.fmax, x, y)


def fmin(x, y, name=None):
    return binary_op("fmin", torch.fmin, x, y)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return unary_op("clip", lambda a: torch.clamp(a, lo, hi), x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.item() if isinstance(scale, Tensor) else scale
    if bias_after_scale:
        return unary_op("scale", lambda a: a * s + bias, x)
    return unary_op("scale", lambda a: (a + bias) * s, x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return apply("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)
    return apply("lerp", lambda a, b: a + weight * (b - a), x, y)


def erf(x, name=None):
    return unary_op("erf", lambda a: torch.erf(_float(a)), x)


def erfinv(x, name=None):
    return unary_op("erfinv", lambda a: torch.erfinv(_float(a)), x)


def logit(x, eps=None, name=None):
    def f(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1.0 - a))

    return unary_op("logit", f, x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return unary_op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiplex(inputs, index, name=None):
    idx = data_of(index)

    def f(*xs):
        stacked = torch.stack(xs, dim=0)
        rows = idx.reshape(-1).long()
        return stacked[rows, torch.arange(stacked.shape[1], device=stacked.device)]

    return apply("multiplex", f, *inputs)


def isnan(x, name=None):
    return unary_op("isnan", torch.isnan, x)


def isinf(x, name=None):
    return unary_op("isinf", torch.isinf, x)


def isfinite(x, name=None):
    return unary_op("isfinite", torch.isfinite, x)


def signbit(x, name=None):
    return unary_op("signbit", torch.signbit, x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return unary_op("nan_to_num",
                    lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf), x)


def _int_acc(a, dtype):
    """jnp's accumulation dtype: ``dtype`` if given, int32 for narrow ints
    and bools, else the input's."""
    if dtype is not None:
        return convert_dtype(dtype)
    if a.is_floating_point() or a.is_complex() or a.dtype == torch.int64:
        return a.dtype
    return torch.int32


def cumsum(x, axis=None, dtype=None, name=None):
    def f(a):
        b = a.reshape(-1) if axis is None else a
        return torch.cumsum(b, dim=0 if axis is None else axis, dtype=_int_acc(a, dtype))

    return unary_op("cumsum", f, x)


def cumprod(x, dim=None, dtype=None, name=None):
    def f(a):
        b = a.reshape(-1) if dim is None else a
        return torch.cumprod(b, dim=0 if dim is None else dim, dtype=_int_acc(a, dtype))

    return unary_op("cumprod", f, x)


def _cum_ext(name, x, axis, better):
    def f(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else axis % arr.dim()
        vals = (torch.cummax if better == "max" else torch.cummin)(arr, dim=ax).values
        n = arr.shape[ax]
        shape = [-1 if i == ax else 1 for i in range(arr.dim())]
        rng = torch.arange(n, device=arr.device).reshape(shape).expand_as(arr)
        idx = torch.cummax(torch.where(arr == vals, rng, torch.zeros_like(rng)), dim=ax).values
        return vals, idx.to(torch.int32)

    return apply(name, f, x)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_ext("cummax", x, axis, "max")


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_ext("cummin", x, axis, "min")


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    return apply("add_n", lambda *xs: sum(xs[1:], xs[0]), *inputs)


def logaddexp(x, y, name=None):
    return binary_op("logaddexp", lambda a, b: torch.logaddexp(_float(a), _float(b)), x, y)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("logsumexp",
                    lambda a: torch.logsumexp(_float(a), dim=dims(ax, a.dim()), keepdim=keepdim),
                    x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return unary_op("trace", lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return unary_op("diagonal", lambda a: torch.diagonal(a, offset, axis1, axis2), x)


def kron(x, y, name=None):
    return binary_op("kron", torch.kron, x, y)


def inner(x, y, name=None):
    return binary_op("inner", torch.inner, x, y)


def outer(x, y, name=None):
    return binary_op("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x, y)


def heaviside(x, y, name=None):
    return binary_op("heaviside", torch.heaviside, x, y)


def gcd(x, y, name=None):
    return binary_op("gcd", torch.gcd, x, y)


def lcm(x, y, name=None):
    return binary_op("lcm", lambda a, b: torch.abs(torch.lcm(a, b)), x, y)


def digamma(x, name=None):
    return unary_op("digamma", lambda a: torch.digamma(_float(a)), x)


def lgamma(x, name=None):
    return unary_op("lgamma", lambda a: torch.lgamma(_float(a)), x)


def polygamma(x, n, name=None):
    return unary_op("polygamma", lambda a: torch.polygamma(n, _float(a)), x)


def i0(x, name=None):
    return unary_op("i0", lambda a: torch.special.i0(_float(a)), x)


def i1(x, name=None):
    return unary_op("i1", lambda a: torch.special.i1(_float(a)), x)


def angle(x, name=None):
    return unary_op("angle", lambda a: torch.angle(_float(a)), x)


def conj(x, name=None):
    return unary_op("conj", lambda a: torch.conj(a).resolve_conj() if a.is_complex() else a, x)


def real(x, name=None):
    return unary_op("real", lambda a: torch.real(a) if a.is_complex() else a, x)


def imag(x, name=None):
    return unary_op("imag", lambda a: torch.imag(a) if a.is_complex() else torch.zeros_like(a),
                    x)


def sgn(x, name=None):
    return unary_op("sgn", torch.sgn, x)


def ldexp(x, y, name=None):
    return binary_op("ldexp", lambda a, b: _float(a) * torch.pow(2.0, b).to(_float(a).dtype),
                     x, y)


def copysign(x, y, name=None):
    return binary_op("copysign", lambda a, b: torch.copysign(_float(a), b), x, y)


def nextafter(x, y, name=None):
    return binary_op("nextafter", torch.nextafter, x, y)


def renorm(x, p, axis, max_norm, name=None):
    def f(a):
        dim = tuple(i for i in range(a.dim()) if i != axis % a.dim())
        norms = torch.sum(torch.abs(a) ** p, dim=dim, keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor

    return unary_op("renorm", f, x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre = None if prepend is None else data_of(prepend)
    app = None if append is None else data_of(append)
    return unary_op("diff", lambda a: torch.diff(a, n=n, dim=axis, prepend=pre, append=app), x)

