"""The op namespace and the Tensor's methods (port of
``paddle_tpu/ops/__init__.py``).

The functional ops of ``creation``, ``extras``, ``linalg``, ``logic``,
``manipulation``, ``math``, ``random``, ``reduction`` and ``search`` are
attached to the port's own :class:`~..framework.tensor.Tensor` as methods
and dunders, as the JAX package attaches them to its Tensor (``torch.Tensor``
is never patched), with the reference's trailing-underscore in-place
variants over every base op present.
"""

from __future__ import annotations

from typing import List

from . import creation, extras, linalg, logic, manipulation, math, random, reduction, search
from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .manipulation import rebind_
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

from ..framework.tensor import Tensor

MODULES = (creation, extras, linalg, logic, manipulation, math, random, reduction, search)

__all__ = [n for m in MODULES for n in m.__all__]

# the reference's in-place API over these base ops, then over extras' own
# (the JAX package's ``extras._INPLACE_BASES``; bases this namespace lacks
# are skipped)
_INPLACE_BASES = [
    "abs", "acos", "asin", "atan", "cos", "cosh", "sin", "sinh", "tan",
    "tanh", "ceil", "floor", "round", "trunc", "exp", "expm1", "erf",
    "log", "log2", "log10", "log1p", "logit", "neg", "reciprocal", "rsqrt",
    "sqrt", "square", "sigmoid", "digamma", "lgamma", "frac", "i0",
    "nan_to_num", "tril", "triu", "cumsum", "cumprod", "cast",
    "divide", "multiply", "subtract", "add", "pow", "remainder", "mod",
    "floor_divide", "gcd", "lcm", "hypot", "ldexp", "copysign",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "bitwise_left_shift", "bitwise_right_shift",
    "equal", "greater_equal", "greater_than", "less_equal", "less_than",
    "not_equal", "masked_fill", "masked_scatter", "index_add",
    "index_fill", "index_put", "scale", "clip", "lerp", "erfinv",
    "polygamma", "renorm", "ldexp", "copysign", "hypot",
    "transpose", "t", "fill_diagonal",
] + list(extras.INPLACE_BASES)


def _make_inplace(base_name, base_fn):
    def inplace(x, *args, **kwargs):
        return rebind_(x, base_fn(x, *args, **kwargs))

    inplace.__name__ = inplace.__qualname__ = base_name + "_"
    inplace.__doc__ = (f"In-place variant of :func:`{base_name}` (reference "
                       f"``paddle.{base_name}_``): rebinds ``x`` to the result and "
                       "returns ``x``.")
    return inplace


def install_inplace_variants(namespace: dict) -> List[str]:
    """Make ``<op>_`` for every base op present in ``namespace`` that has no
    hand-written in-place form; returns the names added."""
    added = []
    for base in _INPLACE_BASES:
        name = base + "_"
        if name in namespace or base not in namespace or not callable(namespace[base]):
            continue
        namespace[name] = _make_inplace(base, namespace[base])
        added.append(name)
    return added


__all__ = __all__ + install_inplace_variants(globals())


def _install_tensor_methods():
    """Attach the functional ops as Tensor methods, with Paddle's aliases
    and the arithmetic and comparison dunders."""
    g = globals()
    for name in __all__:
        if name in ("to_tensor", "is_tensor"):
            continue
        fn = g.get(name)
        if fn is not None and not hasattr(Tensor, name):
            setattr(Tensor, name, fn)

    Tensor.mm = g["matmul"]
    Tensor.dim = lambda self: self.ndim
    Tensor.rank = lambda self: Tensor(self.ndim)
    Tensor.numel = lambda self: g["numel"](self)
    Tensor.element_size = lambda self: self._data.element_size()
    Tensor.add_ = lambda self, y: rebind_(self, g["add"](self, y))
    Tensor.subtract_ = lambda self, y: rebind_(self, g["subtract"](self, y))
    Tensor.multiply_ = lambda self, y: rebind_(self, g["multiply"](self, y))
    Tensor.scale_ = lambda self, scale=1.0, bias=0.0, bias_after_scale=True: rebind_(
        self, g["scale"](self, scale, bias, bias_after_scale))
    Tensor.clip_ = lambda self, min=None, max=None: rebind_(self, g["clip"](self, min, max))
    Tensor.zero_ = lambda self: rebind_(self, g["zeros_like"](self))
    Tensor.fill_ = lambda self, v: rebind_(self, g["full_like"](self, v))
    Tensor.exp_ = lambda self: rebind_(self, g["exp"](self))

    Tensor.__add__ = lambda self, o: g["add"](self, o)
    Tensor.__radd__ = lambda self, o: g["add"](self, o)
    Tensor.__sub__ = lambda self, o: g["subtract"](self, o)
    Tensor.__rsub__ = lambda self, o: g["subtract"](o, self)
    Tensor.__mul__ = lambda self, o: g["multiply"](self, o)
    Tensor.__rmul__ = lambda self, o: g["multiply"](self, o)
    Tensor.__truediv__ = lambda self, o: g["divide"](self, o)
    Tensor.__rtruediv__ = lambda self, o: g["divide"](o, self)
    Tensor.__floordiv__ = lambda self, o: g["floor_divide"](self, o)
    Tensor.__rfloordiv__ = lambda self, o: g["floor_divide"](o, self)
    Tensor.__mod__ = lambda self, o: g["remainder"](self, o)
    Tensor.__rmod__ = lambda self, o: g["remainder"](o, self)
    Tensor.__pow__ = lambda self, o: g["pow"](self, o)
    Tensor.__rpow__ = lambda self, o: g["pow"](o, self)
    Tensor.__neg__ = lambda self: g["neg"](self)
    Tensor.__abs__ = lambda self: g["abs"](self)
    Tensor.__matmul__ = lambda self, o: g["matmul"](self, o)
    Tensor.__rmatmul__ = lambda self, o: g["matmul"](o, self)
    Tensor.__eq__ = lambda self, o: g["equal"](self, o)
    Tensor.__ne__ = lambda self, o: g["not_equal"](self, o)
    Tensor.__lt__ = lambda self, o: g["less_than"](self, o)
    Tensor.__le__ = lambda self, o: g["less_equal"](self, o)
    Tensor.__gt__ = lambda self, o: g["greater_than"](self, o)
    Tensor.__ge__ = lambda self, o: g["greater_equal"](self, o)
    Tensor.__and__ = lambda self, o: g["bitwise_and"](self, o)
    Tensor.__or__ = lambda self, o: g["bitwise_or"](self, o)
    Tensor.__xor__ = lambda self, o: g["bitwise_xor"](self, o)
    Tensor.__invert__ = lambda self: g["bitwise_not"](self)

    Tensor.T = property(lambda self: g["transpose"](self, list(range(self.ndim))[::-1]))


_install_tensor_methods()
