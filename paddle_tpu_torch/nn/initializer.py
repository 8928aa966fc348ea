"""Weight initializers (port of ``paddle_tpu/nn/initializer.py``).

An initializer is called as ``init(shape, dtype, generator)`` and returns a
new tensor on the generator's device, drawn from that generator: the JAX
package draws from its framework key, the port from the explicit
``torch.Generator`` its layer was built with.  Draws are made in fp32 and
cast, as in the JAX package.  The fans follow the JAX ``_fan_in_out`` rule:
``[in, out]`` for a 2-D weight, OIHW past that.  The deterministic ones
(``Constant``, ``Assign``, ``Dirac``, ``Bilinear``) give the JAX package's
values exactly; the random ones its distribution (``Orthogonal``
QR-orthogonalises a normal draw, signs fixed by R's diagonal).
:func:`set_global_initializer` sets the defaults ``Layer.create_parameter``
takes ahead of a layer's own.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
    "Bilinear", "set_global_initializer",
]


def fans(shape: Sequence[int]):
    """``(fan_in, fan_out)`` of a weight: ``[in, out]`` for 2-D, OIHW (the
    Paddle conv layout) past that."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        neg = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + neg ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


def _empty(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                       device=generator.device)


class Initializer:
    def __call__(self, shape, dtype: torch.dtype, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator):
        return _empty(shape, generator).fill_(float(self.value)).to(dtype)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator):
        return _empty(shape, generator).normal_(self.mean, self.std,
                                                generator=generator).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator):
        return _empty(shape, generator).uniform_(self.low, self.high,
                                                 generator=generator).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in: Optional[float] = None, fan_out: Optional[float] = None,
                 gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, generator):
        fi, fo = fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in: Optional[float] = None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, generator):
        fi = self.fan_in if self.fan_in is not None else fans(shape)[0]
        limit = calculate_gain(self.nonlinearity, self.negative_slope) * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator)


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` standard normal truncated to ``[a, b]``."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0, b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, generator):
        z = torch.nn.init.trunc_normal_(_empty(shape, generator), 0.0, 1.0, self.a, self.b,
                                        generator=generator)
        return (self.mean + self.std * z).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None, fan_out: Optional[float] = None,
                 gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, generator):
        fi, fo = fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return Normal(0.0, self.gain * math.sqrt(2.0 / (fi + fo)))(shape, dtype, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, generator):
        fi = self.fan_in if self.fan_in is not None else fans(shape)[0]
        std = calculate_gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, generator)


class Assign(Initializer):
    """The given value (array, list or Tensor), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, generator):
        v = self.value
        v = v._data if hasattr(v, "_data") else v
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return t.to(device=generator.device, dtype=dtype).reshape(
            tuple(int(s) for s in shape)).clone()


class Orthogonal(Initializer):
    """``gain`` times the Q of a normal ``[max(r, c), min(r, c)]`` draw
    (columns signed by R's diagonal), transposed when ``rows < cols``, as
    ``[rows, prod(shape[1:])]``."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, generator):
        shape = tuple(int(s) for s in shape)
        rows, cols = shape[0], math.prod(shape[1:])
        flat = _empty((max(rows, cols), min(rows, cols)), generator).normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """Identity convolution kernels: ones at the spatial centre of
    ``[g o + k, k]`` for ``k < min(out / groups, in)``."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype, generator):
        shape = tuple(int(s) for s in shape)
        out = torch.zeros(shape, dtype=torch.float32)
        o, i = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        per = o // self.groups
        for g in range(self.groups):
            for k in range(min(per, i)):
                out[(g * per + k, k) + centre] = 1.0
        return out.to(device=generator.device, dtype=dtype)


class Bilinear(Initializer):
    """The bilinear upsampling kernel in every ``[o, i]`` slot of a 4-D
    (transposed) convolution weight."""

    def __call__(self, shape, dtype, generator):
        shape = [int(s) for s in shape]
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D conv weight")
        kh, kw = shape[2], shape[3]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
        kernel = ((1 - np.abs(yy / f_h - c_h)) * (1 - np.abs(xx / f_w - c_w))).astype(np.float32)
        w = np.broadcast_to(kernel, shape)
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=generator.device, dtype=dtype)


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """The initializers of parameters created from now on, ahead of a
    layer's defaults (an attr's initializer still wins); None resets."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def global_initializer(is_bias: bool):
    return _GLOBAL_BIAS_INIT if is_bias else _GLOBAL_WEIGHT_INIT
