"""Weight initializers (port of ``paddle_tpu/nn/initializer.py``, the ones
the stock layers use).

An initializer is called as ``init(shape, dtype, generator)`` and returns a
new tensor on the generator's device, drawn from that generator: the JAX
package draws from its framework key, the port from the explicit
``torch.Generator`` its layer was built with.  Draws are made in fp32 and
cast, as in the JAX package.  The fans follow the JAX ``_fan_in_out`` rule:
``[in, out]`` for a 2-D weight, OIHW past that.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierUniform",
           "KaimingUniform", "calculate_gain", "fans"]


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
