"""Convolution and pooling layers (port of the part of
``paddle_tpu/nn/conv.py`` the recipes use).  Weights are OIHW (a transposed
conv's ``[in, out // groups, kH, kW]``), Kaiming-uniform over the fan-in
``in // groups * prod(kernel)``; a bias uniform in +-1/sqrt(fan-in) unless
its attr says otherwise, as the JAX layers."""

from __future__ import annotations

import math

from . import functional as F
from .initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv2DTranspose", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D"]


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1, padding=0,
                 dilation=1, groups=1, weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride, self.padding = _ntuple(stride, nd), padding
        self.dilation, self.groups = _ntuple(dilation, nd), groups
        self.data_format, self.output_padding = data_format, output_padding
        shape = ([in_channels, out_channels // groups] if transpose
                 else [out_channels, in_channels // groups]) + self.kernel_size
        fan_in = in_channels // groups * math.prod(self.kernel_size)
        self.weight = self.create_parameter(shape, attr=weight_attr,
                                            default_initializer=KaimingUniform(fan_in=fan_in))
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound) if bias_attr is None else None))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCL", *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding, dilation,
                         groups, weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding, dilation,
                         groups, weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding, dilation,
                         groups, weight_attr, bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device, generator=generator)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation, output_size,
                                  self.data_format)


class _Pool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.kwargs = kwargs


class MaxPool2D(_Pool2D):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding, **self.kwargs)


class AvgPool2D(_Pool2D):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding, **self.kwargs)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
