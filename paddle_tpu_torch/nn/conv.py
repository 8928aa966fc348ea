"""Convolution and pooling layers (port of ``paddle_tpu/nn/conv.py``).
Weights are OI* (a transposed conv's ``[in, out // groups, *kernel]``),
Kaiming-uniform over the fan-in ``in // groups * prod(kernel)``; a bias
uniform in +-1/sqrt(fan-in) unless its attr says otherwise, as the JAX
layers.  The pools hold their options over :mod:`.functional`."""

from __future__ import annotations

import math

from . import functional as F
from .initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool2D",
]


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


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCDHW", *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding, dilation,
                         groups, weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)


class _ConvTransposeNd(_ConvNd):
    _nd = 2
    _fn = None
    _format = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format=None, *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, self._nd, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format or self._format,
                         transpose=True, output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self.stride, self.padding,
                              self.output_padding, self.groups, self.dilation, output_size,
                              self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _nd, _fn, _format = 1, F.conv1d_transpose, "NCL"


class Conv2DTranspose(_ConvTransposeNd):
    _nd, _fn, _format = 2, F.conv2d_transpose, "NCHW"


class Conv3DTranspose(_ConvTransposeNd):
    _nd, _fn, _format = 3, F.conv3d_transpose, "NCDHW"


def _pool_layer(name, fn):
    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        Layer.__init__(self)
        kwargs.pop("name", None)
        self.kernel_size, self.stride, self.padding, self.kwargs = (kernel_size, stride, padding,
                                                                    kwargs)

    def forward(self, x):
        return fn(x, self.kernel_size, self.stride, self.padding, **self.kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


AvgPool1D = _pool_layer("AvgPool1D", F.avg_pool1d)
AvgPool2D = _pool_layer("AvgPool2D", F.avg_pool2d)
AvgPool3D = _pool_layer("AvgPool3D", F.avg_pool3d)
MaxPool1D = _pool_layer("MaxPool1D", F.max_pool1d)
MaxPool2D = _pool_layer("MaxPool2D", F.max_pool2d)
MaxPool3D = _pool_layer("MaxPool3D", F.max_pool3d)


def _adaptive_layer(name, fn):
    def __init__(self, output_size, *args, name=None, **kwargs):
        Layer.__init__(self)
        self.output_size = output_size

    def forward(self, x):
        return fn(x, self.output_size)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


AdaptiveAvgPool1D = _adaptive_layer("AdaptiveAvgPool1D", F.adaptive_avg_pool1d)
AdaptiveAvgPool2D = _adaptive_layer("AdaptiveAvgPool2D", F.adaptive_avg_pool2d)
AdaptiveAvgPool3D = _adaptive_layer("AdaptiveAvgPool3D", F.adaptive_avg_pool3d)
AdaptiveMaxPool1D = _adaptive_layer("AdaptiveMaxPool1D", F.adaptive_max_pool1d)
AdaptiveMaxPool2D = _adaptive_layer("AdaptiveMaxPool2D", F.adaptive_max_pool2d)
