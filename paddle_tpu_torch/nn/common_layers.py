"""Common layers (port of ``paddle_tpu/nn/common_layers.py``): ``Identity``,
``Linear`` (weight ``[in, out]``, Xavier-uniform, zero bias), ``Embedding``
(N(0, 1), the ``padding_idx`` row zeroed), the dropouts (their masks from
the layer's generator, else the input device's default), the activation,
padding, upsampling, shuffle and distance layers, ``Flatten`` /
``Unflatten``, ``Bilinear`` (weight ``[out, in1, in2]``, bias ``[1, out]``)
and ``Fold`` / ``Unfold``, each over :mod:`.functional`."""

from __future__ import annotations

import torch

from . import functional as F
from .initializer import Constant, Normal, XavierUniform
from .layers import Layer, option_layer

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Softmax", "LogSoftmax", "Tanh",
    "Hardswish", "Hardsigmoid", "LeakyReLU", "ELU", "SELU", "CELU", "Mish",
    "Softplus", "Softsign", "Swish", "GLU", "Hardtanh", "Tanhshrink", "Softshrink",
    "Hardshrink", "PReLU", "LogSigmoid", "ThresholdedReLU", "RReLU",
    "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
    "CosineSimilarity", "PairwiseDistance", "Identity", "Flatten", "Unflatten",
    "Bilinear", "Fold", "Unfold",
]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x W + b`` with ``W: [in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr,
                                            default_initializer=XavierUniform())
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_features], attr=bias_attr, is_bias=True))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter([num_embeddings, embedding_dim], attr=weight_attr,
                                            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """Paddle's dropout; in training with ``p > 0`` its mask comes from the
    layer's generator, else from the input device's advancing
    ``default_generator``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None, *,
                 generator=None):
        super().__init__(generator=generator)
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode,
                         generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *, generator=None):
        super().__init__(generator=generator)
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self._generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *, generator=None):
        super().__init__(generator=generator)
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self._generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__(generator=generator)
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training, generator=self._generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners, self.align_mode = mode, align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.align_mode, self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return x.unflatten(self.axis, tuple(self.shape))


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value, self.data_format = padding, mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadND):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    """``x1ᵀ W x2 + b``: weight ``[out, in1, in2]`` (Xavier-uniform), bias
    ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.weight = self.create_parameter([out_features, in1_features, in2_features],
                                            attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([1, out_features], attr=bias_attr, is_bias=True))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings, self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes, self.strides = output_sizes, kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides, self.paddings,
                      self.dilations)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)


def _act_layer(name, fn):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            self._kwargs = kwargs

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Silu = _act_layer("Silu", F.silu)
Tanh = _act_layer("Tanh", F.tanh)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Mish = _act_layer("Mish", F.mish)
Softsign = _act_layer("Softsign", F.softsign)
Swish = _act_layer("Swish", F.swish)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)


Softmax = option_layer("Softmax", F.softmax, ("axis", -1))
LogSoftmax = option_layer("LogSoftmax", F.log_softmax, ("axis", -1))
LeakyReLU = option_layer("LeakyReLU", F.leaky_relu, ("negative_slope", 0.01))
ELU = option_layer("ELU", F.elu, ("alpha", 1.0))
SELU = option_layer("SELU", F.selu, ("scale", F.SELU_SCALE), ("alpha", F.SELU_ALPHA))
CELU = option_layer("CELU", F.celu, ("alpha", 1.0))
Softplus = option_layer("Softplus", F.softplus, ("beta", 1.0), ("threshold", 20.0))
GLU = option_layer("GLU", F.glu, ("axis", -1))
Hardtanh = option_layer("Hardtanh", F.hardtanh, ("min", -1.0), ("max", 1.0))
Softshrink = option_layer("Softshrink", F.softshrink, ("threshold", 0.5))
Hardshrink = option_layer("Hardshrink", F.hardshrink, ("threshold", 0.5))
ThresholdedReLU = option_layer("ThresholdedReLU", F.thresholded_relu, ("threshold", 1.0),
                                ("value", 0.0))


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *, generator=None):
        super().__init__(generator=generator)
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self._generator)


class PReLU(Layer):
    """Slopes ``[num_parameters]`` (``init`` each)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
