"""Common layers (port of the part of ``paddle_tpu/nn/common_layers.py`` the
recipes use): ``Identity``, ``Linear`` (weight ``[in, out]``, Xavier-uniform,
zero bias), ``Embedding`` (N(0, 1), the ``padding_idx`` row zeroed),
``Dropout`` (its masks from the layer's generator), ``Flatten``,
``Upsample``, ``ChannelShuffle`` and the activation layers."""

from __future__ import annotations

import torch

from .. import default_generator
from . import functional as F
from .initializer import Normal, XavierUniform
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Flatten", "Upsample",
           "ChannelShuffle", "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Swish", "Hardswish",
           "Hardsigmoid"]


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
        draws = self.training and self.p > 0.0
        gen = None
        if draws:
            gen = self._generator if self._generator is not None else default_generator(x.device)
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode,
                         generator=gen)

    def extra_repr(self):
        return f"p={self.p}"


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
GELU = _act_layer("GELU", F.gelu)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
ReLU6 = _act_layer("ReLU6", F.relu6)
Swish = _act_layer("Swish", F.swish)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
