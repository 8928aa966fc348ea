"""Normalization layers (port of the part of ``paddle_tpu/nn/norm.py`` the
recipes use): ``LayerNorm``; ``BatchNorm`` / ``BatchNorm1D`` /
``BatchNorm2D`` with their running statistics in the buffers ``_mean``
(zeros) and ``_variance`` (ones), the JAX layer's names, updated as
:func:`.functional.batch_norm` says."""

from __future__ import annotations

import torch

from . import functional as F
from .initializer import Constant
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.num_features, self.momentum, self.epsilon = num_features, momentum, epsilon
        self.data_format, self.use_global_stats = data_format, use_global_stats
        self.weight = (None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_features], attr=bias_attr, is_bias=True))
        dev = self.generator.device
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self.momentum,
                            epsilon=self.epsilon, data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return (f"num_features={self.num_features}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None, *,
                 device=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format == "NCL" else "NHWC", use_global_stats,
                         device=device, generator=generator)


class BatchNorm2D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None, bias_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else self.create_parameter(
            self.normalized_shape, attr=weight_attr, default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(self.normalized_shape, attr=bias_attr, is_bias=True))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"
