"""Normalization layers (port of ``paddle_tpu/nn/norm.py``): the batch
norms (``BatchNorm`` / ``1D`` / ``2D`` / ``3D``, ``SyncBatchNorm``) with
their running statistics in the buffers ``_mean`` (zeros) and ``_variance``
(ones), the JAX layer's names, updated as :func:`.functional.batch_norm`
says; ``LayerNorm``; ``RMSNorm`` (through :func:`.functional.rms_norm`, so
the RMSNorm kernels on the card); ``GroupNorm``, the instance norms
(``weight`` / ``bias``), ``LocalResponseNorm`` and ``SpectralNorm`` (its
power-iteration start vectors in the buffers ``weight_u`` / ``weight_v``).

``SyncBatchNorm`` is ``BatchNorm`` in one process: the JAX one is
``BatchNorm`` under GSPMD, whose batch statistics are global because the
program is; the port's multi-process form waits for its data-parallel
slice."""

from __future__ import annotations

import math

import torch

from . import functional as F
from .initializer import Constant
from .layers import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]


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


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None, *,
                 device=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr, data_format,
                         use_global_stats, device=device, generator=generator)


class SyncBatchNorm(_BatchNormBase):
    """``BatchNorm`` (one process; see the module docstring)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding the same parameters and statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer.data_format, use_global_stats=layer.use_global_stats,
                      generator=layer.generator)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


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


class RMSNorm(Layer):
    """RMSNorm over the last axes (weight ones), through
    :func:`.functional.rms_norm`: the RMSNorm kernels on a CUDA input whose
    width divides by 128."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(self.normalized_shape, attr=weight_attr,
                                            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.num_groups, self.num_channels = num_groups, num_channels
        self.epsilon, self.data_format = epsilon, data_format
        self.weight = (None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_channels], attr=bias_attr, is_bias=True))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.epsilon,
                            self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCL", name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_features], attr=bias_attr, is_bias=True))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k)


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` the largest singular value of the
    weight as a ``[shape[axis], -1]`` matrix, by ``power_iters`` power
    iterations from the buffers ``weight_u`` / ``weight_v`` (standard
    normal draws; not updated, as in the JAX package)."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12, dtype="float32", *,
                 device=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.axis, self.power_iters, self.epsilon = axis, power_iters, epsilon
        h = int(weight_shape[axis])
        w = math.prod(int(s) for s in weight_shape) // h
        g = self.generator
        self.register_buffer("weight_u", torch.randn(h, generator=g, device=g.device))
        self.register_buffer("weight_v", torch.randn(w, generator=g, device=g.device))

    def forward(self, weight):
        mat = weight.movedim(self.axis, 0).reshape(weight.shape[self.axis], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.epsilon)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.epsilon)
        return weight / (u @ mat @ v)
