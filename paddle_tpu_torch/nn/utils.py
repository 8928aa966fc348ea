"""``nn.utils`` (port of ``paddle_tpu/nn/utils.py``): the reparameterisations
by forward-pre-hook, parameter flattening, and the gradient clips of
:mod:`.clip` re-exported.

As in the JAX package, :func:`weight_norm` replaces ``layer.<name>`` by the
parameters ``<name>_v`` (direction) and ``<name>_g`` (magnitude over every
axis but ``dim``) and recomputes the weight before each forward;
:func:`spectral_norm` renames it ``<name>_orig``, keeps the power
iteration's vector in the buffer ``<name>_u`` (its start drawn from
numpy's ``default_rng(0)``, the JAX package's) and divides the weight by
its estimated largest singular value before each forward, updating
``<name>_u``.  Autograd reaches the pieces through torch's tape.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..framework.tensor import boundary
from .clip import clip_grad_norm_, clip_grad_value_

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_axes(ndim: int, dim):
    return None if dim is None else [i for i in range(ndim) if i != dim]


def _compute_weight(v, g, dim):
    axes = _norm_axes(v.dim(), dim)
    if axes is None:
        return v / torch.clamp((v * v).sum().sqrt(), min=1e-12) * g
    n = (v * v).sum(dim=axes, keepdim=True).sqrt()
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    return v / torch.clamp(n, min=1e-12) * g.reshape(shape)


def _hooks(layer) -> dict:
    if not hasattr(layer, "_weight_norm_hooks"):
        layer._weight_norm_hooks = {}
    return layer._weight_norm_hooks


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Split ``layer.<name>`` into ``<name>_v`` and ``<name>_g``; a
    forward-pre-hook recomputes ``<name> = g v / ||v||`` each call."""
    w = getattr(layer, name)
    if dim is not None:
        dim = dim % w.dim()
    with torch.no_grad():
        axes = _norm_axes(w.dim(), dim)
        g0 = (w * w).sum().sqrt() if axes is None else (w * w).sum(dim=axes).sqrt()
    del layer._parameters[name]
    layer.register_parameter(name + "_v", nn.Parameter(w.detach().clone()))
    layer.register_parameter(name + "_g", nn.Parameter(g0.to(w.dtype)))

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, _compute_weight(getattr(lyr, name + "_v"),
                                                      getattr(lyr, name + "_g"), dim))

    _hooks(layer)[name] = (layer.register_forward_pre_hook(hook), dim)
    hook(layer, None)          # the weight exists before the first forward
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Bake the current weight back into a plain parameter ``<name>`` and
    remove the hook."""
    handle, dim = _hooks(layer).pop(name)
    handle.remove()
    with torch.no_grad():
        w = _compute_weight(getattr(layer, name + "_v"), getattr(layer, name + "_g"), dim)
    del layer._parameters[name + "_v"], layer._parameters[name + "_g"]
    if name in layer.__dict__:
        object.__delattr__(layer, name)
    layer.register_parameter(name, nn.Parameter(w.detach().clone()))
    return layer


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1, eps: float = 1e-12,
                  dim=None):
    """``layer.<name>`` divided by its largest singular value (the weight
    as a ``[shape[dim], -1]`` matrix, ``dim`` 0 by default), estimated by
    ``n_power_iterations`` (at least one) power iterations from the buffer
    ``<name>_u`` before each forward, in fp32."""
    w = getattr(layer, name)
    dim = (0 if dim is None else dim) % w.dim()
    h = int(w.shape[dim])
    u0 = np.random.default_rng(0).normal(size=(h,)).astype(np.float32)
    u0 /= np.linalg.norm(u0) + eps
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(device=w.device, dtype=w.dtype))
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", w)

    def hook(lyr, inputs):
        wp, u_t = getattr(lyr, name + "_orig"), getattr(lyr, name + "_u")
        wm = wp.to(torch.float32).movedim(dim, 0).reshape(h, -1)
        u = u_t.to(torch.float32)
        for _ in range(max(1, n_power_iterations)):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        object.__setattr__(lyr, name, (wp / (u @ wm @ v)).to(wp.dtype))
        with torch.no_grad():
            u_t.copy_(u.to(u_t.dtype))

    _hooks(layer)[name] = (layer.register_forward_pre_hook(hook), dim)
    hook(layer, None)
    return layer


@boundary
def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated."""
    return torch.cat([p.reshape(-1) for p in parameters])


@boundary
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive pieces of ``vec`` into the parameters, in place."""
    parameters = list(parameters)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            p.copy_(vec[offset:offset + p.numel()].reshape(p.shape))
            offset += p.numel()
    if offset != vec.numel():
        raise ValueError(f"vector has {vec.numel()} elements but the parameters hold {offset}")
    return parameters
