"""``nn.Layer`` and the containers (port of ``paddle_tpu/nn/layers.py``).

:class:`Layer` is a ``torch.nn.Module`` that keeps the Paddle surface the
recipes call: :meth:`Layer.create_parameter` (shape, ``attr``, default
initializer), :meth:`Layer.set_state_dict` (name -> array or tensor, a
checked in-place copy), Paddle's forward hooks
(:meth:`Layer.register_forward_pre_hook` /
:meth:`Layer.register_forward_post_hook`, each returning a
:class:`HookRemoveHelper`) and ``train()`` / ``eval()`` (torch's own).
Everything else -- registration, ``named_parameters``, ``state_dict``,
``to`` -- is torch's.  Parameter and buffer names are the JAX
layers' attribute names, so ``models.convert`` carries weights across.

Parameters are drawn from the layer's generator, on its device: pass
``generator=`` (a model threads one through all its layers), or ``device=``
and the layer draws from that device's ``default_generator``, which
advances with every draw, as the JAX package's framework key.  ``device``
None means CUDA and raises without a card, as every entry point of the
port.  A layer that holds no parameter and draws nothing never asks.
"""

from __future__ import annotations

import collections
import copy
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from .. import default_device, default_generator, to_dtype
from ..framework.param_attr import WeightNormParamAttr, apply_attr, refuse_weight_norm_attr
from ..framework.tensor import Tensor, as_param_base, call_unwrapped
from .initializer import Constant, Initializer, XavierUniform, global_initializer

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "HookRemoveHelper",
           "deepcopy_sharing_generators"]


# the handle a hook registration returns: ``remove()`` takes the hook off
HookRemoveHelper = RemovableHandle


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype: str = "float32", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dtype = dtype
        self._device_arg = device
        self._generator = generator

    def __call__(self, *args, **kwargs):
        """The user's entry: Tensor arguments are unwrapped to their torch
        tensors, and the outputs wrapped back when any was a Tensor; inside
        the layer everything is plain torch."""
        return call_unwrapped(super().__call__, args, kwargs)

    def register_parameter(self, name: str, param) -> None:
        """torch's registration, the parameter given Paddle's members
        (``framework.tensor.ParamBase``).  A parameter made under a
        ``WeightNormParamAttr`` (static mode) becomes ``w = g v / ||v||``:
        a torch parametrization whose ``original0`` is g (one value a slice
        along ``dim``) and ``original1`` v, both trained; the weight is
        recomputed at each use, so a Program run sees the trained g and v."""
        if param is not None and hasattr(param, "weight_norm_dim"):
            from torch.nn.utils import parametrize

            super().register_parameter(name, param)
            parametrize.register_parametrization(self, name, _WeightNorm(param.weight_norm_dim,
                                                                         param.dim()))
            return
        super().register_parameter(name, None if param is None else as_param_base(param))

    def _apply(self, fn, recurse=True):
        """torch's ``_apply`` (``to``, ``cuda``, ...), the parameters it
        replaces given Paddle's members again."""
        out = super()._apply(fn, recurse)
        for p in self._parameters.values():
            if p is not None:
                as_param_base(p)
        return out

    @property
    def generator(self) -> torch.Generator:
        """The generator this layer's parameters are drawn from: the one it
        was given, else its device's shared, advancing default."""
        if self._generator is None:
            return default_generator(default_device(self._device_arg))
        return self._generator

    def create_parameter(self, shape, attr=None, dtype=None, is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None) -> nn.Parameter:
        """A new parameter of ``shape``, as the JAX ``Layer`` makes it: drawn
        by ``attr.initializer`` when the attr carries one, else the global
        initializer (``initializer.set_global_initializer``), else
        ``default_initializer``, else zeros for a bias and Xavier-uniform for
        a weight; the attr's learning rate, regularizer and ``trainable``
        recorded on it.  A ``WeightNormParamAttr`` raises (static mode
        only)."""
        init = getattr(attr, "initializer", None)
        if init is None:
            init = global_initializer(is_bias) or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        if isinstance(attr, WeightNormParamAttr):
            from ..static.graph import in_static_mode

            if not in_static_mode():
                refuse_weight_norm_attr()
        p = nn.Parameter(init(shape, to_dtype(dtype or self._dtype), self.generator))
        if isinstance(attr, WeightNormParamAttr):
            p.weight_norm_dim = attr.dim      # reparameterised when it is registered
        return apply_attr(p, attr)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, output)`` after each forward, in
        registration order; a result other than None replaces the output.
        Its pre-forward twin is torch's ``register_forward_pre_hook``, whose
        rules are Paddle's (a result other than None replaces the inputs, a
        non-tuple being the one input).  Hooks see the layer's torch
        tensors."""
        return self.register_forward_hook(hook)

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict`` (name -> numpy array or tensor) into this
        layer's parameters and buffers in place, each cast to its tensor's
        dtype and device.  A shape that differs raises; returns ``(missing,
        unexpected)`` names, as the JAX ``Layer``."""
        own = self.state_dict(keep_vars=True)
        missing = [n for n in own if n not in state_dict]
        unexpected = [n for n in state_dict if n not in own]
        for name, value in state_dict.items():
            if name not in own:
                continue
            target = own[name]
            value = value._data if isinstance(value, Tensor) else value
            src = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {name}: {tuple(src.shape)} vs "
                                 f"{tuple(target.shape)}")
            target.copy_(src.to(device=target.device, dtype=target.dtype))
        return missing, unexpected


class _WeightNorm(nn.Module):
    """``w = g v / max(||v||, 1e-12)``, the norm over every axis but ``dim``
    (all of them for None), as the JAX ``WeightNormParamAttr``."""

    def __init__(self, dim, ndim: int):
        super().__init__()
        self.dim = None if dim is None else dim % ndim
        self.axes = None if dim is None else tuple(i for i in range(ndim) if i != self.dim)

    def _norm(self, v):
        v32 = v.to(torch.float32)
        if self.dim is None:
            return torch.sqrt(torch.sum(v32 * v32))
        return torch.sqrt(torch.sum(v32 * v32, dim=self.axes, keepdim=True))

    def forward(self, g, v):
        n = torch.clamp_min(self._norm(v), 1e-12)
        if self.dim is not None:
            shape = [1] * v.dim()
            shape[self.dim] = v.shape[self.dim]
            g = g.reshape(shape)
        return (v / n * g).to(v.dtype)

    def right_inverse(self, w):
        n = self._norm(w)
        return (n if self.dim is None else n.reshape(-1)).to(w.dtype), w


def option_layer(name: str, fn, *options):
    """A layer class ``name`` holding ``options`` ((name, default) pairs,
    set positionally in this order or by keyword) and calling ``fn(*inputs,
    *values)``: the activation and loss layers over :mod:`.functional`."""
    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        for i, (opt, default) in enumerate(options):
            setattr(self, opt, args[i] if i < len(args) else kwargs.get(opt, default))

    def forward(self, *inputs):
        return fn(*inputs, *(getattr(self, opt) for opt, _ in options))

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


def deepcopy_sharing_generators(layer: nn.Module) -> nn.Module:
    """``copy.deepcopy(layer)`` whose copy draws from the same generators as
    the original (a copied generator would repeat the original's draws)."""
    memo = {}
    for m in layer.modules():
        g = getattr(m, "_generator", None)
        if isinstance(g, torch.Generator):
            memo[id(g)] = g
    return copy.deepcopy(layer, memo)


class Sequential(Layer, nn.Sequential):
    """Sublayers run in order; given as layers (named "0", "1", ...),
    ``(name, layer)`` pairs or one ``OrderedDict``."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            items = list(layers[0].items())
        else:
            items = [layer if isinstance(layer, tuple) else (str(i), layer)
                     for i, layer in enumerate(layers)]
        for name, layer in items:
            self.add_module(str(name), layer)


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """A list of parameters (a port ``Parameter`` is stored as its
    ``torch.nn.Parameter``)."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            self.extend(parameters)

    def append(self, value):
        return nn.ParameterList.append(self, value._data if isinstance(value, Tensor) else value)
