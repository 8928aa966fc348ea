"""``paddle.ParamAttr`` and ``paddle.create_parameter`` (port of
``paddle_tpu/framework/param_attr.py``).

A :class:`ParamAttr` is what every layer's ``weight_attr`` / ``bias_attr``
takes: a name, an initializer, a learning-rate scale, a regularizer, and
whether the parameter trains.  ``nn.Layer.create_parameter`` reads it with
the JAX precedence (the attr's initializer, then the global one, then the
layer's default); the standalone :func:`create_parameter` takes its
``default_initializer`` first, as the JAX one does.  As in the JAX package
the optimizers take weight decay from their own ``weight_decay``; a
parameter's ``regularizer`` and ``optimize_attr`` are recorded on it.
:class:`WeightNormParamAttr` reparameterises a layer's weight in static mode
only (``nn.Layer.create_parameter`` makes it a torch parametrization,
recomputed at every run); in dynamic mode, and through the standalone
:func:`create_parameter`, it raises, and ``nn.utils.weight_norm`` is the
way.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr", "WeightNormParamAttr", "create_parameter"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


class WeightNormParamAttr(ParamAttr):
    """Weight normalisation as a parameter attribute (``w = g v / ||v||``
    over all axes but ``dim``): static-graph only."""

    def __init__(self, dim=None, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer, learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         do_model_average=do_model_average, need_clip=need_clip)
        self.dim = dim


def refuse_weight_norm_attr():
    raise RuntimeError(
        "WeightNormParamAttr reparameterizes through recorded graph ops "
        "and needs static mode (paddle.enable_static()); in dynamic "
        "mode wrap the layer with paddle.nn.utils.weight_norm instead")


def apply_attr(p, attr):
    """Record ``attr``'s learning rate, regularizer and ``trainable`` on the
    parameter ``p`` (a ``torch.nn.Parameter``), as the JAX
    ``create_parameter`` does on its Parameter; returns ``p``."""
    lr = getattr(attr, "learning_rate", None)
    p.optimize_attr = {"learning_rate": 1.0 if lr is None else lr}
    p.regularizer = getattr(attr, "regularizer", None)
    if getattr(attr, "trainable", True) is False:
        p.requires_grad_(False)
    return p


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``paddle.create_parameter``: a trainable :class:`~.tensor.Parameter`
    of ``shape`` on the current device, drawn from its default generator
    by ``default_initializer``, else ``attr.initializer``, else zeros for a
    bias and Xavier-uniform for a weight.  ``attr`` may be a
    :class:`ParamAttr`, a name, or None / True (defaults); False raises."""
    from ..nn.initializer import Constant, XavierUniform
    from . import dtype as dtype_mod
    from .device import default_device
    from .random import default_generator
    from .tensor import Parameter

    if attr is None or attr is True:
        attr = ParamAttr(name=name)
    elif isinstance(attr, str):
        attr = ParamAttr(name=attr)
    elif attr is False:
        raise ValueError("create_parameter(attr=False): nothing to create")
    if isinstance(attr, WeightNormParamAttr):
        refuse_weight_norm_attr()
    init = default_initializer or attr.initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    dev = default_device()
    data = init(list(shape), dtype_mod.convert_dtype(dtype), default_generator(dev))
    p = Parameter(data.to(dev), name=attr.name or name, trainable=attr.trainable is not False)
    if attr.learning_rate is not None:
        p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    return p
