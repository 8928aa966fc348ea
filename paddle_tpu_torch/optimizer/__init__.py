"""``paddle_tpu_torch.optimizer`` (port of ``paddle_tpu.optimizer``)."""

from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    ASGD, LBFGS, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,
    NAdam, Optimizer, RAdam, RMSProp, Rprop, SGD,
)


class L2Decay:
    """Weight decay coefficient holder (reference: ``paddle.regularizer.L2Decay``)."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff
