"""``paddle.regularizer`` (port of ``paddle_tpu/regularizer.py``): the
decay holders an optimizer's ``weight_decay`` takes (it reads their
``_coeff``, as the JAX optimizer does)."""

from .optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
