"""``paddle_tpu_torch.hapi``: the Keras-like high-level ``Model`` API (port
of ``paddle_tpu/hapi``).  ``fit`` drives the port's ``jit.TrainStep`` a
batch at a time; ``evaluate`` / ``predict`` run the network in eval mode
under ``no_grad``."""

from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRSchedulerCallback,
    ModelCheckpoint,
    ProgBarLogger,
)
from .model import Model, summary  # noqa: F401
from .flops import flops  # noqa: F401

__all__ = ["Model", "summary", "flops", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRSchedulerCallback"]
