"""``paddle.callbacks`` namespace: the hapi callbacks (port of
``paddle_tpu/callbacks.py``)."""

from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRSchedulerCallback as LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
)
from .hapi.callbacks import ReduceLROnPlateau, VisualDL, WandbCallback  # noqa: F401

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "WandbCallback"]
