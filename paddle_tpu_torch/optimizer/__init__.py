"""``paddle_tpu_torch.optimizer`` (port of ``paddle_tpu.optimizer``)."""

from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
