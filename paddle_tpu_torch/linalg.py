"""``paddle_tpu_torch.linalg`` (port of ``paddle_tpu/linalg.py``)."""

from .ops.linalg import *  # noqa: F401,F403
from .ops.linalg import __all__  # noqa: F401
