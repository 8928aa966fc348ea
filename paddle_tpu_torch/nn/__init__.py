"""``paddle_tpu_torch.nn``: the pieces of ``paddle_tpu.nn`` the ported paths use."""

from . import clip  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
