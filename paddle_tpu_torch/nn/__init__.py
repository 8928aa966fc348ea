"""``paddle_tpu_torch.nn``: the pieces of ``paddle_tpu.nn`` the ported paths use."""

from . import clip  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
