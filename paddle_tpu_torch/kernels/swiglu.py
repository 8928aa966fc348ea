"""SwiGLU activation (port of ``paddle_tpu/kernels/swiglu.py``):
``silu(x) * y``, or of the two halves of ``x``.  Plain PyTorch on every
device: the JAX original is plain XLA too."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y
