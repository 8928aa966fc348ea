"""``paddle_tpu_torch.incubate`` (port of ``paddle_tpu.incubate``): the
Mixture-of-Experts layer (:mod:`.moe`), the fused ops and layers
(:mod:`.nn`) and the optimizer wrappers (:mod:`.optimizer`).

Not ported: ``asp``, ``autograd``, ``distributed`` and the graph
samplers of the JAX package's top level."""

from __future__ import annotations

import torch

from . import moe, nn, optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["moe", "nn", "optimizer", "LookAhead", "ModelAverage", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss"]


def softmax_mask_fuse(x: torch.Tensor, mask: torch.Tensor, name=None) -> torch.Tensor:
    """softmax(x + mask) over the last dim (additive mask)."""
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x: torch.Tensor, name=None) -> torch.Tensor:
    """Causal softmax over the last two dims: the upper triangle masked out."""
    S, R = x.shape[-1], x.shape[-2]
    keep = torch.ones(R, S, dtype=torch.bool, device=x.device).tril(S - R)
    return torch.softmax(torch.where(keep, x, -1e30), dim=-1)


def identity_loss(x: torch.Tensor, reduction="none") -> torch.Tensor:
    """Mark ``x`` as a loss with a reduction: none / sum / mean (or 2 / 0 / 1)."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 0):
        return x.sum()
    if reduction in ("mean", 1):
        return x.mean()
    raise ValueError(f"unknown reduction {reduction!r}")
