"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``): the global-norm
clip that ``TrainStep`` and ``Optimizer.step`` take as ``grad_clip``.  The
per-value and per-tensor clips come with a later slice."""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """params_grads: list of (param, grad). Returns the same structure clipped."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm over all gradients summed in fp32."""

    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq_sum = None
        for _, g in params_grads:
            if g is None:
                continue
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq_sum = s if sq_sum is None else sq_sum + s
        if sq_sum is None:
            return params_grads
        factor = self.clip_norm / torch.clamp_min(torch.sqrt(sq_sum), self.clip_norm)
        return [(p, (g.to(torch.float32) * factor).to(g.dtype) if g is not None else None)
                for p, g in params_grads]
