"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``): the clips
``TrainStep`` and ``Optimizer.step`` take as ``grad_clip`` (a list of
``(param, grad)`` in, the same list clipped out; the gradient keeps its
dtype, the norms are fp32), and ``clip_grad_norm_`` / ``clip_grad_value_``
over parameters' ``.grad`` in place."""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _scale(g, factor):
    """``g`` times ``factor`` rounded once to ``g``'s dtype: the product is
    taken in fp32, as JAX promotes bf16 x fp32 (torch keeps a bf16 tensor
    times a 0-d fp32 tensor in bf16, rounding ``factor`` first)."""
    return (g.to(torch.float32) * factor).to(g.dtype)


def _over(c, x):
    """``c / x`` rounded once in ``x``'s dtype (a Python number over a
    tensor is ``x.reciprocal() * c`` in torch: two roundings)."""
    return torch.div(torch.full((), c, dtype=x.dtype, device=x.device), x)


class ClipGradBase:
    def __call__(self, params_grads):
        """params_grads: list of (param, grad). Returns the same structure clipped."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if g is not None else None)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by ``min(clip_norm / max(|g|, 1e-12), 1)``, its
    own norm in fp32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, None))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))
            factor = torch.clamp_max(_over(self.clip_norm, torch.clamp_min(norm, 1e-12)), 1.0)
            out.append((p, _scale(g, factor)))
        return out


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
        factor = _over(self.clip_norm, torch.clamp_min(torch.sqrt(sq_sum), self.clip_norm))
        return [(p, _scale(g, factor) if g is not None else None)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-6), 1)``, ``total`` their ``norm_type`` norm (in fp32;
    ``inf``: the largest |value|); returns ``total``."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(p.grad)) for p in params]))
    else:
        total = torch.sum(torch.stack([torch.sum(torch.abs(p.grad.to(torch.float32)) ** norm_type)
                                       for p in params])) ** (1.0 / norm_type)
    factor = torch.clamp_max(_over(max_norm, torch.clamp_min(total, 1e-6)), 1.0)
    for p in params:
        p.grad = _scale(p.grad, factor)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the ``.grad`` of ``parameters`` into ``[-clip_value,
    clip_value]`` in place."""
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)
