"""``paddle_tpu_torch.incubate.optimizer`` (port of
``paddle_tpu/incubate/optimizer/__init__.py``): LookAhead, ModelAverage,
DGCMomentum, and the re-exported LBFGS; :mod:`.functional` holds
``minimize_bfgs`` / ``minimize_lbfgs``.

LookAhead and ModelAverage wrap the port's optimizers: the inner step is
the inner optimizer's own (AdamW's one launch of the multi-tensor kernel,
where the inner optimizer is AdamW).  Their slow and averaged copies are
fp32; where the inner optimizer keeps an fp32 master of a parameter,
LookAhead's sync writes the master too, so the next inner step starts from
the synced value.  DGCMomentum is a port optimizer: its ``_update`` runs in
plain torch ops, as the JAX one runs in XLA.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ...optimizer.optimizer import LBFGS, Optimizer
from . import functional  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "DGCMomentum", "LBFGS"]


def _master(opt, i: int) -> Optional[torch.Tensor]:
    state = getattr(opt, "_state", None)
    return None if state is None else state[i].get("master")


class LookAhead:
    """k steps forward, one step back (Zhang et al. 2019): every ``k``
    inner steps the slow weights move ``alpha`` of the way toward the fast
    ones, and the fast weights reset to the slow ones."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        self._slow: List[torch.Tensor] = [p.detach().to(torch.float32).clone()
                                          for p in inner_optimizer._parameter_list]

    @torch.no_grad()
    def step(self):
        out = self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, (p, slow) in enumerate(zip(self.inner_optimizer._parameter_list,
                                              self._slow)):
                master = _master(self.inner_optimizer, i)
                fast = master if master is not None else p.detach().to(torch.float32)
                slow.copy_(slow + self.alpha * (fast - slow))
                if master is not None:
                    master.copy_(slow)
                p.copy_(slow)
        return out

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """Through this wrapper's :meth:`step`, so the sync still fires."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        return self.inner_optimizer.clear_grad(set_to_zero)

    def state_dict(self) -> dict:
        out = self.inner_optimizer.state_dict()
        out["lookahead"] = {"step_count": self._step_count,
                            "slow": [s.cpu().numpy() for s in self._slow]}
        return out

    def set_state_dict(self, state: dict):
        state = dict(state)
        la = state.pop("lookahead", None)
        self.inner_optimizer.set_state_dict(state)
        if la is not None:
            self._step_count = la["step_count"]
            for dst, src in zip(self._slow, la["slow"]):
                dst.copy_(torch.as_tensor(np.asarray(src)))

    def __getattr__(self, item):
        inner = self.__dict__.get("inner_optimizer")
        if inner is None:
            raise AttributeError(item)
        return getattr(inner, item)


class ModelAverage:
    """A running average of the weights, swapped in by :meth:`apply` (a
    context manager that restores them after).  The window grows with
    training: ``clip(updates * average_window_rate, min_average_window,
    max_average_window)``; past it the sum is rescaled to the window (an
    exponential-window mean).  Sums are fp32."""

    def __init__(self, average_window_rate: float = 0.15, parameters=None,
                 min_average_window: int = 10000, max_average_window: int = 10000, name=None):
        if parameters is None:
            raise ValueError("ModelAverage needs parameters=")
        self.parameters: List[torch.Tensor] = [p[1] if isinstance(p, tuple) else p
                                               for p in parameters]
        self.average_window_rate = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._n = 0
        self._total = 0
        self._sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in self.parameters]
        self._backup: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def step(self):
        """Accumulate the current weights (after the inner optimizer's step)."""
        for s, p in zip(self._sum, self.parameters):
            s.add_(p.detach().to(torch.float32))
        self._n += 1
        self._total += 1
        window = int(max(self.min_average_window,
                         min(self.max_average_window, self._total * self.average_window_rate)))
        if self._n > window:
            scale = window / self._n
            for s in self._sum:
                s.mul_(scale)
            self._n = window

    def apply(self, executor=None, need_restore: bool = True):
        return self._apply_ctx(need_restore)

    @contextlib.contextmanager
    def _apply_ctx(self, need_restore: bool):
        if self._n == 0:
            yield
            return
        with torch.no_grad():
            self._backup = [p.detach().clone() for p in self.parameters]
            for s, p in zip(self._sum, self.parameters):
                p.copy_((s / self._n).to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self.parameters, self._backup):
            p.copy_(b)
        self._backup = None


class DGCMomentum(Optimizer):
    """Deep Gradient Compression momentum (Lin et al. 2018): momentum ``u``
    and an error-feedback residual ``v`` accumulate each step; only the
    top ``1 - sparsity`` share of ``|v|`` is applied, the rest stays in the
    residual, and the applied entries' momentum is cleared.  Sparsity steps
    through ``sparsity`` over ``rampup_step`` steps from
    ``rampup_begin_step``; before that the update is dense momentum.  A
    parameter too small to sparsify stays dense momentum."""

    def __init__(self, learning_rate=0.001, momentum=0.9, rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,), parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._momentum = float(momentum)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(float(s) for s in sparsity)
        if not self._sparsity or not all(0.0 < s < 1.0 for s in self._sparsity):
            raise ValueError(f"sparsity stages must lie in (0, 1): {sparsity}")
        if len(self._sparsity) > 1 and self._rampup_step < len(self._sparsity):
            raise ValueError(
                f"rampup_step ({rampup_step}) must cover the {len(self._sparsity)} "
                "sparsity stages (each stage needs >= 1 step, else the warmup "
                "schedule silently collapses to the last stage)")
        if use_nesterov:
            raise NotImplementedError("DGC with nesterov is not supported")

    def _init_slots(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "residual": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _sparsity_at(self, step: torch.Tensor) -> torch.Tensor:
        """The scheduled sparsity at ``step`` (a 0-d tensor): stage i within
        its share of the rampup window, the last stage after."""
        stages = self._sparsity
        per = self._rampup_step / len(stages)
        s = torch.tensor(stages[-1], dtype=torch.float32, device=step.device)
        for i in reversed(range(len(stages) - 1)):
            s = torch.where(step < self._rampup_begin + int((i + 1) * per),
                            torch.tensor(stages[i], dtype=torch.float32, device=step.device), s)
        return s

    def _update(self, p32, g32, slots, lr, step):
        u = self._momentum * slots["velocity"] + g32
        v = slots["residual"] + u
        n = v.numel()
        k_max = max(1, int(math.ceil((1.0 - min(self._sparsity)) * n)))
        if k_max >= n:
            return p32 - lr * v, {"velocity": u, "residual": torch.zeros_like(v)}
        s_now = self._sparsity_at(step)
        k_dyn = torch.clamp(torch.ceil((1.0 - s_now) * n).to(torch.int64), 1, k_max)
        absv = v.abs().reshape(-1)
        top = torch.topk(absv, k_max).values
        thr = top.gather(0, (k_dyn - 1).reshape(1))[0]
        # a zero threshold (fewer nonzero residuals than k) must not select
        # the zeros: that would clear the whole parameter's momentum
        mask = ((v.abs() >= thr) & (v.abs() > 0)).to(torch.float32)
        dense = (step < self._rampup_begin).to(torch.float32)
        update = v * torch.maximum(mask, dense)
        keep = 1.0 - mask
        velocity = dense * u + (1.0 - dense) * (u * keep)
        residual = (1.0 - dense) * (v * keep)
        return p32 - lr * update, {"velocity": velocity, "residual": residual}
