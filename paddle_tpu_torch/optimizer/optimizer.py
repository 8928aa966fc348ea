"""Optimizer base and Adam / AdamW (port of ``paddle_tpu/optimizer/optimizer.py``).

As in the JAX package each optimizer has a per-leaf update, used by the
eager :meth:`Optimizer.step` and by :meth:`Optimizer.functional`, the
update ``jit.TrainStep`` runs.  Adam and AdamW route every leaf through
``kernels.adamw.adamw_update`` (the JAX package's fused path): the
hand-written kernel on a CUDA tensor, ``adamw_reference`` on a CPU one.
fp32 math throughout; a parameter stored in a lower precision keeps an
fp32 ``master`` copy in its state (``multi_precision``).

PyTorch idiom where JAX had immutable arrays: the update writes parameters
and state in place (``functional()``'s update returns the same tensors).

Weight decay as in the JAX package: the eager ``step()`` honours a
parameter's ``no_weight_decay`` attribute; the functional update decays
every leaf, norms included.

The other optimizers of the JAX package (SGD, Momentum, Lamb, ...) and
ZeRO-1 ``shard_update`` come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.adamw import adamw_update
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:  # L2Decay object
            self._weight_decay = float(getattr(weight_decay, "_coeff",
                                               getattr(weight_decay, "coeff", 0.0)))
        self._step_count = 0
        self._state: Optional[list] = None

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def shard_update(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: ZeRO-1 shard_update comes with the "
                                  "distributed slice")

    # -- per-leaf core (override in subclasses) --------------------------------
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _decoupled_decay(self) -> bool:
        return False  # AdamW overrides

    def _fused_leaf(self, p32, g32, slots, lr, step, apply_decay, out_dtype):
        """Update one leaf's fp32 value and slots in place; returns
        ``(p32_new, slots_new, p_out)`` with ``p_out`` in ``out_dtype``."""
        raise NotImplementedError

    def _new_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        slots = self._init_slots(p)
        if self._multi_precision and p.is_floating_point() and p.dtype != torch.float32:
            slots["master"] = p.detach().to(torch.float32)
        return slots

    @torch.no_grad()
    def _update_leaf(self, p, g, s, lr, step, apply_decay):
        """Update parameter ``p`` and its state dict ``s`` in place from the
        gradient ``g``."""
        p32 = s.get("master", p.detach() if p.dtype == torch.float32
                    else p.detach().to(torch.float32))
        g32 = g if g.dtype == torch.float32 else g.to(torch.float32)
        slots = {k: v for k, v in s.items() if k != "master"}
        p32_new, slots_new, p_out = self._fused_leaf(p32, g32, slots, lr, step, apply_decay,
                                                     p.dtype)
        if "master" in s:
            slots_new["master"] = p32_new
        s.update(slots_new)
        if p_out.data_ptr() != p.data_ptr():
            p.copy_(p_out)

    # -- state ----------------------------------------------------------------
    def _ensure_state(self):
        if self._state is None:
            self._state = [self._new_slots(p) for p in self._parameter_list]

    # -- eager step ------------------------------------------------------------
    def step(self):
        self._ensure_state()
        grads = [p.grad for p in self._parameter_list]
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(self._parameter_list, grads)))]
        self._step_count += 1
        lr = self.get_lr()
        for p, g, s in zip(self._parameter_list, grads, self._state):
            if g is not None:
                self._update_leaf(p, g, s, lr, self._step_count,
                                  not getattr(p, "no_weight_decay", False))

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- serialization ---------------------------------------------------------
    def state_dict(self) -> dict:
        self._ensure_state()
        out = {"step": self._step_count,
               "slots": [{k: v.detach().cpu().numpy() for k, v in s.items()}
                         for s in self._state]}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state: dict):
        self._step_count = state.get("step", 0)
        slots = state.get("slots")
        if slots is not None:
            self._state = [{k: torch.as_tensor(np.asarray(v), device=p.device).clone()
                            for k, v in s.items()}
                           for p, s in zip(self._parameter_list, slots)]
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])

    # -- functional interface for TrainStep ------------------------------------
    def functional(self):
        """``(init_fn, update_fn)`` over dicts of tensors keyed by parameter
        name, for ``jit.TrainStep``.

        ``init_fn(params) -> state``; ``update_fn(params, grads, state, lr,
        step) -> (params, state)`` updates both in place and returns them.
        Every leaf is decayed (the JAX functional path's policy)."""
        def init_fn(params):
            return {n: self._new_slots(p) for n, p in params.items()}

        def update_fn(params, grads, state, lr, step):
            for n, p in params.items():
                g = grads.get(n)
                if g is not None:
                    self._update_leaf(p, g, state[n], lr, step, True)
            return params, state

        return init_fn, update_fn


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-08,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=True, use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots(self, p):
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _fused_leaf(self, p32, g32, slots, lr, step, apply_decay, out_dtype):
        p_new, m, v, p_out = adamw_update(
            p32, g32, slots["m"], slots["v"], lr, step, beta1=self._beta1,
            beta2=self._beta2, epsilon=self._epsilon, weight_decay=self._weight_decay,
            decoupled=self._decoupled_decay(), apply_decay=apply_decay, out_dtype=out_dtype)
        return p_new, {"m": m, "v": v}, p_out


class AdamW(Adam):
    """Decoupled weight decay (reference ``python/paddle/optimizer/adamw.py``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-08,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=True, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("paddle_tpu_torch: lr_ratio and apply_decay_param_fun "
                                      "come later; set p.no_weight_decay = True instead")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name=name)

    def _decoupled_decay(self):
        return True
