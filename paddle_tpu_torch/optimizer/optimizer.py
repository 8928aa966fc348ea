"""Optimizer base and the standard family (port of
``paddle_tpu/optimizer/optimizer.py``).

As in the JAX package each optimizer has a per-leaf functional core
(``_init_slots`` / ``_update``), used by the eager :meth:`Optimizer.step`
and by :meth:`Optimizer.functional`, the update ``jit.TrainStep`` runs.
Adam and AdamW gather every leaf of a step into ONE call of
``kernels.adamw.adamw_update_leaves`` (the JAX package's fused path): one
launch of the hand-written multi-tensor kernel on CUDA tensors,
``adamw_reference`` a leaf on CPU ones.  The others (and NAdam and RAdam,
which override Adam's math, as in the JAX package) run their ``_update``
expression for expression in plain torch ops, as the JAX package leaves
them to XLA.  fp32 math throughout; a parameter stored in a lower
precision keeps an fp32 ``master`` copy in its state
(``multi_precision``), and a bf16 parameter is the kernel's bf16 copy
written in the same pass.

PyTorch idiom where JAX had immutable arrays: the update writes parameters
and state in place (``functional()``'s update returns the same tensors),
so the kernel's launch table, built once, stays valid.

Weight decay as in the JAX package: the eager ``step()`` honours a
parameter's ``no_weight_decay`` attribute (``AdamW``'s
``apply_decay_param_fun`` sets it); the functional update decays every
leaf, norms included.  ``parameters`` may be a model's
``named_parameters()``: the names are what ``apply_decay_param_fun`` is
asked about (the JAX package asks ``Parameter.name``).

ZeRO-1 ``shard_update`` comes with the distributed slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.tensor import Tensor
from ..kernels.adamw import adamw_update_leaves
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb", "NAdam", "RAdam", "ASGD", "Rprop", "LBFGS"]


def _named(parameters):
    """``(names, params)`` of Parameters or ``(name, Parameter)`` pairs; a
    bare Parameter's name is its ``name`` attribute, or ""."""
    names, params = [], []
    for item in parameters:
        if isinstance(item, tuple) and len(item) == 2 and isinstance(item[0], str):
            names.append(item[0])
            params.append(item[1])
        else:
            names.append(getattr(item, "name", "") or "")
            params.append(item)
    # a Parameter of the eager API is updated through its storage
    return names, [p._data if isinstance(p, Tensor) else p for p in params]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        if parameters is None:
            from ..static.graph import current_builder

            if current_builder() is None:
                raise ValueError("parameters must be provided (eager mode, like the reference)")
            # static mode: minimize(loss) trains the Program's parameters
            parameters = []
        self._param_names, self._parameter_list = _named(parameters)
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
        self._state: Optional[List[Dict[str, torch.Tensor]]] = None
        self._tables: dict = {}          # eager | functional -> LeafTable

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    def shard_update(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: ZeRO-1 shard_update comes with the "
                                  "distributed slice")

    # -- functional core (override in subclasses) -----------------------------
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p32, g32, slots, lr, step):
        """Return ``(new_p32, new_slots)``: tensors in, tensors out, as the
        JAX ``_update``; ``lr`` is an fp32 and ``step`` an int32 0-d tensor
        on the leaf's device."""
        raise NotImplementedError

    def _decoupled_decay(self) -> bool:
        return False  # AdamW overrides

    def _fused_slots(self, slots) -> bool:
        """Whether a leaf with these slots goes through the multi-tensor
        kernel (Adam and AdamW override)."""
        return False

    def _new_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        slots = self._init_slots(p)
        if self._multi_precision and p.is_floating_point() and p.dtype != torch.float32:
            slots["master"] = p.detach().to(torch.float32)
        return slots

    # -- the update of a step ---------------------------------------------------
    @torch.no_grad()
    def _apply(self, leaves, lr, step, site: str):
        """Update every ``(p, g, s, apply_decay)`` of ``leaves`` in place:
        the Adam family's leaves in one call, the others one by one.  The
        kernel reads each leaf's gradient in its own dtype, so a step whose
        gradients mix bf16 and fp32 (a bf16 model's fp32 MoE router) is
        one call too, with no widened copy.  The kernel updates an fp32
        parameter in place, or an fp32 master (or, without one, an fp32
        working copy) and writes the parameter as its copy; on CUDA tensors
        the wrapper raises for what it cannot take (a copy other than bf16,
        a non-contiguous leaf)."""
        rows = []
        for p, g, s, apply in leaves:
            if not self._fused_slots(s):
                self._plain_leaf(p, g, s, lr, step, apply)
                continue
            master = s.get("master")
            if master is not None:
                p32, out = master, p
            elif p.dtype == torch.float32:
                p32, out = p, None
            else:
                p32, out = p.detach().to(torch.float32), p
            if g.dtype not in (torch.float32, torch.bfloat16):
                g = g.to(torch.float32)
            g = g if g.is_contiguous() else g.contiguous()
            rows.append((p32, g, s["m"], s["v"], out, apply))
        if rows:
            p32, g, m, v, outs, apply = (list(c) for c in zip(*rows))
            self._tables[site] = adamw_update_leaves(
                p32, g, m, v, outs, lr, step, beta1=self._beta1, beta2=self._beta2,
                epsilon=self._epsilon, weight_decay=self._weight_decay,
                decoupled=self._decoupled_decay(), apply_decay=apply,
                table=self._tables.get(site))

    def _plain_leaf(self, p, g, s, lr, step, apply_decay):
        """One leaf through ``_update`` (the JAX update's XLA expressions,
        weight decay first), written back in place."""
        dev = p.device
        master = s.get("master")
        p32 = master if master is not None else (
            p.detach() if p.dtype == torch.float32 else p.detach().to(torch.float32))
        g32 = g.to(torch.float32)
        lr_t = torch.full((), float(torch.tensor(float(lr), dtype=torch.float32)),
                          dtype=torch.float32, device=dev)
        step_t = torch.full((), int(step), dtype=torch.int32, device=dev)
        wd, decoupled = self._weight_decay, self._decoupled_decay()
        if wd and not decoupled and apply_decay:
            g32 = g32 + wd * p32
        if wd and decoupled and apply_decay:
            p32 = p32 * (1.0 - lr_t * wd)
        slots = {k: v for k, v in s.items() if k != "master"}
        p_new, slots_new = self._update(p32, g32, slots, lr_t, step_t)
        for k, val in slots_new.items():
            if s[k] is not val:
                s[k].copy_(val)
        if master is not None:
            master.copy_(p_new)
        p.copy_(p_new)

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
        leaves = [(p, g, s, not getattr(p, "no_weight_decay", False))
                  for p, g, s in zip(self._parameter_list, grads, self._state) if g is not None]
        self._apply(leaves, self.get_lr(), self._step_count, "eager")

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        from ..static.graph import current_builder

        builder = current_builder()
        if builder is not None:
            # static mode: attach the training directive to the Program;
            # Executor.run then takes the step over its parameters
            builder.set_optimizer(self, loss)
            return None, None
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

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
        """Load :meth:`state_dict`'s layout; slots that exist already are
        overwritten in place."""
        self._step_count = state.get("step", 0)
        slots = state.get("slots")
        if slots is not None:
            self._ensure_state()
            new = []
            for p, cur, src in zip(self._parameter_list, self._state, slots):
                row = {}
                for k, v in src.items():
                    t = torch.as_tensor(np.asarray(v))
                    if k in cur and cur[k].shape == t.shape:
                        row[k] = cur[k].copy_(t)
                    else:
                        row[k] = t.to(p.device).clone()
                new.append(row)
            self._state = new
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
            leaves = [(p, grads[n], state[n], True) for n, p in params.items()
                      if grads.get(n) is not None]
            self._apply(leaves, lr, step, "functional")
            return params, state

        return init_fn, update_fn


def _loss(x) -> float:
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)

    def _update(self, p32, g32, slots, lr, step):
        return p32 - lr * g32, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, p32, g32, slots, lr, step):
        v = self._momentum * slots["velocity"] + g32
        if self._nesterov:
            p_new = p32 - lr * (g32 + self._momentum * v)
        else:
            p_new = p32 - lr * v
        return p_new, {"velocity": v}


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
        return {"m": _zeros(p), "v": _zeros(p)}

    def _update(self, p32, g32, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["m"] + (1 - b1) * g32
        v = b2 * slots["v"] + (1 - b2) * torch.square(g32)
        t = step.to(torch.float32)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        p_new = p32 - lr * m_hat / (torch.sqrt(v_hat) + eps)
        return p_new, {"m": m, "v": v}

    def _fused_slots(self, slots):
        # NAdam / RAdam override the math: no fused kernel (the JAX rule)
        return type(self)._update is Adam._update and set(slots) - {"master"} == {"m", "v"}


class AdamW(Adam):
    """Decoupled weight decay (reference ``python/paddle/optimizer/adamw.py``).

    ``apply_decay_param_fun(name)`` False marks the parameter
    ``no_weight_decay`` (honoured by the eager ``step()``), as the JAX
    package does; ``lr_ratio`` is accepted and, as there, not applied."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-08,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name=name)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun
        if apply_decay_param_fun is not None:
            for n, p in zip(self._param_names, self._parameter_list):
                if not apply_decay_param_fun(n):
                    p.no_weight_decay = True

    def _decoupled_decay(self):
        return True


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, initial_accumulator_value=0.0,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full(p.shape, float(self._init_acc), dtype=torch.float32,
                                     device=p.device)}

    def _update(self, p32, g32, slots, lr, step):
        mom = slots["moment"] + torch.square(g32)
        p_new = p32 - lr * g32 / (torch.sqrt(mom) + self._epsilon)
        return p_new, {"moment": mom}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slots(self, p):
        s = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _update(self, p32, g32, slots, lr, step):
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * torch.square(g32)
        out = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g32
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
            out["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * slots["momentum"] + lr * g32 / denom
        out["momentum"] = mom
        return p32 - mom, out


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_slots(self, p):
        return {"avg_sq_grad": _zeros(p), "avg_sq_update": _zeros(p)}

    def _update(self, p32, g32, slots, lr, step):
        rho, eps = self._rho, self._epsilon
        asg = rho * slots["avg_sq_grad"] + (1 - rho) * torch.square(g32)
        update = g32 * torch.sqrt(slots["avg_sq_update"] + eps) / torch.sqrt(asg + eps)
        asu = rho * slots["avg_sq_update"] + (1 - rho) * torch.square(update)
        return p32 - lr * update, {"avg_sq_grad": asg, "avg_sq_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-08,
                 parameters=None, weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"m": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, p32, g32, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["m"] + (1 - b1) * g32
        u = torch.maximum(b2 * slots["inf_norm"], torch.abs(g32))
        t = step.to(torch.float32)
        p_new = p32 - lr / (1 - b1 ** t) * m / (u + eps)
        return p_new, {"m": m, "inf_norm": u}


class Lamb(Optimizer):
    """LAMB; ``exclude_from_weight_decay_fn`` is accepted and, as in the JAX
    package, not applied."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-06, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        return {"m": _zeros(p), "v": _zeros(p)}

    def _update(self, p32, g32, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["m"] + (1 - b1) * g32
        v = b2 * slots["v"] + (1 - b2) * torch.square(g32)
        t = step.to(torch.float32)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        r = m_hat / (torch.sqrt(v_hat) + eps) + self._lamb_wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p32 - lr * trust * r, {"m": m, "v": v}


class NAdam(Adam):
    def _update(self, p32, g32, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["m"] + (1 - b1) * g32
        v = b2 * slots["v"] + (1 - b2) * torch.square(g32)
        t = step.to(torch.float32)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        m_bar = b1 * m_hat + (1 - b1) * g32 / (1 - b1 ** t)
        return p32 - lr * m_bar / (torch.sqrt(v_hat) + eps), {"m": m, "v": v}


class RAdam(Adam):
    def _update(self, p32, g32, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["m"] + (1 - b1) * g32
        v = b2 * slots["v"] + (1 - b2) * torch.square(g32)
        t = step.to(torch.float32)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * (b2 ** t) / (1 - b2 ** t)
        m_hat = m / (1 - b1 ** t)
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
        v_hat = torch.sqrt(v / (1 - b2 ** t))
        rect = p32 - lr * r * m_hat / (v_hat + eps)
        p_new = torch.where(rho_t > 5.0, rect, p32 - lr * m_hat)
        return p_new, {"m": m, "v": v}


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision,
                         name)

    def _update(self, p32, g32, slots, lr, step):
        return p32 - lr * g32, slots


class Rprop(Optimizer):
    """Resilient backpropagation (reference ``optimizer/rprop.py``):
    per-weight step sizes grown/shrunk by the sign agreement of successive
    gradients; only the gradient SIGN is used."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_slots(self, p):
        lr = self._learning_rate if isinstance(self._learning_rate, (int, float)) else 0.001
        return {"prev_grad": _zeros(p),
                "step_size": torch.full(p.shape, float(lr), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p32, g32, slots, lr, step):
        sign = torch.sign(g32 * slots["prev_grad"])
        one = torch.ones_like(sign)
        scale = torch.where(sign > 0, self._eta_pos * one,
                            torch.where(sign < 0, self._eta_neg * one, one))
        step_size = torch.clamp(slots["step_size"] * scale, self._lr_min, self._lr_max)
        # on sign flip: no move this step, zero the stored grad (classic Rprop-)
        g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
        p_new = p32 - step_size * torch.sign(g_eff)
        return p_new, {"prev_grad": g_eff, "step_size": step_size}


class LBFGS(Optimizer):
    """Limited-memory BFGS with a backtracking (Armijo) line search
    (reference ``optimizer/lbfgs.py``; torch-style closure API).

    Host-driven, as in the JAX package: ``opt.step(closure)``, where
    ``closure()`` recomputes the loss and its gradients (``backward()``);
    the search runs in float64 numpy over the flattened parameters."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, name=None):
        super().__init__(learning_rate, parameters, None, None, True, name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s: list = []
        self._y: list = []

    def _flat_params(self):
        return np.concatenate([p.detach().cpu().to(torch.float32).numpy().ravel()
                               for p in self._parameter_list])

    def _flat_grads(self):
        return np.concatenate([
            (p.grad.detach().cpu().to(torch.float32).numpy().ravel() if p.grad is not None
             else np.zeros(p.numel(), np.float32))
            for p in self._parameter_list])

    @torch.no_grad()
    def _assign(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(torch.from_numpy(np.ascontiguousarray(flat[off:off + n])).reshape(p.shape))
            off += n

    def _direction(self, g):
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / max(float(y @ s), 1e-10)
            a = rho * (s @ q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            q *= float(s_last @ y_last) / max(float(y_last @ y_last), 1e-10)
        for a, rho, s, y in reversed(alphas):
            b = rho * (y @ q)
            q += s * (a - b)
        return -q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step needs a closure re-evaluating the loss")
        f = _loss(closure())
        g = self._flat_grads().astype(np.float64)
        x = self._flat_params().astype(np.float64)
        lr = float(self.get_lr())

        for _ in range(self._max_iter):
            if np.max(np.abs(g)) <= self._tol_grad:
                break
            d = self._direction(g)
            # backtracking Armijo line search (strong-Wolfe optional)
            t = lr
            gtd = float(g @ d)
            if gtd > -1e-16:  # not a descent direction: reset memory
                self._s.clear()
                self._y.clear()
                d = -g
                gtd = float(g @ d)
            ok = False
            for _ls in range(20):
                self._assign((x + t * d).astype(np.float32))
                self.clear_grad()
                f_new = _loss(closure())
                if f_new <= f + 1e-4 * t * gtd:
                    ok = True
                    break
                t *= 0.5
            if not ok:
                self._assign(x.astype(np.float32))
                break
            g_new = self._flat_grads().astype(np.float64)
            x_new = x + t * d
            self._s.append(x_new - x)
            self._y.append(g_new - g)
            if len(self._s) > self._history:
                self._s.pop(0)
                self._y.pop(0)
            if np.max(np.abs(x_new - x)) <= self._tol_change:
                x, g, f = x_new, g_new, f_new
                break
            x, g, f = x_new, g_new, f_new
        self._assign(x.astype(np.float32))
        self.clear_grad()
        self._step_count += 1
        return f
