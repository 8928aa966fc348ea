"""Automatic mixed precision (port of ``paddle_tpu/amp/__init__.py``).

``auto_cast`` sets the cast rule of ``framework.dispatch`` with the JAX
package's op lists (not ``torch.autocast``'s, which differ): under O1 the
white-listed ops run in the AMP dtype and the black-listed ones in fp32,
under O2 every op but the black-listed ones in the AMP dtype.  Each op of
the op namespace, of ``nn.functional`` and each seam of the Llama model
casts its inputs under its JAX op name; the torch code inside a layer
between two such ops is not an op and casts nothing.  ``decorate`` (O2)
casts a model's parameters but its norms'.  :class:`GradScaler` is the
JAX package's dynamic loss scaling, enabled by default whatever the dtype
(bf16 needs no scaling, so ``GradScaler(enable=False)`` passes through).
"""

from __future__ import annotations

import contextlib

import torch

from ..framework import dispatch
from ..framework.dtype import convert_dtype, dtype_name
from ..framework.tensor import Tensor
from . import debugging  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "is_auto_cast_enabled",
           "is_bfloat16_supported", "is_float16_supported", "get_amp_dtype",
           "FP16_WHITE_LIST", "FP16_BLACK_LIST"]

# ops cast TO low precision under O1 (matmul-like, conv)
FP16_WHITE_LIST = {"matmul", "linear", "bmm", "mv", "conv", "einsum"}
# ops kept in fp32 under O1 (numerically sensitive)
FP16_BLACK_LIST = {
    "exp", "square", "square_error_cost", "log", "mean", "sum", "cosine_similarity",
    "softmax", "log_softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits", "cross_entropy",
    "c_softmax_with_cross_entropy", "layer_norm", "group_norm", "batch_norm", "rms_norm",
}


def is_auto_cast_enabled() -> bool:
    return dispatch.amp_state.enabled


def get_amp_dtype() -> str:
    dt = dispatch.amp_state.dtype
    return "bfloat16" if dt is None else dtype_name(dt)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None, custom_black_list=None,
              level: str = "O1", dtype: str = "bfloat16", use_promote: bool = True):
    """O1: the white-listed ops run in ``dtype``, the black-listed in fp32;
    O2: every op but the black-listed in ``dtype``."""
    st = dispatch.amp_state
    prev = (st.enabled, st.dtype, st.level, st.white, st.black)
    st.enabled = enable
    st.dtype = convert_dtype(dtype) if enable else None
    st.level = level
    st.white = frozenset(FP16_WHITE_LIST | set(custom_white_list or ()))
    st.black = frozenset(FP16_BLACK_LIST | set(custom_black_list or ()))
    try:
        yield
    finally:
        st.enabled, st.dtype, st.level, st.white, st.black = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None, master_grad=False, excluded_layers=None):
    """O2: cast every floating parameter and buffer to ``dtype`` in place,
    but those of norm layers and of ``excluded_layers`` (the optimizers
    keep fp32 masters of low-precision parameters)."""
    from ..nn.norm import LayerNorm, _BatchNormBase

    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        target = convert_dtype(dtype)
        ex = excluded_layers if isinstance(excluded_layers, (list, tuple)) else (
            [excluded_layers] if excluded_layers is not None else [])
        ex_types = tuple(e for e in ex if isinstance(e, type))
        ex_ids = {id(e) for e in ex if isinstance(e, torch.nn.Module)}
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, (_BatchNormBase, LayerNorm) + ex_types) or \
                        id(layer) in ex_ids:
                    continue
                for t in list(layer._parameters.values()) + list(layer._buffers.values()):
                    if t is not None and t.is_floating_point():
                        t.data = t.data.to(target)
    if optimizers is None:
        return model_list[0] if single else model_list
    return (model_list[0] if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (the JAX package's, reference
    ``python/paddle/amp/grad_scaler.py:657``).  ``unscale_`` divides every
    gradient of the optimizer's parameters by the scale and notes an inf or
    NaN among them (one host read); ``step`` skips the update then;
    ``update`` halves the scale after ``decr_every_n_nan_or_inf`` bad steps
    and doubles it after ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states: dict = {}  # id(optimizer) -> ("UNSCALED" | "STEPPED", found)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer))
        if state is not None and state[0] == "UNSCALED":
            raise RuntimeError("unscale_() has already been called on this optimizer this step")
        if state is not None and state[0] == "STEPPED":
            raise RuntimeError("unscale_() is being called after step()")
        finite = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad = p.grad / self._scale
                finite.append(torch.isfinite(p.grad).all())
        found = bool(finite) and not bool(torch.stack(finite).all())
        self._found_inf = found
        self._opt_states[id(optimizer)] = ("UNSCALED", found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer))
        if state is not None and state[0] == "STEPPED":
            raise RuntimeError("step() has already been called on this optimizer this iteration")
        if state is None or state[0] != "UNSCALED":
            self.unscale_(optimizer)
        found = self._opt_states[id(optimizer)][1]
        if not found:
            optimizer.step()
        self._opt_states[id(optimizer)] = ("STEPPED", found)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        any_inf = self._found_inf or any(f for _, f in self._opt_states.values())
        self._found_inf = any_inf
        self._opt_states.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def is_bfloat16_supported(device=None) -> bool:
    """bf16 on the CPU and on any card from Ampere on."""
    if torch.cuda.is_available() and (device is None or "cpu" not in str(device)):
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None) -> bool:
    return True

