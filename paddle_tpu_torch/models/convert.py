"""Weight exchange with ``paddle_tpu``, keyed by the JAX parameter names.

``paddle_tpu`` parameter names (``llama.layers.0.self_attn.qkv_proj``,
``lm_head``, ...) are exactly the port's ``named_parameters()`` names, and
both keep weights as ``[in, out]``, so the exchange is a checked copy.  The
persistent buffers go the same way, by name (BatchNorm's running ``_mean``
and ``_variance``): the exchanged names are the port's ``state_dict()``
keys, the JAX side's ``state_dict()`` keys.  Rope tables are
non-persistent buffers recomputed from the config, never copied.

The compiled-graph layer's state goes by the same names:
:func:`load_paddle_tpu_artifact` loads the weights file of a ``jit.save``
artifact of either package (``<prefix>.pdiparams``, the JAX layout
``{"params", "buffers"}``) into a model, and a static Program's state
(its recorded layers' parameters and buffers, by their names) goes to and
from numpy with :func:`to_paddle_tpu_program_state` /
:func:`load_paddle_tpu_program_state`.

The optimizer state of a training step goes the same way: ``{"step": n,
"slots": {param name: {"m": array, "v": array, ...}}}``, the layout of the
JAX ``TrainStep``'s ``_step`` and ``_opt_state`` as numpy, so two trainers
can start from one mid-run state.  The whole resumable state goes as the
flat ``TrainStep.state_dict`` layout (``param.*``, ``opt[...]``, ``step``,
``lr_sched.*``; :func:`load_paddle_tpu_train_state`,
:func:`to_paddle_tpu_train_state`).
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_tpu_params", "to_paddle_tpu_params",
           "load_paddle_tpu_opt_state", "to_paddle_tpu_opt_state",
           "load_paddle_tpu_train_state", "to_paddle_tpu_train_state",
           "load_paddle_tpu_artifact", "to_paddle_tpu_program_state",
           "load_paddle_tpu_program_state"]


def _exchanged(model: nn.Module) -> Tuple[Dict[str, torch.Tensor], Set[str]]:
    """Parameters and persistent buffers by name; the non-persistent
    buffers (recomputed, never copied) apart."""
    own = model.state_dict(keep_vars=True)
    recomputed = {n for n, _ in model.named_buffers()} - set(own)
    return own, recomputed


@torch.no_grad()
def load_paddle_tpu_params(model: nn.Module, params: Dict[str, np.ndarray]) -> None:
    """Copy ``params`` (name -> array, e.g. ``{n: np.asarray(t._data) for n, t
    in jax_model.state_dict().items()}``: parameters and persistent buffers)
    into ``model``, casting each to its tensor's dtype.  Missing, extra or
    mis-shaped entries raise; entries naming one of the model's
    non-persistent buffers are skipped."""
    own, recomputed = _exchanged(model)
    given = set(params) - recomputed
    missing = sorted(set(own) - given)
    extra = sorted(given - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in own.items():
        src = np.asarray(params[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
        p.copy_(torch.tensor(src, dtype=torch.float32).to(p.dtype))


@torch.no_grad()
def to_paddle_tpu_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse: name -> float32 numpy array (bf16 widened exactly), the
    parameters and the persistent buffers."""
    return {name: t.detach().to(device="cpu", dtype=torch.float32).numpy()
            for name, t in _exchanged(model)[0].items()}


@torch.no_grad()
def load_paddle_tpu_opt_state(train_step, state: Dict) -> None:
    """Copy ``state`` (``{"step": n, "slots": {name: {slot: array}}}``) into a
    ``jit.TrainStep``'s optimizer state and step counter.  Names and slots
    must match exactly; each array keeps the slot's dtype and device."""
    own = train_step._opt_state
    slots = state["slots"]
    if sorted(own) != sorted(slots):
        raise KeyError(f"parameter names differ: {sorted(set(own) ^ set(slots))}")
    for name, s in own.items():
        if sorted(s) != sorted(slots[name]):
            raise KeyError(f"{name}: slots {sorted(slots[name])} != {sorted(s)}")
        for k, t in s.items():
            src = np.asarray(slots[name][k])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(torch.tensor(src, dtype=torch.float32).to(t.dtype))
    train_step._step = int(state["step"])


@torch.no_grad()
def to_paddle_tpu_opt_state(train_step) -> Dict:
    """The inverse: the step counter and every slot as a float32 numpy array."""
    return {"step": int(train_step._step),
            "slots": {name: {k: t.detach().to(device="cpu", dtype=torch.float32).numpy()
                             for k, t in s.items()}
                      for name, s in train_step._opt_state.items()}}


def load_paddle_tpu_train_state(train_step, flat: Dict) -> None:
    """Load ``flat``, the JAX ``TrainStep.state_dict()`` as name -> array
    (``{k: np.asarray(v) for k, v in jax_step.state_dict().items()}``),
    into a ``jit.TrainStep``: parameters, optimizer slots, step counter
    and the scheduler's numeric fields, each array cast to its tensor's
    dtype.  The parameter and slot keys must match exactly."""
    own = train_step.state_dict()
    want = {k for k in own if not k.startswith("lr_sched.")}
    have = {k for k in flat if not k.startswith("lr_sched.")}
    if want != have:
        raise KeyError(f"state keys differ: missing {sorted(want - have)}, "
                       f"unexpected {sorted(have - want)}")
    train_step.set_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in flat.items()})


@torch.no_grad()
def to_paddle_tpu_train_state(train_step) -> Dict[str, np.ndarray]:
    """The inverse: ``train_step.state_dict()`` as name -> numpy array (bf16
    widened exactly to float32)."""
    return {k: (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).cpu().numpy()
            for k, t in train_step.state_dict().items()}


def load_paddle_tpu_artifact(model: nn.Module, prefix: str) -> None:
    """Load the weights of a ``jit.save`` artifact (``prefix.pdiparams``,
    written by either package) into ``model``, by name
    (:func:`load_paddle_tpu_params`)."""
    from ..framework.io import load

    state = load(prefix + ".pdiparams", return_numpy=True)
    load_paddle_tpu_params(model, {**state.get("params", {}), **state.get("buffers", {})})


def to_paddle_tpu_program_state(program) -> Dict[str, np.ndarray]:
    """A static Program's state (``Program.state_dict``: its recorded
    layers' parameters and buffers by name) as float32 numpy arrays."""
    return {k: np.asarray(v, np.float32) if np.asarray(v).dtype.kind == "f" else np.asarray(v)
            for k, v in program.state_dict().items()}


def load_paddle_tpu_program_state(program, state: Dict[str, np.ndarray]) -> None:
    """Copy ``state`` (name -> array, e.g. a JAX layer's ``state_dict()``
    under the names of the port layer it was carried into) into a static
    Program's state; names must match exactly."""
    own = program.state_dict()
    if set(own) != set(state):
        raise KeyError(f"state names differ: missing {sorted(set(own) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(own))}")
    for k, v in state.items():
        if tuple(np.shape(v)) != tuple(np.shape(own[k])):
            raise ValueError(f"{k}: shape {tuple(np.shape(v))} != {tuple(np.shape(own[k]))}")
    program.set_state_dict(state)
