"""The AMP cast rule and the NaN/Inf check (port of the two parts of
``paddle_tpu/framework/dispatch.py`` that are not the tape).

The JAX package casts every op's inputs inside ``apply_op`` under the op's
name.  The port has no such choke point: each op of the op namespace
(``ops/common.py``), each ``nn.functional`` op and each seam of the Llama
model that has a JAX ``apply_op`` name calls :func:`amp_cast` with that
name itself.  An op in neither list is cast only under O2, as in the JAX
package.  Outside ``amp.auto_cast`` :func:`amp_cast` returns its inputs.
The same places check their outputs under ``FLAGS_check_nan_inf``
(:func:`checked`, :func:`checked_op`), by the same names, and count them
under ``amp.debugging``'s operator statistics (``(op name, output dtype)``
-> calls, the JAX ``_bump_op_stats``).

The recording seam: while a fragment capture (``jit.subgraph``) or a
static Program (``static.graph``) records, :data:`tls` ``.recorder`` holds
its recorder, and the two entries every Paddle-level call passes through,
``framework.tensor.call_unwrapped`` (layers, models, ``nn.functional``,
the ``boundary`` entry points) and ``ops.common.apply`` (the op
namespace), hand the call to it instead of running it.  Outside a
recording the seam costs one attribute read a call.
"""

from __future__ import annotations

import functools
import threading

import torch

from . import flags

__all__ = ["amp_state", "amp_cast", "amp_target", "cast_to", "check_nan_inf", "checked",
           "checked_op", "shape_inference", "tls"]


class _TLS(threading.local):
    recorder = None       # the active fragment capture or static Program builder
    inferring = False     # a recording is inferring a call's shapes on meta tensors
    exporting = False     # torch.export traces: kernel entries are custom ops


def shape_inference(t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor of a recording's shape inference: a
    kernel entry then gives its plain version's shapes (it moves no data),
    where any other meta tensor is an unsupported device."""
    return tls.inferring and t.is_meta


tls = _TLS()

# amp.debugging's operator statistics: None = off; else (op name, output
# dtype) -> calls while a collection is active
op_stats = None


class _AmpState:
    enabled = False
    dtype = None
    level = "O1"
    white = frozenset()
    black = frozenset()


amp_state = _AmpState()


def amp_target(name: str):
    """The dtype op ``name`` casts its floating inputs to under the current
    ``auto_cast`` (None: no cast): black-listed ops fp32; under O2 every
    other op, under O1 the white-listed ones, the AMP dtype.  Matching is
    exact against the lists, as in the JAX package."""
    if not amp_state.enabled:
        return None
    if name in amp_state.black:
        return torch.float32
    if amp_state.level == "O2" or name in amp_state.white:
        return amp_state.dtype
    return None


def cast_to(target, datas: tuple) -> tuple:
    """``datas`` with their floating tensors cast to ``target`` (None: as
    they are)."""
    if target is None:
        return datas
    return tuple(d.to(target) if isinstance(d, torch.Tensor) and d.is_floating_point()
                 and d.dtype != target else d for d in datas)


def amp_cast(name: str, datas: tuple) -> tuple:
    """``datas`` with their floating tensors cast for op ``name`` under
    ``auto_cast`` (:func:`amp_target`); outside it ``datas`` itself."""
    if not amp_state.enabled:
        return datas
    return cast_to(amp_target(name), datas)


def check_nan_inf(name: str, arrays) -> None:
    """Raise ``FloatingPointError`` (print, at ``check_nan_inf_level`` > 0)
    when a floating output of op ``name`` holds a NaN or an Inf.  Outputs
    being captured into a CUDA graph, and meta tensors (a recording's shape
    inference), are not read, as the JAX package skips traced values."""
    for a in arrays:
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            continue
        if a.is_meta or (a.is_cuda and torch.cuda.is_current_stream_capturing()):
            continue          # no value: shape inference, or a graph being captured
        if not bool(torch.isfinite(a).all()):
            msg = f"NaN or Inf found in output of op '{name}'"
            if flags.get_flag("check_nan_inf_level") > 0:
                print("WARNING:", msg)
            else:
                raise FloatingPointError(msg)


def checked(name: str, out):
    """``out`` (a tensor, or a tuple or list of outputs), after the NaN/Inf
    check of op ``name`` when ``FLAGS_check_nan_inf`` is on, counted in the
    operator statistics when they are collected."""
    if flags.get_flag("check_nan_inf"):
        check_nan_inf(name, out if isinstance(out, (tuple, list)) else (out,))
    if op_stats is not None:
        bump_op_stats(name, out)
    return out


def bump_op_stats(name: str, out) -> None:
    """Count each tensor output of op ``name`` by its dtype's name."""
    for o in (out if isinstance(out, (tuple, list)) else (out,)):
        dt = getattr(o, "dtype", None)
        if isinstance(dt, torch.dtype):
            key = (name, str(dt).replace("torch.", ""))
            op_stats[key] = op_stats.get(key, 0) + 1


def checked_op(name: str, fn):
    """``fn`` with its outputs checked as op ``name`` (:func:`checked`)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return checked(name, fn(*args, **kwargs))

    return op
