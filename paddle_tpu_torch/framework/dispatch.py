"""The AMP cast rule and the NaN/Inf check (port of the two parts of
``paddle_tpu/framework/dispatch.py`` that are not the tape).

The JAX package casts every op's inputs inside ``apply_op`` under the op's
name.  The port has no such choke point: each op of the op namespace
(``ops/common.py``), each ``nn.functional`` op and each seam of the Llama
model that has a JAX ``apply_op`` name calls :func:`amp_cast` with that
name itself.  An op in neither list is cast only under O2, as in the JAX
package.  Outside ``amp.auto_cast`` :func:`amp_cast` returns its inputs.
The same places check their outputs under ``FLAGS_check_nan_inf``
(:func:`checked`, :func:`checked_op`), by the same names.
"""

from __future__ import annotations

import functools

import torch

from . import flags

__all__ = ["amp_state", "amp_cast", "check_nan_inf", "checked", "checked_op"]


class _AmpState:
    enabled = False
    dtype = None
    level = "O1"
    white = frozenset()
    black = frozenset()


amp_state = _AmpState()


def amp_cast(name: str, datas: tuple) -> tuple:
    """``datas`` with their floating tensors cast for op ``name`` under
    ``auto_cast``: black-listed ops to fp32; under O2 every other op, under
    O1 the white-listed ones, to the AMP dtype.  Matching is exact against
    the lists, as in the JAX package."""
    if not amp_state.enabled:
        return datas
    if name in amp_state.black:
        target = torch.float32
    elif amp_state.level == "O2" or name in amp_state.white:
        target = amp_state.dtype
    else:
        return datas
    return tuple(d.to(target) if isinstance(d, torch.Tensor) and d.is_floating_point()
                 and d.dtype != target else d for d in datas)


def check_nan_inf(name: str, arrays) -> None:
    """Raise ``FloatingPointError`` (print, at ``check_nan_inf_level`` > 0)
    when a floating output of op ``name`` holds a NaN or an Inf.  Outputs
    being captured into a CUDA graph are not read, as the JAX package skips
    traced values."""
    for a in arrays:
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            continue
        if a.is_cuda and torch.cuda.is_current_stream_capturing():
            continue
        if not bool(torch.isfinite(a).all()):
            msg = f"NaN or Inf found in output of op '{name}'"
            if flags.get_flag("check_nan_inf_level") > 0:
                print("WARNING:", msg)
            else:
                raise FloatingPointError(msg)


def checked(name: str, out):
    """``out`` (a tensor, or a tuple or list of outputs), after the NaN/Inf
    check of op ``name`` when ``FLAGS_check_nan_inf`` is on."""
    if flags.get_flag("check_nan_inf"):
        check_nan_inf(name, out if isinstance(out, (tuple, list)) else (out,))
    return out


def checked_op(name: str, fn):
    """``fn`` with its outputs checked as op ``name`` (:func:`checked`)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return checked(name, fn(*args, **kwargs))

    return op
