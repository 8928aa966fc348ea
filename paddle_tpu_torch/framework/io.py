"""``save`` / ``load`` (port of ``paddle_tpu/framework/io.py``).

The JAX package's format: a pickle of the object with every Tensor as a
``_TensorPayload`` of its numpy array, whether it was a Parameter, its
name and its ``stop_gradient``.  The port writes the same, its own payload
class (a bfloat16 array widened to float32, its dtype kept by name), and
:func:`load` reads either side's files: an unpickler maps the JAX
package's payload class onto the port's by name, without importing it.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from .tensor import Parameter, Tensor

__all__ = ["save", "load"]


class _TensorPayload:
    def __init__(self, array: np.ndarray, is_param: bool, name: str, stop_gradient: bool,
                 dtype: str = None):
        self.array = array
        self.is_param = is_param
        self.name = name
        self.stop_gradient = stop_gradient
        self.dtype = dtype


def _pack(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        t = obj if isinstance(obj, Tensor) else Tensor._wrap(obj)
        return _TensorPayload(t.numpy(), isinstance(obj, (Parameter, torch.nn.Parameter)),
                              getattr(obj, "name", "") or "", t.stop_gradient,
                              str(t.dtype).replace("torch.", ""))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _array_dtype(payload) -> str:
    """The payload's dtype name: the port's own field, else the array's
    (a JAX file's bfloat16 array is ``ml_dtypes``' bfloat16)."""
    return getattr(payload, "dtype", None) or np.asarray(payload.array).dtype.name


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        dtype = _array_dtype(obj)
        arr = np.asarray(obj.array)
        if arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
            arr = arr.astype(np.float32)     # torch takes no ml_dtypes array
        if obj.is_param:
            p = Parameter(arr, dtype=dtype, name=obj.name)
            p.stop_gradient = obj.stop_gradient
            return p
        t = Tensor(arr, dtype=dtype, stop_gradient=obj.stop_gradient)
        t.name = obj.name
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module in ("paddle_tpu.framework.io", __name__):
            return _TensorPayload
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """The object :func:`save` (or ``paddle_tpu.save``) wrote, Tensors on the
    current device; ``return_numpy`` gives their arrays instead."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy)
