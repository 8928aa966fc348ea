"""Dtypes (port of ``paddle_tpu/framework/dtype.py``).

The Paddle dtype names are ``torch.dtype`` objects here: ``paddle_tpu_torch
.float32 is torch.float32``, and a Tensor's ``dtype`` is its storage's
``torch.dtype``.  :func:`convert_dtype` takes a name (with the JAX
package's aliases, ``"bf16"``, ``"fp32"``, ...), a numpy dtype or a
``torch.dtype``.  ``uint32``, ``uint64`` and the float8 names exist only
where the installed torch has them.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["DTYPES", "to_dtype", "convert_dtype", "dtype_name", "get_default_dtype",
           "set_default_dtype"]

bool_ = torch.bool
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = getattr(torch, "uint16", None)
uint32 = getattr(torch, "uint32", None)
uint64 = getattr(torch, "uint64", None)
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = getattr(torch, "float8_e4m3fn", None)
float8_e5m2 = getattr(torch, "float8_e5m2", None)

_ALIASES = {
    "bool": bool_, "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}
_ALIASES = {k: v for k, v in _ALIASES.items() if v is not None}

# the names the port's modules have always taken (``to_dtype``)
DTYPES = {n: _ALIASES[n] for n in ("float64", "float32", "bfloat16", "float16", "int32",
                                   "int64")}


def convert_dtype(dtype) -> torch.dtype:
    """A user's dtype (name, numpy dtype, ``torch.dtype`` or a Python type)
    -> ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("paddle."):] if dtype.startswith("paddle.") else dtype
        if name not in _ALIASES:
            raise ValueError(f"unsupported dtype {dtype!r}; known: {sorted(_ALIASES)}")
        return _ALIASES[name]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _ALIASES[name]


def to_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``paddle_tpu`` dtype (``"bfloat16"``, a numpy dtype) -> ``torch.dtype``."""
    return convert_dtype(name)


def dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``, ... (numpy's names, the JAX package's)."""
    return str(convert_dtype(dtype)).replace("torch.", "")


_DEFAULT_DTYPE = torch.float32


def set_default_dtype(dtype) -> None:
    """The dtype floating creation ops take when none is given."""
    global _DEFAULT_DTYPE
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError("default dtype must be floating point")
    _DEFAULT_DTYPE = d


def get_default_dtype() -> str:
    return dtype_name(_DEFAULT_DTYPE)

