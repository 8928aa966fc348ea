"""Runtime flags (port of ``paddle_tpu/framework/flags.py``).

One registry of typed flags, each settable through the environment
(``FLAGS_<name>``, read when the flag is defined), :func:`set_flags`, or
read with :func:`get_flag`.  Only the flags the port reads are defined here.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags"]

_LOCK = threading.RLock()


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _parse(raw: str, ty: type) -> Any:
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return ty(raw)


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Register a flag. Environment variable ``FLAGS_<name>`` overrides the default."""
    with _LOCK:
        ty = type(default)
        env = os.environ.get("FLAGS_" + name)
        value = _parse(env, ty) if env is not None else default
        _REGISTRY[name] = _Flag(name=name, default=default, type=ty, help=help, value=value)


def get_flags(names=None) -> Dict[str, Any]:
    """``{name: value}`` of ``names`` (one name, a list, or every flag)."""
    with _LOCK:
        if names is None:
            return {k: f.value for k, f in _REGISTRY.items()}
        if isinstance(names, str):
            names = [names]
        return {n: _REGISTRY[n[len("FLAGS_"):] if n.startswith("FLAGS_") else n].value
                for n in names}


def get_flag(name: str) -> Any:
    with _LOCK:
        return _REGISTRY[name].value


def set_flags(flags: Dict[str, Any]) -> None:
    with _LOCK:
        for name, value in flags.items():
            key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
            if key not in _REGISTRY:
                raise ValueError(f"unknown flag {name!r}")
            f = _REGISTRY[key]
            f.value = (_parse(value, f.type) if isinstance(value, str) and f.type is not str
                       else f.type(value))


define_flag("kernel_admission", False,
            "Refuse a registered CUDA kernel that fails the kernel verifier "
            "(analysis.kernel_lint: the static leg, and on a CUDA tensor the "
            "dynamic leg too) before its first launch")
define_flag("check_nan_inf", False,
            "Check every output of the op namespace, of nn.functional and of "
            "the Llama model's seams for NaN/Inf (raises FloatingPointError)")
define_flag("check_nan_inf_level", 0,
            "0 raises on a NaN/Inf found by check_nan_inf; > 0 prints a warning")
