"""Device selection (port of ``paddle_tpu/framework/device.py``).

Every entry point of the port takes an explicit ``device``; when none is
given, :func:`default_device` gives the device :func:`set_device` chose,
and before any choice ``"cuda"``.  A CUDA device without a usable card
raises: nothing falls back to the CPU unless the caller asked for it.
``set_device("cpu")`` is how a program asks for the CPU;
``set_device("gpu")`` / ``"gpu:1"`` / ``"cuda:1"`` pick a card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "set_device", "get_device", "device_count"]

_CURRENT: Optional[torch.device] = None


def _check(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: CUDA is not available; pass device='cpu' "
            "explicitly (or call set_device('cpu')) to run the plain PyTorch path on the CPU")
    return dev


def _parse(device: Union[str, torch.device]) -> torch.device:
    if isinstance(device, torch.device):
        return device
    name = str(device).lower()
    kind, _, idx = name.partition(":")
    if kind in ("gpu", "cuda"):
        return torch.device("cuda", int(idx)) if idx else torch.device("cuda")
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device(device)


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve an entry point's ``device`` argument: ``None`` means the
    device :func:`set_device` chose, else ``"cuda"``."""
    if device is None:
        return _check(_CURRENT if _CURRENT is not None else torch.device("cuda"))
    return _check(_parse(device))


def set_device(device: Union[str, torch.device, None]):
    """Choose the device that Tensors and entry points given no device use
    (``paddle.set_device``); ``None`` goes back to the card default.
    Returns the device."""
    global _CURRENT
    _CURRENT = None if device is None else _check(_parse(device))
    return _CURRENT


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``, as Paddle names them."""
    dev = default_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0

