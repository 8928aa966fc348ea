"""``paddle.device.cuda`` surface (port of ``paddle_tpu/device/cuda.py``;
reference: ``python/paddle/device/cuda/__init__.py``).

On a card every query is ``torch.cuda``'s.  Where ``torch.cuda.is_available()``
is false it answers as the JAX package does on its CUDA-less build: 0
devices, 0 bytes, and the property queries and ``synchronize`` raise.
"""

from __future__ import annotations

import torch

from ..framework.device import Event, Stream, current_stream, device_count, stream_guard  # noqa: F401

__all__ = [
    "Stream", "Event", "current_stream", "synchronize", "device_count",
    "empty_cache", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "stream_guard",
    "get_device_properties", "get_device_name", "get_device_capability",
]


def _card(device):
    """``device`` (None, an index, ``"gpu:N"`` / ``"cuda:N"`` or a
    ``torch.device``) as a torch CUDA device."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, torch.device):
        return device
    _, _, idx = str(device).partition(":")
    return torch.device("cuda", int(idx) if idx else torch.cuda.current_device())


def _no_cuda(name):
    raise RuntimeError(f"paddle.device.cuda.{name}: CUDA is not available")


def synchronize(device=None):
    if not torch.cuda.is_available():
        _no_cuda("synchronize")
    torch.cuda.synchronize(_card(device))


def empty_cache() -> None:
    """Return the caching allocator's unused blocks to the card (a no-op
    without one)."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _counter(fn, device) -> int:
    return int(fn(_card(device))) if torch.cuda.is_available() else 0


def max_memory_allocated(device=None) -> int:
    return _counter(torch.cuda.max_memory_allocated, device)


def max_memory_reserved(device=None) -> int:
    return _counter(torch.cuda.max_memory_reserved, device)


def memory_allocated(device=None) -> int:
    return _counter(torch.cuda.memory_allocated, device)


def memory_reserved(device=None) -> int:
    return _counter(torch.cuda.memory_reserved, device)


def get_device_properties(device=None):
    if not torch.cuda.is_available():
        _no_cuda("get_device_properties")
    return torch.cuda.get_device_properties(_card(device))


def get_device_name(device=None):
    if not torch.cuda.is_available():
        _no_cuda("get_device_name")
    return torch.cuda.get_device_name(_card(device))


def get_device_capability(device=None):
    if not torch.cuda.is_available():
        _no_cuda("get_device_capability")
    return torch.cuda.get_device_capability(_card(device))
