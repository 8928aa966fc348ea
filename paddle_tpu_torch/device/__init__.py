"""``paddle_tpu_torch.device`` namespace (port of ``paddle_tpu/device``;
reference: ``python/paddle/device/``).

The compile-target questions answer for this build: CUDA through torch
(``is_compiled_with_cuda`` is whether torch was built with CUDA), no TPU,
ROCm, XPU, IPU, CINN or custom device; the distributed stack is built in.
The device lists come from torch: ``["cpu"]`` / ``["cpu:0"]`` without a
card, as the JAX package answers on the CPU, and ``gpu`` / ``gpu:N`` for
each card.
"""

import torch

from ..framework.device import (  # noqa: F401
    Event,
    Stream,
    current_device,
    current_stream,
    device_count,
    get_device,
    is_compiled_with_tpu,
    set_device,
    stream_guard,
    synchronize,
)

__all__ = [
    "set_device", "get_device", "device_count", "synchronize", "current_device",
    "Event", "Stream", "current_stream", "stream_guard", "is_compiled_with_tpu",
]


def get_cudnn_version():
    """cuDNN's version as an int (reference ``get_cudnn_version``), None
    where torch has no cuDNN."""
    return torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    """True: the distributed stack (store, launcher, fleet) is built in."""
    return True


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


class _UnavailablePlace:
    _kind = "device"

    def __init__(self, *args, **kwargs):
        raise RuntimeError(
            f"{type(self).__name__} is unavailable: this build targets CUDA "
            f"and was not compiled with {self._kind} support")


class XPUPlace(_UnavailablePlace):
    _kind = "XPU"


class IPUPlace(_UnavailablePlace):
    _kind = "IPU"


def get_all_device_type():
    return ["cpu"] + (["gpu"] if device_count() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return ["cpu:0"] + [f"gpu:{i}" for i in range(device_count())]


def get_available_custom_device():
    return []


def set_stream(stream=None):
    """Make ``stream`` the current stream of its card (reference
    ``paddle.device.set_stream``) and return the previous one; on the CPU
    there is one stream, returned as it is."""
    prev = current_stream()
    if stream is not None and stream._cuda is not None:
        torch.cuda.set_stream(stream._cuda)
    return prev


from . import cuda  # noqa: E402,F401
from . import xpu  # noqa: E402,F401

__all__ += [
    "get_cudnn_version", "is_compiled_with_cuda", "is_compiled_with_rocm",
    "is_compiled_with_xpu", "is_compiled_with_ipu", "is_compiled_with_cinn",
    "is_compiled_with_distribute", "is_compiled_with_custom_device",
    "XPUPlace", "IPUPlace", "get_all_device_type",
    "get_all_custom_device_type", "get_available_device",
    "get_available_custom_device", "set_stream",
]
