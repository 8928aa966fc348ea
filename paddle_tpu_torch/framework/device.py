"""Device selection (port of ``paddle_tpu/framework/device.py``).

Every entry point of the port takes an explicit ``device``; when none is
given, :func:`default_device` gives the device :func:`set_device` chose,
and before any choice ``"cuda"``.  A CUDA device without a usable card
raises: nothing falls back to the CPU unless the caller asked for it.
``set_device("cpu")`` is how a program asks for the CPU;
``set_device("gpu")`` / ``"gpu:1"`` / ``"cuda:1"`` pick a card.

The stream surface (``synchronize``, ``Event``, ``Stream``,
``current_stream``, ``stream_guard``) is ``torch.cuda``'s on a card.  On a
device the caller set to ``"cpu"`` it is the JAX package's host shims: an
event is a timestamp taken after a barrier, and there is one stream (the
CPU runs each op to its end before the next).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Union

import torch

__all__ = ["default_device", "set_device", "get_device", "device_count", "current_device",
           "synchronize", "Event", "Stream", "current_stream", "stream_guard",
           "is_compiled_with_tpu"]

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



def current_device() -> torch.device:
    """The device entry points given no device use (raises without a card
    unless ``set_device("cpu")`` was called)."""
    return default_device()


def is_compiled_with_tpu() -> bool:
    """False: the port targets CUDA."""
    return False


def synchronize(device=None) -> None:
    """Wait until all work queued on the device is done."""
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Event:
    """Paddle-shaped event: ``torch.cuda.Event`` on a card; on the CPU a
    timestamp taken after a barrier (``record``)."""

    def __init__(self, enable_timing: bool = True, blocking: bool = False,
                 interprocess: bool = False, device=None):
        self.device = default_device(device)
        self.enable_timing = enable_timing
        self._t: Optional[float] = None
        self._cuda = (torch.cuda.Event(enable_timing=enable_timing, blocking=blocking,
                                       interprocess=interprocess)
                      if self.device.type == "cuda" else None)

    def record(self, stream: Optional["Stream"] = None) -> None:
        if self._cuda is not None:
            self._cuda.record(None if stream is None else stream._cuda)
        else:
            synchronize(self.device)
            self._t = time.perf_counter()

    def synchronize(self) -> None:
        if self._cuda is not None:
            self._cuda.synchronize()

    def query(self) -> bool:
        return self._cuda.query() if self._cuda is not None else True

    def elapsed_time(self, end: "Event") -> float:
        """Milliseconds from this event to ``end``."""
        if self._cuda is not None:
            return self._cuda.elapsed_time(end._cuda)
        if self._t is None or end._t is None:
            raise RuntimeError("events must be recorded before elapsed_time")
        return (end._t - self._t) * 1000.0


class Stream:
    """Paddle-shaped stream: ``torch.cuda.Stream`` on a card (Paddle's
    ``priority`` 1 is high, 2 normal); on the CPU the one host stream."""

    def __init__(self, device=None, priority: int = 2, _cuda=None):
        self.device = default_device(device)
        self.priority = priority
        if _cuda is None and self.device.type == "cuda":
            _cuda = torch.cuda.Stream(device=self.device, priority=-1 if priority == 1 else 0)
        self._cuda = _cuda

    def synchronize(self) -> None:
        if self._cuda is not None:
            self._cuda.synchronize()

    def query(self) -> bool:
        return self._cuda.query() if self._cuda is not None else True

    def wait_event(self, event: Event) -> None:
        if self._cuda is not None:
            self._cuda.wait_event(event._cuda)
        else:
            event.synchronize()

    def wait_stream(self, stream: "Stream") -> None:
        if self._cuda is not None:
            self._cuda.wait_stream(stream._cuda)
        else:
            stream.synchronize()

    def record_event(self, event: Optional[Event] = None) -> Event:
        event = event if event is not None else Event(device=self.device)
        event.record(self)
        return event


_HOST_STREAM: Optional[Stream] = None


def current_stream(device=None) -> Stream:
    """The stream work is queued on: the card's current stream, or the one
    host stream on the CPU."""
    global _HOST_STREAM
    dev = default_device(device)
    if dev.type == "cuda":
        return Stream(dev, _cuda=torch.cuda.current_stream(dev))
    if _HOST_STREAM is None:
        _HOST_STREAM = Stream(dev)
    return _HOST_STREAM


@contextlib.contextmanager
def stream_guard(stream: Stream):
    """Queue the block's work on ``stream``."""
    if stream._cuda is None:
        yield stream
        return
    with torch.cuda.stream(stream._cuda):
        yield stream
