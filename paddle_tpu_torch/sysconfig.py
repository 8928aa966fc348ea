"""``paddle.sysconfig`` (port of ``paddle_tpu/sysconfig.py``; reference:
``python/paddle/sysconfig.py``): where the native runtime's sources and
its built library live."""

import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    """Directory of the native runtime's C++ sources (``core/csrc``: the TCP
    store, host tracer and shared-memory channel), for extensions that
    build against them."""
    return os.path.join(_ROOT, "core", "csrc")


def get_lib() -> str:
    """Directory the native library is built into at first use
    (``core/build``, ``libpaddle_tpu_torch_native-<hash>.so``)."""
    return os.path.join(_ROOT, "core", "build")
