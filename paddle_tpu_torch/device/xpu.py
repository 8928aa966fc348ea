"""``paddle.device.xpu`` surface (reference:
``python/paddle/device/xpu/__init__.py``) on an XPU-less build."""

__all__ = ["synchronize"]


def synchronize(device=None):
    raise RuntimeError("paddle.device.xpu.synchronize: not compiled with XPU")
