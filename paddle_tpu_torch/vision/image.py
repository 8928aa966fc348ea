"""Global image-decoding backend (port of ``paddle_tpu/vision/image.py``).

``'pil'``, ``'cv2'`` and ``'tensor'``: the setting is validated when it is
made, the decoder imported when an image is loaded (``cv2`` only for the
``'cv2'`` backend).  With ``'tensor'``, :func:`image_load` returns a
``paddle_tpu_torch`` Tensor in HWC uint8 layout.
"""

from __future__ import annotations

import numpy as np

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend):
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'tensor'], but got {backend}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image via the selected backend: PIL.Image for ``'pil'``,
    ``np.ndarray`` (BGR, matching cv2.imread) for ``'cv2'``, Tensor (HWC
    uint8) for ``'tensor'``."""
    backend = backend or _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'tensor'], but got {backend}")
    if backend == "cv2":
        import cv2

        return cv2.imread(path)
    from PIL import Image

    img = Image.open(path)
    if backend == "pil":
        return img
    from ..framework.tensor import to_tensor

    return to_tensor(np.asarray(img.convert("RGB"), dtype=np.uint8))
