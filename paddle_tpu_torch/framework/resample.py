"""``jax.image.resize``'s scale-and-translate weights, in numpy.

One ``[in_size, out_size]`` float32 matrix an axis, as
``jax.image.resize``'s ``compute_weight_mat`` builds it with antialiasing:
output sample ``i`` sits at ``(i + 0.5) * in / out - 0.5`` in the input,
the kernel (a triangle for ``"linear"``, Keys' cubic with a = -0.5 for
``"cubic"``) is widened by the shrink factor when the axis shrinks, each
output column is normalised to sum to 1, and samples outside the input are
zero.  ``vision.transforms`` (host resizing) and ``nn.functional.interpolate``
apply these matrices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_weights"]


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x):
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str = "linear") -> np.ndarray:
    """``[in_size, out_size]`` float32 weights resampling an axis of
    ``in_size`` to ``out_size`` (``method`` ``"linear"`` or ``"cubic"``)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = f32(max(inv_scale, f32(1.0)))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)
