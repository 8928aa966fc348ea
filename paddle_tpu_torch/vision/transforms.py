"""Vision transforms (port of ``paddle_tpu/vision/transforms.py``).

Operate on numpy HWC arrays (or Tensors): host-side preprocessing, numpy
as in the JAX package, drawing from Python's ``random`` and numpy's global
generator in the same order, so the same seeds give the same crops,
flips and jitters.  ``to_tensor`` gives a ``Tensor`` on the device
``set_device`` chose, as the JAX package's gives a device array.

Bilinear resizing (``resize``, ``Resize``, ``RandomResizedCrop``) is
``jax.image.resize(..., "bilinear")``'s scale-and-translate resampling
written in numpy: a triangle filter whose support widens by the shrink
factor when the image shrinks (antialiasing), one weight matrix an axis.
Each output pixel reads only the few input pixels under its filter, so an
axis is applied as a short weighted sum of gathered rows, in float32.  The
weights are the JAX package's; the sums run in another order.
"""

from __future__ import annotations

import math
import numbers
import random as pyrandom
from typing import List, Sequence

import numpy as np

from ..framework.resample import resize_weights
from ..framework.tensor import Tensor

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop", "RandomCrop",
           "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad", "RandomRotation",
           "to_tensor", "normalize", "resize", "hflip", "vflip", "center_crop", "crop",
           "BaseTransform", "BrightnessTransform", "ContrastTransform",
           "SaturationTransform", "HueTransform", "ColorJitter", "Grayscale",
           "RandomAffine", "RandomPerspective", "RandomErasing",
           "RandomResizedCrop", "adjust_brightness", "adjust_contrast",
           "adjust_hue", "to_grayscale", "pad", "erase", "affine", "rotate",
           "perspective"]


def _np(img):
    if isinstance(img, Tensor):
        return np.asarray(img._data)
    return np.asarray(img)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def to_tensor(pic, data_format="CHW"):
    arr = _np(pic).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return Tensor(arr)


class ToTensor:
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _np(img).astype(np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean) / std
    return Tensor(arr) if isinstance(img, Tensor) else arr


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        self.mean = mean if isinstance(mean, (list, tuple)) else [mean] * 3
        self.std = std if isinstance(std, (list, tuple)) else [std] * 3
        self.data_format = data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


def _resize_np(arr, size):
    h, w = (size, size) if isinstance(size, int) else size
    if arr.ndim == 2:
        arr = arr[:, :, None]
    a = arr.astype(np.float32)
    if a.shape[0] != h:
        a = _resample_axis(a, 0, h)
    if a.shape[1] != w:
        a = _resample_axis(a, 1, w)
    return np.ascontiguousarray(a)


def _resample_axis(a, axis, out_size):
    """``a`` resampled to ``out_size`` along ``axis``: output i is the sum
    over its filter's band of input rows, weights in band order."""
    w = resize_weights(a.shape[axis], out_size)             # [in, out]
    nz = w != 0
    first = nz.argmax(axis=0)
    band = max(1, int(nz.sum(axis=0).max()))
    cols = np.arange(out_size)
    out = None
    for k in range(band):
        rows = first + k
        valid = rows < a.shape[axis]
        rows = np.minimum(rows, a.shape[axis] - 1)
        wk = np.where(valid, w[rows, cols], np.float32(0.0))
        shape = [1] * a.ndim
        shape[axis] = out_size
        term = np.take(a, rows, axis=axis) * wk.reshape(shape)
        out = term if out is None else out + term
    return out


def resize(img, size, interpolation="bilinear"):
    return _resize_np(_np(img), size)


class Resize:
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size

    def __call__(self, img):
        return resize(img, self.size)


def crop(img, top, left, height, width):
    return _np(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = _np(img)
    th, tw = (output_size, output_size) if isinstance(output_size, int) else output_size
    h, w = arr.shape[0], arr.shape[1]
    i = max((h - th) // 2, 0)
    j = max((w - tw) // 2, 0)
    return arr[i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size, keys=None):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def __call__(self, img):
        arr = _np(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) else [self.padding] * 4
            arr = np.pad(arr, [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2))
        th, tw = self.size
        h, w = arr.shape[0], arr.shape[1]
        i = pyrandom.randint(0, max(h - th, 0))
        j = pyrandom.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


def hflip(img):
    return _np(img)[:, ::-1].copy()


def vflip(img):
    return _np(img)[::-1].copy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if pyrandom.random() < self.prob:
            return hflip(img)
        return _np(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if pyrandom.random() < self.prob:
            return vflip(img)
        return _np(img)


class Transpose:
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        arr = _np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding if isinstance(padding, (list, tuple)) else [padding] * 4
        self.fill = fill

    def __call__(self, img):
        arr = _np(img)
        p = self.padding
        width = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, width, constant_values=self.fill)


class RandomRotation:
    def __init__(self, degrees, interpolation="nearest", expand=False, center=None, fill=0, keys=None):
        self.degrees = (-degrees, degrees) if isinstance(degrees, numbers.Number) else degrees

    def __call__(self, img):
        import scipy.ndimage as ndi

        angle = pyrandom.uniform(*self.degrees)
        return ndi.rotate(_np(img), angle, reshape=False, order=1)


# ---------------------------------------------------------------------------
# transform long tail (reference python/paddle/vision/transforms/)
# ---------------------------------------------------------------------------
# functional forms operate on HWC uint8/float numpy (or Tensor) images —
# image augmentation is HOST work feeding the device pipeline.


class BaseTransform:
    """Base class with the reference's keys-dispatch contract: subclasses
    implement ``_apply_image`` (and optionally ``_apply_*`` for other keys)."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _get_params(self, inputs):
        return None

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        if isinstance(inputs, (list, tuple)):
            # (image, label, ...) pairs: apply per-key handlers; keys beyond
            # self.keys pass through untouched (reference BaseTransform)
            self.params = self._get_params(inputs)
            keys = tuple(self.keys) + ("__passthrough__",) * (
                len(inputs) - len(self.keys))
            return tuple(
                getattr(self, f"_apply_{k}", lambda v: v)(v)
                for k, v in zip(keys, inputs))
        self.params = self._get_params((inputs,))
        return self._apply_image(inputs)


def _hwc(arr):
    """Ensure float HWC ndarray for photometric ops; remember dtype."""
    a = _np(arr)
    was_uint8 = a.dtype == np.uint8
    return a.astype(np.float32), was_uint8


def _restore(a, was_uint8):
    if was_uint8:
        return np.clip(np.round(a), 0, 255).astype(np.uint8)
    return a


def adjust_brightness(img, brightness_factor):
    a, u8 = _hwc(img)
    return _restore(a * brightness_factor, u8)


def adjust_contrast(img, contrast_factor):
    a, u8 = _hwc(img)
    mean = a.mean() if a.ndim == 2 else _rgb_to_gray(a).mean()
    return _restore((a - mean) * contrast_factor + mean, u8)


def _rgb_to_gray(a):
    return a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114


def adjust_hue(img, hue_factor):
    """Shift hue by ``hue_factor`` in [-0.5, 0.5] turns (reference
    ``adjust_hue``; HSV roundtrip)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a, u8 = _hwc(img)
    scale = 255.0 if u8 else 1.0
    rgb = a / scale
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, ((g - b) / diff) % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) / 6
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = (i.astype(np.int32) % 6)[..., None]  # broadcast over the channel dim
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return _restore(out * scale, u8)


def to_grayscale(img, num_output_channels=1):
    a, u8 = _hwc(img)
    g = _rgb_to_gray(a)
    out = np.repeat(g[..., None], num_output_channels, axis=-1)
    return _restore(out, u8)


def pad(img, padding, fill=0, padding_mode="constant"):
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    a = _np(img)
    width = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (a.ndim - 2)
    if padding_mode == "constant":
        return np.pad(a, width, constant_values=fill)
    return np.pad(a, width, mode={"reflect": "reflect", "edge": "edge",
                                  "symmetric": "symmetric"}[padding_mode])


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the region rows [i, i+h), cols [j, j+w) (HWC or HW images)."""
    a = _np(img).copy()
    a[i:i + h, j:j + w] = v
    return a


def _affine_np(a, matrix, interpolation="nearest", fill=0.0):
    """Apply an inverse 2x3 affine (output->input coords) to HWC ndarray."""
    H, W = a.shape[:2]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    src_x = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2]
    src_y = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2]
    if interpolation == "bilinear":
        x0 = np.floor(src_x).astype(np.int64)
        y0 = np.floor(src_y).astype(np.int64)
        wx = src_x - x0
        wy = src_y - y0

        def g(yy, xx):
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            yy_c = np.clip(yy, 0, H - 1)
            xx_c = np.clip(xx, 0, W - 1)
            px = a[yy_c, xx_c].astype(np.float32)
            return np.where(valid[..., None] if a.ndim == 3 else valid,
                            px, fill)

        def w_(x):
            return x[..., None] if a.ndim == 3 else x  # channel broadcast

        out = (g(y0, x0) * w_((1 - wy) * (1 - wx))
               + g(y0, x0 + 1) * w_((1 - wy) * wx)
               + g(y0 + 1, x0) * w_(wy * (1 - wx))
               + g(y0 + 1, x0 + 1) * w_(wy * wx))
        return out.astype(a.dtype) if a.dtype != np.uint8 else \
            np.clip(np.round(out), 0, 255).astype(np.uint8)
    xi = np.round(src_x).astype(np.int64)
    yi = np.round(src_y).astype(np.int64)
    valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    out = a[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    if a.ndim == 3:
        out = np.where(valid[..., None], out, fill)
    else:
        out = np.where(valid, out, fill)
    return out.astype(a.dtype)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Affine transform (reference ``transforms.functional.affine``)."""
    a = _np(img)
    H, W = a.shape[:2]
    # pixel-center-symmetric default: exact grid mapping for 90-degree turns
    cx, cy = center if center is not None else ((W - 1) * 0.5, (H - 1) * 0.5)
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in (shear if isinstance(shear, (list, tuple))
                                        else (shear, 0.0)))
    # forward matrix M = T(center) R S Shear T(-center) + translate; invert
    ca, sa = math.cos(rot), math.sin(rot)
    m00 = scale * (ca + sa * math.tan(sy))
    m01 = scale * (ca * math.tan(sx) - sa)
    m10 = scale * (sa + ca * math.tan(sy))
    m11 = scale * ca
    M = np.array([[m00, m01, 0.0], [m10, m11, 0.0]], np.float64)
    M[0, 2] = cx + translate[0] - (M[0, 0] * cx + M[0, 1] * cy)
    M[1, 2] = cy + translate[1] - (M[1, 0] * cx + M[1, 1] * cy)
    full = np.vstack([M, [0, 0, 1]])
    inv = np.linalg.inv(full)[:2]
    return _affine_np(a, inv, interpolation, fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    return affine(img, angle, (0, 0), 1.0, (0.0, 0.0), interpolation, fill,
                  center)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Perspective warp mapping ``startpoints`` -> ``endpoints`` (reference
    ``transforms.functional.perspective``)."""
    a = _np(img)
    # solve the 8-dof homography endpoints -> startpoints (inverse map)
    src = np.asarray(endpoints, np.float64)
    dst = np.asarray(startpoints, np.float64)
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    A = np.asarray(A)
    b = dst.reshape(-1)
    h = np.linalg.lstsq(A, b, rcond=None)[0]
    Hm = np.append(h, 1.0).reshape(3, 3)
    Hh, Ww = a.shape[:2]
    ys, xs = np.meshgrid(np.arange(Hh), np.arange(Ww), indexing="ij")
    den = Hm[2, 0] * xs + Hm[2, 1] * ys + Hm[2, 2]
    sx = (Hm[0, 0] * xs + Hm[0, 1] * ys + Hm[0, 2]) / den
    sy = (Hm[1, 0] * xs + Hm[1, 1] * ys + Hm[1, 2]) / den
    if interpolation == "bilinear":
        # reuse the shared sampler: feed precomputed source coords through an
        # identity-affine call path by sampling directly here
        x0 = np.floor(sx).astype(np.int64)
        y0 = np.floor(sy).astype(np.int64)
        wx = sx - x0
        wy = sy - y0

        def g(yy, xx):
            valid = (yy >= 0) & (yy < Hh) & (xx >= 0) & (xx < Ww)
            px = a[np.clip(yy, 0, Hh - 1), np.clip(xx, 0, Ww - 1)].astype(np.float32)
            return np.where(valid[..., None] if a.ndim == 3 else valid, px, fill)

        def w_(x):
            return x[..., None] if a.ndim == 3 else x

        out = (g(y0, x0) * w_((1 - wy) * (1 - wx))
               + g(y0, x0 + 1) * w_((1 - wy) * wx)
               + g(y0 + 1, x0) * w_(wy * (1 - wx))
               + g(y0 + 1, x0 + 1) * w_(wy * wx))
        return out.astype(a.dtype) if a.dtype != np.uint8 else \
            np.clip(np.round(out), 0, 255).astype(np.uint8)
    xi = np.round(sx).astype(np.int64)
    yi = np.round(sy).astype(np.int64)
    valid = (yi >= 0) & (yi < Hh) & (xi >= 0) & (xi < Ww)
    out = a[np.clip(yi, 0, Hh - 1), np.clip(xi, 0, Ww - 1)]
    mask = valid[..., None] if a.ndim == 3 else valid
    return np.where(mask, out, fill).astype(a.dtype)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        f = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        f = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        f = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        a, u8 = _hwc(img)
        g = _rgb_to_gray(a)[..., None]
        return _restore(g + (a - g) * f, u8)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _np(img)
        return adjust_hue(img, pyrandom.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order (reference
    ``ColorJitter``)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self._ts = [BrightnessTransform(brightness), ContrastTransform(contrast),
                    SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        pyrandom.shuffle(order)
        out = img
        for i in order:
            out = self._ts[i]._apply_image(out)
        return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if isinstance(degrees, numbers.Number) else degrees
        self.translate = translate
        self.scale_rng = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = _np(img)
        H, W = a.shape[:2]
        angle = pyrandom.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = pyrandom.uniform(-self.translate[0], self.translate[0]) * W
            ty = pyrandom.uniform(-self.translate[1], self.translate[1]) * H
        sc = pyrandom.uniform(*self.scale_rng) if self.scale_rng else 1.0
        sx = sy = 0.0
        if isinstance(self.shear, numbers.Number):
            if self.shear:
                sx = pyrandom.uniform(-self.shear, self.shear)
        elif self.shear is not None:
            sh = list(self.shear)
            sx = pyrandom.uniform(sh[0], sh[1])
            if len(sh) == 4:
                sy = pyrandom.uniform(sh[2], sh[3])
        return affine(a, angle, (tx, ty), sc, (sx, sy), self.interpolation,
                      self.fill, self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5, interpolation="nearest",
                 fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.d = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        a = _np(img)
        if pyrandom.random() >= self.prob:
            return a
        H, W = a.shape[:2]
        dx, dy = self.d * W / 2, self.d * H / 2
        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        end = [(pyrandom.uniform(0, dx), pyrandom.uniform(0, dy)),
               (W - 1 - pyrandom.uniform(0, dx), pyrandom.uniform(0, dy)),
               (W - 1 - pyrandom.uniform(0, dx), H - 1 - pyrandom.uniform(0, dy)),
               (pyrandom.uniform(0, dx), H - 1 - pyrandom.uniform(0, dy))]
        return perspective(a, start, end, self.interpolation, self.fill)


class RandomErasing(BaseTransform):
    """Randomly erase a rectangle (reference ``RandomErasing``; Zhong et al.)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio, self.value = prob, scale, ratio, value

    def _apply_image(self, img):
        a = _np(img)
        if pyrandom.random() >= self.prob:
            return a
        H, W = (a.shape[-3], a.shape[-2]) if a.ndim == 3 else a.shape[:2]
        area = H * W
        for _ in range(10):
            target = pyrandom.uniform(*self.scale) * area
            ar = math.exp(pyrandom.uniform(math.log(self.ratio[0]),
                                           math.log(self.ratio[1])))
            h = int(round(math.sqrt(target * ar)))
            w = int(round(math.sqrt(target / ar)))
            if h < H and w < W:
                i = pyrandom.randint(0, H - h)
                j = pyrandom.randint(0, W - w)
                out = a.copy()
                out[i:i + h, j:j + w] = self.value
                return out
        return a


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop then resize (reference ``RandomResizedCrop``)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        a = _np(img)
        H, W = a.shape[:2]
        area = H * W
        for _ in range(10):
            target = pyrandom.uniform(*self.scale) * area
            ar = math.exp(pyrandom.uniform(math.log(self.ratio[0]),
                                           math.log(self.ratio[1])))
            w = int(round(math.sqrt(target * ar)))
            h = int(round(math.sqrt(target / ar)))
            if 0 < h <= H and 0 < w <= W:
                i = pyrandom.randint(0, H - h)
                j = pyrandom.randint(0, W - w)
                return _resize_np(a[i:i + h, j:j + w], self.size)
        return _resize_np(center_crop(a, min(H, W)), self.size)
