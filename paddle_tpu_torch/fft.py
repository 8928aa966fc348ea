"""``paddle.fft`` (port of ``paddle_tpu/fft.py``): ``torch.fft`` under the
JAX package's names and signatures (cuFFT on the card; the JAX package
leaves FFTs to XLA).  ``hfft2`` / ``hfftn`` / ``ihfft2`` / ``ihfftn`` are
the JAX package's composition: the Hermitian transform over the last
axis with complex transforms over the rest."""

from __future__ import annotations

import torch

from .framework.device import default_device
from .framework.tensor import Tensor
from .ops.common import unary_op

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "fftfreq", "rfftfreq", "fftshift", "ifftshift",
    "hfft2", "hfftn", "ihfft2", "ihfftn",
]


def _mk1(name, tf):
    def op(x, n=None, axis=-1, norm="backward", name_=None):
        return unary_op(name, lambda a: tf(a, n=n, dim=axis, norm=norm), x)

    op.__name__ = op.__qualname__ = name
    return op


def _mkn(name, tf, default_axes=None):
    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        return unary_op(name_, lambda a: tf(a, s=s, dim=axes, norm=norm), x)

    name_ = name
    op.__name__ = op.__qualname__ = name
    return op


fft = _mk1("fft", torch.fft.fft)
ifft = _mk1("ifft", torch.fft.ifft)
rfft = _mk1("rfft", torch.fft.rfft)
irfft = _mk1("irfft", torch.fft.irfft)
hfft = _mk1("hfft", torch.fft.hfft)
ihfft = _mk1("ihfft", torch.fft.ihfft)
fft2 = _mkn("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _mkn("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _mkn("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _mkn("irfft2", torch.fft.irfftn, (-2, -1))
fftn = _mkn("fftn", torch.fft.fftn)
ifftn = _mkn("ifftn", torch.fft.ifftn)
rfftn = _mkn("rfftn", torch.fft.rfftn)
irfftn = _mkn("irfftn", torch.fft.irfftn)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor._wrap(torch.fft.fftfreq(n, d=d, device=default_device(None)))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor._wrap(torch.fft.rfftfreq(n, d=d, device=default_device(None)))


def fftshift(x, axes=None, name=None):
    return unary_op("fftshift", lambda a: torch.fft.fftshift(a, dim=axes), x)


def ifftshift(x, axes=None, name=None):
    return unary_op("ifftshift", lambda a: torch.fft.ifftshift(a, dim=axes), x)


def _hermitian_nd(x, s, axes, norm):
    """``hfft`` over the last of ``axes`` after ``fftn`` over the rest."""
    axes = tuple(axes)

    def f(a):
        if axes[:-1]:
            a = torch.fft.fftn(a, s=None if s is None else tuple(s[:-1]), dim=axes[:-1],
                               norm=norm)
        return torch.fft.hfft(a, n=None if s is None else s[-1], dim=axes[-1], norm=norm)

    return unary_op("hfftn", f, x)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-D FFT of a Hermitian-symmetric signal."""
    return _hermitian_nd(x, s, axes, norm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    return _hermitian_nd(x, s, axes if axes is not None else tuple(range(-x.ndim, 0)), norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """``ihfft`` over the last of ``axes``, then ``ifftn`` over the rest."""
    axes = tuple(axes)

    def f(a):
        out = torch.fft.ihfft(a, n=None if s is None else s[-1], dim=axes[-1], norm=norm)
        if axes[:-1]:
            out = torch.fft.ifftn(out, s=None if s is None else tuple(s[:-1]), dim=axes[:-1],
                                  norm=norm)
        return out

    return unary_op("ihfft2", f, x)


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    return ihfft2(x, s=s, axes=tuple(axes) if axes is not None else tuple(range(-x.ndim, 0)),
                  norm=norm)
