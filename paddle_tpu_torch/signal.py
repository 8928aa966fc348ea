"""``paddle.signal`` (port of ``paddle_tpu/signal.py``): ``stft`` /
``istft`` with the JAX package's framing (``n_frames = 1 + (n - n_fft) //
hop``), padding (``n_fft // 2`` a side when ``center``, ``pad_mode``
reflect by default) and window centring (a window shorter than ``n_fft``
zero-padded to it, centred), over ``Tensor.unfold`` and ``torch.fft``
(``torch.stft``'s conventions differ).  ``istft`` overlap-adds the
windowed frames and divides by the overlap-added squared window where it
exceeds 1e-11, as the JAX one."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .ops.common import apply, data_of

__all__ = ["stft", "istft"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant", "edge": "replicate",
              "replicate": "replicate", "wrap": "circular", "circular": "circular"}


def _window(window, n_fft, win_length, ref):
    wl = win_length or n_fft
    w = (torch.ones(wl, dtype=torch.float32, device=ref.device) if window is None
         else data_of(window, ref))
    if wl < n_fft:
        lp = (n_fft - wl) // 2
        w = F.pad(w, (lp, n_fft - wl - lp))
    return w


def stft(x, n_fft: int, hop_length: Optional[int] = None, win_length: Optional[int] = None,
         window=None, center: bool = True, pad_mode: str = "reflect", normalized: bool = False,
         onesided: bool = True, name=None):
    """Short-time Fourier transform: ``[..., N]`` -> ``[..., n_fft // 2 + 1
    (or n_fft), n_frames]`` complex."""
    hop = hop_length or n_fft // 4

    def f(a, w):
        sig = a
        if center:
            lead = sig.shape[:-1]
            sig = F.pad(sig.reshape(-1, 1, sig.shape[-1]), (n_fft // 2, n_fft // 2),
                        mode=_PAD_MODES[pad_mode])
            sig = sig.reshape(lead + sig.shape[-1:])
        frames = sig.unfold(-1, n_fft, hop) * w
        spec = torch.fft.rfft(frames, dim=-1) if onesided else torch.fft.fft(frames, dim=-1)
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)

    ref = data_of(x)
    return apply("stft", f, ref, _window(window, n_fft, win_length, ref))


def istft(x, n_fft: int, hop_length: Optional[int] = None, win_length: Optional[int] = None,
          window=None, center: bool = True, normalized: bool = False, onesided: bool = True,
          length: Optional[int] = None, return_complex: bool = False, name=None):
    """Inverse STFT by overlap-add with squared-window normalisation."""
    hop = hop_length or n_fft // 4

    def overlap_add(frames, out_len):
        """``[B, n_frames, n_fft]`` summed into ``[B, out_len]``."""
        cols = frames.transpose(1, 2)
        return F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(
            frames.shape[0], out_len)

    def f(spec, w):
        s = spec.transpose(-1, -2)
        if normalized:
            s = s * math.sqrt(n_fft)
        if onesided:
            frames = torch.fft.irfft(s, n=n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(s, dim=-1)
            if not return_complex:
                frames = frames.real
        frames = frames * w
        lead, n_frames = frames.shape[:-2], frames.shape[-2]
        out_len = n_fft + hop * (n_frames - 1)
        flat = frames.reshape((-1,) + frames.shape[-2:])
        if flat.is_complex():
            ola = torch.complex(overlap_add(flat.real, out_len), overlap_add(flat.imag, out_len))
        else:
            ola = overlap_add(flat, out_len)
        env = overlap_add((w.to(torch.float32) ** 2).expand(1, n_frames, n_fft), out_len)[0]
        ola = (ola / torch.where(env > 1e-11, env, 1.0)).reshape(lead + (out_len,))
        if center:
            ola = ola[..., n_fft // 2: out_len - n_fft // 2]
        if length is not None:
            ola = ola[..., :length]
        return ola

    ref = data_of(x)
    return apply("istft", f, ref, _window(window, n_fft, win_length, ref))
