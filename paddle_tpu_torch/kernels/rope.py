"""Rotary position embedding (port of ``paddle_tpu/kernels/rope.py``).

Half-rotation (rotate_half / neox) form with the rotation math in fp32.
Plain PyTorch on every device: the JAX original is plain XLA too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rope_freqs", "apply_rope", "fused_rotary_position_embedding"]


def rope_freqs(head_dim: int, max_seq_len: int, base: float = 10000.0,
               dtype: torch.dtype = torch.float32,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[max_seq_len, head_dim]``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                 # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)          # [S, D]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, position_ids: Optional[torch.Tensor] = None):
    """q, k: ``[B, S, H, D]``; cos/sin: ``[S_max, D]``; ``position_ids``
    ``[B, S]`` (absolute positions) or None for positions ``0..S-1``.
    Returns rotated (q, k) in their input dtypes."""
    if position_ids is not None:
        cos = cos[position_ids][:, :, None, :]       # [B, S, 1, D]
        sin = sin[position_ids][:, :, None, :]
    else:
        s = q.shape[1]
        cos = cos[None, :s, None, :]
        sin = sin[None, :s, None, :]

    def rot(x):
        x32 = x.to(torch.float32)
        return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)

    return rot(q), rot(k)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None, position_ids=None,
                                    use_neox_rotary_style=True):
    """The reference-shaped entry: rotates each of q, k, v given (``[B, S,
    H, D]``) by the tables ``cos``/``sin`` (any shape that squeezes to
    ``[S_max, D]``; when either is None, tables of ``q``'s head dim and
    length at base 10000).  Returns the triple, None where none was given."""
    if cos is None or sin is None:
        cos, sin = rope_freqs(q.shape[-1], q.shape[1], device=q.device)
    else:
        cos, sin = cos.squeeze(), sin.squeeze()
    return tuple(None if x is None else apply_rope(x, x, cos, sin, position_ids)[0]
                 for x in (q, k, v))
