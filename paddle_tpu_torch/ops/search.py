"""Search and sort ops (port of ``paddle_tpu/ops/search.py``); indices are
int32, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.tensor import Tensor
from .common import apply, axis_or_none, data_of, np_of, unary_op

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "searchsorted", "bucketize",
    "kthvalue", "mode", "index_sample",
]


def _arg(fn, a, ax, keepdim):
    if ax is None:
        out = fn(a.reshape(-1))
        return out.reshape([1] * a.dim()) if keepdim else out
    return fn(a, dim=ax, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = axis_or_none(axis)
    return unary_op("argmax", lambda a: _arg(torch.argmax, a, ax, keepdim).to(torch.int32), x)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = axis_or_none(axis)
    return unary_op("argmin", lambda a: _arg(torch.argmin, a, ax, keepdim).to(torch.int32), x)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return unary_op("argsort", lambda a: torch.sort(a, dim=axis, descending=descending,
                                                    stable=True).indices.to(torch.int32), x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return unary_op("sort", lambda a: torch.sort(a, dim=axis, descending=descending,
                                                 stable=True).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, Tensor) else int(k)

    def f(a):
        ax = (a.dim() - 1) if axis is None else axis % a.dim()
        vals, idx = torch.topk(a, kk, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int32)

    return apply("topk", f, x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    def f(seq, v):
        if seq.dim() == 1:
            out = torch.searchsorted(seq, v.to(seq.dtype), right=right)
        else:
            out = torch.searchsorted(seq.contiguous(), v.to(seq.dtype).contiguous(), right=right)
        return out.to(torch.int32)

    return apply("searchsorted", f, sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        ax = axis % a.dim()
        srt = torch.sort(a, dim=ax, stable=True)
        vals = srt.values.select(ax, k - 1)
        idx = srt.indices.select(ax, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx.to(torch.int32)

    return apply("kthvalue", f, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest among ties) and
    the index of its last occurrence, on the host, as the JAX package."""
    ref = data_of(x)
    a = np_of(ref)
    ax = axis % a.ndim
    moved = np.moveaxis(a, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], dtype=a.dtype)
    idxs = np.empty(flat.shape[0], dtype=np.int32)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        cand = uniq[counts == counts.max()][-1]
        vals[i] = cand
        idxs[i] = np.where(row == cand)[0][-1]
    vals = vals.reshape(moved.shape[:-1])
    idxs = idxs.reshape(moved.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, ax), np.expand_dims(idxs, ax)
    dev = ref.device
    return (Tensor._wrap(torch.from_numpy(vals).to(device=dev, dtype=ref.dtype)),
            Tensor._wrap(torch.from_numpy(idxs).to(dev)))


def index_sample(x, index, name=None):
    return apply("index_sample", lambda a, idx: torch.gather(a, 1, idx.long()), x, index)
