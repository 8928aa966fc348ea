"""Reduction and statistics ops (port of ``paddle_tpu/ops/reduction.py``).

As the JAX package: ``max`` / ``min`` return values only, sums of narrow
integers and bools are int32, ``quantile`` computes in fp32, and the
histogram ops (data-dependent output) run on the host."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.tensor import Tensor
from .common import apply, axis_or_none, data_of, dims, np_of, unary_op

__all__ = [
    "sum", "nansum", "mean", "nanmean", "max", "min", "amax", "amin", "prod",
    "all", "any", "std", "var", "median", "nanmedian", "quantile", "nanquantile",
    "count_nonzero", "bincount", "histogram", "histogramdd", "numel",
]


def _acc(a, dtype):
    if dtype is not None:
        return convert_dtype(dtype)
    if a.is_floating_point() or a.is_complex() or a.dtype == torch.int64:
        return a.dtype
    return torch.int32


def _host(t: np.ndarray, ref: torch.Tensor) -> Tensor:
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(t)).to(ref.device))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("sum", lambda a: torch.sum(a, dim=dims(ax, a.dim()), keepdim=keepdim,
                                               dtype=_acc(a, dtype)), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("nansum", lambda a: torch.nansum(a, dim=dims(ax, a.dim()), keepdim=keepdim,
                                                     dtype=_acc(a, dtype)), x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("mean", lambda a: torch.mean(_f(a), dim=dims(ax, a.dim()), keepdim=keepdim),
                    x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("nanmean",
                    lambda a: torch.nanmean(_f(a), dim=dims(ax, a.dim()), keepdim=keepdim), x)


def _f(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(torch.float32)


def max(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("max", lambda a: torch.amax(a, dim=dims(ax, a.dim()), keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("min", lambda a: torch.amin(a, dim=dims(ax, a.dim()), keepdim=keepdim), x)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = axis_or_none(axis)

    def f(a):
        acc = _acc(a, dtype)
        out = a.to(acc)
        for d in sorted((d % a.dim() for d in dims(ax, a.dim())), reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdim)
        return out.to(acc)

    return unary_op("prod", f, x)


def all(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("all", lambda a: torch.all(a.bool(), dim=dims(ax, a.dim()), keepdim=keepdim)
                    if a.dim() else a.bool(), x)


def any(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("any", lambda a: torch.any(a.bool(), dim=dims(ax, a.dim()), keepdim=keepdim)
                    if a.dim() else a.bool(), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("std", lambda a: torch.std(_f(a), dim=dims(ax, a.dim()),
                                               correction=1 if unbiased else 0, keepdim=keepdim),
                    x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = axis_or_none(axis)
    return unary_op("var", lambda a: torch.var(_f(a), dim=dims(ax, a.dim()),
                                               correction=1 if unbiased else 0, keepdim=keepdim),
                    x)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """``mode="avg"``: the mean of the two middle values; ``"min"``: the
    lower one and its int32 index."""
    ax = axis_or_none(axis)
    if mode == "avg":
        def f(a):
            arr = _f(a).reshape(-1) if ax is None else _f(a)
            d = 0 if ax is None else ax
            n = arr.shape[d]
            srt = torch.sort(arr, dim=d).values
            lo = srt.narrow(d, (n - 1) // 2, 1)
            hi = srt.narrow(d, n // 2, 1)
            out = (lo + hi) / 2
            if ax is None:
                return out.reshape([1] * a.dim()) if keepdim else out.reshape(())
            return out if keepdim else out.squeeze(d)

        return unary_op("median", f, x)

    def f(a):
        arr = a.reshape(-1) if ax is None else a
        d = 0 if ax is None else ax
        k = (arr.shape[d] - 1) // 2
        srt = torch.sort(arr, dim=d, stable=True)
        vals = srt.values.select(d, k)
        idx = srt.indices.select(d, k)
        if keepdim and ax is not None:
            vals, idx = vals.unsqueeze(d), idx.unsqueeze(d)
        return vals, idx.to(torch.int32)

    return apply("median_min", f, x)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = axis_or_none(axis)
    a = data_of(x)
    out = np.nanmedian(np_of(a), axis=ax, keepdims=keepdim)
    return _host(np.asarray(out, dtype=np_of(a[:0]).dtype), a)


def _quantile(name, x, q, axis, keepdim, interpolation, fn):
    ax = axis_or_none(axis)
    qv = data_of(q) if isinstance(q, Tensor) else torch.as_tensor(q)

    def f(a):
        a32 = a.to(torch.float32)
        qq = qv.to(device=a.device, dtype=torch.float32)
        if isinstance(ax, tuple):
            axset = {d % a.dim() for d in ax}
            keep = [d for d in range(a.dim()) if d not in axset]
            flat = a32.permute(keep + sorted(axset)).reshape([a.shape[d] for d in keep] + [-1])
            out = fn(flat, qq, dim=-1, interpolation=interpolation)
            if keepdim:
                out = out.reshape(tuple(qq.shape) + tuple(1 if d in axset else a.shape[d]
                                                          for d in range(a.dim())))
            return out
        if ax is None:
            out = fn(a32.reshape(-1), qq, dim=0, interpolation=interpolation)
            return out.reshape(qq.shape + (1,) * a.dim()) if keepdim else out
        return fn(a32, qq, dim=ax, keepdim=keepdim, interpolation=interpolation)

    return unary_op(name, f, x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return _quantile("quantile", x, q, axis, keepdim, interpolation, torch.quantile)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return _quantile("nanquantile", x, q, axis, keepdim, interpolation, torch.nanquantile)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)

    def f(a):
        out = torch.count_nonzero(a, dim=dims(ax, a.dim())).to(torch.int32)
        if keepdim:
            for d in sorted(d % a.dim() for d in dims(ax, a.dim())):
                out = out.unsqueeze(d)
        return out

    return unary_op("count_nonzero", f, x)


def bincount(x, weights=None, minlength=0, name=None):
    a = data_of(x)
    w = None if weights is None else np_of(weights)
    out = np.bincount(np_of(a), weights=w, minlength=minlength)
    return _host(out.astype(np.int32) if w is None else out.astype(w.dtype), a)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False, name=None):
    a = data_of(input)
    arr = np_of(a)
    lo, hi = (min, max) if (min != 0 or max != 0) else (arr.min(), arr.max())
    w = None if weight is None else np_of(weight)
    hist, _ = np.histogram(arr, bins=bins, range=(lo, hi), weights=w, density=density)
    return _host(hist.astype(np.float32) if density else hist.astype(np.int32), a)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    a = data_of(x)
    w = None if weights is None else np_of(weights)
    hist, edges = np.histogramdd(np_of(a), bins=bins, range=ranges, density=density, weights=w)
    return (_host(hist.astype(np.float32), a),
            [_host(e.astype(np.float32), a) for e in edges])


def numel(x, name=None):
    d = data_of(x)
    return Tensor._wrap(torch.tensor(d.numel(), dtype=torch.int32, device=d.device))

