"""Shape and layout manipulation ops (port of
``paddle_tpu/ops/manipulation.py``).

Torch expressions of the JAX package's jnp ones.  Ops whose output shape
depends on the data (``masked_select``, ``nonzero``, ``unique``, ...) run
on the host as there, and index outputs are int32.  ``as_strided`` and
``unfold`` are the strided views of the reference as the JAX package
builds them: a gather over the flattened storage, so overlapping windows
scatter-add their gradients and an index past the storage raises.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.tensor import Tensor
from .common import apply, axis_or_none, data_of, int_list, np_of, unary_op

__all__ = [
    "reshape", "reshape_", "transpose", "flatten", "squeeze", "unsqueeze",
    "concat", "stack", "split", "tensor_split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll", "gather", "gather_nd",
    "scatter", "scatter_", "scatter_nd", "scatter_nd_add", "index_select", "index_add",
    "index_put", "masked_select", "masked_fill", "masked_scatter", "where",
    "take_along_axis", "put_along_axis", "slice", "strided_slice", "crop", "pad",
    "unstack", "unbind", "repeat_interleave", "cast", "moveaxis", "swapaxes",
    "unique", "unique_consecutive", "nonzero", "as_complex", "as_real", "view", "view_as",
    "unfold", "as_strided", "flatten_", "squeeze_", "unsqueeze_", "unflatten", "atleast_1d",
    "atleast_2d", "atleast_3d", "diag_embed", "index_fill", "select_scatter",
]


def rebind_(x: Tensor, out: Tensor) -> Tensor:
    """In-place op semantics without mutating storage: ``x`` takes ``out``'s
    tensor (and graph), as the JAX ``inplace_rebind_``."""
    x._data = out._data
    return x


def _host(t: np.ndarray, ref: torch.Tensor) -> Tensor:
    """A host result back on ``ref``'s device (int64 -> int32)."""
    if t.dtype == np.int64:
        t = t.astype(np.int32)
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(t)).to(ref.device))


def reshape(x, shape, name=None):
    s = int_list(shape)
    return unary_op("reshape", lambda a: torch.reshape(a, s), x)


def reshape_(x, shape, name=None):
    return rebind_(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = convert_dtype(shape_or_dtype)
    return unary_op("view_dtype", lambda a: a.contiguous().view(d), x)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def transpose(x, perm=None, name=None):
    p = int_list(perm)
    return unary_op("transpose", lambda a: a.permute(*(p if p is not None
                                                       else range(a.dim())[::-1])), x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        nd = a.dim()
        if nd == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis % nd, stop_axis % nd)

    return unary_op("flatten", f, x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return rebind_(x, flatten(x, start_axis, stop_axis))


def unflatten(x, axis, shape, name=None):
    s = int_list(shape)
    return unary_op("unflatten", lambda a: torch.unflatten(a, axis % a.dim(), s), x)


def squeeze(x, axis=None, name=None):
    ax = axis_or_none(axis)

    def f(a):
        if ax is None:
            return torch.squeeze(a)
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a_ % a.dim() for a_ in axes if a.shape[a_ % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a

    return unary_op("squeeze", f, x)


def squeeze_(x, axis=None, name=None):
    return rebind_(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    ax = axis_or_none(axis)
    axes = ax if isinstance(ax, tuple) else (ax,)

    def f(a):
        nd = a.dim() + len(axes)
        out = a
        for d in sorted(d % nd for d in axes):
            out = out.unsqueeze(d)
        return out

    return unary_op("unsqueeze", f, x)


def unsqueeze_(x, axis, name=None):
    return rebind_(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply("concat", lambda *xs: torch.cat(xs, dim=ax), *x)


def stack(x, axis=0, name=None):
    return apply("stack", lambda *xs: torch.stack(xs, dim=axis), *x)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    dim = data_of(x).shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if any(s == -1 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    return list(apply("split", lambda a: tuple(torch.split(a, sizes, dim=ax)), x))


def tensor_split(x, num_or_indices, axis=0, name=None):
    ax = int(axis)
    dim = data_of(x).shape[ax]
    if isinstance(num_or_indices, int):
        base, rem = divmod(dim, num_or_indices)
        return split(x, [base + (1 if i < rem else 0) for i in range(num_or_indices)], ax)
    idx = [0] + list(num_or_indices) + [dim]
    return split(x, [idx[i + 1] - idx[i] for i in range(len(idx) - 1)], ax)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    r = int_list(repeat_times)
    return unary_op("tile", lambda a: torch.tile(a, r), x)


def expand(x, shape, name=None):
    s = int_list(shape)

    def f(a):
        target = list(s)
        for i in range(len(target)):
            if target[i] == -1:
                target[i] = a.shape[i - len(target) + a.dim()]
        return torch.broadcast_to(a, target)

    return unary_op("expand", f, x)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(apply("broadcast_tensors", lambda *xs: tuple(torch.broadcast_tensors(*xs)),
                      *inputs))


def flip(x, axis, name=None):
    ax = axis_or_none(axis)
    return unary_op("flip", lambda a: torch.flip(a, ax if isinstance(ax, tuple) else (ax,)), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return unary_op("rot90", lambda a: torch.rot90(a, k, list(axes)), x)


def roll(x, shifts, axis=None, name=None):
    sh = int_list(shifts)
    sh = sh[0] if len(sh) == 1 and not isinstance(shifts, (list, tuple)) else sh
    ax = axis_or_none(axis)
    return unary_op("roll", lambda a: torch.roll(a, sh, ax), x)


def _as_t(v):
    return v if isinstance(v, (Tensor, torch.Tensor)) else Tensor(v)


def gather(x, index, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply("gather", lambda a, i: torch.index_select(a, ax, i.reshape(-1).long()),
                 x, _as_t(index))


def gather_nd(x, index, name=None):
    return apply("gather_nd", lambda a, idx: a[tuple(idx.long().movedim(-1, 0))],
                 x, _as_t(index))


def scatter(x, index, updates, overwrite=True, name=None):
    def f(a, idx, upd):
        idx = idx.reshape(-1).long()
        if overwrite:
            return a.index_put((idx,), upd.to(a.dtype))
        return a.index_put((idx,), upd.to(a.dtype), accumulate=True)

    return apply("scatter", f, x, _as_t(index), _as_t(updates))


def scatter_(x, index, updates, overwrite=True, name=None):
    return rebind_(x, scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    s = int_list(shape)

    def f(idx, upd):
        zeros = torch.zeros(s, dtype=upd.dtype, device=upd.device)
        return zeros.index_put(tuple(idx.long().movedim(-1, 0)), upd, accumulate=True)

    return apply("scatter_nd", f, _as_t(index), _as_t(updates))


def scatter_nd_add(x, index, updates, name=None):
    return apply("scatter_nd_add",
                 lambda a, idx, upd: a.index_put(tuple(idx.long().movedim(-1, 0)),
                                                 upd.to(a.dtype), accumulate=True),
                 x, _as_t(index), _as_t(updates))


def index_select(x, index, axis=0, name=None):
    return apply("index_select",
                 lambda a, i: torch.index_select(a, axis, i.reshape(-1).long())
                 .reshape(a.shape[:axis % a.dim()] + i.shape + a.shape[axis % a.dim() + 1:]),
                 x, _as_t(index))


def index_add(x, index, axis, value, name=None):
    return apply("index_add", lambda a, i, v: a.index_add(axis, i.long(), v.to(a.dtype)),
                 x, _as_t(index), _as_t(value))


def index_fill(x, index, axis, fill_value, name=None):
    return apply("index_fill", lambda a, i: a.index_fill(axis, i.long(), fill_value),
                 x, _as_t(index))


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(data_of(i).long() if data_of(i).dtype != torch.bool else data_of(i)
                for i in indices)
    return apply("index_put", lambda a, v: a.index_put(idx, v.to(a.dtype), accumulate=accumulate),
                 x, _as_t(value))


def masked_select(x, mask, name=None):
    a = data_of(x)
    return Tensor._wrap(a[data_of(mask, a).to(torch.bool)])


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, Tensor) and value.ndim == 0 else value
    if isinstance(v, Tensor):
        return apply("masked_fill", lambda a, m, val: torch.where(m.bool(), val.to(a.dtype), a),
                     x, _as_t(mask), v)
    return apply("masked_fill",
                 lambda a, m: torch.where(m.bool(), torch.tensor(v, dtype=a.dtype,
                                                                 device=a.device), a),
                 x, _as_t(mask))


def masked_scatter(x, mask, value, name=None):
    m = data_of(mask).to(torch.bool)

    def f(a, v):
        mm = torch.broadcast_to(m, a.shape)
        flat_idx = torch.cumsum(mm.reshape(-1).long(), 0) - 1
        src = v.reshape(-1)[:mm.numel()]
        picked = src[torch.clamp(flat_idx, 0, src.shape[0] - 1)].reshape(a.shape)
        return torch.where(mm, picked.to(a.dtype), a)

    return apply("masked_scatter", f, x, _as_t(value))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    cond = _as_t(condition)

    def const(v, like):
        return torch.tensor(v, dtype=like.dtype if like is not None else None,
                            device=data_of(cond).device)

    if not isinstance(x, (Tensor, torch.Tensor)) and not isinstance(y, (Tensor, torch.Tensor)):
        xv, yv = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        return apply("where", lambda c: torch.where(c.bool(), xv.to(c.device), yv.to(c.device)),
                     cond)
    if not isinstance(x, (Tensor, torch.Tensor)):
        return apply("where", lambda c, b: torch.where(c.bool(), const(x, b), b), cond, y)
    if not isinstance(y, (Tensor, torch.Tensor)):
        return apply("where", lambda c, a: torch.where(c.bool(), a, const(y, a)), cond, x)
    return apply("where", lambda c, a, b: torch.where(c.bool(), a, b), cond, x, y)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(a, i):
        i = i.long()
        shape = [max(s, t) if d != axis % a.dim() else t
                 for d, (s, t) in enumerate(zip(a.shape, i.shape))]
        a_b = a.expand([s if d != axis % a.dim() else a.shape[d] for d, s in enumerate(shape)])
        return torch.take_along_dim(a_b, i.expand(shape), dim=axis)

    return apply("take_along_axis", f, arr, _as_t(indices))


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True, name=None):
    def f(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v, i.shape) if v.dim() else torch.full(
            i.shape, v.item(), dtype=a.dtype, device=a.device)
        v = v.to(a.dtype)
        if reduce == "assign":
            return a.scatter(axis, i, v)
        mode = {"add": "sum", "multiply": "prod", "mul": "prod", "amax": "amax",
                "amin": "amin"}[reduce]
        return a.scatter_reduce(axis, i, v, mode, include_self=True)

    return apply("put_along_axis", f, arr, _as_t(indices), _as_t(values))


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = int_list(axes), int_list(starts), int_list(ends)

    def f(a):
        out = a
        for ax, st, en in zip(axes, starts, ends):
            dim = a.shape[ax]
            st2 = builtins.max(st + dim, 0) if st < 0 else builtins.min(st, dim)
            en2 = builtins.max(en + dim, 0) if en < 0 else builtins.min(en, dim)
            out = out.narrow(ax, st2, builtins.max(en2 - st2, 0))
        return out

    return unary_op("slice", f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends = int_list(axes), int_list(starts), int_list(ends)
    steps = int_list(strides)

    def f(a):
        out = a
        for ax, st, en, sd in zip(axes, starts, ends, steps):
            idx = np.arange(a.shape[ax])[builtins.slice(st, en, sd)]
            out = torch.index_select(out, ax, torch.as_tensor(idx, device=a.device))
        return out

    return unary_op("strided_slice", f, x)


def crop(x, shape=None, offsets=None, name=None):
    s = int_list(shape)
    o = int_list(offsets) or [0] * len(s)

    def f(a):
        out = a
        for i in range(len(s)):
            size = a.shape[i] if s[i] == -1 else s[i]
            start = builtins.min(builtins.max(o[i], 0), a.shape[i] - size)
            out = out.narrow(i, start, size)
        return out

    return unary_op("crop", f, x)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    p = int_list(pad)

    def f(a):
        if len(p) == 2 * a.dim():
            width = [(p[2 * i], p[2 * i + 1]) for i in range(a.dim())]
        else:
            # the last len(p) // 2 spatial dims in NC* order (innermost-first
            # pairs), or the leading ones after N in N*C order
            n_spatial = len(p) // 2
            width = [(0, 0)] * a.dim()
            if data_format.startswith("NC"):
                dims = range(a.dim() - n_spatial, a.dim())
            else:
                dims = range(1, 1 + n_spatial)
            for j, d in enumerate(reversed(list(dims))):
                width[d] = (p[2 * j], p[2 * j + 1])
        flat = [v for lo_hi in reversed(width) for v in lo_hi]
        if mode == "constant":
            return torch.nn.functional.pad(a, flat, mode="constant", value=value)
        tmode = {"reflect": "reflect", "replicate": "replicate", "circular": "circular"}[mode]
        lead = [i for i, w in enumerate(width) if w != (0, 0)]
        # torch pads the trailing dims of a batched input: move the padded
        # dims last and add the batch axes torch's modes want
        k = len(lead)
        moved = a.movedim(lead, list(range(a.dim() - k, a.dim())))
        batch = moved.shape[:a.dim() - k]
        b = moved.reshape((1, -1) + moved.shape[a.dim() - k:])
        fl = [v for d in reversed(lead) for v in width[d]]
        out = torch.nn.functional.pad(b, fl, mode=tmode)
        out = out.reshape(tuple(batch) + out.shape[2:])
        return out.movedim(list(range(a.dim() - k, a.dim())), lead)

    return unary_op("pad", f, x)


def unstack(x, axis=0, num=None, name=None):
    return list(apply("unstack", lambda a: tuple(torch.unbind(a, axis)), x))


def unbind(input, axis=0, name=None):
    return unstack(input, axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        r = repeats._data.long()
        return apply("repeat_interleave",
                     lambda a: torch.repeat_interleave(a if axis is not None else a.reshape(-1),
                                                       r, dim=axis if axis is not None else 0),
                     x)
    return apply("repeat_interleave", lambda a: torch.repeat_interleave(a, repeats, dim=axis),
                 x)


def cast(x, dtype, name=None):
    return x.astype(dtype)


def moveaxis(x, source, destination, name=None):
    return unary_op("moveaxis", lambda a: torch.movedim(a, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return unary_op("swapaxes", lambda a: torch.swapaxes(a, axis0, axis1), x)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    a = data_of(x)
    res = np.unique(np_of(a), return_index=return_index, return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _host(res, a)
    return tuple(_host(r, a) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    ref = data_of(x)
    a = np_of(ref)
    if axis is None:
        a = a.reshape(-1)
        ax = 0
    else:
        ax = axis
    mask = np.ones(a.shape[ax], dtype=bool)
    if a.shape[ax] > 1:
        sliced = np.moveaxis(a, ax, 0)
        eq = (sliced[1:] == sliced[:-1]).reshape(sliced.shape[0] - 1, -1).all(axis=1)
        mask[1:] = ~eq
    results = [_host(np.compress(mask, a, axis=ax), ref)]
    if return_inverse:
        results.append(_host(np.cumsum(mask) - 1, ref))
    if return_counts:
        idx = np.flatnonzero(mask)
        results.append(_host(np.diff(np.append(idx, a.shape[ax])), ref))
    return results[0] if len(results) == 1 else tuple(results)


def nonzero(x, as_tuple=False, name=None):
    a = data_of(x)
    nz = torch.nonzero(a).to(torch.int32)
    if as_tuple:
        return tuple(Tensor._wrap(nz[:, i].contiguous()) for i in range(a.dim()))
    return Tensor._wrap(nz)


def as_complex(x, name=None):
    return unary_op("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return unary_op("as_real", lambda a: torch.stack([a.real, a.imag], dim=-1), x)


def as_strided(x, shape, stride, offset=0, name=None):
    """Strided view (reference ``tensor/manipulation.py:6959``) as a gather
    over the flattened storage: out[i0, i1, ...] = flat[offset + sum(i_k
    stride_k)], overlapping windows included; an index outside the storage
    raises, as the reference."""
    shape, stride = int_list(shape), int_list(stride)
    if len(shape) != len(stride):
        raise ValueError(f"shape rank {len(shape)} != stride rank {len(stride)}")
    max_index = offset + builtins.sum((s - 1) * st for s, st in zip(shape, stride)
                                      if st > 0 and s > 0)
    min_index = offset + builtins.sum((s - 1) * st for s, st in zip(shape, stride)
                                      if st < 0 and s > 0)
    n_elems = int(np.prod(data_of(x).shape))
    if 0 not in shape and (min_index < 0 or max_index >= n_elems):
        raise ValueError(
            f"as_strided out of bounds: flat index range [{min_index}, {max_index}] "
            f"(offset {offset}) on a tensor of {n_elems} elements")

    def f(a):
        lin = torch.full((), offset, dtype=torch.long, device=a.device)
        for k, (s, st) in enumerate(zip(shape, stride)):
            view = [1] * len(shape)
            view[k] = s
            lin = lin + (torch.arange(s, device=a.device) * st).reshape(view)
        return a.reshape(-1)[lin]

    return unary_op("as_strided", f, x)


def unfold(x, axis, size, step, name=None):
    """Every ``size``-wide window along ``axis`` at stride ``step``, on a new
    last dim (reference ``tensor/manipulation.py:7110``)."""
    if step <= 0:
        raise ValueError(f"unfold step must be positive, got {step}")
    shape = data_of(x).shape
    dim = shape[axis % len(shape)]
    if size > dim:
        raise ValueError(f"unfold size {size} exceeds dim {dim} of axis {axis}")

    def f(a):
        ax = axis % a.dim()
        n_windows = (a.shape[ax] - size) // step + 1
        idx = (torch.arange(n_windows, device=a.device)[:, None] * step
               + torch.arange(size, device=a.device)[None, :])
        out = torch.index_select(a, ax, idx.reshape(-1))
        out = out.reshape(a.shape[:ax] + (n_windows, size) + a.shape[ax + 1:])
        return out.movedim(ax + 1, -1)

    return unary_op("tensor_unfold", f, x)


def _atleast(name, fn, inputs):
    outs = [unary_op(name, fn, t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    def f(a):
        # jnp puts a 1-D input at [1, n, 1] and a 2-D at [m, n, 1]
        if a.dim() == 0:
            return a.reshape(1, 1, 1)
        if a.dim() == 1:
            return a.reshape(1, -1, 1)
        if a.dim() == 2:
            return a[..., None]
        return a

    return _atleast("atleast_3d", f, inputs)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    def f(a):
        n = a.shape[-1]
        m = n + builtins.abs(offset)
        rows = torch.arange(n, device=a.device) + (builtins.abs(offset) if offset < 0 else 0)
        cols = torch.arange(n, device=a.device) + (offset if offset > 0 else 0)
        full = torch.zeros(a.shape[:-1] + (m, m), dtype=a.dtype, device=a.device)
        full[..., rows, cols] = a
        if (dim1, dim2) != (-2, -1):
            full = torch.movedim(full, (-2, -1), (dim1, dim2))
        return full

    return unary_op("diag_embed", f, input)


def select_scatter(x, values, axis, index, name=None):
    return apply("select_scatter",
                 lambda a, v: torch.select_scatter(a, v.to(a.dtype), axis, index),
                 x, _as_t(values))
