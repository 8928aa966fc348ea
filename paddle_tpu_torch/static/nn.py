"""``paddle.static.nn``: layer builders and graph control flow (port of
``paddle_tpu/static/nn.py``).

The builders instantiate the ordinary layers: their parameters exist at
creation, and the Program reads them through the recorded layer call, so
``fc(x, 10)`` is ``nn.Linear`` and a call, not a second implementation.
The ops of their own (``bilinear_tensor_product``, ``row_conv``,
``data_norm``, ``nce``, ``spectral_norm``, the ``sequence_*`` family) are
torch expressions recorded through the op namespace's seam
(``ops.common.apply``), under the JAX package's op names.  Control flow:

- ``cond`` / ``case`` / ``switch_case`` record every branch once and select
  the result (``torch.where``), as the JAX package lowers them;
- ``while_loop`` records one op that runs the loop when the Program runs:
  ``cond`` and ``body`` are called on the loop-carried values, which keep
  their shapes and dtypes (the op's shape rule).  Everything the body reads
  must flow through ``loop_vars`` (the reference's rule too).

The LoD ``sequence_*`` ops work on padded dense ``[batch, time, ...]``
tensors with optional per-row lengths, as in the JAX package.
``deform_conv2d`` needs ``vision.ops``, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.tensor import Tensor, unwrap, wrap
from ..ops.common import apply

__all__ = [
    "fc", "batch_norm", "bilinear_tensor_product", "embedding", "case",
    "cond", "static_pylayer", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "sparse_embedding",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
]


def _t(x) -> Tensor:
    return x if isinstance(x, Tensor) else Tensor(x)


def _apply_act(out, activation):
    if activation is None:
        return out
    from ..nn import functional as F

    return getattr(F, activation)(out)


# ---------------------------------------------------------------------------
# layer builders (each call creates fresh parameters, as the reference's
# builders append new variables to the Program)
# ---------------------------------------------------------------------------

def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None, activation=None,
       name=None):
    """Reference ``static.nn.fc``: flatten the trailing dims, Linear,
    activation."""
    from ..nn import Linear

    xt = _t(x)
    shape = xt.shape
    if num_flatten_dims < 0:
        num_flatten_dims = len(shape) + num_flatten_dims
    in_features = int(np.prod(shape[num_flatten_dims:]))
    if len(shape) > num_flatten_dims + 1:
        xt = xt.reshape(list(shape[:num_flatten_dims]) + [in_features])
    layer = Linear(in_features, size, weight_attr=weight_attr, bias_attr=bias_attr)
    return _apply_act(layer(xt), activation)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05, param_attr=None,
               bias_attr=None, data_layout="NCHW", in_place=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True, use_global_stats=False):
    from ..nn import BatchNorm

    xt = _t(input)
    c_axis = len(xt.shape) - 1 if data_layout in ("NHWC", "NLC", "NDHWC") else 1
    layer = BatchNorm(int(xt.shape[c_axis]), momentum=momentum, epsilon=epsilon,
                      weight_attr=param_attr, bias_attr=bias_attr, data_format=data_layout,
                      use_global_stats=use_global_stats or None)
    layer.train() if not is_test else layer.eval()
    return _apply_act(layer(xt), act)


def _conv(cls, input, num_filters, filter_size, stride, padding, dilation, groups,
          param_attr, bias_attr, act, data_format, channels_last):
    xt = _t(input)
    c_axis = len(xt.shape) - 1 if data_format == channels_last else 1
    layer = cls(int(xt.shape[c_axis]), num_filters, filter_size, stride=stride,
                padding=padding, dilation=dilation, groups=groups, weight_attr=param_attr,
                bias_attr=bias_attr, data_format=data_format)
    return _apply_act(layer(xt), act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCHW"):
    from ..nn import Conv2D

    return _conv(Conv2D, input, num_filters, filter_size, stride, padding, dilation, groups,
                 param_attr, bias_attr, act, data_format, "NHWC")


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1,
                     padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None, data_format="NCHW"):
    from ..nn import Conv2DTranspose

    return _conv(Conv2DTranspose, input, num_filters, filter_size, stride, padding, dilation,
                 groups, param_attr, bias_attr, act, data_format, "NHWC")


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCDHW"):
    from ..nn import Conv3D

    return _conv(Conv3D, input, num_filters, filter_size, stride, padding, dilation, groups,
                 param_attr, bias_attr, act, data_format, "NDHWC")


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1,
                     padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    from ..nn import Conv3DTranspose

    return _conv(Conv3DTranspose, input, num_filters, filter_size, stride, padding, dilation,
                 groups, param_attr, bias_attr, act, data_format, "NDHWC")


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    from ..nn import Embedding

    layer = Embedding(size[0], size[1], padding_idx=padding_idx, weight_attr=param_attr)
    return layer(_t(input))


def sparse_embedding(input, size, padding_idx=None, is_test=False, entry=None,
                     table_class="MemorySparseTable", param_attr=None, dtype="float32",
                     slot=None):
    """The reference's parameter-server embedding; on one card a dense
    embedding lookup."""
    return embedding(input, size, padding_idx=padding_idx, param_attr=param_attr, dtype=dtype)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-05,
               param_attr=None, bias_attr=None, act=None, name=None):
    from ..framework.param_attr import create_parameter
    from ..nn import functional as F

    xt = _t(input)
    norm_shape = [int(s) for s in xt.shape[begin_norm_axis:]]
    w = create_parameter(norm_shape, "float32", attr=param_attr) if scale else None
    b = create_parameter(norm_shape, "float32", attr=bias_attr, is_bias=True) if shift else None
    return _apply_act(F.layer_norm(xt, norm_shape, weight=w, bias=b, epsilon=epsilon), act)


def group_norm(input, groups, epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               data_layout="NCHW", name=None):
    from ..nn import GroupNorm

    xt = _t(input)
    c_axis = len(xt.shape) - 1 if data_layout == "NHWC" else 1
    layer = GroupNorm(groups, int(xt.shape[c_axis]), epsilon=epsilon, weight_attr=param_attr,
                      bias_attr=bias_attr)
    return _apply_act(layer(xt), act)


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None, name=None):
    from ..nn import InstanceNorm2D

    xt = _t(input)
    layer = InstanceNorm2D(int(xt.shape[1]), epsilon=epsilon, weight_attr=param_attr,
                           bias_attr=bias_attr)
    return layer(xt)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..framework.param_attr import create_parameter
    from ..nn import functional as F
    from ..nn.initializer import Constant

    xt = _t(x)
    if mode == "all":
        n = 1
    elif mode == "channel":
        n = int(xt.shape[-1 if data_format == "NHWC" else 1])
    else:  # element
        n = int(np.prod(xt.shape[1:]))
    alpha = create_parameter([n], "float32", attr=param_attr,
                             default_initializer=Constant(0.25))
    return F.prelu(xt, alpha, data_format=data_format)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1, padding=0,
                  dilation=1, groups=1, deformable_groups=1, im2col_step=1, param_attr=None,
                  bias_attr=None, name=None):
    raise NotImplementedError(
        "static.nn.deform_conv2d calls vision.ops.deform_conv2d, which paddle_tpu_torch "
        "does not have yet (ROADMAP: vision/ops.py)")


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None, bias_attr=None):
    """``out[., k] = x^T W_k y + b_k`` (reference ``bilinear_tensor_product``)."""
    from ..framework.param_attr import create_parameter

    xt, yt = _t(x), _t(y)
    d1, d2 = int(xt.shape[-1]), int(yt.shape[-1])
    w = create_parameter([size, d1, d2], "float32", attr=param_attr)
    b = create_parameter([size], "float32", attr=bias_attr, is_bias=True)

    def f(a, c, W, bias):
        out = torch.einsum("bi,kij,bj->bk", a.float(), W.float(), c.float())
        return (out + bias.float()).to(a.dtype)

    return _apply_act(apply("bilinear_tensor_product", f, xt, yt, w, b), act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference ``row_conv``): ``out[t] =
    sum_j w[j] * x[t + j]`` over a [B, T, D] input."""
    from ..framework.param_attr import create_parameter

    xt = _t(input)
    d = int(xt.shape[-1])
    k = future_context_size + 1
    w = create_parameter([k, d], "float32", attr=param_attr)

    def f(a, wt):
        a32 = a.float()
        pad = TF.pad(a32, (0, 0, 0, k - 1))
        out = sum(pad[:, j:j + a.shape[1], :] * wt[j].float() for j in range(k))
        return out.to(a.dtype)

    return _apply_act(apply("row_conv", f, xt, w), act)


def data_norm(input, act=None, epsilon=1e-05, param_attr=None, data_layout="NCHW",
              in_place=False, name=None, slot_dim=-1, summary_decay_rate=0.9999999,
              sync_stats=False, enable_scale_and_shift=False):
    """Accumulated-statistics normalisation (reference CTR ``data_norm``):
    batch_size / batch_sum / batch_square_sum accumulators are carried
    Program state; the output is normalised by their mean and std."""
    from ..framework.param_attr import create_parameter
    from ..nn.initializer import Constant

    xt = _t(input)
    d = int(xt.shape[-1])
    size = create_parameter([d], "float32", default_initializer=Constant(1e4))
    ssum = create_parameter([d], "float32", default_initializer=Constant(0.0))
    sqsum = create_parameter([d], "float32", default_initializer=Constant(1e4))
    for p in (size, ssum, sqsum):
        p.stop_gradient = True

    def f(a, n, s, sq):
        a32 = a.float()
        mean = s / n
        scale = torch.sqrt(n / torch.clamp_min(sq - n * mean * mean, epsilon))
        out = (a32 - mean) * scale
        return (out.to(a.dtype), n + a.shape[0], s + a32.sum(0), sq + (a32 * a32).sum(0))

    out, new_n, new_s, new_sq = apply("data_norm", f, xt, size, ssum, sqsum)
    size._data, ssum._data, sqsum._data = new_n._data, new_s._data, new_sq._data
    return _apply_act(out, act)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None, bias_attr=None,
        num_neg_samples=10, name=None, sampler="uniform", custom_dist=None, seed=0,
        is_sparse=False):
    """Noise-contrastive estimation loss (reference ``static.nn.nce``):
    logistic discrimination of the true class from sampled noise classes.
    The negatives are drawn once, when the Program is built, from ``seed``
    (as in the JAX package; vary ``seed`` to reshuffle)."""
    from ..framework.param_attr import create_parameter

    xt, lt = _t(input), _t(label)
    d = int(xt.shape[-1])
    w = create_parameter([num_total_classes, d], "float32", attr=param_attr)
    b = create_parameter([num_total_classes], "float32", attr=bias_attr, is_bias=True)
    rng = np.random.default_rng(seed or 0)
    if sampler == "custom_dist" and custom_dist is not None:
        p = np.asarray(custom_dist, np.float64)
        neg = rng.choice(num_total_classes, size=num_neg_samples, p=p / p.sum())
    else:
        neg = rng.integers(0, num_total_classes, size=num_neg_samples)
    neg = [int(i) for i in neg]

    def f(a, lab, W, bias):
        a32 = a.float()
        li = lab.long().reshape(-1)
        ni = torch.tensor(neg, dtype=torch.long, device=a.device)
        pos_logit = (a32 * W[li].float()).sum(-1) + bias[li]
        neg_logit = a32 @ W[ni].float().T + bias[ni]
        pos_loss = TF.softplus(-pos_logit)
        neg_loss = TF.softplus(neg_logit).sum(-1)
        return (pos_loss + neg_loss).reshape(-1, 1)

    return apply("nce", f, xt, lt, w, b)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Spectral normalisation of a weight (reference ``spectral_norm``):
    power iteration estimates sigma_max; the u / v vectors are carried
    Program state, updated at each run."""
    from ..framework.param_attr import create_parameter
    from ..nn.initializer import Normal

    wt = _t(weight)
    shape = [int(s) for s in wt.shape]
    h = shape[dim]
    w_dim = int(np.prod(shape)) // h
    u = create_parameter([h], "float32", default_initializer=Normal(0.0, 1.0))
    v = create_parameter([w_dim], "float32", default_initializer=Normal(0.0, 1.0))
    u.stop_gradient = True
    v.stop_gradient = True

    def f(W, u0, v0):
        Wm = torch.movedim(W.float(), dim, 0).reshape(h, w_dim)
        uu, vv = u0, v0
        for _ in range(max(1, power_iters)):
            vv = Wm.T @ uu
            vv = vv / (torch.linalg.norm(vv) + eps)
            uu = Wm @ vv
            uu = uu / (torch.linalg.norm(uu) + eps)
        sigma = uu @ Wm @ vv
        return (W / sigma).to(W.dtype), uu, vv

    out, new_u, new_v = apply("spectral_norm", f, wt, u, v)
    u._data, v._data = new_u._data, new_v._data
    return out


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def _select_leaves(pred, t_out, f_out):
    if t_out is None and f_out is None:
        return None
    if isinstance(t_out, (list, tuple)):
        return type(t_out)(_select_leaves(pred, a, b) for a, b in zip(t_out, f_out))

    def f(c, a, b):
        c = c.reshape((1,) * a.dim()) if c.dim() <= a.dim() and c.numel() == 1 else c
        return torch.where(c.bool(), a, b)

    return apply("select", f, _t(pred), _t(t_out), _t(f_out))


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """Data-dependent branch (reference ``static.nn.cond``): both branches
    are recorded (pure functions, as the reference asks too) and the outputs
    selected on ``pred``."""
    t_out = true_fn() if true_fn is not None else None
    f_out = false_fn() if false_fn is not None else None
    if (t_out is None) != (f_out is None):
        raise ValueError("cond branches must both return values or neither")
    return _select_leaves(pred, t_out, f_out)


def case(pred_fn_pairs, default=None, name=None):
    """First-match multi-branch (reference ``static.nn.case``).  Every
    branch is built exactly once (builders create parameters a call)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    pairs = [(pred, fn()) for pred, fn in pred_fn_pairs]
    result = default() if default is not None else pairs[-1][1]
    for pred, out in reversed(pairs):
        result = _select_leaves(pred, out, result)
    return result


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Indexed multi-branch (reference ``static.nn.switch_case``); each
    branch built exactly once."""
    items = sorted(branch_fns.items()) if isinstance(branch_fns, dict) else \
        list(enumerate(branch_fns))
    bi = _t(branch_index)
    pairs = [(idx, fn()) for idx, fn in items]
    result = default() if default is not None else pairs[-1][1]
    for idx, out in reversed(pairs):
        result = _select_leaves(bi == idx, out, result)
    return result


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Graph loop (reference ``static.nn.while_loop``): one recorded op that
    runs the loop at each run; everything the body reads flows through
    ``loop_vars``."""
    tensors = [_t(v) for v in loop_vars]

    def f(*vals):
        if vals[0].device.type == "meta":
            return tuple(vals)      # the shape rule: the carried values keep theirs
        vals = list(vals)
        while True:
            c = cond(*wrap(vals))
            c = c[0] if isinstance(c, (list, tuple)) else c
            if not bool(unwrap(c)):
                return tuple(vals)
            outs = body(*wrap(vals))
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            vals = [o.to(v.dtype) for o, v in zip(unwrap(outs), vals)]

    return list(apply("while_loop", f, *tensors))


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """Reference ``static.nn.static_pylayer``: a forward function with an
    optional custom backward (the forward runs under no_grad without one)."""
    if backward_fn is None:
        with torch.no_grad():
            return forward_fn(*inputs)
    return forward_fn(*inputs)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    from . import py_func as _pf

    return _pf(func, x, out, backward_func, skip_vars_in_backward_input)


# ---------------------------------------------------------------------------
# sequence ops over padded dense [batch, time, ...] (+ optional lengths)
# ---------------------------------------------------------------------------

def _time_mask(a32, lengths, ndim):
    t = a32.shape[1]
    m = (torch.arange(t, device=a32.device)[None, :] < lengths.reshape(-1, 1)).float()
    while m.dim() < ndim:
        m = m[..., None]
    return m


def sequence_softmax(input, use_cudnn=False, name=None, lengths=None):
    xt = _t(input)
    if lengths is None:
        return apply("sequence_softmax",
                     lambda a: torch.softmax(a.float(), dim=1).to(a.dtype), xt)

    def f(a, ln):
        a32 = a.float()
        m = _time_mask(a32, ln, a32.dim())
        a32 = torch.where(m > 0, a32, torch.full_like(a32, -1e30))
        return (torch.softmax(a32, dim=1) * m).to(a.dtype)

    return apply("sequence_softmax", f, xt, _t(lengths))


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0, lengths=None):
    xt = _t(input)
    pool_type = pool_type.lower()
    args = (xt,) if lengths is None else (xt, _t(lengths))

    def f(a, *rest):
        a32 = a.float()
        m = _time_mask(a32, rest[0], a32.dim()) if rest else None
        if pool_type == "max":
            src = a32 if m is None else torch.where(m > 0, a32, torch.full_like(a32, -np.inf))
            out = src.amax(dim=1)
        elif pool_type in ("average", "avg"):
            out = a32.mean(1) if m is None else \
                (a32 * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
        elif pool_type == "sum":
            out = (a32 if m is None else a32 * m).sum(1)
        elif pool_type == "sqrt":
            n = torch.tensor(float(a.shape[1]), device=a.device) if m is None else m.sum(1)
            out = (a32 if m is None else a32 * m).sum(1) / torch.sqrt(torch.clamp_min(n, 1.0))
        elif pool_type == "first":
            out = a32[:, 0]
        elif pool_type == "last":
            if rest:
                idx = torch.clamp_min(rest[0].long() - 1, 0).reshape(-1)
                out = torch.take_along_dim(
                    a32, idx.reshape(-1, *([1] * (a32.dim() - 1))), dim=1)[:, 0]
            else:
                out = a32[:, -1]
        else:
            raise ValueError(f"unknown pool_type {pool_type!r}")
        return out.to(a.dtype)

    return apply("sequence_pool", f, *args)


def sequence_first_step(input, lengths=None):
    return sequence_pool(input, "first", lengths=lengths)


def sequence_last_step(input, lengths=None):
    return sequence_pool(input, "last", lengths=lengths)


def sequence_expand(x, y, ref_level=-1, name=None):
    """Dense form of LoD expand: ``x``'s per-row features broadcast across
    ``y``'s time axis."""
    def f(a, b):
        t = b.shape[1]
        if a.dim() == 2:
            return a[:, None, :].expand(a.shape[0], t, a.shape[1])
        return a.expand(a.shape[0], t, *a.shape[2:])

    return apply("sequence_expand", f, _t(x), _t(y))


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1, padding=True,
                  padding_start=None, bias_attr=None, param_attr=None, act=None, name=None):
    """Context-window convolution over time (reference ``sequence_conv``):
    each step sees ``filter_size`` neighbouring steps, centred by default
    (``padding_start = -floor(k / 2)``)."""
    from ..framework.param_attr import create_parameter

    xt = _t(input)
    d = int(xt.shape[-1])
    k = int(filter_size)
    w = create_parameter([k * d, num_filters], "float32", attr=param_attr)
    b = create_parameter([num_filters], "float32", attr=bias_attr, is_bias=True) \
        if bias_attr is not False else None
    start = -(k // 2) if padding_start is None else int(padding_start)

    def f(a, W, *bias):
        a32 = a.float()
        t = a.shape[1]
        pre, post = max(0, -start), max(0, start + k - 1)
        pad = TF.pad(a32, (0, 0, pre, post))
        ctx = torch.cat([pad[:, j:j + t, :] for j in range(k)], dim=-1)
        out = ctx @ W.float()
        if bias:
            out = out + bias[0].float()
        return out.to(a.dtype)

    args = (xt, w) + ((b,) if b is not None else ())
    return _apply_act(apply("sequence_conv", f, *args), act)
