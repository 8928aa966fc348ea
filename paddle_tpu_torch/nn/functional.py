"""``nn.functional`` (port of the subset of ``paddle_tpu/nn/functional.py``
the stock layers and the ERNIE and OCR recipes call).

Paddle's conventions, as in the JAX package: a linear weight is ``[in,
out]`` (``x @ w``); convolutions are NCHW with OIHW weights, a transposed
one ``[in, out // groups, kH, kW]``; attention takes ``[batch, seq, heads,
head_dim]``; losses compute in fp32.  Where the JAX package leaves the work
to XLA (convolutions, pools, norms, the GRU, CTC) the port uses stock torch
ops, cuDNN included.  Where the two libraries define an op differently,
the port follows the JAX package:

- :func:`interpolate` ``"nearest"`` is ``jax.image.resize``'s half-pixel
  rule (torch's ``"nearest-exact"``); ``"bilinear"`` without
  ``align_corners`` antialiases when it shrinks, as ``jax.image.resize``;
- :func:`batch_norm` updates the running statistics with the *biased*
  batch variance, ``momentum * old + (1 - momentum) * new``;
- :func:`ctc_loss` log-softmaxes raw logits itself, uses -1e30 as its log
  zero (an impossible alignment costs a huge finite loss) and its
  ``"mean"`` divides each loss by its label length clamped to >= 1;
- :func:`embedding` returns zeros at ``padding_idx``;
- :func:`scaled_dot_product_attention` ignores ``dropout_p``.

:func:`scaled_dot_product_attention` routes as the JAX package does: with
no mask, a head dim the port's flash kernel takes (32/64/128/256) and an
fp32 or bf16 input it calls ``kernels.flash_attention`` (the CUDA kernels
on a CUDA tensor, their plain versions on a CPU one); anything else runs
the plain ``_attention_reference``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import to_dtype
from ..framework.dispatch import amp_cast, checked_op
from ..framework.tensor import boundary
from ..incubate.nn.functional import dropout as _dropout
from ..kernels import flash_attention as _fa

__all__ = [
    "linear", "embedding", "dropout", "relu", "relu6", "gelu", "tanh", "sigmoid", "swish",
    "hardswish", "hardsigmoid", "softmax", "log_softmax", "channel_shuffle", "layer_norm", "batch_norm", "conv1d", "conv2d", "conv2d_transpose",
    "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d", "interpolate", "upsample",
    "cross_entropy", "binary_cross_entropy", "mse_loss", "ctc_loss",
    "scaled_dot_product_attention", "flash_attention",
]

NEG = -1e30


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(x, name=None):
    (x,) = amp_cast("relu", (x,))
    return torch.relu(x)


def relu6(x, name=None):
    """``min(max(x, 0), 6)``."""
    (x,) = amp_cast("relu6", (x,))
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    """Exact erf GELU; ``approximate=True`` the tanh form."""
    (x,) = amp_cast("gelu", (x,))
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    (x,) = amp_cast("tanh", (x,))
    return torch.tanh(x)


def sigmoid(x, name=None):
    (x,) = amp_cast("sigmoid", (x,))
    return torch.sigmoid(x)


def swish(x, name=None):
    """``x * sigmoid(x)`` (SiLU)."""
    (x,) = amp_cast("swish", (x,))
    return x * torch.sigmoid(x)


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    (x,) = amp_cast("hardswish", (x,))
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """Paddle's ``clip(slope * x + offset, 0, 1)``: its default slope is
    0.1666667, not torch's 1/6, so this is not ``F.hardsigmoid``."""
    (x,) = amp_cast("hardsigmoid", (x,))
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp_cast("softmax", (x,))
    return torch.softmax(x if dtype is None else x.to(to_dtype(dtype)), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp_cast("log_softmax", (x,))
    return torch.log_softmax(x if dtype is None else x.to(to_dtype(dtype)), dim=axis)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """NCHW channels ``[g0 c0, g0 c1, ..., g1 c0, ...]`` reordered to
    ``[g0 c0, g1 c0, ..., g0 c1, ...]``."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


# ---------------------------------------------------------------------------
# linear, embedding, dropout
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``, the weight ``[in_features, out_features]``."""
    x, weight, bias = amp_cast("linear", (x, weight, bias))
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; zeros where ``x == padding_idx`` (so that
    row gets no gradient), as the JAX package."""
    x, weight = amp_cast("embedding", (x, weight))
    idx = x.long()
    out = weight[idx]
    if padding_idx is not None:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None,
            generator: Optional[torch.Generator] = None):
    """Paddle's dropout (``incubate.nn.functional.dropout``): the mask is
    drawn from ``generator``.  A mask shared along axes (``axis``) is not
    ported."""
    if axis is not None:
        raise NotImplementedError("paddle_tpu_torch: dropout over chosen axes is not ported")
    (x,) = amp_cast("dropout", (x,))
    return _dropout(x, p, training=training, mode=mode, generator=generator)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05, name=None):
    """Over the last ``len(normalized_shape)`` axes, in fp32, cast back."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast("layer_norm", (x, weight, bias))
    f32 = torch.float32
    out = F.layer_norm(x.to(f32), list(normalized_shape),
                       None if weight is None else weight.to(f32),
                       None if bias is None else bias.to(f32), epsilon)
    return out.to(x.dtype)


def _channel_first(x, data_format):
    """``x`` with its channel axis at 1, and the inverse move."""
    if data_format in ("NHWC", "NLC", "NDHWC"):
        return x.movedim(-1, 1), (lambda y: y.movedim(1, -1))
    return x, (lambda y: y)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-05, data_format="NCHW", use_global_stats=None,
               name=None):
    """Batch statistics in training (unless ``use_global_stats``), the
    running ones otherwise; fp32 inside, cast back.  A training call
    updates ``running_mean`` / ``running_var`` in place, outside autograd,
    as the JAX package: ``momentum * old + (1 - momentum) * batch``, the
    batch variance biased (torch's own update would take the unbiased one
    and weigh the new value by ``momentum``)."""
    x, weight, bias = amp_cast("batch_norm", (x, weight, bias))
    x, back = _channel_first(x, data_format)
    use_batch = training and not use_global_stats
    f32 = torch.float32
    w = None if weight is None else weight.to(f32)
    b = None if bias is None else bias.to(f32)
    x32 = x.to(f32)
    if use_batch:
        out = F.batch_norm(x32, None, None, w, b, True, 0.0, epsilon)
        if running_mean is not None:
            with torch.no_grad():
                axes = [i for i in range(x.dim()) if i != 1]
                var, mu = torch.var_mean(x32.detach(), dim=axes, correction=0)
                running_mean.copy_(momentum * running_mean.to(f32) + (1 - momentum) * mu)
                running_var.copy_(momentum * running_var.to(f32) + (1 - momentum) * var)
    else:
        out = F.batch_norm(x32, running_mean.to(f32), running_var.to(f32), w, b, False, 0.0,
                           epsilon)
    return back(out.to(x.dtype))


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------

def _ntuple(v, n):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return [int(a) for a in (v * n if len(v) == 1 else v)]


def _same_pads(size, k, s, d):
    """XLA's ``"SAME"``: the output ``ceil(size / s)``, the padding split
    low-first."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_pads(padding, nd, spatial, kernel, stride, dilation):
    """``(symmetric, pads)``: ``symmetric`` a per-axis list torch's conv
    takes, or None with ``pads`` the (low, high) pairs for ``F.pad``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [0] * nd, None
        if mode != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        pairs = [_same_pads(spatial[i], kernel[i], stride[i], dilation[i]) for i in range(nd)]
    else:
        p = _ntuple(padding, nd)
        if len(p) == nd:
            return p, None
        if len(p) != 2 * nd:
            raise ValueError(f"bad padding {padding}")
        pairs = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    if all(lo == hi for lo, hi in pairs):
        return [lo for lo, _ in pairs], None
    return None, pairs


def _conv(x, weight, bias, stride, padding, dilation, groups, nd, data_format):
    x, weight, bias = amp_cast("conv", (x, weight, bias))
    x, back = _channel_first(x, data_format)
    st, dl = _ntuple(stride, nd), _ntuple(dilation, nd)
    sym, pairs = _conv_pads(padding, nd, x.shape[2:], weight.shape[2:], st, dl)
    if sym is None:
        x = F.pad(x, [v for lo, hi in reversed(pairs) for v in (lo, hi)])
        sym = [0] * nd
    conv = F.conv1d if nd == 1 else F.conv2d
    return back(conv(x, weight, bias, st, sym, dl, groups))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCL",
           name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCHW", name=None):
    """Weight ``[in, out // groups, kH, kW]`` (Paddle's and torch's layout);
    output ``(H - 1) s - 2 p + d (k - 1) + output_padding + 1`` a side.
    Asymmetric or string padding and ``output_size`` are not ported."""
    if output_size is not None or isinstance(padding, str):
        raise NotImplementedError("paddle_tpu_torch: conv2d_transpose takes numeric padding "
                                  "and no output_size")
    pad = _ntuple(padding, 2)
    if len(pad) != 2:
        raise NotImplementedError("paddle_tpu_torch: asymmetric conv2d_transpose padding")
    x, weight, bias = amp_cast("conv", (x, weight, bias))
    x, back = _channel_first(x, data_format)
    return back(F.conv_transpose2d(x, weight, bias, _ntuple(stride, 2), pad,
                                   _ntuple(output_padding, 2), groups, _ntuple(dilation, 2)))


def _pool_args(kernel_size, stride, padding):
    ks = _ntuple(kernel_size, 2)
    st = ks if stride is None else _ntuple(stride, 2)
    if isinstance(padding, str) or len(_ntuple(padding, 2)) != 2:
        raise NotImplementedError("paddle_tpu_torch: pools take symmetric numeric padding")
    return ks, st, _ntuple(padding, 2)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over windows, padding at -inf."""
    if return_mask:
        raise NotImplementedError("paddle_tpu_torch: max_pool2d(return_mask=True)")
    (x,) = amp_cast("max_pool2d", (x,))
    x, back = _channel_first(x, data_format)
    ks, st, pd = _pool_args(kernel_size, stride, padding)
    return back(F.max_pool2d(x, ks, st, pd, ceil_mode=ceil_mode))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """Mean over windows; ``exclusive`` leaves the padding out of the count."""
    (x,) = amp_cast("avg_pool2d", (x,))
    x, back = _channel_first(x, data_format)
    ks, st, pd = _pool_args(kernel_size, stride, padding)
    return back(F.avg_pool2d(x, ks, st, pd, ceil_mode=ceil_mode,
                             count_include_pad=not exclusive,
                             divisor_override=divisor_override))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Window i of n over a side of h: rows floor(i h / n) to ceil((i + 1) h / n)."""
    (x,) = amp_cast("adaptive_avg_pool2d", (x,))
    x, back = _channel_first(x, data_format)
    return back(F.adaptive_avg_pool2d(x, _ntuple(output_size, 2)))


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None):
    """Resize the spatial axes to ``size`` or ``int(side * scale_factor)``.
    ``"nearest"`` takes the input pixel under each output pixel's centre
    (half-pixel rule); ``"bilinear"`` / ``"linear"`` interpolate between
    half-pixel centres (antialiased when shrinking), or between corners with
    ``align_corners``."""
    (x,) = amp_cast("interpolate", (x,))
    x, back = _channel_first(x, data_format)
    spatial = x.shape[2:]
    if size is not None:
        out = tuple(int(s) for s in (size if isinstance(size, (list, tuple, torch.Size))
                                     else [size] * len(spatial)))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        out = tuple(int(c * s) for c, s in zip(spatial, sf))
    if mode == "nearest":
        return back(F.interpolate(x, size=out, mode="nearest-exact"))
    if mode in ("bilinear", "linear"):
        torch_mode = "bilinear" if len(spatial) == 2 else "linear"
        if align_corners:
            return back(F.interpolate(x, size=out, mode=torch_mode, align_corners=True))
        return back(F.interpolate(x, size=out, mode=torch_mode, align_corners=False,
                                  antialias=torch_mode == "bilinear"))
    raise NotImplementedError(f"paddle_tpu_torch: interpolate mode {mode!r}")


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy in fp32 with hard (class index) or soft labels,
    ``ignore_index``, class ``weight`` and label smoothing; ``"mean"`` over
    hard labels divides by the kept labels (their weights)."""
    (input,) = amp_cast("cross_entropy", (input,))
    logits = input.to(torch.float32)
    axis = axis % logits.dim()
    lp = (torch.log_softmax(logits, dim=axis) if use_softmax
          else torch.log(logits.clamp(1e-15, 1.0)))
    n = logits.shape[axis]
    if soft_label:
        soft = label.to(torch.float32)
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-(soft * lp).sum(axis), reduction)
    idx = label.long()
    if idx.dim() == lp.dim():
        idx = idx.squeeze(axis)
    valid = idx != ignore_index
    safe = idx.clamp(0, n - 1)
    if label_smoothing > 0.0:
        oh = F.one_hot(safe, n).to(torch.float32).movedim(-1, axis)
        oh = oh * (1 - label_smoothing) + label_smoothing / n
        loss = -(oh * lp).sum(axis)
    else:
        loss = -lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        w = torch.where(valid, weight.to(torch.float32)[safe], 0.0)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(torch.float32).clamp_min(1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    input, label = amp_cast("bce", (input, label))
    p, y = input.to(torch.float32), label.to(torch.float32)
    loss = -(y * torch.log(p.clamp(1e-12, 1.0)) + (1 - y) * torch.log((1 - p).clamp(1e-12, 1.0)))
    if weight is not None:
        loss = loss * weight.to(torch.float32)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast("mse_loss", (input, label))
    return _reduce((input.to(torch.float32) - label.to(torch.float32)).square(), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC by the forward algorithm in log space, the JAX package's
    dynamic program op for op.  ``log_probs`` ``[T, B, C]`` are raw logits
    (log-softmaxed here); ``labels`` ``[B, S]``; the recursion freezes each
    row past its input length."""
    (log_probs,) = amp_cast("ctc_loss", (log_probs,))
    lp = torch.log_softmax(log_probs.to(torch.float32), dim=-1)
    T, B, _ = lp.shape
    dev = lp.device
    lab = torch.as_tensor(labels, device=dev).long()
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    L = 2 * lab.shape[1] + 1
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    neg = torch.full((B, 2), NEG, device=dev)
    alpha = torch.full((B, L), NEG, device=dev)
    alpha = torch.cat([lp[0, :, blank:blank + 1], lp[0].gather(1, ext[:, 1:2]),
                       alpha[:, 2:]], dim=1)
    same = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    odd = (torch.arange(L, device=dev) % 2 == 1)[None, :]
    allow_skip = odd & ~same
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.where(allow_skip, torch.cat([neg, alpha[:, :-2]], dim=1), NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = merged + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    ll1 = alpha.gather(1, (2 * lab_len)[:, None])[:, 0]
    ll2 = alpha.gather(1, (2 * lab_len - 1).clamp_min(0)[:, None])[:, 0]
    loss = -torch.logaddexp(ll1, torch.where(lab_len > 0, ll2, NEG))
    if norm_by_times:
        loss = loss / in_len.to(torch.float32).clamp_min(1.0)
    if reduction == "mean":
        return (loss / lab_len.to(torch.float32).clamp_min(1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _takes_kernel(q, attn_mask) -> bool:
    return (attn_mask is None and q.shape[-1] in _fa._HEAD_DIMS
            and q.dtype in _fa._DTYPES)


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, name=None):
    """Attention over ``[B, S, H, D]`` (K/V may have fewer heads).  Without a
    mask, at a head dim and dtype the flash kernel takes, through
    ``kernels.flash_attention``; otherwise the plain reference (a boolean
    mask keeps, a float one adds).  ``dropout_p`` is ignored, as in the JAX
    package."""
    query, key, value, attn_mask = amp_cast("scaled_dot_product_attention",
                                            (query, key, value, attn_mask))
    if _takes_kernel(query, attn_mask):
        return _fa.flash_attention(query, key, value, causal=is_causal)
    rep = query.shape[2] // key.shape[2]
    return _fa._attention_reference(query, key.repeat_interleave(rep, dim=2),
                                    value.repeat_interleave(rep, dim=2), is_causal,
                                    attn_mask, query.shape[-1] ** -0.5)


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True, name=None):
    """``(out, None)``, as the JAX package's."""
    return scaled_dot_product_attention(query, key, value, None, dropout, causal,
                                        training), None


# the JAX op name of each function whose name is not its op's
_OP_NAMES = {"conv1d": "conv", "conv2d": "conv", "conv2d_transpose": "conv",
             "binary_cross_entropy": "bce", "upsample": "interpolate",
             "flash_attention": "scaled_dot_product_attention"}

# the user's entry: Tensors in, Tensors out (plain torch tensors pass as they
# are); the outputs checked under FLAGS_check_nan_inf by the op's JAX name
for _name in __all__:
    globals()[_name] = boundary(checked_op(_OP_NAMES.get(_name, _name), globals()[_name]))
del _name
