"""``nn.functional`` (port of ``paddle_tpu/nn/functional.py`` and
``paddle_tpu/nn/_functional_extras.py``: the same ``__all__``, names,
signatures and parameter names).

Paddle's conventions, as in the JAX package: a linear weight is ``[in,
out]`` (``x @ w``); convolutions are NC* with OI* weights, a transposed
one ``[in, out // groups, *k]``; attention takes ``[batch, seq, heads,
head_dim]``; losses compute in fp32 where the JAX package does.  Where the
JAX package leaves the work to XLA (convolutions, pools, norms, the losses,
FFT-free resampling) the port uses stock torch ops, cuDNN included.  Where
the two libraries define an op differently, the port follows the JAX
package:

- :func:`interpolate` ``"nearest"`` is ``jax.image.resize``'s half-pixel
  rule (torch's ``"nearest-exact"``); ``"linear"`` / ``"bilinear"`` /
  ``"trilinear"`` / ``"area"`` are ``jax.image.resize``'s linear
  scale-and-translate (antialiased when an axis shrinks; ``"area"`` is
  linear, not an adaptive average), ``"bicubic"`` its Keys cubic with
  a = -0.5 (torch's bicubic uses -0.75); with ``align_corners`` every mode
  but nearest is the JAX linear index map;
- the pools give the floor output size (the JAX package ignores
  ``ceil_mode``; the port raises for ``ceil_mode=True``); a string padding
  is XLA's ``"SAME"`` / ``"VALID"``, and ``avg_pool*`` under a string
  padding divides by the window size;
- a transposed convolution ignores ``output_size`` and refuses a string
  padding;
- :func:`batch_norm` updates the running statistics with the *biased*
  batch variance, ``momentum * old + (1 - momentum) * new``;
- :func:`dropout` returns its input unchanged outside training, whatever
  the mode;
- :func:`ctc_loss` log-softmaxes raw logits itself, uses -1e30 as its log
  zero (an impossible alignment costs a huge finite loss) and its
  ``"mean"`` divides each loss by its label length clamped to >= 1;
- :func:`embedding` returns zeros at ``padding_idx``; :func:`one_hot`
  returns fp32 (zeros for an index out of range);
- :func:`scaled_dot_product_attention` ignores ``dropout_p``.

Random ops (the dropouts, :func:`rrelu`, :func:`gumbel_softmax`,
:func:`class_center_sample`) draw from ``generator=`` when given, else from
the input device's advancing ``default_generator``; the fractional pools
use ``random_u`` (0.5 when None), as the JAX package, and draw nothing.

Kernels: :func:`rms_norm` calls ``kernels.rms_norm.rms_norm`` (the CUDA
forward and backward kernels on a CUDA tensor, their plain versions on a
CPU one) where the JAX function calls the Pallas kernel, a last axis
divisible by 128; other widths take the plain version on every device.
:func:`scaled_dot_product_attention` (and :func:`flash_attention`,
:func:`flash_attn_qkvpacked`) routes as the JAX package does: with no mask,
a head dim the flash kernel takes (32/64/128/256) and an fp32 or bf16
input it calls ``kernels.flash_attention``; anything else runs the plain
``_attention_reference``.  :func:`flash_attn_unpadded` (and
:func:`flash_attn_varlen_qkvpacked`) computes on a CUDA tensor, at a head
dim and dtype the kernel takes, each packed segment with keys through the
flash kernel (one forward and one backward launch a segment, ``cu_seqlens``
read on the host once a call; a query row that sees no key gets the JAX
function's mean of every packed value row); elsewhere the JAX function's
one masked attention over the packed length.

Every function is an entry point: Tensors in, Tensors out (plain torch
tensors pass as they are), the inputs cast under ``amp.auto_cast`` and
the outputs checked under ``FLAGS_check_nan_inf`` by the JAX op name.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_generator, to_dtype
from ..framework.dispatch import amp_cast, checked_op
from ..framework.resample import resize_weights
from ..framework.tensor import Tensor, boundary, unwrap
from ..incubate.nn.functional import dropout as _dropout
from ..kernels import flash_attention as _fa
from ..kernels import rms_norm as _krms

__all__ = [
    # activations
    "relu", "relu6", "gelu", "sigmoid", "silu", "softmax", "log_softmax", "tanh",
    "hardswish", "hardsigmoid", "leaky_relu", "elu", "selu", "celu", "mish",
    "softplus", "softsign", "swish", "glu", "hardtanh", "tanhshrink", "softshrink",
    "hardshrink", "prelu", "log_sigmoid", "gumbel_softmax", "thresholded_relu",
    # linear & conv & pool
    "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
    "max_pool2d", "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    # norm
    "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
    "local_response_norm", "normalize",
    # regularization
    "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    # embedding
    "embedding", "one_hot",
    # loss
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "smooth_l1_loss",
    "nll_loss", "kl_div", "margin_ranking_loss", "sigmoid_focal_loss",
    "cosine_embedding_loss", "triplet_margin_loss", "hinge_embedding_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "square_error_cost", "ctc_loss",
    # misc
    "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle", "cosine_similarity",
    "pad", "pairwise_distance", "label_smooth", "sequence_mask", "unfold",
    "scaled_dot_product_attention", "flash_attention", "flash_attn_unpadded", "channel_shuffle",
    "temporal_shift", "npair_loss", "rrelu", "zeropad2d",
]

NEG = -1e30
SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


def _gen(generator, x) -> torch.Generator:
    """The generator a random op draws from: ``generator``, else the
    input device's default."""
    return generator if generator is not None else default_generator(x.device)


def _softplus(a):
    """``jax.nn.softplus``: ``log(1 + exp(a))`` as ``logaddexp(a, 0)``."""
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype, device=a.device))


def _f32(v):
    return None if v is None else v.to(torch.float32)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    """``min(max(x, 0), 6)``."""
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    """Exact erf GELU; ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def silu(x, name=None):
    """``x * sigmoid(x)``, as ``jax.nn.silu`` (the same bits)."""
    return x * torch.sigmoid(x)


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(x if dtype is None else x.to(to_dtype(dtype)), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(x if dtype is None else x.to(to_dtype(dtype)), dim=axis)


def tanh(x, name=None):
    return torch.tanh(x)


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """Paddle's ``clip(slope * x + offset, 0, 1)``: its default slope is
    0.1666667, not torch's 1/6, so this is not ``F.hardsigmoid``."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=SELU_SCALE, alpha=SELU_ALPHA, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    """``max(x, 0) + alpha * expm1(min(x, 0) / alpha)`` (``jax.nn.celu``)."""
    return torch.clamp(x, min=0) + alpha * torch.expm1(torch.clamp(x, max=0) / alpha)


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(beta * x > threshold, x, _softplus(beta * x) / beta)


def softsign(x, name=None):
    return x / (1 + torch.abs(x))


def swish(x, name=None):
    """``x * sigmoid(x)`` (SiLU)."""
    return x * torch.sigmoid(x)


def glu(x, axis=-1, name=None):
    a1, a2 = torch.chunk(x, 2, dim=axis)
    return a1 * torch.sigmoid(a2)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x > 0, x, w x)``: one slope, or one a channel (axis 1 for
    ``NC*``, the last axis otherwise)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = ([1, -1] + [1] * (x.dim() - 2) if data_format == "NCHW"
             else [1] * (x.dim() - 1) + [-1])
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None, *,
          generator: Optional[torch.Generator] = None):
    """Negative inputs times a slope drawn uniform in ``[lower, upper)``
    (fp32 draws, cast); outside training the mean slope."""
    if not training:
        return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))
    slopes = torch.empty(x.shape, dtype=torch.float32, device=x.device).uniform_(
        lower, upper, generator=_gen(generator, x)).to(x.dtype)
    return torch.where(x >= 0, x, x * slopes)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full((), value, dtype=x.dtype, device=x.device))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator: Optional[torch.Generator] = None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g = -log(-log
    u)``, ``u`` uniform in ``[1e-20, 1)``; ``hard`` gives the one-hot of the
    argmax forward and the soft gradient backward."""
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device).uniform_(
        1e-20, 1.0, generator=_gen(generator, x))
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


# ---------------------------------------------------------------------------
# linear, convolution, pooling
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``, the weight ``[in_features, out_features]``."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _ntuple(v, n):
    if isinstance(v, Tensor):
        v = v.tolist()
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return [int(a) for a in (v * n if len(v) == 1 else v)]


def _channel_first(x, data_format):
    """``x`` with its channel axis at 1, and the inverse move."""
    if data_format in ("NHWC", "NLC", "NDHWC", "NWC"):
        return x.movedim(-1, 1), (lambda y: y.movedim(1, -1))
    return x, (lambda y: y)


def _same_pads(size, k, s, d):
    """XLA's ``"SAME"``: the output ``ceil(size / s)``, the padding split
    low-first."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pad_pairs(padding, nd, spatial, kernel, stride, dilation):
    """``padding`` as ``nd`` (low, high) pairs: a number or ``nd`` numbers
    (symmetric), ``2 nd`` numbers (low, high per axis), or ``"SAME"`` /
    ``"VALID"``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        return [_same_pads(spatial[i], kernel[i], stride[i], dilation[i]) for i in range(nd)]
    p = _ntuple(padding, nd)
    if len(p) == nd:
        return [(v, v) for v in p]
    if len(p) != 2 * nd:
        raise ValueError(f"bad padding {padding}")
    return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]


def _torch_pad(pairs):
    """(low, high) pairs of the leading spatial axes as ``F.pad``'s list."""
    return [v for lo, hi in reversed(pairs) for v in (lo, hi)]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _conv(x, weight, bias, stride, padding, dilation, groups, nd, data_format):
    x, back = _channel_first(x, data_format)
    st, dl = _ntuple(stride, nd), _ntuple(dilation, nd)
    pairs = _pad_pairs(padding, nd, x.shape[2:], weight.shape[2:], st, dl)
    if all(lo == hi for lo, hi in pairs):
        sym = [lo for lo, _ in pairs]
    else:
        x = F.pad(x, _torch_pad(pairs))
        sym = [0] * nd
    return back(_CONV[nd](x, weight, bias, st, sym, dl, groups))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCL",
           name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3, data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups, dilation, nd,
                    data_format):
    """The JAX package's transposed convolution: the stride-dilated input
    convolved with the flipped kernel under padding ``d (k - 1) - lo`` and
    ``d (k - 1) - hi + output_padding``.  Torch's ``conv_transpose`` runs
    it; padding torch cannot express is a crop or zero-pad of its full
    output.  A string padding raises, as the JAX one does."""
    if isinstance(padding, str):
        raise ValueError("String padding is not implemented for transposed convolution; "
                         "specify the padding exactly")
    x, back = _channel_first(x, data_format)
    st, dl = _ntuple(stride, nd), _ntuple(dilation, nd)
    op = _ntuple(output_padding, nd)
    pairs = _pad_pairs(padding, nd, None, weight.shape[2:], st, dl)
    if all(lo == hi for lo, hi in pairs) and all(op[i] < max(st[i], dl[i]) for i in range(nd)):
        return back(_CONV_T[nd](x, weight, bias, st, [lo for lo, _ in pairs], op, groups, dl))
    crops = [(pairs[i][0], pairs[i][1] - op[i]) for i in range(nd)]
    out = _CONV_T[nd](x, weight, None, st, 0, 0, groups, dl)
    # a negative crop is zero padding: F.pad crops with negative widths
    out = F.pad(out, _torch_pad([(-lo, -hi) for lo, hi in crops]))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return back(out)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, groups, dilation, 1,
                           data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCHW", name=None):
    """Weight ``[in, out // groups, kH, kW]`` (Paddle's and torch's layout);
    output ``(H - 1) s - lo - hi + d (k - 1) + output_padding + 1`` a side;
    ``output_size`` is ignored, as in the JAX package."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, groups, dilation, 2,
                           data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, groups, dilation, 3,
                           data_format)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _floor_only(ceil_mode):
    """The JAX pools take ``ceil_mode`` and give the floor size whatever it
    is; the port refuses ``ceil_mode=True`` rather than give that shape."""
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True: the pools give the floor output size, "
                                  "as in the JAX package")


def _pool_geometry(x, kernel_size, stride, padding, nd):
    ks = _ntuple(kernel_size, nd)
    st = ks if stride is None else _ntuple(stride, nd)
    return ks, st, _pad_pairs(padding, nd, x.shape[2:], ks, st, [1] * nd)


def _max_pool(x, kernel_size, stride, padding, nd, return_mask=False):
    """Max over windows, padding at -inf (the lowest integer for integers);
    ``return_mask`` adds the flat index of each window's first maximum in
    its (unpadded) map, int32."""
    ks, st, pairs = _pool_geometry(x, kernel_size, stride, padding, nd)
    sym = all(lo == hi for lo, hi in pairs)
    if sym:
        pd = [lo for lo, _ in pairs]
    else:
        low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        x = F.pad(x, _torch_pad(pairs), value=low)
        pd = [0] * nd
    if not return_mask:
        return _MAX_POOL[nd](x, ks, st, pd)
    out, idx = _MAX_POOL[nd](x, ks, st, pd, return_indices=True)
    if not sym:             # indices into the padded map -> into the input's
        padded = x.shape[2:]
        coords, rem = [], idx
        for i in reversed(range(nd)):
            coords.append(rem % padded[i] - pairs[i][0])
            rem = rem // padded[i]
        idx = torch.zeros_like(idx)
        for i, c in zip(range(nd), reversed(coords)):
            idx = idx * (padded[i] - pairs[i][0] - pairs[i][1]) + c
    return out, idx.to(torch.int32)


def _avg_pool(x, kernel_size, stride, padding, nd, exclusive=True, divisor_override=None):
    """Sum over windows of the zero-padded input over the kept count
    (``exclusive``), the window size, or ``divisor_override``; a string
    padding divides by the window size, as the JAX package."""
    ks, st, pairs = _pool_geometry(x, kernel_size, stride, padding, nd)
    window = float(np.prod(ks))
    if all(lo == hi for lo, hi in pairs) and not isinstance(padding, str):
        pd = [lo for lo, _ in pairs]
        if divisor_override and nd > 1:
            return _AVG_POOL[nd](x, ks, st, pd, divisor_override=divisor_override)
        if not divisor_override:
            return _AVG_POOL[nd](x, ks, st, pd, count_include_pad=not exclusive)
    xp = F.pad(x, _torch_pad(pairs))
    s = _AVG_POOL[nd](xp, ks, st, 0) * window
    if divisor_override:
        return s / divisor_override
    if exclusive and not isinstance(padding, str):
        ones = F.pad(torch.ones_like(x[:1, :1]), _torch_pad(pairs))
        return s / (_AVG_POOL[nd](ones, ks, st, 0) * window)
    return s / window


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               name=None):
    _floor_only(ceil_mode)
    return _avg_pool(x, kernel_size, stride, padding, 1, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """Mean over windows; ``exclusive`` leaves the padding out of the count."""
    _floor_only(ceil_mode)
    x, back = _channel_first(x, data_format)
    return back(_avg_pool(x, kernel_size, stride, padding, 2, exclusive, divisor_override))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    _floor_only(ceil_mode)
    return _avg_pool(x, kernel_size, stride, padding, 3, exclusive, divisor_override)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               name=None):
    """``return_mask`` is ignored, as in the JAX package."""
    _floor_only(ceil_mode)
    return _max_pool(x, kernel_size, stride, padding, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over windows, padding at -inf; ``return_mask`` also gives each
    window's flat ``h * W + w`` index of its maximum (NCHW)."""
    _floor_only(ceil_mode)
    if return_mask:
        return _max_pool(x, kernel_size, stride, padding, 2, True)
    x, back = _channel_first(x, data_format)
    return back(_max_pool(x, kernel_size, stride, padding, 2))


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    _floor_only(ceil_mode)
    return _max_pool(x, kernel_size, stride, padding, 3)


def adaptive_avg_pool1d(x, output_size, name=None):
    return F.adaptive_avg_pool1d(x, _ntuple(output_size, 1))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Window i of n over a side of h: rows floor(i h / n) to ceil((i + 1) h / n)."""
    x, back = _channel_first(x, data_format)
    return back(F.adaptive_avg_pool2d(x, _ntuple(output_size, 2)))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Divisible sizes only, as in the JAX package."""
    size = _ntuple(output_size, 3)
    if any(s % o for s, o in zip(x.shape[-3:], size)):
        raise NotImplementedError("adaptive_avg_pool3d with non-divisible sizes")
    return F.adaptive_avg_pool3d(x, size)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """``return_mask`` is ignored, as in the JAX package."""
    return F.adaptive_max_pool1d(x, _ntuple(output_size, 1))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """``return_mask`` is ignored, as in the JAX package."""
    return F.adaptive_max_pool2d(x, _ntuple(output_size, 2))


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05, name=None):
    """Over the last ``len(normalized_shape)`` axes, in fp32, cast back."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    out = F.layer_norm(x.to(torch.float32), list(normalized_shape), _f32(weight), _f32(bias),
                       epsilon)
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis with fp32 statistics.  A last axis
    divisible by 128 goes to ``kernels.rms_norm.rms_norm`` (the CUDA kernels
    forward and backward on a CUDA tensor, raising for a dtype they do not
    take; the plain version on a CPU one), as the JAX function sends it to
    the Pallas kernel; other widths take the plain version on every
    device."""
    if x.shape[-1] % 128 == 0:
        return _krms.rms_norm(x, weight, epsilon)
    return _krms.rms_norm_reference(x, weight, epsilon)


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
    x32 = x.to(torch.float32)
    w, b = _f32(weight), _f32(bias)
    if use_batch:
        out = F.batch_norm(x32, None, None, w, b, True, 0.0, epsilon)
        if running_mean is not None:
            with torch.no_grad():
                axes = [i for i in range(x.dim()) if i != 1]
                var, mu = torch.var_mean(x32.detach(), dim=axes, correction=0)
                running_mean.copy_(momentum * running_mean.to(torch.float32)
                                   + (1 - momentum) * mu)
                running_var.copy_(momentum * running_var.to(torch.float32)
                                  + (1 - momentum) * var)
    elif running_mean.requires_grad or running_var.requires_grad:
        # differentiable in the statistics, as the JAX op (torch's is not)
        shape = [1, -1] + [1] * (x.dim() - 2)
        out = (x32 - running_mean.to(torch.float32).reshape(shape)) * torch.rsqrt(
            running_var.to(torch.float32).reshape(shape) + epsilon)
        out = out if w is None else out * w.reshape(shape)
        out = out if b is None else out + b.reshape(shape)
    else:
        out = F.batch_norm(x32, running_mean.to(torch.float32), running_var.to(torch.float32),
                           w, b, False, 0.0, epsilon)
    return back(out.to(x.dtype))


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05, data_format="NCHW",
               name=None):
    """Statistics over each group of ``C / num_groups`` channels and the
    spatial axes, in fp32, cast back."""
    x, back = _channel_first(x, data_format)
    out = F.group_norm(x.to(torch.float32), num_groups, _f32(weight), _f32(bias), epsilon)
    return back(out.to(x.dtype))


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-05, data_format="NCHW", name=None):
    """Statistics of each sample's channel over the spatial axes, in fp32;
    the running statistics are neither read nor updated, as in the JAX
    package."""
    out = F.instance_norm(x.to(torch.float32), None, None, _f32(weight), _f32(bias), True, 0.0,
                          eps)
    return out.to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
    """``x / (k + alpha * sum(x^2 over size channels) / size) ** beta``, the
    window ``[c - size // 2, c + (size - 1) // 2]``."""
    c = x.shape[1]
    half = size // 2
    sq = F.pad(torch.square(x).movedim(1, -1), (half, size - 1 - half)).movedim(-1, 1)
    acc = sum(sq[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


# ---------------------------------------------------------------------------
# dropout, embedding
# ---------------------------------------------------------------------------

def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None, *,
            generator: Optional[torch.Generator] = None):
    """Paddle's dropout: outside training (or at ``p`` 0) the input itself;
    in training a keep mask (shared along the axes not in ``axis`` when
    given) drawn from ``generator``, the kept values scaled by ``1 / (1 -
    p)`` in ``upscale_in_train`` mode."""
    if not training or p == 0.0:
        return x
    if axis is None:
        return _dropout(x, p, training=True, mode=mode, generator=_gen(generator, x))
    axes = {a % x.dim() for a in (axis if isinstance(axis, (list, tuple)) else [axis])}
    shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, generator=_gen(generator, x), device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4], training=training,
                   generator=generator)


def _alpha_dropout(x, p, shape, a_coef, b_coef, generator):
    alpha_p = -SELU_ALPHA * SELU_SCALE
    keep = torch.rand(shape, generator=_gen(generator, x), device=x.device) >= p
    return a_coef * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                                    device=x.device)) + b_coef


def alpha_dropout(x, p=0.5, training=True, name=None, *,
                  generator: Optional[torch.Generator] = None):
    """Dropped values set to SELU's negative saturation, then the affine map
    that keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -SELU_ALPHA * SELU_SCALE
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * (1 - q)) ** -0.5
    b_coef = -a_coef * alpha_p * (1 - q)
    return _alpha_dropout(x, p, x.shape, a_coef, b_coef, generator).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None, max_norm=None,
              norm_type=2.0, scale_grad_by_freq=False):
    """Rows of ``weight`` at ``x``; zeros where ``x == padding_idx`` (so that
    row gets no gradient), as the JAX package."""
    idx = x.long()
    out = weight[idx]
    if padding_idx is not None:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows (``jax.nn.one_hot``: an index outside
    ``[0, num_classes)`` gives a row of zeros)."""
    return (x.long()[..., None] == torch.arange(num_classes, device=x.device)).to(torch.float32)


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


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    p, y = input.to(torch.float32), label.to(torch.float32)
    loss = -(y * torch.log(p.clamp(1e-12, 1.0)) + (1 - y) * torch.log((1 - p).clamp(1e-12, 1.0)))
    if weight is not None:
        loss = loss * weight.to(torch.float32)
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    z, y = logit.to(torch.float32), label.to(torch.float32)
    soft = torch.log1p(torch.exp(-torch.abs(z)))
    if pos_weight is not None:
        log_w = (pos_weight.to(torch.float32) - 1) * y + 1
        loss = (1 - y) * z + log_w * (soft + torch.clamp(-z, min=0))
    else:
        loss = torch.clamp(z, min=0) - z * y + soft
    if weight is not None:
        loss = loss * weight.to(torch.float32)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input.to(torch.float32) - label.to(torch.float32)).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    ad = torch.abs(d)
    return _reduce(torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta)), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    """``-input[n, label[n]]`` over the class axis 1; ``ignore_index`` rows
    count 0; ``"mean"`` divides by the kept rows (their weights)."""
    n = input.shape[1]
    ii = label.long()
    loss = -input.gather(1, ii.clamp(0, n - 1).unsqueeze(1)).squeeze(1)
    valid = ii != ignore_index
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))
    if weight is not None:
        w_per = weight.to(input.dtype)[ii.clamp(0, n - 1)]
        loss = loss * w_per
        if reduction == "mean":
            return loss.sum() / torch.where(valid, w_per, 0.0).sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(input.dtype).clamp_min(1.0)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    t, lp = label.to(torch.float32), input.to(torch.float32)
    if log_target:
        loss = torch.exp(t) * (t - lp)
    else:
        loss = t * (torch.log(t.clamp(min=1e-12)) - lp)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction="sum",
                       name=None):
    p = torch.sigmoid(logit.to(torch.float32))
    y = label.to(torch.float32)
    ce = torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def _l2(a, dim):
    return torch.sqrt(torch.sum(a * a, dim=dim))


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    cos = torch.sum(input1 * input2, dim=-1) / (_l2(input1, -1) * _l2(input2, -1) + 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0)), reduction)


def _p_dist(a, b, p, keepdim=False):
    return torch.sum(torch.abs(a - b) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-06, swap=False,
                        reduction="mean", name=None):
    d_ap = _p_dist(input, positive, p)
    d_an = _p_dist(input, negative, p)
    if swap:
        d_an = torch.minimum(d_an, _p_dist(positive, negative, p))
    return _reduce(torch.clamp(d_ap - d_an + margin, min=0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    return _reduce(torch.where(label == 1, input, torch.clamp(margin - input, min=0)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8, reduction="mean",
                     name=None):
    z, y = input, label
    loss = torch.exp(z) - y * z if log_input else z - y * torch.log(z + epsilon)
    if full:
        stirling = (y * torch.log(y + 1e-12) - y
                    + 0.5 * torch.log(2 * math.pi * torch.clamp(y, min=1e-12)))
        loss = loss + torch.where(y > 1, stirling, torch.zeros((), dtype=stirling.dtype,
                                                               device=y.device))
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6, reduction="mean",
                      name=None):
    v = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(v) + torch.square(label - input) / v)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean", name=None):
    loss = -(label * F.logsigmoid(input) + (1 - label) * F.logsigmoid(-input))
    loss = loss.mean(dim=-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    yv = labels.reshape(-1, 1)
    same = (yv == yv.T).to(torch.float32)
    same = same / same.sum(dim=1, keepdim=True)
    xent = -torch.mean(torch.sum(same * torch.log_softmax(sim, dim=1), dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), dim=1))
                    + torch.mean(torch.sum(torch.square(positive), dim=1))) * 0.25
    return xent + reg


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC by the forward algorithm in log space, the JAX package's
    dynamic program op for op.  ``log_probs`` ``[T, B, C]`` are raw logits
    (log-softmaxed here); ``labels`` ``[B, S]``; the recursion freezes each
    row past its input length."""
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
# resampling, shuffles, distances, padding
# ---------------------------------------------------------------------------

def _resample(a, axis, out_size, method):
    """``a`` resampled along ``axis`` by ``jax.image.resize``'s weights."""
    w = torch.from_numpy(resize_weights(a.shape[axis], out_size, method)).to(a.device, a.dtype)
    return torch.matmul(a.movedim(axis, -1), w).movedim(-1, axis)


def _align_corners(a, axis, out_size):
    """The JAX package's ``align_corners``: linear between the input
    samples at ``linspace(0, n_in - 1, n_out)``."""
    n_in = a.shape[axis]
    pos = (torch.zeros(1, device=a.device) if out_size == 1
           else torch.linspace(0, n_in - 1, out_size, device=a.device))
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    shape = [1] * a.dim()
    shape[axis] = -1
    w = (pos - i0).to(a.dtype).reshape(shape)
    g0, g1 = a.index_select(axis, i0), a.index_select(axis, i1)
    return g0 + w * (g1 - g0)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None):
    """Resize the spatial axes to ``size`` or ``int(side * scale_factor)``
    (``jax.image.resize``'s methods; see the module docstring)."""
    x, back = _channel_first(x, data_format)
    spatial = x.shape[2:]
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    if size is not None:
        out = (tuple(int(s) for s in size) if isinstance(size, (list, tuple, torch.Size))
               else (int(size),) * len(spatial))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        out = tuple(int(c * s) for c, s in zip(spatial, sf))
    if mode == "nearest":
        return back(F.interpolate(x, size=out, mode="nearest-exact"))
    method = {"bilinear": "linear", "linear": "linear", "trilinear": "linear",
              "bicubic": "cubic", "area": "linear"}[mode]
    if method == "linear" and len(spatial) == 2 and x.is_floating_point():
        # torch's antialiased bilinear is jax.image.resize's linear
        return back(F.interpolate(x, size=out, mode="bilinear", align_corners=bool(align_corners),
                                  antialias=not align_corners))
    a = x if x.is_floating_point() else x.to(torch.float32)
    for i, n in enumerate(out):
        if n != a.shape[2 + i]:
            a = (_align_corners(a, 2 + i, n) if align_corners
                 else _resample(a, 2 + i, n, method))
    return back(a.to(x.dtype))


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return F.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return F.pixel_unshuffle(x, downscale_factor)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """NCHW channels ``[g0 c0, g0 c1, ..., g1 c0, ...]`` reordered to
    ``[g0 c0, g1 c0, ..., g0 c1, ...]``."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW", name=None):
    """TSM: along each clip of ``seg_num`` frames, the first ``c *
    shift_ratio`` channels shift one frame back, the next as many one frame
    forward, zeros shifted in."""
    nt, c, h, w = x.shape
    r = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([r[:, 1:, :fold], torch.zeros_like(r[:, :1, :fold])], dim=1)
    right = torch.cat([torch.zeros_like(r[:, :1, fold:2 * fold]), r[:, :-1, fold:2 * fold]],
                      dim=1)
    return torch.cat([left, right, r[:, :, 2 * fold:]], dim=2).reshape(nt, c, h, w)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    return torch.sum(x1 * x2, dim=axis) / torch.clamp(_l2(x1, axis) * _l2(x2, axis), min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return torch.sum(torch.abs(x - y + epsilon) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", pad_from_left_axis=True,
        name=None):
    """``ops.pad`` (Paddle's pad list and modes)."""
    from ..ops.manipulation import pad as _pad

    return unwrap(_pad(x, pad, mode=mode, value=value, data_format=data_format))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0, data_format=data_format)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` over ``maxlen`` (the longest
    length when None); int32 for the integer dtypes, as the JAX package."""
    ml = int(maxlen or int(lengths.max()))
    mask = torch.arange(ml, device=lengths.device) < lengths.reshape(-1, 1)
    mask = mask.reshape(tuple(lengths.shape) + (ml,))
    return mask.to(torch.int32 if dtype in ("int64", "int32") else to_dtype(dtype))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col patches ``[N, C * kh * kw, L]`` (not the strided view
    ``paddle.unfold``); four paddings are ``[top, left, bottom, right]``."""
    pd = _ntuple(paddings, 2)
    if len(pd) == 4:
        x = F.pad(x, [pd[1], pd[3], pd[0], pd[2]])
        pd = [0, 0]
    return F.unfold(x, _ntuple(kernel_sizes, 2), _ntuple(dilations, 2), pd, _ntuple(strides, 2))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _takes_kernel(q, attn_mask) -> bool:
    return (attn_mask is None and q.shape[-1] in _fa._HEAD_DIMS
            and q.dtype in _fa._DTYPES)


def _plain_attention(q, k, v, causal, mask, sm_scale):
    rep = q.shape[2] // k.shape[2]
    return _fa._attention_reference(q, k.repeat_interleave(rep, dim=2),
                                    v.repeat_interleave(rep, dim=2), causal, mask, sm_scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, name=None):
    """Attention over ``[B, S, H, D]`` (K/V may have fewer heads).  Without a
    mask, at a head dim and dtype the flash kernel takes, through
    ``kernels.flash_attention``; otherwise the plain reference (a boolean
    mask keeps, a float one adds).  ``dropout_p`` is ignored, as in the JAX
    package."""
    if _takes_kernel(query, attn_mask):
        return _fa.flash_attention(query, key, value, causal=is_causal)
    return _plain_attention(query, key, value, is_causal, attn_mask, query.shape[-1] ** -0.5)


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True, name=None):
    """``(out, None)``, as the JAX package's."""
    return scaled_dot_product_attention(query, key, value, None, dropout, causal,
                                        training), None


def _boundaries(cu) -> list:
    """``cu_seqlens`` as a host list (one read a call)."""
    if isinstance(cu, torch.Tensor):
        return [int(v) for v in cu.tolist()]
    return [int(v) for v in np.asarray(cu).reshape(-1)]


def _varlen_reference(q, k, v, cu_q, cu_k, causal, scale):
    """The JAX function: one attention over the packed length with a
    segment mask, causal rows aligned bottom-right within their segment."""
    dev = q.device
    cq = torch.tensor(cu_q, device=dev)
    ck = torch.tensor(cu_k, device=dev)
    seg_q = torch.searchsorted(cq[1:], torch.arange(q.shape[0], device=dev), right=True)
    seg_k = torch.searchsorted(ck[1:], torch.arange(k.shape[0], device=dev), right=True)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        rel_q = torch.arange(q.shape[0], device=dev) - cq[seg_q]
        rel_k = torch.arange(k.shape[0], device=dev) - ck[seg_k]
        shift = rel_q + (ck[seg_q + 1] - ck[seg_q]) - (cq[seg_q + 1] - cq[seg_q])
        mask = mask & (shift[:, None] >= rel_k[None, :])
    return _plain_attention(q[None], k[None], v[None], False, mask[None, None], scale)[0]


def _varlen_segments(query, key, value, cu_q, cu_k, causal, scale):
    """The JAX function segment by segment through ``kernels.flash_attention``
    (no mask; causal Sq > Sk aligned bottom-right by the kernel).  A query row
    that sees no key (every row of a segment without keys, and the first
    ``Lq - Lk`` rows of a causal segment with more queries than keys) gets
    what the JAX function's softmax over scores all at its finite NEG_INF
    gives it: uniform weights over every packed key, the mean of ``value``;
    the kernel runs on the segment's other rows only."""
    blind, outs = None, []
    for (q0, q1), (k0, k1) in zip(zip(cu_q, cu_q[1:]), zip(cu_k, cu_k[1:])):
        nb = q1 - q0 if k1 == k0 else (max(0, (q1 - q0) - (k1 - k0)) if causal else 0)
        if nb:
            if blind is None:
                blind = (value.float().sum(0) / max(value.shape[0], 1)).to(query.dtype)
            outs.append(blind.expand(nb, *blind.shape))
        if q1 - q0 > nb:
            outs.append(_fa.flash_attention(query[q0 + nb:q1][None], key[k0:k1][None],
                                            value[k0:k1][None], causal=causal,
                                            sm_scale=scale)[0])
    return torch.cat(outs) if outs else query.new_zeros(query.shape)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale, dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True, name=None):
    """Varlen (packed) attention: ``query`` / ``key`` / ``value`` ``[total,
    H, D]`` hold several sequences along axis 0, ``cu_seqlens_*`` ``[B +
    1]`` their boundaries; each sequence attends only within itself
    (causally, its rows aligned bottom-right).  Returns ``(out, None)``.

    On a CUDA tensor at a head dim and dtype the flash kernel takes, each
    segment with keys runs through ``kernels.flash_attention`` with no mask
    (one forward launch a segment, one backward; see
    :func:`_varlen_segments` for the rows that see no key); elsewhere the
    JAX function's masked attention over the packed length."""
    cu_q, cu_k = _boundaries(cu_seqlens_q), _boundaries(cu_seqlens_k)
    if query.device.type == "cuda" and _takes_kernel(query, None):
        return _varlen_segments(query, key, value, cu_q, cu_k, causal, scale), None
    return _varlen_reference(query, key, value, cu_q, cu_k, causal, scale), None


# ---------------------------------------------------------------------------
# the long tail (geometry, pools, losses, packed attention, in-place)
# ---------------------------------------------------------------------------

from . import _functional_extras as _fx  # noqa: E402
from ._functional_extras import *  # noqa: E402,F401,F403

__all__ = __all__ + _fx.__all__

# the JAX op name of each function whose name is not its op's
_OP_NAMES = {
    "conv1d": "conv", "conv2d": "conv", "conv3d": "conv", "conv1d_transpose": "conv",
    "conv2d_transpose": "conv", "conv3d_transpose": "conv", "avg_pool1d": "avg_pool2d",
    "max_pool1d": "max_pool2d", "adaptive_avg_pool1d": "adaptive_avg_pool2d",
    "adaptive_max_pool1d": "adaptive_max_pool2d", "dropout2d": "dropout",
    "dropout3d": "dropout", "binary_cross_entropy": "bce",
    "binary_cross_entropy_with_logits": "bce_logits",
    "softmax_with_cross_entropy": "cross_entropy", "upsample": "interpolate",
    "zeropad2d": "pad", "flash_attention": "scaled_dot_product_attention",
    "max_unpool1d": "max_unpool", "max_unpool2d": "max_unpool", "max_unpool3d": "max_unpool",
    "lp_pool1d": "lp_pool", "lp_pool2d": "lp_pool",
    "fractional_max_pool2d": "fractional_max_pool",
    "fractional_max_pool3d": "fractional_max_pool",
    "flash_attn_qkvpacked": "scaled_dot_product_attention",
    "flash_attn_varlen_qkvpacked": "flash_attn_unpadded",
}


def _amp_op(name, fn):
    """``fn`` with its tensor arguments cast for op ``name`` under
    ``auto_cast`` (the JAX ``apply_op``'s cast of its inputs)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        args = amp_cast(name, args)
        if kwargs:
            kwargs = dict(zip(kwargs, amp_cast(name, tuple(kwargs.values()))))
        return fn(*args, **kwargs)

    return op


# the user's entry: Tensors in, Tensors out (plain torch tensors pass as they
# are); the inputs cast (batch_norm casts its own: its running statistics
# are updated in place) and the outputs checked by the op's JAX name.  The
# in-place variants take the Tensor itself and call these.
for _name in __all__:
    if _name not in _fx.INPLACE:
        _op = _OP_NAMES.get(_name, _name)
        _fn = globals()[_name] if _name == "batch_norm" else _amp_op(_op, globals()[_name])
        globals()[_name] = boundary(checked_op(_op, _fn), name=_op)
del _name, _op, _fn
