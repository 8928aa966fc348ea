"""The long tail of ``nn.functional`` (port of
``paddle_tpu/nn/_functional_extras.py``): sampling geometry
(``grid_sample`` / ``affine_grid``), ``fold``, unpooling, LP and
fractional pools, ``maxout``, the loss family (dice, log, multi-margin,
triplet with a distance, hierarchical sigmoid, RNN-T, adaptive
log-softmax), the packed flash-attention entry points, ``gather_tree`` and
the in-place activations.

Each function is the JAX one's expression in torch; :mod:`.functional`
wraps them as entry points.  Where the JAX package keeps an op on XLA
(``flashmask_attention``, ``sparse_attention``, ``grid_sample``) the port
uses torch ops; the packed entry points reach the flash kernel through
:func:`.functional.scaled_dot_product_attention` and
:func:`.functional.flash_attn_unpadded`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.tensor import Tensor, unwrap, wrap

__all__ = [
    "affine_grid", "grid_sample", "fold",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "lp_pool1d", "lp_pool2d", "fractional_max_pool2d", "fractional_max_pool3d",
    "adaptive_max_pool3d", "maxout",
    "dice_loss", "log_loss", "multi_margin_loss",
    "triplet_margin_with_distance_loss", "hsigmoid_loss", "rnnt_loss",
    "adaptive_log_softmax_with_loss",
    "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    "flashmask_attention", "sparse_attention",
    "gather_tree", "feature_alpha_dropout", "bilinear",
    "class_center_sample", "margin_cross_entropy",
    "softmax_", "tanh_", "elu_", "leaky_relu_", "hardtanh_",
    "thresholded_relu_",
]

INPLACE = ("softmax_", "tanh_", "elu_", "leaky_relu_", "hardtanh_", "thresholded_relu_")
NEG = -1e30


def _fn():
    from . import functional

    return functional


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2-D / 3-D sampling grids ``[N, *out, nd]`` (x first) from affine
    matrices ``theta`` ``[N, nd, nd + 1]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    shp = [int(s) for s in out_shape]

    def line(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=theta.device, dtype=theta.dtype)
        return ((torch.arange(n, device=theta.device, dtype=theta.dtype) * 2 + 1) / n - 1.0)

    if len(shp) == 4:
        _, _, H, W = shp
        ys, xs = torch.meshgrid(line(H), line(W), indexing="ij")
        base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
        return torch.einsum("hwk,nck->nhwc", base, theta)
    _, _, D, H, W = shp
    zs, ys, xs = torch.meshgrid(line(D), line(H), line(W), indexing="ij")
    base = torch.stack([xs, ys, zs, torch.ones_like(xs)], dim=-1)
    return torch.einsum("dhwk,nck->ndhwc", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True, name=None):
    """Samples of NCHW ``x`` at the normalised ``grid`` ``[N, Hg, Wg, 2]``
    positions (bilinear or nearest; ``zeros``, ``border`` or ``reflection``
    padding), the JAX package's gathers."""
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(v, n):
        if align_corners:
            return (v + 1.0) * (n - 1) / 2.0
        return ((v + 1.0) * n - 1.0) / 2.0

    ix, iy = unnorm(gx, W), unnorm(gy, H)
    if padding_mode == "border":
        ix, iy = torch.clamp(ix, 0, W - 1), torch.clamp(iy, 0, H - 1)
    elif padding_mode == "reflection":
        def reflect(v, n):
            if align_corners:
                span = 2 * (n - 1)
                v = torch.abs(v) % span if span else v * 0
                return torch.where(v > n - 1, span - v, v)
            span = 2 * n
            v = torch.abs(v + 0.5) % span
            v = torch.where(v > n, span - v, v) - 0.5
            return torch.clamp(v, 0, n - 1)

        ix, iy = reflect(ix, W), reflect(iy, H)
    batch = torch.arange(N, device=x.device)[:, None, None]

    def gather(yy, xx):
        out = x[batch, :, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]     # [N, Hg, Wg, C]
        if padding_mode == "zeros":
            valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            out = out * valid[..., None]
        return out

    if mode == "nearest":
        out = gather(torch.round(iy).long(), torch.round(ix).long())
    else:
        x0, y0 = torch.floor(ix), torch.floor(iy)
        wx, wy = ix - x0, iy - y0
        x0i, y0i = x0.long(), y0.long()
        out = (gather(y0i, x0i) * ((1 - wy) * (1 - wx))[..., None]
               + gather(y0i, x0i + 1) * ((1 - wy) * wx)[..., None]
               + gather(y0i + 1, x0i) * (wy * (1 - wx))[..., None]
               + gather(y0i + 1, x0i + 1) * (wy * wx)[..., None])
    return out.movedim(-1, 1)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """col2im, the inverse of ``unfold``: ``[N, C * kh * kw, L]`` ->
    ``[N, C, H, W]``, overlapping patches summed."""
    return F.fold(x, _pair(output_sizes), _pair(kernel_sizes), _pair(dilations), _pair(paddings),
                  _pair(strides))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _tuple(v, nd):
    return (int(v),) * nd if isinstance(v, int) else tuple(int(a) for a in v)


def _unpool_nd(x, indices, kernel_size, stride, padding, output_size, nd):
    """Pooled values scattered back to the flat positions ``indices`` of
    each ``[spatial]`` map."""
    spatial = x.shape[2:]
    if output_size is not None:
        out_sp = tuple(int(s) for s in list(output_size)[-nd:])
    else:
        ks = _tuple(kernel_size, nd)
        st = ks if stride is None else _tuple(stride, nd)
        pd = _tuple(padding, nd)
        out_sp = tuple((spatial[i] - 1) * st[i] - 2 * pd[i] + ks[i] for i in range(nd))
    N, C = x.shape[0], x.shape[1]
    out = x.new_zeros((N, C, int(np.prod(out_sp))))
    out = out.scatter(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return out.reshape((N, C) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCL", name=None):
    return _unpool_nd(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCHW", name=None):
    return _unpool_nd(x, indices, kernel_size, stride, padding, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCDHW", name=None):
    return _unpool_nd(x, indices, kernel_size, stride, padding, output_size, 3)


_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d}


def _lp_pool(x, norm_type, kernel, stride, nd):
    """``(sum |x|^p over each VALID window) ** (1 / p)``."""
    ks = _tuple(kernel, nd)
    st = ks if stride is None else _tuple(stride, nd)
    p = float(norm_type)
    s = _AVG_POOL[nd](torch.abs(x) ** p, ks, st) * float(np.prod(ks))
    return s ** (1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, ceil_mode=False, data_format="NCL",
              name=None):
    _fn()._floor_only(ceil_mode)
    return _lp_pool(x, norm_type, kernel_size, stride, 1)


def lp_pool2d(x, norm_type, kernel_size, stride=None, ceil_mode=False, data_format="NCHW",
              name=None):
    _fn()._floor_only(ceil_mode)
    return _lp_pool(x, norm_type, kernel_size, stride, 2)


def _segment_max(a, axis, bounds):
    """Max over each ``[bounds[r], bounds[r + 1])`` slice of ``axis``."""
    return torch.cat([a.narrow(axis, int(lo), int(hi - lo)).amax(axis, keepdim=True)
                      for lo, hi in zip(bounds[:-1], bounds[1:])], dim=axis)


def _fractional_pool(x, output_size, random_u, nd):
    """Fractional max pooling (Graham 2014) with the reference's
    deterministic ``random_u`` (0.5 when None): region ``r`` of an axis of
    ``n_in`` spans up to ``ceil(alpha (r + u)) - 1``, ``alpha = n_in /
    n_out``; pooled one axis at a time."""
    outs = _tuple(output_size, nd)
    u = float(random_u) if random_u is not None else 0.5
    out = x
    for d in range(nd):
        n_in, n_out = x.shape[2 + d], outs[d]
        idx = (np.ceil(n_in / n_out * (np.arange(n_out) + u)) - 1).astype(np.int64)
        idx = np.clip(idx, 0, n_in - 1)
        out = _segment_max(out, 2 + d, np.concatenate([[0], idx[:-1] + 1, [n_in]]))
    return out


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    out = _fractional_pool(x, output_size, random_u, 2)
    return (out, None) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    out = _fractional_pool(x, output_size, random_u, 3)
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = F.adaptive_max_pool3d(x, _tuple(output_size, 3))
    return (out, None) if return_mask else out


def maxout(x, groups, axis=1, name=None):
    """Max over ``groups`` consecutive channels."""
    ax = axis % x.dim()
    c = x.shape[ax]
    return x.reshape(x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]).amax(ax + 1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - 2 |p y| / (|p| + |y|))``: ``input`` ``[N, ..., C]``
    probabilities, ``label`` ``[N, ..., 1]`` class ids."""
    oh = (label[..., 0].long()[..., None] == torch.arange(input.shape[-1], device=input.device)
          ).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1 - 2 * inter / (union + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(1 - input + epsilon)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None, reduction="mean", name=None):
    n, c = input.shape
    y = label.long()
    m = torch.clamp(margin - input.gather(1, y[:, None]) + input, min=0.0) ** p
    if weight is not None:
        m = m * weight[y][:, None]
    m = m.scatter(1, y[:, None], 0.0)
    per = m.sum(dim=1) / c
    if reduction == "none":
        return per
    return per.mean() if reduction == "mean" else per.sum()


def triplet_margin_with_distance_loss(input, positive, negative, distance_function=None,
                                      margin=1.0, swap=False, reduction="mean", name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)``; ``distance_function`` is
    called with Tensors, as in the JAX package (default: Euclidean)."""
    def dist(a, b):
        if distance_function is None:
            return torch.sqrt(torch.clamp(torch.sum((a - b) ** 2, dim=-1), min=1e-12))
        return unwrap(distance_function(wrap(a), wrap(b)))

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    per = torch.clamp(dp - dn + margin, min=0.0)
    if reduction == "none":
        return per
    return per.mean() if reduction == "mean" else per.sum()


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None, path_code=None,
                  is_sparse=False, name=None):
    """Hierarchical sigmoid loss over the reference's default complete
    binary tree (code ``label + num_classes``; level d's node ``(c >> (d +
    1)) - 1``, its bit ``(c >> d) & 1``), or a custom tree given by
    ``path_table`` / ``path_code``.  ``input`` ``[N, D]``, ``weight``
    ``[num_classes - 1, D]``; the mean over rows."""
    if path_table is not None:
        nodes = path_table.long()
        codes = torch.where(path_code > 0, 1.0, -1.0).to(input.dtype)
        valid = nodes >= 0
        nodes = nodes.clamp(min=0)
    else:
        max_depth = max(1, int(math.floor(math.log2(2 * num_classes - 1))))
        c = label.long() + num_classes
        nodes = torch.stack([(c >> (d + 1)) - 1 for d in range(max_depth)], -1)
        codes = torch.stack([torch.where((c >> d) & 1 == 1, -1.0, 1.0)
                             for d in range(max_depth)], -1).to(input.dtype)
        valid = (nodes >= 0) & (nodes < num_classes - 1)
        nodes = nodes.clamp(0, num_classes - 2)
    scores = torch.einsum("nd,npd->np", input, weight[nodes])
    if bias is not None:
        scores = scores + (bias[nodes][..., 0] if bias.dim() == 2 else bias[nodes])
    logp = F.logsigmoid(codes * scores)
    return -torch.where(valid, logp, torch.zeros((), dtype=logp.dtype,
                                                 device=logp.device)).sum(-1).mean()


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0, fastemit_lambda=0.0,
              reduction="mean", name=None):
    """RNN-Transducer loss: the log-space alpha recursion over the (T, U)
    lattice, ``input`` ``[B, T, U + 1, V]`` logits, ``label`` ``[B, U]``.
    Along u the recursion ``alpha[t, u] = logaddexp(alpha[t - 1, u] +
    blank, alpha[t, u - 1] + emit)`` is a prefix log-sum over the emits'
    running sum, one ``logcumsumexp`` a time step.  FastEmit is not
    implemented, as in the JAX package: a non-zero ``fastemit_lambda``
    raises."""
    if fastemit_lambda:
        raise NotImplementedError("rnnt_loss: FastEmit regularization (fastemit_lambda != 0) "
                                  "is not implemented")
    B, T, U1, _ = input.shape
    U = U1 - 1
    logp = torch.log_softmax(input.to(torch.float32), dim=-1)
    blank_lp = logp[..., blank]                                           # [B, T, U + 1]
    lab_lp = logp[:, :, :U, :].gather(-1, label.long()[:, None, :, None].expand(
        B, T, U, 1))[..., 0]                                              # [B, T, U]
    zero = torch.zeros((B, T, 1), dtype=torch.float32, device=input.device)
    emit = torch.cat([zero, torch.cumsum(lab_lp, dim=-1)], dim=-1)      # [B, T, U + 1]
    alphas = [emit[:, 0]]
    for t in range(1, T):
        from_blank = alphas[-1] + blank_lp[:, t - 1]
        alphas.append(emit[:, t] + torch.logcumsumexp(from_blank - emit[:, t], dim=-1))
    alpha = torch.stack(alphas, dim=1)                                    # [B, T, U + 1]
    rows = torch.arange(B, device=input.device)
    t_idx, u_idx = input_lengths.long() - 1, label_lengths.long()
    nll = -(alpha[rows, t_idx, u_idx] + blank_lp[rows, t_idx, u_idx])
    if reduction == "none":
        return nll
    return nll.mean() if reduction == "mean" else nll.sum()


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights, cutoffs,
                                   head_bias=None, name=None):
    """Adaptive softmax (Grave et al.): the head covers the frequent
    classes and one entry a tail cluster, each cluster a two-matrix
    projection.  Returns ``(log-likelihoods [N], loss)``."""
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    head_lp = torch.log_softmax(head, dim=-1)
    y = label.long()
    out = head_lp.gather(1, y.clamp(0, cutoffs[0] - 1)[:, None])[:, 0]
    lo = cutoffs[0]
    for c, (w1, w2) in enumerate(tail_weights):
        cluster_lp = torch.log_softmax((input @ w1) @ w2, dim=-1)
        size = w2.shape[-1]
        rel = (y - lo).clamp(0, size - 1)
        cand = head_lp[:, cutoffs[0] + c] + cluster_lp.gather(1, rel[:, None])[:, 0]
        out = torch.where((y >= lo) & (y < lo + size), cand, out)
        lo += size
    return out, -out.mean()


# ---------------------------------------------------------------------------
# attention entry points, misc
# ---------------------------------------------------------------------------

def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True, name=None):
    """Packed-QKV flash attention, ``qkv`` ``[B, S, 3, H, D]``: q, k and v
    are strided views of it, which the flash kernel reads in place when
    every row is 16-byte aligned.  Returns ``(out, None)``."""
    out = _fn().scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None,
                                             dropout, causal, training)
    return out, None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                                scale, dropout=0.0, causal=False, return_softmax=False,
                                fixed_seed_offset=None, rng_name="", varlen_padded=True,
                                training=True, name=None):
    """Varlen packed-QKV attention, ``qkv`` ``[total, 3, H, D]``, through
    :func:`.functional.flash_attn_unpadded`."""
    return _fn().flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q,
                                     cu_seqlens_k, max_seqlen_q, max_seqlen_k, scale, dropout,
                                     causal, return_softmax, fixed_seed_offset, rng_name,
                                     training)


def flashmask_attention(query, key, value, startend_row_indices=None, dropout=0.0, causal=False,
                        window_size=None, name=None):
    """FlashMask attention: the mask comes compressed as per-column start
    (and end) rows ``[B, H or 1, S, 1|2|4]``; expanded to a dense mask and
    run through the plain attention, as the JAX package."""
    from ..kernels.flash_attention import _attention_reference

    S, D = query.shape[1], query.shape[3]
    dev = query.device
    mask = None
    if startend_row_indices is not None:
        sre = startend_row_indices.long()
        rows = torch.arange(S, device=dev)[:, None]
        base = (rows >= torch.arange(S, device=dev)[None, :] if causal
                else torch.ones((S, S), dtype=torch.bool, device=dev))
        masked = rows[None, None] >= sre[..., 0][:, :, None, :]
        if sre.shape[-1] >= 2:
            masked = masked & (rows[None, None] < sre[..., 1][:, :, None, :])
        mask = base[None, None] & ~masked
    elif causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()[None, None]
    return _attention_reference(query, key, value, False, mask, 1.0 / math.sqrt(D))


def sparse_attention(query, key, value, sparse_csr_offset=None, sparse_csr_columns=None,
                     key_padding_mask=None, attn_mask=None, name=None):
    """CSR-masked attention, ``q / k / v`` ``[B, H, S, D]``: each row's
    key positions given by ``sparse_csr_offset`` ``[B, H, S + 1]`` and
    ``sparse_csr_columns`` ``[B, H, nnz]``, expanded to a dense mask; fp32
    scores, rows with no key zeroed, as the JAX package."""
    qf, kf, vf = (t.to(torch.float32) for t in (query, key, value))
    B, H, S, D = qf.shape
    off, cols = sparse_csr_offset.long(), sparse_csr_columns.long()
    nnz = cols.shape[-1]
    kidx = torch.arange(nnz, device=query.device).expand(B, H, nnz).contiguous()
    rows = torch.searchsorted(off.contiguous(), kidx, right=True) - 1
    valid = kidx < off[..., -1:]
    flat = torch.where(valid, rows * S + cols, S * S)      # the dropped slot past the end
    mask = torch.zeros((B, H, S * S + 1), dtype=torch.bool, device=query.device)
    mask = mask.scatter(2, flat, True)[..., :S * S].reshape(B, H, S, S)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(float(D))
    s = torch.where(mask, s, NEG)
    if key_padding_mask is not None:
        s = s + key_padding_mask.to(torch.float32)[:, None, None, :]
    if attn_mask is not None:
        s = s + attn_mask.to(torch.float32)[None, None, :, :]
    row_ok = s.amax(dim=-1, keepdim=True) > -1e29
    p = torch.softmax(torch.where(row_ok, s, 0.0), dim=-1)
    p = torch.where(row_ok, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(query.dtype)


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace: from the last step, follow the parent
    pointers of ``ids`` / ``parents`` ``[T, B, beam]`` to the full beams."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(ids.shape[1:]).to(
        parents.dtype)
    out = []
    for t in range(T - 1, -1, -1):
        out.append(ids[t].gather(-1, beams.long()))
        beams = parents[t].gather(-1, beams.long())
    return torch.stack(out[::-1])


def feature_alpha_dropout(x, p=0.5, training=True, name=None, *,
                          generator: Optional[torch.Generator] = None):
    """Alpha dropout of whole feature maps (one draw a sample and channel)."""
    if not training or p == 0.0:
        return x
    from .functional import SELU_ALPHA, SELU_SCALE, _alpha_dropout

    alpha_p = -SELU_ALPHA * SELU_SCALE
    a_coef = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b_coef = -a_coef * p * alpha_p
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    return _alpha_dropout(x, p, shape, a_coef, b_coef, generator)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``x1ᵀ W x2 (+ bias)``, weight ``[out, in1, in2]``."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias


def class_center_sample(label, num_classes, num_samples, group=None, *,
                        generator: Optional[torch.Generator] = None):
    """PartialFC's sampling (one process): every positive class and
    uniformly drawn negatives up to ``num_samples``.  Returns ``(remapped
    label, sampled class ids)``, int32, on the label's device; the draw is
    a permutation of the negatives from ``generator`` (on the host, as the
    data-dependent sizes are)."""
    y = label.detach().cpu().numpy().astype(np.int64)
    pos = np.unique(y)
    n_extra = max(0, num_samples - len(pos))
    rest = np.setdiff1d(np.arange(num_classes), pos)
    g = _fn()._gen(generator, label)
    perm = torch.randperm(rest.shape[0], generator=g, device=g.device).cpu().numpy()
    sampled = np.sort(np.concatenate([pos, rest[perm[:n_extra]]]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(remap[y].astype(np.int32)).to(label.device),
            torch.from_numpy(sampled.astype(np.int32)).to(label.device))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: ``cos(m1 theta + m2) - m3`` at the
    target logit, then the scaled softmax cross-entropy."""
    cos = torch.clamp(logits, -1.0, 1.0)
    y = label.long()
    theta = torch.arccos(cos.gather(1, y[:, None]))[:, 0]
    target = torch.cos(margin1 * theta + margin2) - margin3
    z = cos.scatter(1, y[:, None], target[:, None]) * scale
    nll = -torch.log_softmax(z, dim=-1).gather(1, y[:, None])[:, 0]
    loss = nll if reduction == "none" else (nll.mean() if reduction == "mean" else nll.sum())
    if return_softmax:
        return loss, torch.softmax(z, dim=-1)
    return loss


# ---------------------------------------------------------------------------
# in-place activations
# ---------------------------------------------------------------------------

def _act_inplace(base_name):
    def fn(x, *args, **kwargs):
        out = getattr(_fn(), base_name)(x, *args, **kwargs)
        if isinstance(x, Tensor):
            x._data = out._data          # rebinds x, as the JAX inplace_rebind_
            return x
        return x.copy_(out)

    fn.__name__ = fn.__qualname__ = base_name + "_"
    fn.__doc__ = f"In-place variant of :func:`{base_name}`: ``x`` rebound to the result."
    return fn


softmax_ = _act_inplace("softmax")
tanh_ = _act_inplace("tanh")
elu_ = _act_inplace("elu")
leaky_relu_ = _act_inplace("leaky_relu")
hardtanh_ = _act_inplace("hardtanh")
thresholded_relu_ = _act_inplace("thresholded_relu")
