"""paddle_tpu_torch.nn.functional against paddle_tpu's, name by name (CPU).

Every name of ``paddle_tpu.nn.functional.__all__`` (the 130 of
``functional`` and ``_functional_extras``) runs on the same numpy inputs,
made from a seed, through both packages: forward values, dtypes and shapes,
and for a differentiable name the gradient of a fixed weighted sum of its
float outputs with respect to every float input (the JAX side by
``jax.grad``, all cases in one jitted program; the port's by torch's
autograd).  Tolerances:

- integer and bool results, and every dtype and shape: exact;
- fp32 values: ``RTOL`` (1e-6 relative, with an atol of 1e-6 of the
  reference's largest magnitude), unless the case states its own:
  ``ACCUM`` (1e-5) where the two libraries sum in another order (pools
  taken as a mean times the window, resampling matrices, convolutions,
  attention, the RNN-T lattice by ``logcumsumexp``), ``LOOSE`` (1e-4) for
  chains of such sums (the transposed convolutions, ``grid_sample``'s
  gradients, the 3-D resampling);
- gradients: the case's limit, at least ``ACCUM``;
- random names draw from torch generators, not JAX's: shape and dtype
  exact, values held to their support and moments (``RANDOM``), and the
  same draws again after reseeding.

The in-place activations are held to their base ops and must return the
object they were given.
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device
from test_torch_ops import _Ref, _flat, _np, assert_same, jax_reference

RTOL = 1e-6
ACCUM = 1e-5
LOOSE = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


rng = np.random.default_rng(18)


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _i(lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


X1 = _f(2, 3, 8)                       # NCL
X = _f(2, 3, 6, 6)                     # NCHW
X4 = _f(2, 4, 5, 5)                    # four channels
X3 = _f(2, 3, 4, 6, 6)                 # NCDHW
V = _f(4, 6)
V2 = _f(4, 6)
V3 = _f(4, 6)
LG = _f(4, 5)                          # logits
Y = np.array([0, 3, 1, 4], np.int32)    # class ids
YI = np.array([0, -100, 1, 4], np.int32)
P = _f(4, 5, lo=0.05, hi=0.95)         # probabilities
YB = rng.integers(0, 2, (4, 5)).astype(np.float32)
PM = np.array([1.0, -1.0, 1.0, -1.0], np.float32)
POS = _f(4, 5, lo=0.2, hi=2.0)
CNT = rng.integers(0, 5, (4, 5)).astype(np.float32)
Q = _f(2, 5, 4, 32)
K2 = _f(2, 5, 2, 32)
V_2 = _f(2, 5, 2, 32)
MASK = rng.integers(0, 2, (2, 1, 5, 5)).astype(bool) | np.eye(5, dtype=bool)
CU = np.array([0, 3, 4, 9], np.int32)
CU_K = np.array([0, 4, 5, 11], np.int32)
PQ, PK, PV = _f(9, 2, 32), _f(11, 2, 32), _f(11, 2, 32)
PK9, PV9 = _f(9, 2, 32), _f(9, 2, 32)
THETA = _f(2, 2, 3, lo=-1.0, hi=1.0)
THETA3 = _f(2, 3, 4, lo=-1.0, hi=1.0)
GRID = _f(2, 4, 5, 2, lo=-1.1, hi=1.1)
W1 = _f(4, 3, 3)
W2 = _f(4, 3, 3, 3)
W3 = _f(2, 3, 3, 3, 3)
WT1 = _f(4, 3, 3)                      # transposed: [in, out // groups, k]
WT2 = _f(4, 3, 3, 3)
WT2G = _f(4, 2, 3, 3)
WT3 = _f(3, 2, 3, 3, 3)
B4, B3, B2, B6 = _f(4), _f(3), _f(2), _f(6)
IDX2 = np.stack([rng.permutation(36)[:9] for _ in range(6)]).reshape(2, 3, 3, 3).astype(np.int32)
IDX1 = np.stack([rng.permutation(8)[:4] for _ in range(6)]).reshape(2, 3, 4).astype(np.int32)
IDX3 = np.stack([rng.permutation(64)[:8] for _ in range(6)]).reshape(2, 3, 2, 2, 2).astype(
    np.int32)
SEQ_LENS = np.array([1, 3, 2], np.int32)
EMB_IDX = np.array([[0, 1, 4], [1, 2, 3]], np.int32)
EMB_W = _f(5, 4)
OH_IDX = np.array([0, 2, 5, -1, 4], np.int32)
TREE_IDS = _i(0, 9, 4, 2, 3)
TREE_PAR = _i(0, 3, 4, 2, 3)
CSR_OFF = np.array([[[0, 1, 3, 3, 5], [0, 2, 3, 4, 6]]], np.int32)
CSR_COL = np.array([[[0, 0, 1, 2, 3, 0], [1, 3, 2, 0, 1, 2]]], np.int32)
SQ, SK, SV = _f(1, 2, 4, 8), _f(1, 2, 4, 8), _f(1, 2, 4, 8)
FM_Q, FM_K, FM_V = _f(2, 6, 2, 16), _f(2, 6, 2, 16), _f(2, 6, 2, 16)
FM_SE = np.stack([_i(2, 7, 2, 1, 6), _i(4, 7, 2, 1, 6)], -1).astype(np.int32)
FM_SE[..., 1] = np.maximum(FM_SE[..., 0], FM_SE[..., 1])
RNNT_X = _f(2, 4, 3, 5)
RNNT_Y = _i(1, 5, 2, 2)
ALS_X = _f(4, 8)
ALS_Y = np.array([1, 5, 7, 9], np.int32)
QKV = _f(2, 5, 3, 2, 32)
QKV_V = _f(9, 3, 2, 32)
COS = _f(4, 5, lo=-0.95, hi=0.95)
DICE_P = _f(2, 3, 3, 4, lo=0.05, hi=1.0)
DICE_Y = _i(0, 4, 2, 3, 3, 1)
HS_W, HS_B = _f(4, 6), _f(4)
HS_TABLE = np.array([[0, 1, -1], [0, 2, 3], [0, 1, -1], [0, 2, -1]], np.int32)
HS_CODE = np.array([[1, 0, 0], [0, 1, 1], [0, 1, 0], [1, 1, 0]], np.int32)


def T(P_, a, grad=False):
    t = P_.to_tensor(a)
    if grad:
        t.stop_gradient = False
    return t


# name -> (inputs, fn(P, F, *tensors), rtol, differentiable); the numpy
# inputs become Tensors of the package, F is its nn.functional ("name:variant"
# keys hold more cases of one name)
CASES = {
    # ---- activations
    "relu": ((V,), lambda P, F, x: F.relu(x), RTOL, True),
    "relu6": ((V * 4,), lambda P, F, x: F.relu6(x), RTOL, True),
    "gelu": ((V,), lambda P, F, x: [F.gelu(x), F.gelu(x, approximate=True)], ACCUM, True),
    "sigmoid": ((V,), lambda P, F, x: F.sigmoid(x), RTOL, True),
    "silu": ((V,), lambda P, F, x: F.silu(x), RTOL, True),
    "softmax": ((V,), lambda P, F, x: [F.softmax(x), F.softmax(x, axis=0)], RTOL, True),
    "log_softmax": ((V,), lambda P, F, x: F.log_softmax(x, axis=0), RTOL, True),
    "tanh": ((V,), lambda P, F, x: F.tanh(x), RTOL, True),
    "hardswish": ((V * 3,), lambda P, F, x: F.hardswish(x), RTOL, True),
    "hardsigmoid": ((V * 3,), lambda P, F, x: F.hardsigmoid(x), RTOL, True),
    "leaky_relu": ((V,), lambda P, F, x: F.leaky_relu(x, 0.2), RTOL, True),
    "elu": ((V,), lambda P, F, x: F.elu(x, 0.7), RTOL, True),
    "selu": ((V,), lambda P, F, x: F.selu(x), RTOL, True),
    "celu": ((V,), lambda P, F, x: F.celu(x, 1.5), RTOL, True),
    "mish": ((V,), lambda P, F, x: F.mish(x), ACCUM, True),
    "softplus": ((V * 10,), lambda P, F, x: [F.softplus(x), F.softplus(x, 2.0, 5.0)], RTOL,
                 True),
    "softsign": ((V,), lambda P, F, x: F.softsign(x), RTOL, True),
    "swish": ((V,), lambda P, F, x: F.swish(x), RTOL, True),
    "glu": ((V,), lambda P, F, x: [F.glu(x), F.glu(x, axis=0)], RTOL, True),
    "hardtanh": ((V * 2,), lambda P, F, x: F.hardtanh(x, -1.5, 0.5), RTOL, True),
    "tanhshrink": ((V,), lambda P, F, x: F.tanhshrink(x), ACCUM, True),
    "softshrink": ((V,), lambda P, F, x: F.softshrink(x, 0.3), RTOL, True),
    "hardshrink": ((V,), lambda P, F, x: F.hardshrink(x, 0.3), RTOL, True),
    "prelu": ((X, B3), lambda P, F, x, w: [F.prelu(x, w), F.prelu(x, w[:1])], RTOL, True),
    "log_sigmoid": ((V,), lambda P, F, x: F.log_sigmoid(x), RTOL, True),
    "thresholded_relu": ((V,), lambda P, F, x: F.thresholded_relu(x, 0.4, 0.1), RTOL, True),
    "rrelu": ((V,), lambda P, F, x: F.rrelu(x, 0.1, 0.3, training=False), RTOL, True),
    # ---- linear, convolution, pooling
    "linear": ((V, _f(6, 3), B3), lambda P, F, x, w, b: F.linear(x, w, b), ACCUM, True),
    "conv1d": ((X1, W1, B4), lambda P, F, x, w, b: [
        F.conv1d(x, w, b, stride=2, padding="SAME"), F.conv1d(x, w, None, padding=[2, 1])],
        ACCUM, True),
    "conv2d": ((X, W2, B4), lambda P, F, x, w, b: [
        F.conv2d(x, w, b, padding=[1, 0, 2, 1]), F.conv2d(x, w, b, stride=2, padding="SAME"),
        F.conv2d(x, w, b, padding="VALID", dilation=2)], ACCUM, True),
    "conv3d": ((X3, W3, B2), lambda P, F, x, w, b: [
        F.conv3d(x, w, b, padding=1), F.conv3d(x, w, None, stride=2, padding="SAME")],
        ACCUM, True),
    "conv1d_transpose": ((_f(2, 4, 5), WT1, B3), lambda P, F, x, w, b: [
        F.conv1d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
        F.conv1d_transpose(x, w, None, stride=2, padding=[2, 0])], LOOSE, True),
    "conv2d_transpose": ((_f(2, 4, 4, 4), WT2, WT2G, B3), lambda P, F, x, w, wg, b: [
        F.conv2d_transpose(x, w, b, stride=2, padding=[1, 0, 0, 2], output_padding=1),
        F.conv2d_transpose(x, w, b, stride=2, padding=[0, 3, 1, 1], output_size=[9, 9]),
        F.conv2d_transpose(x, wg, None, stride=2, padding=1, groups=2),
        F.conv2d_transpose(x, w, None, stride=1, padding=0, output_padding=2)], LOOSE, True),
    "conv3d_transpose": ((_f(2, 3, 2, 3, 3), WT3, B2), lambda P, F, x, w, b: [
        F.conv3d_transpose(x, w, b, stride=2, padding=1)], LOOSE, True),
    "avg_pool1d": ((X1,), lambda P, F, x: [F.avg_pool1d(x, 3, 2, 1),
                                           F.avg_pool1d(x, 3, 2, 1, exclusive=False)],
                   ACCUM, True),
    "avg_pool2d": ((X,), lambda P, F, x: [
        F.avg_pool2d(x, 3, 2, [1, 0, 1, 2]), F.avg_pool2d(x, 3, 2, "SAME"),
        F.avg_pool2d(x, 2, divisor_override=3), F.avg_pool2d(x, 3, 1, 1, exclusive=False)],
        ACCUM, True),
    "avg_pool3d": ((X3,), lambda P, F, x: [F.avg_pool3d(x, 2, 2), F.avg_pool3d(x, 3, 2, 1),
                                           F.avg_pool3d(x, 2, divisor_override=5)],
                   ACCUM, True),
    "max_pool1d": ((X1,), lambda P, F, x: [F.max_pool1d(x, 3, 2, 1), F.max_pool1d(x, 2)], RTOL,
                   True),
    "max_pool2d": ((X,), lambda P, F, x: [
        F.max_pool2d(x, 3, 2, "SAME"), F.max_pool2d(x, 2, 2, [0, 1, 1, 0])], RTOL, True),
    # (the JAX mask's variadic reduce_window has no gradient rule)
    "max_pool2d:mask": ((X,), lambda P, F, x: [
        *F.max_pool2d(x, 3, 2, 1, return_mask=True),
        *F.max_pool2d(x, 2, 2, [1, 0, 0, 1], return_mask=True)], RTOL, False),
    "max_pool3d": ((X3,), lambda P, F, x: [F.max_pool3d(x, 2), F.max_pool3d(x, 3, 2, 1)], RTOL,
                   True),
    "adaptive_avg_pool1d": ((X1,), lambda P, F, x: F.adaptive_avg_pool1d(x, 3), ACCUM, True),
    "adaptive_avg_pool2d": ((X,), lambda P, F, x: [F.adaptive_avg_pool2d(x, 4),
                                                   F.adaptive_avg_pool2d(x, [3, 2])],
                            ACCUM, True),
    "adaptive_avg_pool3d": ((X3,), lambda P, F, x: F.adaptive_avg_pool3d(x, [2, 3, 3]), ACCUM,
                            True),
    "adaptive_max_pool1d": ((X1,), lambda P, F, x: F.adaptive_max_pool1d(x, 3), RTOL, True),
    "adaptive_max_pool2d": ((X,), lambda P, F, x: F.adaptive_max_pool2d(x, [4, 3]), RTOL, True),
    # ---- norms
    "batch_norm": ((X, B3, POS[0, :3], B3, B3 + 1, np.zeros(3, np.float32),
                    np.ones(3, np.float32)),
                   lambda P, F, x, m, v, w, b, m0, v0: [
                       F.batch_norm(x, m, v, w, b), F.batch_norm(x, m, v, None, b),
                       F.batch_norm(x, m0, v0, w, b, training=True, momentum=0.8),
                       F.batch_norm(x.transpose([0, 2, 3, 1]), m, v, w, b,
                                    data_format="NHWC")], ACCUM, True),
    "layer_norm": ((X, _f(6, 6), _f(6, 6)), lambda P, F, x, w, b: F.layer_norm(x, [6, 6], w, b),
                   ACCUM, True),
    "group_norm": ((X4, B4, B4 + 1), lambda P, F, x, w, b: [
        F.group_norm(x, 2, w, b), F.group_norm(x.transpose([0, 2, 3, 1]), 4, w, None,
                                               data_format="NHWC")], ACCUM, True),
    "instance_norm": ((X, B3, B3 + 1), lambda P, F, x, w, b: [
        F.instance_norm(x, weight=w, bias=b), F.instance_norm(x)], ACCUM, True),
    "rms_norm": ((_f(3, 128), _f(128), _f(2, 48)), lambda P, F, x, w, z: [
        F.rms_norm(x, w), F.rms_norm(x), F.rms_norm(z, epsilon=1e-5)], ACCUM, True),
    "local_response_norm": ((X4,), lambda P, F, x: [F.local_response_norm(x, 3),
                                                    F.local_response_norm(x, 2, 0.1, 0.5, 2.0)],
                            ACCUM, True),
    "normalize": ((V,), lambda P, F, x: [F.normalize(x), F.normalize(x, p=1, axis=0)], ACCUM,
                  True),
    # ---- dropout, embedding (the random draws: RANDOM)
    "dropout": ((V,), lambda P, F, x: [F.dropout(x, 0.5, training=False),
                                       F.dropout(x, 0.3, training=False,
                                                 mode="downscale_in_infer")], RTOL, True),
    "dropout2d": ((X,), lambda P, F, x: F.dropout2d(x, 0.5, training=False), RTOL, True),
    "dropout3d": ((X3,), lambda P, F, x: F.dropout3d(x, 0.5, training=False), RTOL, True),
    "alpha_dropout": ((V,), lambda P, F, x: F.alpha_dropout(x, 0.5, training=False), RTOL, True),
    "embedding": ((EMB_IDX, EMB_W), lambda P, F, i, w: F.embedding(i, w, padding_idx=1), RTOL,
                  True),
    "one_hot": ((OH_IDX,), lambda P, F, i: F.one_hot(i, 5), RTOL, False),
    # ---- losses
    "cross_entropy": ((LG, Y, B4[:1].repeat(5) + 2), lambda P, F, x, y, w: [
        F.cross_entropy(x, y), F.cross_entropy(x, y, weight=w, label_smoothing=0.1),
        F.cross_entropy(x, y, reduction="none")], ACCUM, True),
    "softmax_with_cross_entropy": ((LG, Y[:, None]), lambda P, F, x, y: [
        *F.softmax_with_cross_entropy(x, y, return_softmax=True)], ACCUM, True),
    "binary_cross_entropy": ((P, YB, POS), lambda P_, F, p, y, w: [
        F.binary_cross_entropy(p, y), F.binary_cross_entropy(p, y, w, reduction="sum")],
        ACCUM, True),
    "binary_cross_entropy_with_logits": ((LG, YB, POS, POS[0]), lambda P_, F, z, y, w, pw: [
        F.binary_cross_entropy_with_logits(z, y),
        F.binary_cross_entropy_with_logits(z, y, w, "none", pw)], ACCUM, True),
    "mse_loss": ((LG, P), lambda P_, F, a, b: F.mse_loss(a, b, "sum"), ACCUM, True),
    "l1_loss": ((LG, P), lambda P_, F, a, b: [F.l1_loss(a, b), F.l1_loss(a, b, "none")], ACCUM,
                True),
    "smooth_l1_loss": ((LG, P), lambda P_, F, a, b: F.smooth_l1_loss(a, b, delta=0.5), ACCUM,
                       True),
    "nll_loss": ((LG, YI, POS[0]), lambda P_, F, x, y, w: [
        F.nll_loss(x, y), F.nll_loss(x, y, w), F.nll_loss(x, y, reduction="none")], ACCUM,
        True),
    "kl_div": ((LG, P), lambda P_, F, lp, t: [
        F.kl_div(lp, t), F.kl_div(lp, t, "batchmean"), F.kl_div(lp, t, "sum", log_target=True)],
        ACCUM, True),
    "margin_ranking_loss": ((V[:, 0], V[:, 1], PM), lambda P_, F, a, b, y:
                            F.margin_ranking_loss(a, b, y, 0.1), ACCUM, True),
    "sigmoid_focal_loss": ((LG, YB, np.float32(3.0) * np.ones(1, np.float32)),
                           lambda P_, F, z, y, n: [F.sigmoid_focal_loss(z, y),
                                                   F.sigmoid_focal_loss(z, y, n, 0.5, 1.0,
                                                                        "mean")], ACCUM, True),
    "cosine_embedding_loss": ((V, V2, PM), lambda P_, F, a, b, y:
                              F.cosine_embedding_loss(a, b, y, 0.2), ACCUM, True),
    "triplet_margin_loss": ((V, V2, V3), lambda P_, F, a, p, n: [
        F.triplet_margin_loss(a, p, n), F.triplet_margin_loss(a, p, n, 0.5, 1.5, swap=True)],
        ACCUM, True),
    "hinge_embedding_loss": ((V[:, 0], PM), lambda P_, F, a, y:
                             F.hinge_embedding_loss(a, y, 0.5), ACCUM, True),
    "poisson_nll_loss": ((LG, POS, CNT), lambda P_, F, z, p, y: [
        F.poisson_nll_loss(z, y), F.poisson_nll_loss(p, y, log_input=False, full=True)],
        ACCUM, True),
    "gaussian_nll_loss": ((LG, P, POS), lambda P_, F, m, y, v: [
        F.gaussian_nll_loss(m, y, v), F.gaussian_nll_loss(m, y, v, full=True, reduction="none")],
        ACCUM, True),
    "multi_label_soft_margin_loss": ((LG, YB, POS[:, 0]), lambda P_, F, z, y, w: [
        F.multi_label_soft_margin_loss(z, y), F.multi_label_soft_margin_loss(z, y, w, "sum")],
        ACCUM, True),
    "soft_margin_loss": ((V[:, 0], PM), lambda P_, F, z, y: F.soft_margin_loss(z, y), ACCUM,
                         True),
    "square_error_cost": ((LG, P), lambda P_, F, a, b: F.square_error_cost(a, b), RTOL, True),
    "ctc_loss": ((_f(6, 2, 5), _i(1, 5, 2, 3), np.array([6, 5], np.int32),
                  np.array([3, 2], np.int32)),
                 lambda P_, F, lp, lab, il, ll: [F.ctc_loss(lp, lab, il, ll),
                                                 F.ctc_loss(lp, lab, il, ll, reduction="none")],
                 ACCUM, True),
    "npair_loss": ((V, V2, np.array([0, 1, 0, 2], np.int32)), lambda P_, F, a, p, y:
                   F.npair_loss(a, p, y), ACCUM, True),
    # ---- resampling, shuffles, distances, padding
    "interpolate": ((X, X1, X3), lambda P_, F, x, x1, x3: [
        F.interpolate(x, scale_factor=2, mode="nearest"),
        F.interpolate(x, size=[4, 5], mode="bilinear"),
        F.interpolate(x, size=[9, 8], mode="bicubic"),
        F.interpolate(x, size=[4, 3], mode="bicubic"),
        F.interpolate(x, size=[9, 4], mode="bicubic", align_corners=True),
        F.interpolate(x, size=[4, 4], mode="area"),
        F.interpolate(x1, size=[5], mode="linear"),
        F.interpolate(x1, size=[12], mode="linear", align_corners=True),
        F.interpolate(x3, size=[3, 4, 8], mode="trilinear"),
        F.interpolate(x.transpose([0, 2, 3, 1]), size=[4, 9], mode="bilinear",
                      data_format="NHWC")], LOOSE, True),
    "upsample": ((X,), lambda P_, F, x: F.upsample(x, size=[8, 9], mode="bilinear",
                                                   align_corners=True), ACCUM, True),
    "pixel_shuffle": ((X4[:, :, :3, :4],), lambda P_, F, x: F.pixel_shuffle(x, 2), RTOL, True),
    "pixel_unshuffle": ((X,), lambda P_, F, x: F.pixel_unshuffle(x, 2), RTOL, True),
    "cosine_similarity": ((V, V2), lambda P_, F, a, b: [F.cosine_similarity(a, b),
                                                        F.cosine_similarity(a, b, axis=0)],
                          ACCUM, True),
    "pad": ((X,), lambda P_, F, x: [F.pad(x, [1, 2, 0, 1]), F.pad(x, [1, 1, 2, 2], "reflect"),
                                    F.pad(x, [2, 0, 1, 1], "replicate", data_format="NCHW")],
            RTOL, True),
    "pairwise_distance": ((V, V2), lambda P_, F, a, b: [F.pairwise_distance(a, b),
                                                        F.pairwise_distance(a, b, 1.0,
                                                                            keepdim=True)],
                          ACCUM, True),
    "label_smooth": ((YB, P[0]), lambda P_, F, y, prior: [F.label_smooth(y),
                                                          F.label_smooth(y, prior, 0.2)],
                     RTOL, True),
    "sequence_mask": ((SEQ_LENS,), lambda P_, F, n: [F.sequence_mask(n), F.sequence_mask(n, 5),
                                                     F.sequence_mask(n, 4, dtype="float32")],
                      RTOL, False),
    "unfold": ((X,), lambda P_, F, x: [F.unfold(x, 2, 2, [1, 0, 0, 1]),
                                       F.unfold(x, [3, 2], 1, 1, 2)], RTOL, True),
    "scaled_dot_product_attention": ((Q, K2, V_2, MASK), lambda P_, F, q, k, v, m: [
        F.scaled_dot_product_attention(q, k, v, is_causal=True),
        F.scaled_dot_product_attention(q, k, v, attn_mask=m)], ACCUM, True),
    "flash_attention": ((Q, Q[::-1].copy(), Q * 0.5), lambda P_, F, q, k, v:
                        F.flash_attention(q, k, v, causal=True)[0], ACCUM, True),
    "flash_attn_unpadded": ((PQ, PK, PV, PK9, PV9, CU, CU_K), lambda P_, F, q, k, v, k9, v9, cq,
                            ck: [F.flash_attn_unpadded(q, k, v, cq, ck, 5, 6, 0.3,
                                                       causal=True)[0],
                                 F.flash_attn_unpadded(q, k9, v9, cq, cq, 5, 5, 0.2)[0]],
                            ACCUM, True),
    "channel_shuffle": ((X4,), lambda P_, F, x: F.channel_shuffle(x, 2), RTOL, True),
    "temporal_shift": ((X4,), lambda P_, F, x: F.temporal_shift(x, 2, 0.25), RTOL, True),
    "zeropad2d": ((X,), lambda P_, F, x: F.zeropad2d(x, [1, 0, 2, 1]), RTOL, True),
    # ---- the long tail (_functional_extras)
    "affine_grid": ((THETA, THETA3), lambda P_, F, t, t3: [
        F.affine_grid(t, [2, 3, 4, 5]), F.affine_grid(t, [2, 3, 4, 5], align_corners=False),
        F.affine_grid(t3, [2, 3, 2, 3, 4])], ACCUM, True),
    "grid_sample": ((X, GRID), lambda P_, F, x, g: [
        F.grid_sample(x, g), F.grid_sample(x, g, padding_mode="border", align_corners=False),
        F.grid_sample(x, g, padding_mode="reflection"),
        F.grid_sample(x, g, padding_mode="reflection", align_corners=False),
        F.grid_sample(x, g, mode="nearest")], LOOSE, True),
    "fold": ((_f(2, 12, 16), _f(2, 12, 16)), lambda P_, F, x, y: [
        F.fold(x, [5, 5], 2), F.fold(y, [6, 6], 2, 2, 1)], RTOL, True),
    "max_unpool1d": ((_f(2, 3, 4), IDX1), lambda P_, F, x, i: F.max_unpool1d(x, i, 2), RTOL,
                     True),
    "max_unpool2d": ((_f(2, 3, 3, 3), IDX2), lambda P_, F, x, i: [
        F.max_unpool2d(x, i, 2), F.max_unpool2d(x, i, 2, output_size=[2, 3, 6, 6])], RTOL, True),
    "max_unpool3d": ((_f(2, 3, 2, 2, 2), IDX3), lambda P_, F, x, i: F.max_unpool3d(x, i, 2),
                     RTOL, True),
    "lp_pool1d": ((X1,), lambda P_, F, x: F.lp_pool1d(x, 2, 3, 2), ACCUM, True),
    "lp_pool2d": ((X,), lambda P_, F, x: [F.lp_pool2d(x, 3, 2), F.lp_pool2d(x, 1, [3, 2])],
                  ACCUM, True),
    "fractional_max_pool2d": ((X,), lambda P_, F, x: [
        F.fractional_max_pool2d(x, 4), F.fractional_max_pool2d(x, [4, 5], random_u=0.3),
        F.fractional_max_pool2d(x, 3, return_mask=True)[0]], RTOL, True),
    "fractional_max_pool3d": ((X3,), lambda P_, F, x: F.fractional_max_pool3d(x, [3, 4, 4]),
                              RTOL, True),
    "adaptive_max_pool3d": ((X3,), lambda P_, F, x: F.adaptive_max_pool3d(x, [2, 3, 4]), RTOL,
                            True),
    "maxout": ((X4,), lambda P_, F, x: [F.maxout(x, 2), F.maxout(x.transpose([0, 2, 3, 1]), 2,
                                                               axis=-1)], RTOL, True),
    "dice_loss": ((DICE_P, DICE_Y), lambda P_, F, p, y: F.dice_loss(p, y), ACCUM, True),
    "log_loss": ((P[:, :1], YB[:, :1]), lambda P_, F, p, y: F.log_loss(p, y), RTOL, True),
    "multi_margin_loss": ((LG, Y, POS[0]), lambda P_, F, x, y, w: [
        F.multi_margin_loss(x, y), F.multi_margin_loss(x, y, 2, 0.5, w, "sum")], ACCUM, True),
    "triplet_margin_with_distance_loss": ((V, V2, V3), lambda P_, F, a, p, n: [
        F.triplet_margin_with_distance_loss(a, p, n),
        F.triplet_margin_with_distance_loss(
            a, p, n, lambda u, w: (u - w).abs().sum(axis=-1), 0.5, True, "none")], ACCUM, True),
    "hsigmoid_loss": ((V, Y, HS_W, HS_B, HS_TABLE, HS_CODE), lambda P_, F, x, y, w, b, t, c: [
        F.hsigmoid_loss(x, y, 5, w, b), F.hsigmoid_loss(x, y, 5, w),
        F.hsigmoid_loss(x, y, 5, w, b, t, c)], ACCUM, True),
    "rnnt_loss": ((RNNT_X, RNNT_Y, np.array([4, 3], np.int32), np.array([2, 1], np.int32)),
                  lambda P_, F, x, y, il, ll: [F.rnnt_loss(x, y, il, ll),
                                               F.rnnt_loss(x, y, il, ll, reduction="none")],
                  ACCUM, True),
    "adaptive_log_softmax_with_loss": (
        (ALS_X, ALS_Y, _f(8, 6), _f(8, 2), _f(2, 3), _f(8, 1), _f(1, 3), _f(6)),
        lambda P_, F, x, y, hw, a1, a2, b1, b2, hb: [
            *F.adaptive_log_softmax_with_loss(x, y, hw, [(a1, a2), (b1, b2)], [4, 7], hb)],
        ACCUM, True),
    "flash_attn_qkvpacked": ((QKV,), lambda P_, F, qkv: F.flash_attn_qkvpacked(qkv, causal=True)[0],
                             ACCUM, True),
    "flash_attn_varlen_qkvpacked": ((QKV_V, CU), lambda P_, F, qkv, cu: [
        F.flash_attn_varlen_qkvpacked(qkv, cu, cu, 5, 5, 0.25, causal=True)[0],
        F.flash_attn_varlen_qkvpacked(qkv, cu, cu, 5, 5, 0.25)[0]], ACCUM, True),
    "flashmask_attention": ((FM_Q, FM_K, FM_V, FM_SE), lambda P_, F, q, k, v, se: [
        F.flashmask_attention(q, k, v, se[..., :1], causal=True),
        F.flashmask_attention(q, k, v, se), F.flashmask_attention(q, k, v, causal=True)],
        ACCUM, True),
    "sparse_attention": ((SQ, SK, SV, CSR_OFF, CSR_COL, _f(1, 4)), lambda P_, F, q, k, v, o, c,
                         kp: [F.sparse_attention(q, k, v, o, c),
                              F.sparse_attention(q, k, v, o, c, key_padding_mask=kp)], ACCUM,
                         True),
    "gather_tree": ((TREE_IDS, TREE_PAR), lambda P_, F, i, p: F.gather_tree(i, p), RTOL, False),
    "feature_alpha_dropout": ((X,), lambda P_, F, x: F.feature_alpha_dropout(x, 0.5,
                                                                             training=False),
                              RTOL, True),
    "bilinear": ((_f(4, 3), _f(4, 5), _f(6, 3, 5), _f(1, 6)), lambda P_, F, a, b, w, c: [
        F.bilinear(a, b, w, c), F.bilinear(a, b, w)], ACCUM, True),
    "margin_cross_entropy": ((COS, Y), lambda P_, F, x, y: [
        *F.margin_cross_entropy(x, y, return_softmax=True),
        F.margin_cross_entropy(x, y, 1.0, 0.3, 0.1, 16.0, reduction="none")], ACCUM, True),
}

# name -> (fn(P, F), checks of the port's draws): (lo, hi, mean, rel) -- the
# support, and the mean within ``rel`` of ``mean`` (None: not checked)
RANDOM = {
    "dropout": (lambda P, F: F.dropout(P.ones([20000]), 0.25), (0.0, 4 / 3, 1.0, 0.03)),
    "dropout2d": (lambda P, F: F.dropout2d(P.ones([40, 50, 2, 2]), 0.5), (0.0, 2.0, 1.0, 0.1)),
    "dropout3d": (lambda P, F: F.dropout3d(P.ones([40, 50, 1, 2, 2]), 0.5),
                  (0.0, 2.0, 1.0, 0.1)),
    "alpha_dropout": (lambda P, F: F.alpha_dropout(P.zeros([20000]), 0.2), (-2.0, 2.0, 0.0, None)),
    "feature_alpha_dropout": (lambda P, F: F.feature_alpha_dropout(P.zeros([100, 200, 2]), 0.2),
                              (-2.0, 2.0, 0.0, None)),
    "rrelu": (lambda P, F: -F.rrelu(-P.ones([20000]), 0.1, 0.3), (0.1, 0.3, 0.2, 0.01)),
    "gumbel_softmax": (lambda P, F: F.gumbel_softmax(P.zeros([5000, 4]), 0.5),
                       (0.0, 1.0, 0.25, 0.02)),
}


def _functional(P_):
    return P_.nn.functional


def _run(name, P_, cases=CASES, ns=_functional):
    """Case ``name`` through package ``P_`` (``ns(P_)`` the namespace its
    fn takes)."""
    inputs, fn = cases[name][:2]
    return fn(P_, ns(P_), *(T(P_, a) if isinstance(a, np.ndarray) else a for a in inputs))


def _float_positions(inputs):
    return [i for i, a in enumerate(inputs) if isinstance(a, np.ndarray) and a.dtype.kind == "f"]


def _cotangent(shape, k):
    """A fixed, non-constant weight of output ``k`` (a plain sum would
    give the normalising ops an analytically zero gradient)."""
    n = int(np.prod(shape))
    return (np.cos(np.arange(n, dtype=np.float32) * 0.7 + k) + 0.5).reshape(shape)


def _jax_loss(name, cases, ns):
    """(loss over the float inputs' arrays, the float positions) of a case:
    the sum of its float outputs (real and imaginary parts of a complex
    one) weighted by :func:`_cotangent`, with every array output as aux."""
    import jax.numpy as jnp

    inputs, fn = cases[name][:2]
    pos = _float_positions(inputs)

    def loss(*xs):
        args = [T(jp, a) if isinstance(a, np.ndarray) else a for a in inputs]
        for i, x in zip(pos, xs):
            args[i] = jp.Tensor(x)
        total, outs = 0.0, []
        for k, o in enumerate(_flat(fn(jp, ns(jp), *args))):
            d = o._data
            outs.append(d)
            if jnp.issubdtype(d.dtype, jnp.inexact):
                parts = (jnp.real(d), jnp.imag(d)) if jnp.iscomplexobj(d) else (d,)
                for j, part in enumerate(parts):
                    total = total + jnp.sum(part.astype(jnp.float32)
                                            * _cotangent(part.shape, 2 * k + j))
        return total, outs

    return loss, pos


def jax_outputs_and_grads(names, cases=CASES, ns=_functional):
    """name -> (the case's JAX outputs as ``_Ref`` s, the gradients of its
    loss as host arrays): one ``value_and_grad`` a case, the cases as one
    jitted program (one at a time where that program does not trace)."""
    import jax

    def one(n):
        loss, pos = _jax_loss(n, cases, ns)
        inputs = cases[n][0]
        (_, outs), grads = jax.value_and_grad(loss, argnums=tuple(range(len(pos))),
                                              has_aux=True)(*(inputs[i] for i in pos))
        return outs, grads

    try:
        out = jax.jit(lambda: {n: one(n) for n in names})()
    except Exception:
        out = {}
        for n in names:
            try:
                out[n] = jax.jit(functools.partial(one, n))()
            except Exception:
                out[n] = one(n)
    return {n: ([_Ref(np.asarray(o)) for o in outs], [np.asarray(g) for g in grads])
            for n, (outs, grads) in out.items()}


def check_port_gradient(name, want, cases=CASES, ns=_functional):
    """The port's gradients of case ``name``'s loss against ``want``."""
    inputs, fn, rtol, _ = cases[name]
    pos = _float_positions(inputs)
    args = [T(tp, a, grad=i in pos) if isinstance(a, np.ndarray) else a
            for i, a in enumerate(inputs)]
    total = 0.0
    for k, o in enumerate(_flat(fn(tp, ns(tp), *args))):
        d = getattr(o, "_data", None)
        if isinstance(d, torch.Tensor) and (d.is_floating_point() or d.is_complex()):
            parts = (d.real, d.imag) if d.is_complex() else (d,)
            for j, part in enumerate(parts):
                c = torch.from_numpy(_cotangent(tuple(part.shape), 2 * k + j))
                total = total + (part.to(torch.float32) * c).sum()
    total.backward()
    for k, i in enumerate(pos):
        g = args[i].grad
        got = np.zeros_like(inputs[i]) if g is None else g.numpy()
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        tol = max(rtol, ACCUM)
        np.testing.assert_allclose(got, want[k], rtol=tol, atol=tol * scale,
                                   err_msg=f"{name}: d/d input {i}")


@pytest.fixture(scope="module")
def ref():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    try:
        jp.seed(3)
        cases = {("op", n): functools.partial(_run, n) for n, c in CASES.items() if not c[3]}
        cases.update({("random", n): (lambda P_, fn=fn: fn(P_, P_.nn.functional))
                      for n, (fn, _) in RANDOM.items()})
        cases.update({("inplace", n): functools.partial(_inplace_run, n) for n in INPLACE})
        out = jax_reference(cases)
        both = jax_outputs_and_grads([n for n, c in CASES.items() if c[3]])
        out.update({("op", n): o for n, (o, _) in both.items()})
        out["grads"] = {n: g for n, (_, g) in both.items()}
        return out
    finally:
        tp.set_device(prev)


def test_cases_cover_every_name_of_jax_functional():
    import paddle_tpu.nn.functional as JF

    names = set(JF.__all__)
    assert tp.nn.functional.__all__ == JF.__all__
    cased = {n.split(":")[0] for n in CASES}
    assert names == cased | set(RANDOM) | set(INPLACE) | {"class_center_sample"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_matches_jax(name, ref):
    tp.seed(0)
    assert_same(_run(name, tp), ref[("op", name)], rtol=CASES[name][2], what=name)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[3]))
def test_functional_gradient_matches_jax(name, ref):
    check_port_gradient(name, ref["grads"][name])


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_functional_matches_jax_in_distribution(name, ref):
    fn, (lo, hi, mean, rel) = RANDOM[name]
    tp.seed(3)
    got = fn(tp, tp.nn.functional)
    g, gd, gs = _np(got)
    _, wd, ws = _np(ref[("random", name)][0])
    assert (gd, gs) == (wd, ws)
    assert g.min() >= lo - 1e-6 and g.max() <= hi + 1e-6, (g.min(), g.max())
    if rel is not None:
        assert abs(float(g.mean()) - mean) <= rel * max(abs(mean), 1.0), g.mean()
    tp.seed(3)
    np.testing.assert_array_equal(_np(fn(tp, tp.nn.functional))[0], g)


def test_batch_norm_updates_the_running_statistics_as_jax():
    """Eager JAX (its traced calls leave the statistics alone)."""
    got = [tp.to_tensor(B3), tp.to_tensor(POS[0, :3])]
    want = [jp.to_tensor(B3), jp.to_tensor(POS[0, :3])]
    for P_, (m, v) in ((tp, got), (jp, want)):
        P_.nn.functional.batch_norm(P_.to_tensor(X), m, v, training=True, momentum=0.8)
    assert_same(got, want, rtol=ACCUM, what="running statistics")


def test_dropout_masks_share_the_unchosen_axes_and_draw_from_the_generator():
    F = tp.nn.functional
    g = torch.Generator().manual_seed(4)
    out = F.dropout(torch.ones(6, 50, 3), 0.5, axis=[0, 1], generator=g).numpy()
    assert (out == out[:, :, :1]).all() and set(np.unique(out)) <= {0.0, 2.0}
    d2 = F.dropout2d(torch.ones(4, 30, 3, 3), 0.5, generator=torch.Generator().manual_seed(1))
    assert (d2 == d2[:, :, :1, :1]).all()
    a = F.alpha_dropout(torch.zeros(20000), 0.3, generator=torch.Generator().manual_seed(2))
    q, alpha_p = 0.7, -1.6732632423543772 * 1.0507009873554805
    a_coef = (q + alpha_p ** 2 * q * (1 - q)) ** -0.5
    np.testing.assert_allclose(np.unique(a.numpy()), sorted(
        [a_coef * alpha_p - a_coef * alpha_p * (1 - q), -a_coef * alpha_p * (1 - q)]), rtol=1e-6)
    hard = F.gumbel_softmax(torch.randn(6, 4, requires_grad=True), hard=True,
                            generator=torch.Generator().manual_seed(0))
    h = hard.detach().numpy()
    np.testing.assert_allclose(np.sort(h, -1), [[0, 0, 0, 1]] * 6, atol=1e-6)


def test_class_center_sample_keeps_the_positives_and_remaps():
    label = np.array([3, 7, 3, 1, 9], np.int32)
    kinds = []
    for P_ in (tp, jp):
        P_.seed(0)
        remapped, sampled = P_.nn.functional.class_center_sample(P_.to_tensor(label), 12, 6)
        r, s = remapped.numpy(), sampled.numpy()
        assert len(s) == 6 and set(label) <= set(s.tolist()) and (np.diff(s) > 0).all()
        np.testing.assert_array_equal(s[r], label)
        kinds.append([_np(t)[1:] for t in (remapped, sampled)])
    assert kinds[0] == kinds[1]
    tp.seed(5)
    a = tp.nn.functional.class_center_sample(tp.to_tensor(label), 12, 8)[1].numpy()
    tp.seed(5)
    np.testing.assert_array_equal(tp.nn.functional.class_center_sample(
        tp.to_tensor(label), 12, 8)[1].numpy(), a)


INPLACE = ["softmax_", "tanh_", "elu_", "leaky_relu_", "hardtanh_", "thresholded_relu_"]


def _inplace_run(name, P_):
    t = T(P_, V)
    out = getattr(P_.nn.functional, name)(t)
    assert out is t
    return out


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_activation_rebinds_to_its_base(name, ref):
    assert_same(_inplace_run(name, tp), ref[("inplace", name)], rtol=RTOL, what=name)
    x = torch.tensor(V)
    y = getattr(tp.nn.functional, name)(x)
    assert y is x and torch.equal(x, getattr(tp.nn.functional, name[:-1])(torch.tensor(V)))


def test_raises_are_lifted_where_jax_computes():
    """Dropout over axes, asymmetric and string pool padding, the pool mask,
    bicubic and area resizing and the transposed convolution's asymmetric
    padding all compute (their values: the cases above); a string padding
    of a transposed convolution raises in both packages."""
    F = tp.nn.functional
    x = torch.randn(1, 2, 6, 6)
    assert F.dropout(x, 0.5, axis=1).shape == x.shape
    assert F.max_pool2d(x, 3, 2, [0, 1, 1, 0]).shape == (1, 2, 3, 3)
    assert F.avg_pool2d(x, 3, 2, "SAME").shape == (1, 2, 3, 3)
    assert F.max_pool2d(x, 2, return_mask=True)[1].dtype == torch.int32
    assert F.interpolate(x, size=[3, 3], mode="bicubic").shape == (1, 2, 3, 3)
    assert F.interpolate(x, size=[4, 4], mode="area").shape == (1, 2, 4, 4)
    w = torch.randn(2, 3, 3, 3)
    assert F.conv2d_transpose(x, w, padding=[1, 0, 0, 1]).shape == (1, 3, 7, 7)
    for P_ in (tp, jp):         # both packages refuse a string padding here
        with pytest.raises(ValueError, match="String padding"):
            P_.nn.functional.conv2d_transpose(P_.to_tensor(x.numpy()), P_.to_tensor(w.numpy()),
                                              stride=2, padding="SAME")



POOLS = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d", "max_pool3d",
         "lp_pool1d", "lp_pool2d"]


@pytest.mark.parametrize("name", POOLS)
def test_pools_refuse_ceil_mode(name):
    """The JAX pools give the floor size whatever ``ceil_mode`` says; the
    port gives it at the default and raises for ``ceil_mode=True``."""
    F = tp.nn.functional
    nd = int(name[-2])
    x = torch.randn(1, 2, *[7] * nd)
    args = (2.0, 2) if name.startswith("lp") else (2,)
    assert tuple(getattr(F, name)(x, *args).shape[2:]) == (3,) * nd
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        getattr(F, name)(x, *args, ceil_mode=True)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_segments_match_the_jax_function(causal):
    """The card's route of ``flash_attn_unpadded`` (each segment with keys
    through the flash entry, here its plain version; the rows that see no
    key filled as the JAX function fills them) against the JAX function,
    values and gradients within ``ACCUM``, where the query and key
    boundaries differ: a segment with more keys than queries, two with
    more queries than keys (causal: rows that see no key), one without
    keys."""
    import jax

    r = np.random.default_rng(181)
    cu_q, cu_k = [0, 4, 10, 13, 16, 21], [0, 6, 9, 9, 12, 14]
    q, k, v = (r.standard_normal((n, 2, 32)).astype(np.float32) for n in (21, 14, 14))
    ct = _cotangent((21, 2, 32), 0)

    def jax_loss(q, k, v):
        o = jp.nn.functional.flash_attn_unpadded(jp.Tensor(q), jp.Tensor(k), jp.Tensor(v),
                                                 np.array(cu_q), np.array(cu_k), 6, 6, 0.3,
                                                 causal=causal)[0]._data
        return (o * ct).sum(), o

    (_, want), grads = jax.value_and_grad(jax_loss, (0, 1, 2), has_aux=True)(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = tp.nn.functional._varlen_segments(*ts, cu_q, cu_k, causal, 0.3)
    (got * torch.from_numpy(ct)).sum().backward()
    for a, b in [(got.detach(), want)] + [(t.grad, g) for t, g in zip(ts, grads)]:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=ACCUM, atol=ACCUM * np.abs(b).max())


def test_entry_points_take_and_give_tensors():
    x = tp.to_tensor(V)
    out = tp.nn.functional.silu(x)
    assert isinstance(out, tp.Tensor)
    assert isinstance(tp.nn.functional.silu(torch.tensor(V)), torch.Tensor)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="rms_norm"):
            tp.nn.functional.rms_norm(tp.to_tensor(np.full((2, 128), np.inf, np.float32)))
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})
