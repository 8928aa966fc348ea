"""paddle_tpu_torch.nn's convolutions, pools and resizing against
paddle_tpu.nn on the same inputs (CPU, fp32); the rest of the layer
library is ``test_torch_nn.py``'s and ``test_torch_nn_seq.py``'s.

Inputs come from numpy generators with fixed seeds; a layer's weights are
carried from the JAX layer into the port's by ``models.convert``.  Outputs
and gradients are held to rtol = atol = 1e-5 (fp32 sums in another order)
unless a case says otherwise; nearest resizing, at odd sizes too, to the
bit (``jax.image.resize``'s half-pixel rule is torch's "nearest-exact").
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.models import load_paddle_tpu_params

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _carry(jax_layer, layer):
    """The JAX layer's parameters and persistent buffers into the port's."""
    load_paddle_tpu_params(layer, {k: np.asarray(v._data)
                                   for k, v in jax_layer.state_dict().items()})
    return layer


def _jt(a, grad=False):
    t = paddle.to_tensor(a)
    if grad:
        t.stop_gradient = False
    return t


def _tt(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _grads_match(jax_layer, layer, **tol):
    jg = {n: p.grad for n, p in jax_layer.named_parameters()}
    for n, p in layer.named_parameters():
        _close(p.grad, jg[n], **tol)


# ---------------------------------------------------------------------------
# convolution, pooling, resizing
# ---------------------------------------------------------------------------

def test_conv2d_values_and_grads_match_jax():
    paddle.seed(1)
    jc = jnn.Conv2D(3, 8, 3, stride=2, padding=1, groups=1)
    tc = _carry(jc, nn.Conv2D(3, 8, 3, stride=2, padding=1, **CPU))
    x = _rand((2, 3, 9, 9))
    jx, tx = _jt(x, True), _tt(x, True)
    jo, to = jc(jx), tc(tx)
    _close(to, jo)
    jo.sum().backward()
    to.sum().backward()
    _close(tx.grad, jx.grad)
    _grads_match(jc, tc)


@pytest.mark.parametrize("padding", ["SAME", "VALID", [1, 2], [0, 1, 2, 1]])
def test_conv2d_paddings_match_jax(padding):
    w, x = _rand((4, 2, 3, 3)), _rand((1, 2, 7, 8), 1)
    for stride in (1, 2):
        _close(F.conv2d(_tt(x), _tt(w), stride=stride, padding=padding),
               JF.conv2d(_jt(x), _jt(w), stride=stride, padding=padding))


def test_conv1d_matches_jax():
    w, b, x = _rand((4, 3, 3)), _rand((4,), 2), _rand((2, 3, 10), 1)
    _close(F.conv1d(_tt(x), _tt(w), _tt(b), padding=1),
           JF.conv1d(_jt(x), _jt(w), _jt(b), padding=1))


def test_conv2d_matches_manual():
    conv = nn.Conv2D(1, 1, 2, bias_attr=False, **CPU)
    conv.set_state_dict({"weight": np.ones((1, 1, 2, 2), np.float32)})
    out = conv(torch.arange(9, dtype=torch.float32).reshape(1, 1, 3, 3))
    np.testing.assert_allclose(_np(out)[0, 0], [[8, 12], [20, 24]])


@pytest.mark.parametrize("stride,padding,out_pad,groups", [(2, 1, 0, 1), (2, 0, 1, 2),
                                                           (3, 1, 2, 1), (2, 0, 0, 1)])
def test_conv2d_transpose_matches_jax(stride, padding, out_pad, groups):
    paddle.seed(2)
    jc = jnn.Conv2DTranspose(4, 6, 3, stride=stride, padding=padding, output_padding=out_pad,
                             groups=groups)
    tc = _carry(jc, nn.Conv2DTranspose(4, 6, 3, stride=stride, padding=padding,
                                       output_padding=out_pad, groups=groups, **CPU))
    assert tuple(tc.weight.shape) == (4, 6 // groups, 3, 3)
    x = _rand((2, 4, 5, 5))
    jx, tx = _jt(x, True), _tt(x, True)
    jo, to = jc(jx), tc(tx)
    assert tuple(to.shape) == tuple(jo.shape)
    _close(to, jo)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(tx.grad, jx.grad, rtol=1e-5, atol=1e-4)
    _grads_match(jc, tc, rtol=1e-5, atol=1e-4)


def test_pools_match_jax():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    np.testing.assert_allclose(_np(F.max_pool2d(_tt(x), 2, 2))[0, 0], [[5, 7], [13, 15]])
    np.testing.assert_allclose(_np(F.avg_pool2d(_tt(x), 2, 2))[0, 0],
                               [[2.5, 4.5], [10.5, 12.5]])
    np.testing.assert_allclose(_np(F.adaptive_avg_pool2d(_tt(x), 1)).reshape(-1), [7.5])
    y = _rand((2, 3, 7, 9))
    _close(F.max_pool2d(_tt(y), 3, 2, 1), JF.max_pool2d(_jt(y), 3, 2, 1))
    _close(F.max_pool2d(_tt(y), (2, 1), (2, 1)), JF.max_pool2d(_jt(y), (2, 1), (2, 1)))
    for exclusive in (True, False):
        _close(F.avg_pool2d(_tt(y), 3, 2, 1, exclusive=exclusive),
               JF.avg_pool2d(_jt(y), 3, 2, 1, exclusive=exclusive))
    _close(F.adaptive_avg_pool2d(_tt(y), (3, 4)), JF.adaptive_avg_pool2d(_jt(y), (3, 4)))
    _close(nn.MaxPool2D(2, 2)(_tt(y)), jnn.MaxPool2D(2, 2)(_jt(y)))
    _close(nn.AvgPool2D(2, 2)(_tt(y)), jnn.AvgPool2D(2, 2)(_jt(y)))
    _close(nn.AdaptiveAvgPool2D(2)(_tt(y)), jnn.AdaptiveAvgPool2D(2)(_jt(y)))


@pytest.mark.parametrize("src,dst", [((3, 3), (6, 6)), ((5, 7), (10, 13)), ((3, 3), (5, 5)),
                                     ((10, 15), (6, 7)), ((12, 12), (6, 6))])
def test_interpolate_nearest_at_odd_sizes_matches_jax(src, dst):
    x = _rand((2, 3) + src)
    got = F.interpolate(_tt(x), size=dst, mode="nearest")
    _close(got, JF.interpolate(_jt(x), size=list(dst), mode="nearest"), rtol=0, atol=0)


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 13)), ((3, 3), (5, 5)), ((10, 15), (6, 7))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_interpolate_bilinear_matches_jax(src, dst, align_corners):
    x = _rand((2, 3) + src)
    _close(F.interpolate(_tt(x), size=dst, mode="bilinear", align_corners=align_corners),
           JF.interpolate(_jt(x), size=list(dst), mode="bilinear",
                          align_corners=align_corners))


def test_interpolate_scale_factor_and_upsample():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    out = F.interpolate(_tt(x), size=[4, 4], mode="nearest")
    assert tuple(out.shape) == (1, 1, 4, 4)
    _close(F.interpolate(_tt(x), scale_factor=2, mode="bilinear"),
           JF.interpolate(_jt(x), scale_factor=2, mode="bilinear"))
    y = _rand((1, 2, 5, 5))
    _close(nn.Upsample(scale_factor=1.5)(_tt(y)), jnn.Upsample(scale_factor=1.5)(_jt(y)),
           rtol=0, atol=0)
