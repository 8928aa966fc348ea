"""paddle_tpu_torch.nn's recurrent layers (the cells, ``RNN`` and the
multi-layer, bidirectional nets) against paddle_tpu.nn on the same inputs
(CPU, fp32): parameter names, outputs, final states and gradients.

Inputs come from numpy generators with fixed seeds; a layer's weights are
carried from the JAX layer into the port's by ``models.convert``.  Outputs
and gradients are held to rtol = atol = 1e-5 (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as nn
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
# recurrent layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,kw", [("GRU", dict(direction="bidirect")),
                                    ("GRU", dict(num_layers=2)),
                                    ("LSTM", dict(num_layers=2, direction="bidirect")),
                                    ("SimpleRNN", dict()),
                                    ("SimpleRNN", dict(activation="relu", time_major=True))],
                         ids=["gru-bi", "gru-2", "lstm-2-bi", "rnn", "rnn-relu-tm"])
def test_recurrent_nets_and_gradients_match_jax(cls, kw):
    paddle.seed(11)
    jr = getattr(jnn, cls)(8, 16, **kw)
    tr = _carry(jr, getattr(nn, cls)(8, 16, **kw, **CPU))
    assert [n for n, _ in tr.named_parameters()] == [n for n, _ in jr.named_parameters()]
    x = _rand((4, 6, 8))
    jx, tx = _jt(x, True), _tt(x, True)
    (jo, js), (to, ts) = jr(jx), tr(tx)
    _close(to, jo)
    if cls == "LSTM":
        _close(ts[0], js[0])
        _close(ts[1], js[1])
    else:
        _close(ts, js)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(tx.grad, jx.grad)
    _grads_match(jr, tr)


@pytest.mark.parametrize("cls", ["GRUCell", "LSTMCell", "SimpleRNNCell"])
def test_cells_and_rnn_wrapper_match_jax(cls):
    paddle.seed(12)
    jc = getattr(jnn, cls)(5, 7)
    tc = _carry(jc, getattr(nn, cls)(5, 7, **CPU))
    x = _rand((3, 4, 5))
    jo, js = jnn.RNN(jc, is_reverse=True)(_jt(x))
    to, ts = nn.RNN(tc, is_reverse=True)(_tt(x))
    _close(to, jo)
    if cls == "LSTMCell":
        _close(ts[1], js[1])
    h, _ = tc(_tt(x[:, 0]))
    _close(h, jc(_jt(x[:, 0]))[0])
