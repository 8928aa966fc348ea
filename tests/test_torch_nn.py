"""paddle_tpu_torch.nn (the stock layer library) against paddle_tpu.nn on
the same inputs (CPU, fp32).

Inputs come from numpy generators with fixed seeds; a layer's weights (and
BatchNorm's running statistics) are carried from the JAX layer into the
port's by ``models.convert``.  Outputs and gradients are held to rtol =
atol = 1e-5 (fp32 sums in another order) unless a case says otherwise;
BatchNorm's ``_mean`` / ``_variance`` after three training forwards to the
same limit.  The cases follow ``tests/test_nn.py`` where the ported
modules cover them, and add the places where torch and the JAX package
define an op differently (the running-statistics update).  The
convolutions, pools and resizing are ``test_torch_nn_conv.py``'s; the
sequence layers (CTC, attention, the transformer and recurrent families)
``test_torch_nn_seq.py``'s.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.nn.initializer import _fan_in_out
from paddle_tpu_torch.models import load_paddle_tpu_params, to_paddle_tpu_params
from paddle_tpu_torch.nn import initializer as I

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
# Layer, containers, initializers
# ---------------------------------------------------------------------------

def test_linear_matches_jax_and_has_its_layout():
    paddle.seed(0)
    jl = jnn.Linear(4, 3)
    tl = _carry(jl, nn.Linear(4, 3, **CPU))
    assert tuple(tl.weight.shape) == (4, 3)
    x = _rand((2, 4))
    _close(tl(_tt(x)), jl(_jt(x)))
    _close(tl(_tt(x)), x @ _np(tl.weight) + _np(tl.bias))


def test_layer_registration_and_state_dict():
    class M(nn.Layer):
        def __init__(self):
            super().__init__(**CPU)
            self.fc1 = nn.Linear(4, 4, **CPU)
            self.sub = nn.Sequential(nn.Linear(4, 4, **CPU), nn.ReLU())
            self.p = self.create_parameter([3], default_initializer=I.Constant(0.0))

        def forward(self, x):
            return self.sub(self.fc1(x)) + 0 * self.p.sum()

    m = M()
    names = [n for n, _ in m.named_parameters()]
    assert "p" in names and "fc1.weight" in names and "sub.0.weight" in names
    assert len(list(m.parameters())) == 5
    sd = m.state_dict()
    assert set(sd) == set(names)
    missing, unexpected = m.set_state_dict({k: np.ones(tuple(v.shape), np.float32)
                                            for k, v in sd.items()})
    assert (missing, unexpected) == ([], [])
    np.testing.assert_allclose(_np(m.fc1.weight), 1.0)
    missing, unexpected = m.set_state_dict({"fc1.bias": np.zeros(4, np.float32), "nope": 1})
    assert "fc1.weight" in missing and unexpected == ["nope"]
    with pytest.raises(ValueError, match="shape mismatch"):
        m.set_state_dict({"p": np.zeros(4, np.float32)})


def test_train_eval_mode():
    m = nn.Sequential(nn.Linear(4, 4, **CPU), nn.Dropout(0.5))
    m.eval()
    x = torch.ones(10, 4)
    _close(m(x), m(x))
    m.train()
    assert m[1].training


def test_layers_without_generator_draw_apart():
    """Layers built without ``generator=`` draw from the device's advancing
    default generator: two Linears get different weights, two Dropouts
    different masks, and ``seed`` replays the same sequence."""

    def draw():
        a, b = nn.Linear(8, 8, **CPU), nn.Linear(8, 8, **CPU)
        x = torch.ones(64, 8)
        da, db = nn.Dropout(0.5), nn.Dropout(0.5)
        return a.weight.detach(), b.weight.detach(), da(x), db(x)

    pt.seed(3)
    wa, wb, ma, mb = draw()
    assert not torch.equal(wa, wb)
    assert not torch.equal(ma, mb)
    pt.seed(3)
    again = draw()
    for x, y in zip((wa, wb, ma, mb), again):
        assert torch.equal(x, y)


def test_sequential_and_layerlist():
    s = nn.Sequential(nn.Linear(4, 8, **CPU), nn.ReLU(), nn.Linear(8, 2, **CPU))
    assert len(s) == 3 and isinstance(s[0:2], nn.Sequential) and len(s[0:2]) == 2
    named = nn.Sequential(("a", nn.ReLU()), ("b", nn.Tanh()))
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    ll = nn.LayerList([nn.Linear(2, 2, **CPU) for _ in range(3)])
    ll.append(nn.Linear(2, 2, **CPU))
    assert len(ll) == 4 and len(list(ll)) == 4
    assert isinstance(ll, nn.Layer) and isinstance(s, nn.Layer)
    pl = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    assert len(pl) == 1 and len(list(pl.parameters())) == 1


@pytest.mark.parametrize("shape", [[5], [4, 3], [8, 3, 3, 3], [6, 2, 5]])
def test_fans_follow_the_jax_rule(shape):
    assert I.fans(shape) == tuple(_fan_in_out(shape))


def test_initializers_draw_from_the_generator():
    g = torch.Generator().manual_seed(3)
    w = I.XavierUniform()([64, 32], torch.float32, g)
    assert float(w.abs().max()) <= (6.0 / 96) ** 0.5 and w.dtype == torch.float32
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(w, I.XavierUniform()([64, 32], torch.float32, g2))
    k = I.KaimingUniform(fan_in=27)([8, 3, 3, 3], torch.float32, g)
    assert float(k.abs().max()) <= I.calculate_gain("relu") * (3.0 / 27) ** 0.5
    c = I.Constant(0.5)([3], torch.bfloat16, g)
    assert c.dtype == torch.bfloat16 and float(c.float().min()) == 0.5
    n = I.Normal(0.0, 1.0)([4096], torch.float32, g)
    assert abs(float(n.mean())) < 0.1 and abs(float(n.std()) - 1.0) < 0.1


def test_layers_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.Linear(2, 2)
    nn.ReLU()                                          # holds nothing: never asks
    nn.MaxPool2D(2, 2)


def test_convert_carries_batchnorm_buffers_both_ways():
    paddle.seed(0)
    jb = jnn.BatchNorm2D(3)
    jb(_jt(_rand((4, 3, 5, 5))))                      # moves the JAX running stats
    tb = _carry(jb, nn.BatchNorm2D(3, **CPU))
    _close(tb._mean, jb._mean)
    _close(tb._variance, jb._variance)
    back = to_paddle_tpu_params(tb)
    assert set(back) == {"weight", "bias", "_mean", "_variance"}
    jb2 = jnn.BatchNorm2D(3)
    jb2.set_state_dict({k: paddle.to_tensor(v) for k, v in back.items()})
    _close(jb2._variance, tb._variance)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def test_batchnorm_running_stats_after_three_training_forwards_match_jax():
    paddle.seed(3)
    jb = jnn.BatchNorm2D(4, momentum=0.9)
    tb = _carry(jb, nn.BatchNorm2D(4, momentum=0.9, **CPU))
    for i in range(3):
        x = _rand((3, 4, 5, 6), seed=i, scale=2.0) + i
        _close(tb(_tt(x)), jb(_jt(x)))
    _close(tb._mean, jb._mean)
    _close(tb._variance, jb._variance)
    jb.eval()
    tb.eval()
    x = _rand((2, 4, 5, 6), seed=9)
    _close(tb(_tt(x)), jb(_jt(x)))


def test_batchnorm_gradients_and_1d_match_jax():
    paddle.seed(4)
    jb, x = jnn.BatchNorm1D(5), _rand((6, 5, 7))
    tb = _carry(jb, nn.BatchNorm1D(5, **CPU))
    jx, tx = _jt(x, True), _tt(x, True)
    jo, to = jb(jx), tb(tx)
    _close(to, jo)
    (jo * jo * jo).sum().backward()
    (to * to * to).sum().backward()
    _close(tx.grad, jx.grad, rtol=1e-4, atol=1e-4)
    _grads_match(jb, tb, rtol=1e-4, atol=1e-4)
    _close(tb._mean, jb._mean)
    _close(tb._variance, jb._variance)


def test_layernorm_matches_jax():
    paddle.seed(5)
    jl = jnn.LayerNorm(8)
    tl = _carry(jl, nn.LayerNorm(8, **CPU))
    x = _rand((2, 4, 8), scale=3.0)
    jx, tx = _jt(x, True), _tt(x, True)
    jo, to = jl(jx), tl(tx)
    _close(to, jo)
    np.testing.assert_allclose(_np(to).mean(-1), 0.0, atol=1e-5)
    (jo * jo * jo).sum().backward()
    (to * to * to).sum().backward()
    _close(tx.grad, jx.grad, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# embedding, dropout, activations, losses
# ---------------------------------------------------------------------------

def test_embedding_padding_idx_matches_jax():
    paddle.seed(6)
    je = jnn.Embedding(10, 4, padding_idx=0)
    te = _carry(je, nn.Embedding(10, 4, padding_idx=0, **CPU))
    np.testing.assert_allclose(_np(te.weight)[0], 0.0)
    idx = np.array([[1, 0], [2, 3]])
    jo, to = je(_jt(idx)), te(_tt(idx))
    _close(to, jo)
    np.testing.assert_allclose(_np(to)[0, 1], 0.0)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(te.weight.grad, je.weight.grad)
    np.testing.assert_allclose(_np(te.weight.grad)[0], 0.0)


def test_dropout_scaling():
    x = torch.ones(1000)
    g = torch.Generator().manual_seed(5)
    out = F.dropout(x, 0.5, training=True, generator=g)
    kept = _np(out)[_np(out) != 0]
    np.testing.assert_allclose(kept, 2.0)
    assert 300 < kept.size < 700
    np.testing.assert_allclose(_np(F.dropout(x, 0.5, training=False)), 1.0)
    pt.seed(0)                      # the layer draws from the CPU's default generator
    layer = nn.Dropout(0.5)
    assert torch.equal(layer(x) != 0,
                       F.dropout(x, 0.5, generator=torch.Generator().manual_seed(0)) != 0)


def test_activations_match_jax():
    x = _rand((3, 7), scale=2.0)
    for name in ("relu", "gelu", "tanh", "sigmoid"):
        _close(getattr(F, name)(_tt(x)), getattr(JF, name)(_jt(x)))
    _close(F.gelu(_tt(x), approximate=True), JF.gelu(_jt(x), approximate=True))
    _close(F.softmax(_tt(x), axis=0), JF.softmax(_jt(x), axis=0))
    _close(F.log_softmax(_tt(x)), JF.log_softmax(_jt(x)))
    _close(nn.GELU()(_tt(x)), jnn.GELU()(_jt(x)))
    np.testing.assert_allclose(_np(F.gelu(_tt(np.array([-2.0, 0.0, 2.0], np.float32)))),
                               [-0.0455, 0.0, 1.9545], atol=1e-3)


@pytest.mark.parametrize("kw", [dict(), dict(reduction="none"), dict(reduction="sum"),
                                dict(ignore_index=1), dict(label_smoothing=0.1),
                                dict(weight=[0.5, 2.0, 1.0]),
                                dict(weight=[0.5, 2.0, 1.0], ignore_index=0)],
                         ids=["mean", "none", "sum", "ignore", "smoothing", "weight",
                              "weight+ignore"])
def test_cross_entropy_matches_jax(kw):
    logits, labels = _rand((6, 3), scale=2.0), np.array([0, 1, 2, 1, 0, 2])
    jkw, tkw = dict(kw), dict(kw)
    if "weight" in kw:
        w = np.asarray(kw["weight"], np.float32)
        jkw["weight"], tkw["weight"] = _jt(w), _tt(w)
    jl, tl = _jt(logits, True), _tt(logits, True)
    jo, to = JF.cross_entropy(jl, _jt(labels), **jkw), F.cross_entropy(tl, _tt(labels), **tkw)
    _close(to, jo)
    jo.sum().backward()
    to.sum().backward()
    _close(tl.grad, jl.grad)
    _close(nn.CrossEntropyLoss(**tkw)(_tt(logits), _tt(labels)),
           jnn.CrossEntropyLoss(**jkw)(_jt(logits), _jt(labels)))


def test_cross_entropy_soft_labels_and_label_column():
    logits = _rand((4, 5))
    soft = np.random.default_rng(1).dirichlet(np.ones(5), size=4).astype(np.float32)
    _close(F.cross_entropy(_tt(logits), _tt(soft), soft_label=True),
           JF.cross_entropy(_jt(logits), _jt(soft), soft_label=True))
    col = np.array([[1], [0], [4], [2]])
    _close(F.cross_entropy(_tt(logits), _tt(col)), JF.cross_entropy(_jt(logits), _jt(col)))


def test_other_losses_match_jax():
    a = np.array([0.2, 0.8, 0.0, 1.0], np.float32)
    b = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    _close(F.mse_loss(_tt(a), _tt(b)), JF.mse_loss(_jt(a), _jt(b)))
    _close(nn.MSELoss("sum")(_tt(a), _tt(b)), jnn.MSELoss("sum")(_jt(a), _jt(b)))
    _close(F.binary_cross_entropy(_tt(a), _tt(b)), JF.binary_cross_entropy(_jt(a), _jt(b)))
    w = np.array([1.0, 2.0, 0.5, 1.0], np.float32)
    _close(nn.BCELoss(_tt(w), "none")(_tt(a), _tt(b)),
           jnn.BCELoss(_jt(w), "none")(_jt(a), _jt(b)))
