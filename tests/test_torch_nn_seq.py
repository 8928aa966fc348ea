"""paddle_tpu_torch.nn's CTC loss, attention and transformer family against
paddle_tpu.nn on the same inputs (CPU, fp32); the recurrent layers are
``test_torch_nn_rnn.py``'s.

Inputs come from numpy generators with fixed seeds; a layer's weights are
carried from the JAX layer into the port's by ``models.convert``.  Outputs
and gradients are held to rtol = atol = 1e-5 (fp32 sums in another order)
unless a case says otherwise.  CTC's losses and gradients are held for rows
of every kind, its impossible alignment (a huge finite loss) included.
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
# CTC
# ---------------------------------------------------------------------------

def test_ctc_loss_simple_case():
    logits = np.log(np.array([[[0.6, 0.4]], [[0.3, 0.7]]], np.float32))
    loss = F.ctc_loss(_tt(logits), np.array([[1]]), np.array([2]), np.array([1]),
                      reduction="none")
    p = 0.6 * 0.7 + 0.4 * 0.3 + 0.4 * 0.7
    np.testing.assert_allclose(_np(loss), [-np.log(p)], rtol=1e-4)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_gradients_match_jax(reduction):
    """Rows of every kind: a repeated label (needs a blank between), a
    short input, an empty label; with ``"none"`` also a row that cannot
    fit its labels, whose loss is huge and finite as in the JAX package.
    Its gradient is rounding at 1e30 on both sides, so it is weighted 0."""
    T, B, C = 12, 4, 7
    logits = _rand((T, B, C), scale=2.0)
    labels = np.array([[1, 2, 2, 3, 0], [4, 4, 0, 0, 0], [5, 1, 6, 2, 3], [0, 0, 0, 0, 0]])
    lab_len = np.array([4, 2, 5, 0])
    in_len = np.array([12, 9, 4 if reduction == "none" else 11, 6])
    jl, tl = _jt(logits, True), _tt(logits, True)
    jo = JF.ctc_loss(jl, _jt(labels), _jt(in_len), _jt(lab_len), blank=0, reduction=reduction)
    to = F.ctc_loss(tl, labels, in_len, lab_len, blank=0, reduction=reduction)
    _close(to, jo)
    if reduction == "none":
        assert np.isfinite(_np(to)).all() and _np(to)[2] > 1e29
        w = np.array([1.0, 2.0, 0.0, 3.0], np.float32)
        jo, to = (jo * _jt(w)).sum(), (to * _tt(w)).sum()
    jo.backward()
    to.backward()
    _close(tl.grad, jl.grad)
    _close(nn.CTCLoss(reduction=reduction)(_tt(logits), labels, in_len, lab_len),
           jnn.CTCLoss(reduction=reduction)(_jt(logits), _jt(labels), _jt(in_len),
                                            _jt(lab_len)))


# ---------------------------------------------------------------------------
# attention and transformers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "mask"])
def test_multihead_attention_matches_jax(masked):
    paddle.seed(7)
    jm = jnn.MultiHeadAttention(32, 4, dropout=0.1)
    tm = _carry(jm, nn.MultiHeadAttention(32, 4, dropout=0.1, **CPU))
    x = _rand((2, 6, 32))
    mask = None
    if masked:
        keep = np.ones((2, 6), np.float32)
        keep[1, 4:] = 0.0
        mask = ((1.0 - keep[:, None, None, :]) * -1e9).astype(np.float32)
    jx, tx = _jt(x, True), _tt(x, True)
    jo = jm(jx, attn_mask=None if mask is None else _jt(mask))
    to = tm(tx, attn_mask=None if mask is None else _tt(mask))
    _close(to, jo)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(tx.grad, jx.grad)
    _grads_match(jm, tm)


def test_sdpa_routes_as_the_jax_package(monkeypatch):
    from paddle_tpu_torch.kernels import flash_attention as fa

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    q = _tt(_rand((2, 8, 4, 64)))
    F.scaled_dot_product_attention(q, q, q)
    assert calls == [1]                                      # no mask, D 64: the kernel
    F.scaled_dot_product_attention(q, q, q, attn_mask=torch.zeros(2, 1, 1, 8))
    q26 = _tt(_rand((2, 8, 4, 26)))
    F.scaled_dot_product_attention(q26, q26, q26)
    assert calls == [1]                                      # masked, or D 26: plain
    jq = _rand((2, 8, 4, 64), 1)
    for causal in (False, True):
        _close(F.scaled_dot_product_attention(_tt(jq), _tt(jq), _tt(jq), is_causal=causal),
               JF.scaled_dot_product_attention(_jt(jq), _jt(jq), _jt(jq), is_causal=causal))
    out, none = F.flash_attention(_tt(jq), _tt(jq), _tt(jq), causal=True)
    assert none is None and tuple(out.shape) == jq.shape


def test_transformer_encoder_matches_jax_and_copies_its_layer():
    paddle.seed(8)
    jl = jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0, activation="gelu")
    je = jnn.TransformerEncoder(jl, 2)
    te = nn.TransformerEncoder(nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                                          activation="gelu", **CPU), 2)
    for a, b in zip(te.layers[0].parameters(), te.layers[1].parameters()):
        assert torch.equal(a, b)                    # deep copies: the same start
    _carry(je, te)
    x = _rand((2, 5, 16))
    jx, tx = _jt(x, True), _tt(x, True)
    jo, to = je(jx), te(tx)
    _close(to, jo)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(tx.grad, jx.grad, rtol=1e-4, atol=1e-5)
    _grads_match(je, te, rtol=1e-4, atol=1e-5)
    g = te.layers[0].dropout1._generator
    assert g is te.layers[1].dropout1._generator


def test_transformer_encoder_decoder_matches_jax():
    paddle.seed(9)
    jt = jnn.Transformer(16, 4, 2, 2, 32, dropout=0.0, normalize_before=True)
    tt = _carry(jt, nn.Transformer(16, 4, 2, 2, 32, dropout=0.0, normalize_before=True, **CPU))
    src, tgt = _rand((2, 6, 16)), _rand((2, 5, 16), 1)
    mask = np.asarray(tt.generate_square_subsequent_mask(5))
    _close(tt(_tt(src), _tt(tgt), tgt_mask=_tt(mask)),
           jt(_jt(src), _jt(tgt), tgt_mask=_jt(mask)), rtol=1e-4, atol=1e-5)


def test_multihead_attention_cache_matches_jax():
    paddle.seed(10)
    jm = jnn.MultiHeadAttention(16, 2)
    tm = _carry(jm, nn.MultiHeadAttention(16, 2, **CPU))
    mem, x = _rand((1, 3, 16)), _rand((1, 2, 16), 1)
    jo, jc = jm(_jt(x), cache=jm.gen_cache(_jt(mem)))
    to, tc = tm(_tt(x), cache=tm.gen_cache(_tt(mem)))
    _close(to, jo)
    assert tuple(tc.k.shape) == (1, 5, 2, 8)
