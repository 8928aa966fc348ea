"""ERNIE text classification (BASELINE configs[0]) in paddle_tpu_torch
against paddle_tpu (CPU, fp32): the non-``hapi`` cases of
``tests/test_ernie.py``, on weights carried across by ``models.convert``.

Logits (with and without segment ids, with a padding mask) within rtol =
atol = 1e-5; five Adam steps of ``TrainStep`` against the JAX
``TrainStep``'s losses within rtol 2e-4, atol 2e-5 (the JAX test's own
eager-vs-compiled limit) and the parameters after them within 1e-4; the
port's eager loop against its ``TrainStep`` to the same limit.  (The key
biases are left out of the parameter check: their gradient is zero but for
rounding, which Adam normalises into a step of either sign.)  A cut
ERNIE at head dim 64 sends attention through ``kernels.flash_attention``
(its plain versions on the CPU) and is held to the JAX model the same way.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieForSequenceClassification as JaxErnie
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ErnieConfig, ErnieForSequenceClassification,
                                     ernie_tiny_config, load_paddle_tpu_params,
                                     to_paddle_tpu_params)
from paddle_tpu_torch.optimizer import Adam

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)


def _task(n=64, seq=16, vocab=200, classes=2, seed=0):
    """Synthetic separable text-cls: class = which marker token appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    y = rng.integers(0, classes, size=(n,)).astype(np.int64)
    ids[:, 1] = y + 1
    return ids, y


def _tiny(**kw):
    cfg = dict(vocab_size=200, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=96, max_position_embeddings=32, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    cfg.update(kw)
    return cfg


def _pair(cfg_kw, num_classes=2, seed=0):
    """The JAX model and the port's on its weights."""
    import paddle_tpu.models.ernie as jax_ernie

    paddle.seed(seed)
    jm = JaxErnie(jax_ernie.ernie_tiny_config(**cfg_kw), num_classes=num_classes)
    tm = ErnieForSequenceClassification(ernie_tiny_config(**cfg_kw), num_classes=num_classes,
                                        device="cpu", seed=seed)
    load_paddle_tpu_params(tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    return jm, tm


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x._data)


@pytest.mark.parametrize("cut", [dict(), dict(hidden_size=128, num_attention_heads=2,
                                             intermediate_size=256)],
                         ids=["head dim 12, plain", "head dim 64, the flash route"])
def test_forward_shapes_and_logits_match_jax(cut, monkeypatch):
    from paddle_tpu_torch.kernels import flash_attention as fa

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    jm, tm = _pair(_tiny(**cut), num_classes=3)
    hidden = tm.ernie.config.hidden_size
    ids, _ = _task(n=4)
    seg = (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(4, 0)
    logits = tm(torch.from_numpy(ids))
    assert tuple(logits.shape) == (4, 3)
    assert len(calls) == (2 if cut else 0)               # a layer each at head dim 64
    np.testing.assert_allclose(_np(logits), _np(jm(paddle.to_tensor(ids))), **TOL)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(ids), torch.from_numpy(seg))),
                               _np(jm(paddle.to_tensor(ids), paddle.to_tensor(seg))), **TOL)
    seq_out, pooled = tm.ernie(torch.from_numpy(ids))
    assert tuple(seq_out.shape) == (4, 16, hidden) and tuple(pooled.shape) == (4, hidden)


def test_attention_mask_zeroes_padding_influence_and_matches_jax():
    jm, tm = _pair(_tiny())
    tm.eval()
    jm.eval()
    ids, _ = _task(n=2)
    mask = np.ones_like(ids, np.float32)
    mask[:, 8:] = 0.0
    out1 = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    ids2 = ids.copy()
    ids2[:, 8:] = 99                                    # only masked positions change
    out2 = tm(torch.from_numpy(ids2), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(out1), _np(out2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(out1), _np(jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))), **TOL)


def test_eager_training_learns():
    """The configs[0] contract: trains eagerly on the CPU and learns."""
    model = ErnieForSequenceClassification(ernie_tiny_config(**_tiny()), device="cpu", seed=0)
    opt = Adam(learning_rate=2e-3, parameters=model.parameters())
    ids, y = _task()
    ids_t, y_t = torch.from_numpy(ids), torch.from_numpy(y)
    first = None
    for _ in range(25):
        loss = model.compute_loss(model(ids_t), y_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = first if first is not None else float(loss.detach())
    assert float(loss.detach()) < first * 0.3
    preds = np.argmax(_np(model(ids_t)), -1)
    assert (preds == y).mean() > 0.9


def test_trainstep_adam_losses_match_jax_and_eager():
    """Five Adam steps: the port's TrainStep against the JAX TrainStep on
    the same weights and batch, and against the port's eager loop."""
    ids, y = _task(n=32)

    def loss_fn(m, ids, y):
        return m.compute_loss(m(ids), y)

    jm, tm = _pair(_tiny(), seed=1)
    jstep = paddle.jit.TrainStep(jm, loss_fn,
                                 paddle.optimizer.Adam(learning_rate=1e-3,
                                                       parameters=jm.parameters()))
    jax_losses = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(y)).numpy())
                  for _ in range(5)]
    tstep = TrainStep(tm, loss_fn, Adam(learning_rate=1e-3, parameters=tm.parameters()))
    losses = [float(tstep(torch.from_numpy(ids), torch.from_numpy(y))) for _ in range(5)]
    np.testing.assert_allclose(losses, jax_losses, **LOSS_TOL)
    after = to_paddle_tpu_params(tm)
    for k, v in jm.state_dict().items():
        if k.endswith("k_proj.bias"):
            # a key bias shifts a query's scores evenly: its gradient is zero
            # but for rounding, which Adam's normalised step turns into +-lr
            continue
        np.testing.assert_allclose(after[k], np.asarray(v._data), rtol=1e-4, atol=1e-4,
                                   err_msg=k)

    _, em = _pair(_tiny(), seed=1)
    opt = Adam(learning_rate=1e-3, parameters=em.parameters())
    eager = []
    for _ in range(5):
        loss = em.compute_loss(em(torch.from_numpy(ids)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss.detach()))
    np.testing.assert_allclose(losses, eager, **LOSS_TOL)


def test_config_defaults_are_ernie_tiny_and_the_model_refuses_cpu_unasked(monkeypatch):
    cfg = ernie_tiny_config()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.vocab_size) == (312, 4, 12, 1248, 18000)
    assert isinstance(cfg, ErnieConfig)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ErnieForSequenceClassification(ernie_tiny_config(**_tiny()))
