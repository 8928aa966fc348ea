"""The OCR detection + recognition recipe (BASELINE configs[3]) in
paddle_tpu_torch against paddle_tpu (CPU, fp32): ``tests/test_ocr.py``'s
cases, and DBNet and CRNN held to the JAX models on weights (and BatchNorm
statistics) carried across by ``models.convert``.

The training-mode forward (batch statistics) within rtol = atol = 1e-5, at
odd FPN sizes too; three ``TrainStep`` steps (DBNet under Momentum, CRNN
under Adam) against the JAX ``TrainStep``'s losses within rtol 1e-5 and the
parameters after them within 1e-5 (Momentum) / 1e-4 (Adam: its normalised
step magnifies rounding in tiny gradients).  The JAX ``TrainStep`` never
updates BatchNorm's running statistics (its batch_norm skips the update
under a tracer); the port's, eager, updates them as Paddle's dygraph step
does, so they are held after eager forwards instead
(``test_torch_nn.py``).  The ``ocr`` preset runs at its CPU size.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.ocr as jax_ocr
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_paddle_tpu_params, to_paddle_tpu_params
from paddle_tpu_torch.models.ocr import db_loss, ocr_det_tiny, ocr_rec_tiny
from paddle_tpu_torch.models.presets import build_ocr_step
from paddle_tpu_torch.optimizer import Adam, Momentum

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x._data)


def _det_batch(b=2, size=64, seed=0):
    """Synthetic 'text' rectangles: image = noise + bright boxes, gt = box mask."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 0.3, size=(b, 3, size, size)).astype(np.float32)
    gt = np.zeros((b, 1, size, size), np.float32)
    for i in range(b):
        x0, y0 = rng.integers(4, size // 2, 2)
        w, h = rng.integers(8, size // 3, 2)
        img[i, :, y0:y0 + h, x0:x0 + w] += 1.5
        gt[i, 0, y0:y0 + h, x0:x0 + w] = 1.0
    return img, gt


def _jax_forward(jm, img):
    """The JAX model's training-mode forward, compiled whole (its eager
    forward compiles op by op)."""
    return _np(paddle.jit.to_static(jm)(paddle.to_tensor(img)))


def _jax_db_loss(m, img, gt):
    return jax_ocr.db_loss(m(img), gt)


def _db_loss(m, img, gt):
    return db_loss(m(img), gt)


def _carry(jm, tm):
    load_paddle_tpu_params(tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    return tm


def _det_pair():
    paddle.seed(0)
    jm = jax_ocr.ocr_det_tiny()
    return jm, _carry(jm, ocr_det_tiny(device="cpu"))


def _rec_pair(num_classes):
    paddle.seed(1)
    jm = jax_ocr.ocr_rec_tiny(num_classes=num_classes)
    return jm, _carry(jm, ocr_rec_tiny(num_classes=num_classes, device="cpu"))


def _params_close(jm, tm, **tol):
    after = to_paddle_tpu_params(tm)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(after[n], np.asarray(p._data), err_msg=n, **tol)


class TestDet:
    def test_output_shape_full_resolution_and_forward_match_jax(self):
        jm, tm = _det_pair()
        img, _ = _det_batch()
        out = tm(torch.from_numpy(img))
        assert tuple(out.shape) == (2, 1, 64, 64)
        vals = _np(out)
        assert vals.min() >= 0.0 and vals.max() <= 1.0
        np.testing.assert_allclose(vals, _jax_forward(jm, img), **TOL)

    def test_non_multiple_of_32_sizes(self):
        """FPN upsampling at odd intermediate sizes (48 = 16 * 3): the
        nearest rule picks the JAX package's pixels."""
        jm, tm = _det_pair()
        img = np.random.default_rng(2).normal(size=(1, 3, 48, 48)).astype(np.float32)
        out = tm(torch.from_numpy(img))
        assert tuple(out.shape) == (1, 1, 48, 48)
        np.testing.assert_allclose(_np(out), _jax_forward(jm, img), **TOL)
        with pytest.raises(ValueError, match="multiples of 4"):
            tm(torch.zeros(1, 3, 46, 46))

    def test_training_reduces_db_loss_and_three_steps_match_jax(self):
        jm, tm = _det_pair()
        img, gt = _det_batch()
        jstep = paddle.jit.TrainStep(jm, _jax_db_loss, paddle.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9, parameters=jm.parameters()))
        jl = [float(jstep(paddle.to_tensor(img), paddle.to_tensor(gt)).numpy())
              for _ in range(3)]
        step = TrainStep(tm, _db_loss, Momentum(learning_rate=0.05, momentum=0.9,
                                                parameters=tm.parameters()))
        it, gtt = torch.from_numpy(img), torch.from_numpy(gt)
        losses = [float(step(it, gtt)) for _ in range(3)]
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        _params_close(jm, tm, **TOL)
        losses += [float(step(it, gtt)) for _ in range(17)]
        assert losses[-1] < losses[0] * 0.7, losses


class TestRec:
    def test_logits_shape_and_forward_match_jax(self):
        jm, tm = _rec_pair(40)
        img = np.random.default_rng(0).normal(size=(2, 3, 32, 96)).astype(np.float32)
        lg = tm(torch.from_numpy(img))
        assert tuple(lg.shape) == (2, 24, 40)
        np.testing.assert_allclose(_np(lg), _jax_forward(jm, img), **TOL)

    def test_ctc_training_reduces_loss_and_matches_jax(self):
        jm, tm = _rec_pair(16)
        rng = np.random.default_rng(3)
        img = rng.normal(size=(2, 3, 32, 64)).astype(np.float32)
        labels = rng.integers(1, 16, size=(2, 5)).astype(np.int32)
        lab_len = np.asarray([5, 3], np.int32)

        def jloss(m, img):
            return m.compute_loss(m(img), paddle.to_tensor(labels), paddle.to_tensor(lab_len))

        def tloss(m, img):
            return m.compute_loss(m(img), torch.from_numpy(labels), torch.from_numpy(lab_len))

        jstep = paddle.jit.TrainStep(jm, jloss, paddle.optimizer.Adam(
            learning_rate=3e-3, parameters=jm.parameters()))
        jl = [float(jstep(paddle.to_tensor(img)).numpy()) for _ in range(3)]
        step = TrainStep(tm, tloss, Adam(learning_rate=3e-3, parameters=tm.parameters()))
        losses = [float(step(torch.from_numpy(img))) for _ in range(3)]
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        _params_close(jm, tm, rtol=1e-4, atol=1e-4)
        losses += [float(step(torch.from_numpy(img))) for _ in range(12)]
        assert losses[-1] < losses[0] * 0.5, losses


def test_ocr_preset_at_cpu_size():
    """The port's copy of bench.py's ``ocr`` preset, at its CPU size."""
    step, (img, gt), model, (batch, size) = build_ocr_step("cpu")
    assert (batch, size) == (2, 64) and tuple(img.shape) == (2, 3, 64, 64)
    assert float(gt.mean()) == pytest.approx(0.2, abs=0.02)
    assert type(step.optimizer).__name__ == "Momentum"
    losses = [float(step(img, gt)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
