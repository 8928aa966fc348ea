"""``hapi``, ``callbacks`` and ``metric`` of paddle_tpu_torch against
paddle_tpu's (CPU).

Both sides get the same seeded numpy data and the same weights (the JAX
model's carried into the port's with ``models.convert``), and fit with
``shuffle=False``.  Held to the JAX package:

- ``fit``'s history within 1e-5 relative, ``evaluate``'s loss within 1e-5
  and its accuracy equal, ``predict`` within 1e-5 absolute (an MLP and
  ``LeNet`` on 28 x 28 images under Adam: float32 sums in another order);
- ``accumulate_grad_batches=2`` (also equal to the doubled batch),
  ``num_iters``, ``EarlyStopping`` with and without a baseline,
  ``LRSchedulerCallback``, ``ModelCheckpoint``, a JAX-written
  ``.pdparams`` read by the port's ``Model.load``, ``summary``'s counts;
- the hooks a probe callback records, with the eval hooks filtered out:
  the JAX ``Model`` never fires ``on_eval_begin`` / ``on_eval_end``, the
  port's (as Paddle's) does, so ``ReduceLROnPlateau`` acts inside the
  port's ``fit`` and not inside the JAX one;
- ``Accuracy`` / ``Precision`` / ``Recall`` / ``Auc`` / ``accuracy`` equal
  on the same numpy scores (tie-free: the port ranks on the device with
  ``torch.topk``, the JAX package with ``np.argsort``);
- ``flops``: the port counts the products exactly (``2 B (16 32 + 32 8)``
  for the MLP, ``2 2 8 16 16 3 9`` for the conv).  XLA's count adds the
  elementwise work, so for the MLP the JAX count lies in [port, 1.3 x
  port]; for the padded conv it leaves out the products with the zero
  padding (46 of a side's 48 taps reach the image) and adds the bias and
  the ReLU, which puts it at 0.955 x the port's: the test writes that sum
  out.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.models.convert import load_paddle_tpu_params

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _cls_arrays(n=128, dim=8, classes=3, seed=0):
    """Linearly separable synthetic classification data."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(dim, classes))
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=(n, classes))).argmax(-1).astype(np.int64)
    return x, y


def _dataset(P, n=128, seed=0):
    x, y = _cls_arrays(n, seed=seed)
    return P.io.TensorDataset([P.to_tensor(x), P.to_tensor(y)])


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 32), P.nn.ReLU(), P.nn.Linear(32, 3))


def _carry(jnet, tnet):
    load_paddle_tpu_params(tnet, {n: np.asarray(t._data) for n, t in jnet.state_dict().items()})


def _model(P, net, opt=None, metrics="acc"):
    model = P.Model(net)
    opt = opt or P.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    m = P.metric.Accuracy() if metrics == "acc" else metrics
    model.prepare(opt, P.nn.CrossEntropyLoss(), m)
    return model


def _pair(build=_mlp, **kw):
    """(JAX Model, port Model) over the same weights."""
    jp.seed(0)
    jnet = build(jp)
    tnet = build(tp)
    _carry(jnet, tnet)
    return _model(jp, jnet, **kw), _model(tp, tnet, **kw)


def _lenet(P):
    return P.vision.models.LeNet()


def _fakes(P, n=32):
    return P.vision.datasets.FakeData(num_samples=n, image_shape=(1, 28, 28), num_classes=10,
                                      seed=3)


@pytest.mark.parametrize("kind", ["mlp", "lenet"])
def test_fit_evaluate_predict_match_jax(kind):
    if kind == "mlp":
        jm, tm = _pair()
        fit_kw = dict(epochs=3, batch_size=32)
        data = _dataset
    else:
        jm, tm = _pair(_lenet)
        fit_kw = dict(epochs=2, batch_size=16)
        data = _fakes
    hj = jm.fit(data(jp), shuffle=False, verbose=0, **fit_kw)
    ht = tm.fit(data(tp), shuffle=False, verbose=0, **fit_kw)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=RTOL)
    ej = jm.evaluate(data(jp), batch_size=16, verbose=0)
    et = tm.evaluate(data(tp), batch_size=16, verbose=0)
    assert sorted(et) == sorted(ej) == ["acc", "loss"]
    np.testing.assert_allclose(et["loss"], ej["loss"], rtol=RTOL)
    assert et["acc"] == ej["acc"]
    pj = jm.predict(data(jp), batch_size=16, stack_outputs=True)[0]
    pt = tm.predict(data(tp), batch_size=16, stack_outputs=True)[0]
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)


def test_accumulate_grad_batches_matches_jax_and_the_doubled_batch():
    jm, tm = _pair()
    hj = jm.fit(_dataset(jp, 64), epochs=2, batch_size=16, shuffle=False, verbose=0,
                accumulate_grad_batches=2)
    ht = tm.fit(_dataset(tp, 64), epochs=2, batch_size=16, shuffle=False, verbose=0,
                accumulate_grad_batches=2)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=RTOL)
    _, big = _pair()
    hb = big.fit(_dataset(tp, 64), epochs=2, batch_size=32, shuffle=False, verbose=0)
    np.testing.assert_allclose(ht["loss"], hb["loss"], rtol=RTOL)


def test_num_iters_stops_where_jax_stops():
    jm, tm = _pair()
    hj = jm.fit(_dataset(jp), epochs=10, batch_size=32, shuffle=False, verbose=0, num_iters=3)
    ht = tm.fit(_dataset(tp), epochs=10, batch_size=32, shuffle=False, verbose=0, num_iters=3)
    assert len(ht["loss"]) == len(hj["loss"]) == 1
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(min_delta=100.0), dict(baseline=1e-9)],
                         ids=["no_improvement", "baseline"])
def test_early_stopping_matches_jax(kw):
    jm, tm = _pair()
    js = jp.hapi.EarlyStopping(monitor="loss", mode="min", patience=0, **kw)
    ts = tp.hapi.EarlyStopping(monitor="loss", mode="min", patience=0, **kw)
    hj = jm.fit(_dataset(jp), epochs=10, batch_size=32, shuffle=False, verbose=0,
                callbacks=[js])
    ht = tm.fit(_dataset(tp), epochs=10, batch_size=32, shuffle=False, verbose=0,
                callbacks=[ts])
    assert len(ht["loss"]) == len(hj["loss"]) < 10
    assert ts.stopped_epoch == js.stopped_epoch
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=RTOL)


def test_lr_scheduler_callback_matches_jax():
    out = {}
    for name, P in (("jax", jp), ("port", tp)):
        sched = P.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
        jp.seed(0)
        jnet = jp.nn.Sequential(jp.nn.Linear(8, 3))
        net = jnet if P is jp else tp.nn.Sequential(tp.nn.Linear(8, 3))
        if P is tp:
            _carry(jnet, net)
        opt = P.optimizer.SGD(learning_rate=sched, parameters=net.parameters())
        model = P.Model(net)
        model.prepare(opt, P.nn.CrossEntropyLoss())
        hist = model.fit(_dataset(P), epochs=3, batch_size=64, shuffle=False, verbose=0,
                         callbacks=[P.hapi.LRSchedulerCallback()])
        out[name] = (opt.get_lr(), hist["loss"])
    assert out["port"][0] == out["jax"][0] == pytest.approx(0.1 * 0.5 ** 3)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=RTOL)


def test_model_checkpoint_files_and_reload(tmp_path):
    jm, tm = _pair()
    jm.fit(_dataset(jp), epochs=2, batch_size=32, shuffle=False, verbose=0,
           save_dir=str(tmp_path / "jax"))
    tm.fit(_dataset(tp), epochs=2, batch_size=32, shuffle=False, verbose=0,
           save_dir=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["0.pdparams", "1.pdparams", "final.pdparams"]
    before = tm.predict(_dataset(tp, 8), batch_size=8, stack_outputs=True)[0]
    _, fresh = _pair()
    fresh.load(str(tmp_path / "port" / "final"))
    after = fresh.predict(_dataset(tp, 8), batch_size=8, stack_outputs=True)[0]
    np.testing.assert_array_equal(after, before)


def test_port_model_loads_a_jax_checkpoint(tmp_path):
    jm, _ = _pair()
    jm.fit(_dataset(jp), epochs=2, batch_size=32, shuffle=False, verbose=0)
    jm.save(str(tmp_path / "jax_model"))
    want = jm.predict(_dataset(jp, 16), batch_size=16, stack_outputs=True)[0]
    tp.seed(5)
    net = _mlp(tp)
    tm = _model(tp, net)
    tm.load(str(tmp_path / "jax_model"))
    got = tm.predict(_dataset(tp, 16), batch_size=16, stack_outputs=True)[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the loaded model trains on from there as a JAX model that loaded it does
    jp.seed(5)
    jm2 = _model(jp, _mlp(jp))
    jm2.load(str(tmp_path / "jax_model"))
    hj = jm2.fit(_dataset(jp), epochs=1, batch_size=32, shuffle=False, verbose=0)
    ht = tm.fit(_dataset(tp), epochs=1, batch_size=32, shuffle=False, verbose=0)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=RTOL)


def test_summary_counts_match_jax(capsys):
    jnet = jp.nn.Sequential(jp.nn.Linear(8, 4), jp.nn.Linear(4, 2))
    tnet = tp.nn.Sequential(tp.nn.Linear(8, 4), tp.nn.Linear(4, 2))
    assert tp.summary(tnet) == jp.summary(jnet) == {"total_params": 46,
                                                     "trainable_params": 46}
    jnet[0].weight.stop_gradient = True
    tnet[0].weight.requires_grad_(False)
    assert tp.Model(tnet).summary() == jp.Model(jnet).summary() == {
        "total_params": 46, "trainable_params": 14}
    assert "Total params" in capsys.readouterr().out


_EVAL_HOOKS = ("eval_begin", "eval_end")


def _probe(P, events):
    class Probe(P.hapi.Callback):
        pass

    def hook(name):
        def record(self, *args, **kwargs):
            events.append(name if not args or isinstance(args[0], dict) or args[0] is None
                          else f"{name}_{args[0]}")
        return record

    for name in ("train_begin", "train_end", "epoch_begin", "epoch_end", "train_batch_begin",
                 "train_batch_end", "eval_begin", "eval_end"):
        setattr(Probe, f"on_{name}", hook(name))
    return Probe()


def test_hook_sequence_matches_jax_with_eval_hooks_filtered():
    jm, tm = _pair()
    ev_j, ev_t = [], []
    jm.fit(_dataset(jp, 64), eval_data=_dataset(jp, 32, seed=1), epochs=2, batch_size=32,
           shuffle=False, verbose=0, callbacks=[_probe(jp, ev_j)])
    tm.fit(_dataset(tp, 64), eval_data=_dataset(tp, 32, seed=1), epochs=2, batch_size=32,
           shuffle=False, verbose=0, callbacks=[_probe(tp, ev_t)])
    assert not any(e in _EVAL_HOOKS for e in ev_j)           # the JAX Model's fault
    assert [e for e in ev_t if e not in _EVAL_HOOKS] == ev_j
    # the port fires the pair once an evaluation, before the epoch's end
    for epoch in range(2):
        i = ev_t.index(f"epoch_end_{epoch}")
        assert ev_t[i - 2:i] == list(_EVAL_HOOKS)
    assert ev_t.count("eval_begin") == ev_t.count("eval_end") == 2


def test_reduce_lr_on_plateau_acts_within_the_port_fit(tmp_path):
    """Nothing counts as improving (min_delta 100), patience 1: every
    evaluation after the first lowers the rate by ``factor``, three in four
    epochs.  The JAX ``fit`` fires no eval hook, so its rate stays where it
    was."""
    rates, logs = {}, {}
    for name, P in (("jax", jp), ("port", tp)):
        jm, tm = _pair()
        model = jm if P is jp else tm
        vdl = str(tmp_path / name)
        model.fit(_dataset(P, 64), eval_data=_dataset(P, 32, seed=1), epochs=4, batch_size=32,
                  shuffle=False, verbose=0,
                  callbacks=[P.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                                           patience=1, min_delta=100.0,
                                                           verbose=0),
                             P.callbacks.VisualDL(log_dir=vdl)])
        rates[name] = model._optimizer.get_lr()
        with open(os.path.join(vdl, "scalars.jsonl")) as f:
            logs[name] = f.read()
    assert rates["jax"] == pytest.approx(1e-2)
    assert rates["port"] == pytest.approx(1e-2 * 0.5 ** 3)
    assert '"eval/loss"' in logs["port"] and '"eval/acc"' in logs["port"]
    assert '"eval/' not in logs["jax"]


def test_wandb_callback_needs_the_package():
    with pytest.raises(ImportError, match="wandb"):
        tp.callbacks.WandbCallback()


def test_predict_runs_eval_mode_and_fit_keeps_train_mode():
    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Linear(8, 32), tp.nn.Dropout(0.5), tp.nn.Linear(32, 3))
    model = tp.Model(net)
    ds = _dataset(tp, 16)
    a = model.predict(ds, batch_size=16, stack_outputs=True)[0]
    b = model.predict(ds, batch_size=16, stack_outputs=True)[0]
    np.testing.assert_array_equal(a, b)
    assert net.training
    net.eval()
    x, _ = _cls_arrays(16)
    np.testing.assert_array_equal(a, net(torch.from_numpy(x)).detach().numpy())


# ---------------------------------------------------------------------------
# metric
# ---------------------------------------------------------------------------

def _scores(rng, n, c):
    """Tie-free scores: a permutation of distinct values a row."""
    return np.stack([rng.permutation(c) for _ in range(n)]).astype(np.float32) / c + \
        rng.random((n, c)).astype(np.float32) * 1e-3


def test_accuracy_topk_matches_jax():
    rng = np.random.default_rng(0)
    ja = jp.metric.Accuracy(topk=(1, 3))
    ta = tp.metric.Accuracy(topk=(1, 3))
    for n in (7, 16, 5):
        p = _scores(rng, n, 6)
        y = rng.integers(0, 6, size=(n, 1))
        cj = ja.compute(jp.to_tensor(p), jp.to_tensor(y))
        ct = ta.compute(tp.to_tensor(p), tp.to_tensor(y))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj._data))
        assert ta.update(ct) == ja.update(cj)
    assert ta.accumulate() == ja.accumulate()
    assert ta.name() == ja.name() == "acc"
    # one-hot labels are taken by their argmax, as there
    p = _scores(rng, 4, 3)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    np.testing.assert_array_equal(tp.metric.Accuracy().compute(p, oh).numpy(),
                                  np.asarray(jp.metric.Accuracy().compute(p, oh)._data))


def test_io_amp_metric_case():
    acc = tp.metric.Accuracy()
    pred = tp.to_tensor(np.array([[0.9, 0.1], [0.2, 0.8]], np.float32))
    label = tp.to_tensor(np.array([[0], [1]]))
    acc.update(acc.compute(pred, label))
    assert acc.accumulate() == 1.0


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_function_matches_jax(k):
    rng = np.random.default_rng(k)
    p = _scores(rng, 32, 5)
    y = rng.integers(0, 5, size=(32,))
    got = tp.metric.accuracy(tp.to_tensor(p), tp.to_tensor(y), k=k)
    want = jp.metric.accuracy(jp.to_tensor(p), jp.to_tensor(y), k=k)
    assert got.numpy().dtype == np.float32
    assert float(got) == float(np.asarray(want._data))


def test_precision_recall_auc_match_jax():
    rng = np.random.default_rng(1)
    pairs = [(tp.metric.Precision(), jp.metric.Precision()),
             (tp.metric.Recall(), jp.metric.Recall()),
             (tp.metric.Auc(), jp.metric.Auc()),
             (tp.metric.Auc(num_thresholds=7), jp.metric.Auc(num_thresholds=7))]
    for n in (50, 33):
        p = rng.random((n, 2)).astype(np.float32)
        p[:3, 1] = [0.0, 1.0, 0.5]
        y = rng.integers(0, 2, size=(n, 1))
        for t, j in pairs:
            args = (p[:, 1], y) if not isinstance(t, tp.metric.Auc) else (p, y)
            t.update(tp.to_tensor(args[0]), tp.to_tensor(args[1]))
            j.update(jp.to_tensor(args[0]), jp.to_tensor(args[1]))
    for t, j in pairs:
        assert t.accumulate() == j.accumulate()
        assert t.name() == j.name()
    np.testing.assert_array_equal(pairs[2][0]._stat_pos, pairs[2][1]._stat_pos)
    np.testing.assert_array_equal(pairs[2][0]._stat_neg, pairs[2][1]._stat_neg)


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def test_flops_counts_the_products():
    jp.seed(0)
    jm = jp.nn.Sequential(jp.nn.Linear(16, 32), jp.nn.ReLU(), jp.nn.Linear(32, 8))
    tm = tp.nn.Sequential(tp.nn.Linear(16, 32), tp.nn.ReLU(), tp.nn.Linear(32, 8))
    want = 2 * 4 * (16 * 32 + 32 * 8)
    got = tp.flops(tm, [4, 16])
    assert got == want
    assert got <= jp.flops(jm, [4, 16]) <= 1.3 * got
    jc = jp.nn.Sequential(jp.nn.Conv2D(3, 8, 3, padding=1), jp.nn.ReLU())
    tc = tp.nn.Sequential(tp.nn.Conv2D(3, 8, 3, padding=1), tp.nn.ReLU())
    got = tp.flops(tc, [2, 3, 16, 16], print_detail=True)
    assert got == 2 * 2 * 8 * 16 * 16 * 3 * 9
    in_image_taps = (16 * 3 - 2) ** 2            # of 16 * 16 * 9: pad 1 of a 3-tap side
    bias_and_relu = 2 * (2 * 8 * 16 * 16)
    assert jp.flops(jc, [2, 3, 16, 16]) == 2 * 2 * 8 * 3 * in_image_taps + bias_and_relu
    assert tc.training                                   # the mode is put back
