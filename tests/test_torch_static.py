"""``paddle_tpu_torch.static`` against ``paddle_tpu.static`` (CPU).

Every case of ``tests/test_static_mode.py`` and ``tests/test_static_nn.py``:
the same Program built in both packages (static mode), the same weights
carried from the JAX layers into the port's (``models.convert``) or given to
both through ``ParamAttr(initializer=Assign(...))``, the same numpy feeds
from a seed.  Fetches, losses and parameters after ``Executor.run`` agree
within fp32 tolerance (``RTOL`` relative; ``ATOL`` for values near 0);
the port's own properties (carried state, fresh dropout draws, errors) are
checked as the JAX tests check them.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.models.convert import (load_paddle_tpu_params,
                                             load_paddle_tpu_program_state,
                                             to_paddle_tpu_program_state)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


@contextlib.contextmanager
def static(P):
    P.enable_static()
    try:
        yield
    finally:
        P.disable_static()


def snapshot(jl):
    """The JAX layer's parameters and buffers as numpy copies."""
    return {n: np.array(t._data) for n, t in jl.state_dict().items()}


def carry(jl, tl):
    """The JAX layer's parameters and buffers (or a snapshot of them) into
    the port layer."""
    load_paddle_tpu_params(tl, jl if isinstance(jl, dict) else snapshot(jl))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _toy_batch(n=16, d=4, c=3, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    ys = rng.integers(0, c, size=(n, 1)).astype(np.int64)
    return xs, ys


def _train_linear(P, F, opt_cls, lr, steps, xs, ys, w0, b0):
    """A Linear + cross-entropy Program from weights ``(w0, b0)`` trained
    ``steps`` runs; returns the losses and the layer."""
    with static(P):
        main, startup = P.static.Program(), P.static.Program()
        with P.static.program_guard(main, startup):
            x = P.static.data("x", [None, xs.shape[1]], "float32")
            y = P.static.data("y", [None, 1], "int64")
            net = P.nn.Linear(xs.shape[1], 3)
            with P.no_grad():
                net.weight.set_value(P.to_tensor(w0))
                net.bias.set_value(P.to_tensor(b0))
            loss = F.cross_entropy(net(x), y)
            opt_cls(learning_rate=lr).minimize(loss)
        exe = P.static.Executor()
        exe.run(startup)
        losses = [float(exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
                  for _ in range(steps)]
    return losses, net


# ---------------------------------------------------------------------------
# test_static_mode.py
# ---------------------------------------------------------------------------

def test_static_training_decreases_loss():
    xs, ys = _toy_batch()
    rng = np.random.default_rng(1)
    w0, b0 = rng.normal(size=(4, 3)).astype(np.float32), np.zeros(3, np.float32)
    j_losses, jnet = _train_linear(jp, JF, jp.optimizer.SGD, 0.1, 6, xs, ys, w0, b0)
    t_losses, tnet = _train_linear(tp, TF, tp.optimizer.SGD, 0.1, 6, xs, ys, w0, b0)
    close(t_losses, j_losses)
    assert t_losses[-1] < t_losses[0]
    close(tnet.weight.numpy(), jnet.weight.numpy(), atol=1e-5)
    assert not np.allclose(tnet.weight.numpy(), w0)


def test_static_matches_dynamic_step():
    """One SGD step in static mode equals the eager step (and the JAX
    package's static step)."""
    xs, ys = _toy_batch(n=8)
    tp.seed(7)
    eager = tp.nn.Linear(4, 3)
    w0, b0 = eager.weight.numpy().copy(), eager.bias.numpy().copy()
    eopt = tp.optimizer.SGD(learning_rate=0.5, parameters=eager.parameters())
    el = TF.cross_entropy(eager(tp.to_tensor(xs)), tp.to_tensor(ys))
    el.backward()
    eopt.step()

    out = {}
    for P, F in ((tp, TF), (jp, JF)):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4], "float32")
                y = P.static.data("y", [None, 1], "int64")
                snet = P.nn.Linear(4, 3)
                with P.no_grad():
                    snet.weight.set_value(P.to_tensor(w0))
                    snet.bias.set_value(P.to_tensor(b0))
                loss = F.cross_entropy(snet(x), y)
                P.optimizer.SGD(learning_rate=0.5).minimize(loss)
            (lv,) = P.static.Executor().run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        out[P] = (float(lv), np.asarray(snet.weight.numpy()))
    close(out[tp][0], float(el.numpy()))
    close(out[tp][1], eager.weight.numpy(), atol=1e-6)
    close(out[tp][0], out[jp][0])
    close(out[tp][1], out[jp][1], atol=1e-6)


def test_default_program_without_guard():
    xs = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = {}
    for P in (tp, jp):
        with static(P):
            x = P.static.data("xin", [None, 2], "float32")
            out = (x * 2.0).sum(axis=-1)
            exe = P.static.Executor()
            exe.run(P.static.default_startup_program())
            (got[P],) = exe.run(P.static.default_main_program(), feed={"xin": xs},
                                fetch_list=[out])
    close(got[tp], [6.0, 14.0])
    close(got[tp], got[jp])


def test_batchnorm_running_stats_are_carried_state():
    xs = np.random.default_rng(3).normal(loc=5.0, size=(32, 4)).astype(np.float32)
    means = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4], "float32")
                bn = P.nn.BatchNorm1D(4)
                bn.train()
                out = bn(x).mean()
            exe = P.static.Executor()
            runs = []
            for _ in range(2):
                exe.run(main, feed={"x": xs}, fetch_list=[out])
                runs.append(np.asarray(bn._mean.numpy()).copy())
        means[P] = runs
    m1, m2 = means[tp]
    assert np.all(m1 > 0.1), m1             # moved toward the batch mean (~5)
    assert np.all(m2 > m1)                  # and keeps integrating
    close(m1, means[jp][0])
    close(m2, means[jp][1])


def test_build_time_materialization_is_an_error():
    with static(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 3], "float32")
            s = x.sum()
            with pytest.raises(RuntimeError, match="static-graph Variable"):
                float(s)


def test_fetch_by_name_and_missing_feed_error():
    xs = np.ones((2, 3), np.float32)
    with static(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 3], "float32")
            y = x * 3.0
        exe = tp.static.Executor()
        (fx,) = exe.run(main, feed={"x": xs}, fetch_list=["x"])
        close(fx, xs)
        (fy,) = exe.run(main, feed={"x": xs}, fetch_list=[y])
        close(fy, xs * 3)
        with pytest.raises(KeyError, match="missing feeds"):
            exe.run(main, feed={}, fetch_list=[y])


def _softmax_program(P, F, jl=None):
    main = P.static.Program()
    with P.static.program_guard(main):
        x = P.static.data("x", [None, 4], "float32")
        net = P.nn.Linear(4, 3)
        if jl is not None:
            carry(jl, net)
        pred = F.softmax(net(x))
    return main, x, pred, net


def test_save_load_inference_model(tmp_path):
    xs, _ = _toy_batch(n=5)
    with static(jp):
        jmain, _, jpred, jnet = _softmax_program(jp, JF)
        (want,) = jp.static.Executor().run(jmain, feed={"x": xs}, fetch_list=[jpred])
    with static(tp):
        main, x, pred, _ = _softmax_program(tp, TF, jl=jnet)
        exe = tp.static.Executor()
        (got0,) = exe.run(main, feed={"x": xs}, fetch_list=[pred])
        path = str(tmp_path / "infer")
        tp.static.save_inference_model(path, [x], [pred], exe, program=main)
        prog, feed_names, fetch_targets = tp.static.load_inference_model(path, exe)
        assert feed_names == ["x"]
        (got,) = exe.run(prog, feed={"x": xs}, fetch_list=fetch_targets)
    close(got0, want)
    close(got, want)


def test_inference_artifact_is_jit_load_compatible(tmp_path):
    with static(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 2], "float32")
            out = (x * 2.0 + 1.0).sum(axis=-1)
        path = str(tmp_path / "compat")
        tp.static.save_inference_model(path, [x], [out], tp.static.Executor(), program=main)
    fn = tp.jit.load(path)
    for xs in (np.array([[1.0, 1.0], [0.0, 2.0]], np.float32),
               np.ones((5, 2), np.float32)):        # another batch: the None dim is dynamic
        got = fn(tp.to_tensor(xs))
        got = got[0] if isinstance(got, (list, tuple)) else got
        close(got.numpy(), (xs * 2 + 1).sum(-1))


def test_program_state_save_load(tmp_path):
    xs = np.ones((2, 4), np.float32)
    with static(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 4], "float32")
            net = tp.nn.Linear(4, 2)
            out = net(x).sum()
        exe = tp.static.Executor()
        (r0,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        state = main.state_dict()
        assert state, "the program recorded no state"
        with tp.no_grad():
            net.weight.set_value(tp.to_tensor(np.zeros((4, 2), np.float32)))
        (z,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        main.set_state_dict(state)
        (r,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        assert not np.allclose(r, z)
        close(r, r0)
        # the same through static.save / static.load
        tp.static.save(main, str(tmp_path / "prog"))
        with tp.no_grad():
            net.weight.set_value(tp.to_tensor(np.zeros((4, 2), np.float32)))
        tp.static.load(main, str(tmp_path / "prog"))
        (r2,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        close(r2, r0)


def test_dynamic_mode_compat_shims():
    """Outside static mode: data() is an InputSpec, program_guard changes
    nothing, in_dynamic_mode() is True (False in static mode)."""
    assert tp.in_dynamic_mode()
    spec = tp.static.data("x", [None, 3], "float32")
    assert isinstance(spec, tp.static.InputSpec)
    with tp.static.program_guard(tp.static.Program()):
        t = tp.to_tensor(np.ones((2,), np.float32)) * 2
        assert float(t.sum()) == 4.0
    with static(tp):
        assert not tp.in_dynamic_mode()
    assert tp.in_dynamic_mode()


def test_static_mlp_mnist_style():
    """A scaled-down static MNIST loop (MLP, relu, cross-entropy, accuracy
    fetch, Adam), the port from the JAX layers' weights: losses and
    accuracies agree run for run."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 16)).astype(np.float32)
    ys = np.argmax(xs.reshape(64, 4, 4).sum(-1), axis=1).reshape(-1, 1).astype(np.int64)
    hist, layers = {}, {}
    for P, F in ((jp, JF), (tp, TF)):
        with static(P):
            main, startup = P.static.Program(), P.static.Program()
            with P.static.program_guard(main, startup):
                img = P.static.data("img", [None, 16], "float32")
                lab = P.static.data("lab", [None, 1], "int64")
                l1, l2 = P.nn.Linear(16, 32), P.nn.Linear(32, 4)
                if P is tp:
                    carry(layers["l1"], l1)
                    carry(layers["l2"], l2)
                else:
                    layers.update(l1=snapshot(l1), l2=snapshot(l2))
                logits = l2(F.relu(l1(img)))
                loss = F.cross_entropy(logits, lab)
                acc = P.static.accuracy(logits, lab)
                P.optimizer.Adam(learning_rate=0.01).minimize(loss)
            exe = P.static.Executor()
            exe.run(startup)
            hist[P] = [tuple(float(v) for v in exe.run(main, feed={"img": xs, "lab": ys},
                                                       fetch_list=[loss, acc]))
                       for _ in range(30)]
    t, j = np.asarray(hist[tp]), np.asarray(hist[jp])
    close(t[:, 0], j[:, 0], rtol=1e-4)
    np.testing.assert_array_equal(t[:, 1], j[:, 1])
    assert t[-1, 1] > 0.8, t[-5:]


def test_continued_building_after_run_sees_trained_params():
    xs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    ys = np.zeros((8, 4), np.float32)
    probes = {}
    jl = None
    for P, F in ((jp, JF), (tp, TF)):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4], "float32")
                y = P.static.data("y", [None, 4], "float32")
                net = P.nn.Linear(4, 4)
                if jl is None:
                    jl = snapshot(net)
                else:
                    carry(jl, net)
                loss = F.mse_loss(net(x), y)
                P.optimizer.SGD(learning_rate=0.5).minimize(loss)
            exe = P.static.Executor()
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
            with P.static.program_guard(main):
                probe = net(x).sum()
            (p1,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[probe])
            for _ in range(5):
                exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
            (p2,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[probe])
        probes[P] = (float(p1), float(p2))
    p1, p2 = probes[tp]
    assert not np.allclose(p1, p2)
    assert abs(p2) < abs(p1)
    close(probes[tp], probes[jp], rtol=1e-4, atol=1e-5)


def test_static_dropout_resamples_per_run():
    xs = np.ones((2, 256), np.float32)
    with static(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 256], "float32")
            out = TF.dropout(x, p=0.5)
        exe = tp.static.Executor()
        (m1,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        (m2,) = exe.run(main, feed={"x": xs}, fetch_list=[out])
        assert not np.array_equal(m1, m2)
        for m in (m1, m2):
            assert 0.3 < (m > 0).mean() < 0.7
            assert set(np.unique(m)) <= {0.0, 2.0}
        with pytest.raises(ValueError, match="stochastic"):
            tp.static.save_inference_model("/nonexistent/no_rng_export", [x], [out], exe,
                                           program=main)
    # at p = 0 the same program in both packages passes its input through
    got = {}
    for P, F in ((tp, TF), (jp, JF)):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 256], "float32")
                out = F.dropout(x * 2.0, p=0.0)
            (got[P],) = P.static.Executor().run(main, feed={"x": xs}, fetch_list=[out])
    close(got[tp], got[jp])


def _weight_norm_program(P, F):
    main = P.static.Program()
    with P.static.program_guard(main):
        x = P.static.data("x", [None, 4], "float32")
        y = P.static.data("y", [None, 6], "float32")
        lin = P.nn.Linear(4, 6, weight_attr=P.static.WeightNormParamAttr(dim=1))
        loss = F.mse_loss(lin(x), y)
        P.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return main, lin, loss


def test_weight_norm_param_attr():
    """The layer's weight is recomputed from trainable v / g at every run:
    after training, each column norm of the fetched weight equals the
    trained |g|; from the JAX program's initial v, g and bias the losses
    agree run for run."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(16, 4)).astype(np.float32)
    ys = rng.normal(size=(16, 6)).astype(np.float32)
    with static(jp):
        jmain, jlin, jloss = _weight_norm_program(jp, JF)
        jexe = jp.static.Executor()
        j_losses = []
        for i in range(21):
            if i == 0:
                # the JAX program's slots in first-use order: v, g, bias
                slots = jmain._builder.state_slots()
                jv, jg, jb = (np.asarray(s["init"]) for s in slots.values())
            j_losses.append(float(jexe.run(jmain, feed={"x": xs, "y": ys},
                                           fetch_list=[jloss])[0]))
    with static(tp):
        main, lin, loss = _weight_norm_program(tp, TF)
        with torch.no_grad():
            lin.parametrizations.weight.original0.copy_(torch.from_numpy(jg.copy()))
            lin.parametrizations.weight.original1.copy_(torch.from_numpy(jv.copy()))
            lin.bias.copy_(torch.from_numpy(jb.copy()))
        exe = tp.static.Executor()
        (l0,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        t_losses, w0 = [float(l0)], None
        for _ in range(20):
            lv, wv = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss, lin.weight])
            t_losses.append(float(lv))
            w0 = wv if w0 is None else w0
        assert t_losses[-1] < t_losses[0]
        assert not np.allclose(wv, w0)
        state_before = main.state_dict()
        (wv2,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[lin.weight])
    # (|g|: a g trained through 0 flips its column)
    g_val = [v for v in state_before.values()
             if v.shape == (6,) and np.allclose(np.linalg.norm(wv2, axis=0), np.abs(v),
                                                rtol=1e-4)]
    assert g_val, "no state slot matches the column norms"
    close(t_losses, j_losses, rtol=1e-4)


def test_weight_norm_param_attr_dynamic_raises():
    with pytest.raises(RuntimeError, match="static mode"):
        tp.nn.Linear(4, 6, weight_attr=tp.static.WeightNormParamAttr(dim=1))


def test_frozen_parameter_left_unchanged_by_a_static_step():
    """``stop_gradient = True`` on a parameter keeps it out of the step, in
    both packages; the trained one moves alike."""
    xs, ys = _toy_batch()
    out, jl = {}, None
    for P, F in ((jp, JF), (tp, TF)):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4], "float32")
                y = P.static.data("y", [None, 1], "int64")
                net = P.nn.Linear(4, 3)
                if jl is None:
                    jl = snapshot(net)
                else:
                    carry(jl, net)
                net.weight.stop_gradient = True
                loss = F.cross_entropy(net(x), y)
                P.optimizer.SGD(learning_rate=0.5).minimize(loss)
            w0, b0 = net.weight.numpy().copy(), net.bias.numpy().copy()
            exe = P.static.Executor()
            for _ in range(3):
                exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        out[P] = (w0, net.weight.numpy(), b0, net.bias.numpy())
    w0, w1, b0, b1 = out[tp]
    np.testing.assert_array_equal(w1, w0)
    assert not np.allclose(b1, b0)
    np.testing.assert_array_equal(out[jp][1], out[jp][0])
    close(b1, out[jp][3])


@pytest.mark.parametrize("aux_width", [3, 5])
def test_optimizer_slots_stay_with_their_parameters_whatever_the_fetch_list(aux_width):
    """AdamW over a Program with a second Linear recorded before the loss's:
    runs fetching ``[loss]``, then ``[loss, aux]``.  Every run updates every
    trainable parameter of the Program (the unreached one by its weight
    decay alone) with its own slots, as in the JAX package, whose slots are
    keyed once for the whole Program; ``aux_width`` 3 gives both weights one
    shape."""
    xs, ys = _toy_batch(n=8)
    rng = np.random.default_rng(3)
    wa = rng.normal(size=(4, aux_width)).astype(np.float32)
    ba = rng.normal(size=aux_width).astype(np.float32)
    w0, b0 = rng.normal(size=(4, 3)).astype(np.float32), np.zeros(3, np.float32)
    out = {}
    for P, F in ((tp, TF), (jp, JF)):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4], "float32")
                y = P.static.data("y", [None, 1], "int64")
                aux_net, net = P.nn.Linear(4, aux_width), P.nn.Linear(4, 3)
                with P.no_grad():
                    for layer, (w, b) in ((aux_net, (wa, ba)), (net, (w0, b0))):
                        layer.weight.set_value(P.to_tensor(w))
                        layer.bias.set_value(P.to_tensor(b))
                aux = aux_net(x)
                loss = F.cross_entropy(net(x), y)
                P.optimizer.AdamW(learning_rate=0.1).minimize(loss)
            exe = P.static.Executor()
            fetched = [exe.run(main, feed={"x": xs, "y": ys}, fetch_list=fl)
                       for fl in ([loss], [loss], [loss, aux], [loss, aux])]
        out[P] = (fetched, [np.asarray(t.numpy()) for t in (net.weight, net.bias,
                                                             aux_net.weight, aux_net.bias)])
    for got, want in zip(out[tp][0], out[jp][0]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
    for got, want in zip(out[tp][1], out[jp][1]):
        close(got, want)
    assert not np.allclose(out[tp][1][0], w0)


# ---------------------------------------------------------------------------
# test_static_nn.py
# ---------------------------------------------------------------------------

def _run(P, program, feed, fetch):
    return P.static.Executor().run(program, feed=feed, fetch_list=fetch)


def _attr(P, arr):
    return P.ParamAttr(initializer=P.nn.initializer.Assign(arr))


def test_fc_trains():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(16, 8)).astype(np.float32)
    ys = rng.integers(0, 3, (16, 1)).astype(np.int64)
    w1 = rng.normal(size=(8, 16)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(16, 3)).astype(np.float32) * 0.3
    hist = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 8], "float32")
                y = P.static.data("y", [None, 1], "int64")
                h = P.static.nn.fc(x, 16, activation="relu", weight_attr=_attr(P, w1))
                loss = P.nn.functional.cross_entropy(
                    P.static.nn.fc(h, 3, weight_attr=_attr(P, w2)), y)
                P.optimizer.SGD(learning_rate=0.2).minimize(loss)
            hist[P] = [float(_run(P, main, {"x": xs, "y": ys}, [loss])[0]) for _ in range(11)]
    assert hist[tp][-1] < hist[tp][0]
    close(hist[tp], hist[jp], rtol=1e-4)


def test_conv_bn_builders():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 0.2
    bias = rng.normal(size=(4,)).astype(np.float32) * 0.1
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                img = P.static.data("img", [None, 3, 8, 8], "float32")
                c = P.static.nn.conv2d(img, num_filters=4, filter_size=3, padding=1,
                                       act="relu", param_attr=_attr(P, w),
                                       bias_attr=_attr(P, bias))
                pooled = P.static.nn.batch_norm(c).mean(axis=[2, 3])
            (got[P],) = _run(P, main, {"img": xs}, [pooled])
    assert got[tp].shape == (2, 4)
    close(got[tp], got[jp], atol=1e-5)


def test_embedding_builder():
    table = np.random.default_rng(2).normal(size=(10, 6)).astype(np.float32)
    ids = np.random.default_rng(3).integers(0, 10, (3, 5)).astype(np.int64)
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                i = P.static.data("ids", [None, 5], "int64")
                out = P.static.nn.embedding(i, size=[10, 6], param_attr=_attr(P, table)).sum(
                    axis=1)
            (got[P],) = _run(P, main, {"ids": ids}, [out])
    assert got[tp].shape == (3, 6)
    close(got[tp], got[jp])


def test_cond_selects_branch():
    av = np.array([1, 2, 3, 4], np.float32)
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                a = P.static.data("a", [4], "float32")
                out = P.static.nn.cond(a.sum() > 0, lambda: a * 2, lambda: a - 1)
            (o,) = _run(P, main, {"a": av}, [out])
            close(o, av * 2)
            (o2,) = _run(P, main, {"a": -av}, [out])
            close(o2, -av - 1)


def test_switch_case_and_case():
    av = np.array([1.0, 2.0], np.float32)
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                i = P.static.data("i", [1], "int64")
                a = P.static.data("a", [2], "float32")
                sw = P.static.nn.switch_case(i, {0: lambda: a + 1, 1: lambda: a * 10},
                                             default=lambda: a * 0)
                cs = P.static.nn.case([(i == 0, lambda: a + 100)], default=lambda: a)
            o_sw, o_cs = _run(P, main, {"i": np.array([1]), "a": av}, [sw, cs])
            close(o_sw, av * 10)
            close(o_cs, av)
            o_sw0, o_cs0 = _run(P, main, {"i": np.array([0]), "a": av}, [sw, cs])
            close(o_sw0, av + 1)
            close(o_cs0, av + 100)


def test_while_loop_runs_the_loop_each_run():
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [1], "float32")
                i0 = P.to_tensor(np.float32(0))
                iv, xv = P.static.nn.while_loop(lambda i, s: i < 4,
                                                lambda i, s: [i + 1, s * 2], [i0, x])
            (o,) = _run(P, main, {"x": np.array([3.0], np.float32)}, [xv])
            close(o, [48.0])      # 3 * 2**4
            (o,) = _run(P, main, {"x": np.array([-1.5], np.float32)}, [xv])
            close(o, [-24.0])


def test_sequence_ops_masked():
    xs = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    lens = np.array([2, 4], np.int64)
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 4, 3], "float32")
                ln = P.static.data("ln", [None], "int64")
                outs = [P.static.nn.sequence_softmax(x, lengths=ln),
                        P.static.nn.sequence_pool(x, "average", lengths=ln),
                        P.static.nn.sequence_last_step(x, lengths=ln)]
                outs += [P.static.nn.sequence_pool(x, kind, lengths=ln)
                         for kind in ("max", "sum", "sqrt", "first")]
                outs.append(P.static.nn.sequence_expand(x[:, 0], x))
            got[P] = _run(P, main, {"x": xs, "ln": lens}, outs)
    o_sm, o_pool, o_last = got[tp][:3]
    assert np.allclose(o_sm[0, 2:], 0.0)
    assert np.allclose(o_sm[0, :2].sum(axis=0), 1.0, atol=1e-5)
    close(o_pool[0], xs[0, :2].mean(axis=0))
    close(o_last[0], xs[0, 1])
    close(o_last[1], xs[1, 3])
    for g, w in zip(got[tp], got[jp]):
        close(g, w)


def test_bilinear_row_conv_shapes():
    rng = np.random.default_rng(4)
    wb = rng.normal(size=(5, 3, 4)).astype(np.float32)
    wr = rng.normal(size=(3, 3)).astype(np.float32)
    wc = rng.normal(size=(9, 7)).astype(np.float32)
    feed = {"x1": rng.normal(size=(2, 3)).astype(np.float32),
            "x2": rng.normal(size=(2, 4)).astype(np.float32),
            "seq": rng.normal(size=(2, 6, 3)).astype(np.float32)}
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x1 = P.static.data("x1", [None, 3], "float32")
                x2 = P.static.data("x2", [None, 4], "float32")
                bt = P.static.nn.bilinear_tensor_product(x1, x2, size=5,
                                                         param_attr=_attr(P, wb))
                seq = P.static.data("seq", [None, 6, 3], "float32")
                rc = P.static.nn.row_conv(seq, future_context_size=2, param_attr=_attr(P, wr))
                sc = P.static.nn.sequence_conv(seq, num_filters=7, filter_size=3,
                                               param_attr=_attr(P, wc))
            got[P] = _run(P, main, feed, [bt, rc, sc])
    assert [g.shape for g in got[tp]] == [(2, 5), (2, 6, 3), (2, 6, 7)]
    for g, w in zip(got[tp], got[jp]):
        close(g, w, atol=1e-5)


def test_spectral_norm_normalizes_and_carries_uv():
    w = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    want = float((w * w).sum() / np.linalg.svd(w, compute_uv=False)[0] ** 2)
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                wp = P.static.create_parameter([6, 4], "float32",
                                               default_initializer=P.nn.initializer.Assign(w))
                wn = P.static.nn.spectral_norm(wp, power_iters=6)
                frob = (wn * wn).sum()
            exe = P.static.Executor()
            got[P] = [float(exe.run(main, feed={}, fetch_list=[frob])[0]) for _ in range(3)]
    f1, f2, f3 = got[tp]
    assert f1 < 20.0 and np.isfinite(f2)
    # the carried u / v refine the estimate run after run: both packages
    # converge on ||W||_F^2 / sigma_max^2 from their own random u / v
    close(f3, want, rtol=1e-3)
    close(got[jp][2], want, rtol=1e-3)


def test_nce_and_data_norm_shapes():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4, 8)).astype(np.float32)
    wn = rng.normal(size=(20, 8)).astype(np.float32) * 0.1
    got = {}
    for P in (tp, jp):
        with static(P):
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [None, 8], "float32")
                lab = P.static.data("lab", [None, 1], "int64")
                loss = P.static.nn.nce(x, lab, num_total_classes=20, num_neg_samples=5,
                                       param_attr=_attr(P, wn))
                dn = P.static.nn.data_norm(x)
            exe = P.static.Executor()
            feed = {"x": xs, "lab": np.zeros((4, 1), np.int64)}
            got[P] = [exe.run(main, feed=feed, fetch_list=[loss, dn]) for _ in range(2)]
    o_loss, o_dn = got[tp][0]
    assert o_loss.shape == (4, 1) and np.all(o_loss > 0)
    assert o_dn.shape == (4, 8)
    for run_t, run_j in zip(got[tp], got[jp]):     # the accumulators carried alike
        for g, w in zip(run_t, run_j):
            close(g, w, atol=1e-5)


def test_deform_conv2d_names_its_missing_dependency():
    with pytest.raises(NotImplementedError, match="vision.ops"):
        tp.static.nn.deform_conv2d(None, None, None, 4, 3)


def test_static_all_matches_jax():
    import paddle_tpu.static as js
    import paddle_tpu.static.graph as jg
    import paddle_tpu.static.nn as jn

    assert tp.static.__all__ == js.__all__
    assert tp.static.nn.__all__ == jn.__all__
    assert tp.static.graph.__all__ == jg.__all__
    for name in js.__all__:
        assert hasattr(tp.static, name), name


def test_program_state_goes_to_and_from_numpy_by_name():
    """A Program's state by its layers' names: the JAX layers' weights go in
    through it and give the JAX program's fetch; a bad name raises."""
    xs, _ = _toy_batch(n=5)
    with static(jp):
        jmain, _, jpred, jnet = _softmax_program(jp, JF)
        (want,) = jp.static.Executor().run(jmain, feed={"x": xs}, fetch_list=[jpred])
    with static(tp):
        main, x, pred, _ = _softmax_program(tp, TF)
        state = to_paddle_tpu_program_state(main)
        assert sorted(state) == ["bias", "weight"]
        load_paddle_tpu_program_state(main, snapshot(jnet))
        (got,) = tp.static.Executor().run(main, feed={"x": xs}, fetch_list=[pred])
        with pytest.raises(KeyError, match="names differ"):
            load_paddle_tpu_program_state(main, {"w": state["weight"]})
    close(got, want)
