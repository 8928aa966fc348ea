"""``paddle_tpu_torch.jit`` (``to_static``, fragment capture of
``jit.subgraph``, ``functional_call``, ``bucketed``, ``save`` / ``load``)
against ``paddle_tpu.jit`` (CPU).

Every case of ``tests/test_subgraph.py`` and the three ``to_static`` cases
of ``tests/test_jit.py``: the same function or layer in both packages, the
same weights (carried with ``models.convert``), the same numpy inputs from
a seed; outputs agree within fp32 tolerance (``RTOL``), and the recorder's
accounting (fragments, breaks, eager ops, cache hits and misses) is the JAX
package's on the same program.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit import subgraph
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.framework.lazy import LazyArray
from paddle_tpu_torch.models.convert import load_paddle_tpu_params

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _arr(shape=(8, 16), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _x(P, shape=(8, 16), seed=0):
    return P.to_tensor(_arr(shape, seed))


def carry(jl, tl):
    load_paddle_tpu_params(tl, {n: np.array(t._data) for n, t in jl.state_dict().items()})


def _fn(x):
    y = (x @ x.transpose([1, 0])).sum(axis=1)
    if float(y.sum()) > 0:          # graph break
        z = y * 2 + 1
    else:
        z = y - 100
    return z.mean()


def test_capture_matches_eager_and_caches():
    recs = {}
    for P in (tp, jp):
        x = _x(P)
        ref = float(_fn(x))
        with P.jit.capture("t") as rec:
            out = float(_fn(x))
        with P.jit.capture("t") as rec2:
            out2 = float(_fn(x))
        recs[P] = (ref, out, out2, len(rec.fragments), len(rec.breaks), rec.eager_ops,
                   rec2.cache_misses, rec2.cache_hits)
    ref, out, out2, frags, breaks, eager, misses, hits = recs[tp]
    assert abs(out - ref) < 1e-5 and abs(out2 - ref) < 1e-5
    assert (frags, breaks, eager, misses, hits) == (2, 2, 0, 0, 2)
    close(out, recs[jp][1])
    assert recs[tp][3:] == recs[jp][3:]


def test_a_cache_hit_runs_no_shape_inference(monkeypatch):
    """A fragment counted a hit was recorded without running any call on
    meta tensors; the repeat of a captured call is all hits."""
    calls = []
    infer = subgraph.Recorder._infer

    def counted(self, *args):
        calls.append(args)
        return infer(self, *args)

    monkeypatch.setattr(subgraph.Recorder, "_infer", counted)
    x = _x(tp)
    with jit.capture("t"):
        float(_fn(x))
    first = len(calls)
    with jit.capture("t") as rec:
        float(_fn(x))
    assert (rec.cache_hits, rec.cache_misses, len(calls)) == (2, 0, first)


def test_export_routing_is_per_thread():
    """While one thread traces an export, another thread's kernel entries
    stay differentiable (the custom op has no autograd)."""
    from paddle_tpu_torch.kernels import export_ops
    from paddle_tpu_torch.kernels.rms_norm import rms_norm

    x = torch.from_numpy(_arr((4, 16))).requires_grad_()
    w = torch.ones(16)
    grads = []

    def other():
        rms_norm(x, w).sum().backward()
        grads.append(x.grad.clone())

    with export_ops.export_trace():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with pytest.raises(RuntimeError):
            rms_norm(x, w).sum().backward()
    assert len(grads) == 1 and torch.isfinite(grads[0]).all()


def test_break_site_points_at_user_code():
    x = _x(tp)
    with jit.capture() as rec:
        y = x.sum()
        if float(y) > -1e30:            # the break is THIS line
            z = x * 2
        _ = z.numpy()
    assert rec.breaks, "no break recorded"
    assert "test_torch_jit.py" in rec.breaks[0]["site"]


def _gated(P, F):
    class GatedNet(P.nn.Layer):
        """Data-dependent Python branch: the classic fragment fallback."""

        def __init__(self):
            super().__init__()
            self.a = P.nn.Linear(16, 64)
            self.b = P.nn.Linear(64, 64)
            self.head_pos = P.nn.Linear(64, 4)
            self.head_neg = P.nn.Linear(64, 4)

        def forward(self, x):
            h = F.gelu(self.b(F.gelu(self.a(x))))
            if float(h.mean()) > 0:
                return self.head_pos(h)
            return self.head_neg(h)

    return GatedNet()


def _gated_pair():
    jp.seed(0)
    jnet = _gated(jp, JF)
    tnet = _gated(tp, TF)
    carry(jnet, tnet)
    return jnet, tnet


def test_to_static_fallback_uses_fragments():
    jnet, tnet = _gated_pair()
    x = _arr()
    ref = tnet(tp.to_tensor(x)).numpy()
    close(ref, jnet(jp.to_tensor(x)).numpy(), atol=1e-5)
    static = tp.jit.to_static(tnet)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out1 = static(tp.to_tensor(x))
    msgs = [str(i.message) for i in w if "fragment capture" in str(i.message)]
    assert msgs, "fallback diagnostic not emitted"
    assert "graph break" in msgs[0]
    close(out1.numpy(), ref)
    out2 = static(tp.to_tensor(x))           # steady state: every fragment seen
    close(out2.numpy(), ref)
    rec = static._last_capture
    assert rec.cache_misses == 0 and rec.eager_ops == 0
    assert sum(f["recorded"] for f in rec.fragments) == rec.ops_recorded
    jstatic = jp.jit.to_static(jnet)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstatic(jp.to_tensor(x))
        jout = jstatic(jp.to_tensor(x))
    close(out2.numpy(), jout.numpy(), atol=1e-5)
    jrec = jstatic._last_capture
    assert (len(rec.fragments), len(rec.breaks)) == (len(jrec.fragments), len(jrec.breaks))


def test_branch_flip_compiles_new_fragment_reuses_shared_prefix():
    jnet, tnet = _gated_pair()
    static = tp.jit.to_static(tnet)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        static(_x(tp, seed=1))                  # warm: records the positive branch
    with tp.no_grad():
        tnet.b.bias.set_value(tp.to_tensor(np.full((64,), -100.0, np.float32)))
        jnet.b.bias.set_value(jp.to_tensor(np.full((64,), -100.0, np.float32)))
    x = _arr(seed=2)
    ref = tnet(tp.to_tensor(x)).numpy()
    out = static(tp.to_tensor(x))
    close(out.numpy(), ref)
    close(out.numpy(), jnet(jp.to_tensor(x)).numpy(), atol=1e-5)
    assert static._last_capture.cache_misses <= 1


def test_data_dependent_loop_trip_count():
    def fn(x):
        steps = 0
        while float(x.max()) > 1.0:             # a break each iteration
            x = x * 0.5
            steps += 1
        return x.sum(), steps

    x = tp.to_tensor(np.full((4,), 8.0, np.float32))
    ref, ref_steps = fn(x)
    with jit.capture() as rec:
        out, steps = fn(x)
    assert steps == ref_steps == 3
    assert abs(float(out) - float(ref)) < 1e-6
    assert rec.eager_ops == 0
    close(float(out), float(fn(jp.to_tensor(np.full((4,), 8.0, np.float32)))[0]))


def test_multi_output_and_mixed_inputs():
    def fn(P, x, c):
        a, b = P.split(x + c, 2, axis=0)         # a multi-output op
        m = (a * b).sum()
        if float(m) < 1e30:
            return a.mean() + b.mean()
        return m

    xs, cs = _arr((6, 8)), np.ones((6, 8), np.float32)
    x, c = tp.to_tensor(xs), tp.to_tensor(cs)
    ref = float(fn(tp, x, c))
    with jit.capture() as rec:
        out = float(fn(tp, x, c))
    assert abs(out - ref) < 1e-5
    assert rec.eager_ops == 0
    close(out, float(fn(jp, jp.to_tensor(xs), jp.to_tensor(cs))))


def test_numpy_read_substitutes_concrete_storage():
    x = _x(tp)
    with jit.capture():
        y = x * 3
        n = y.numpy()                    # a break: materialises y
        assert isinstance(y._data, torch.Tensor)   # storage substituted in place
    close(n, x.numpy() * 3)


def test_nesting_raises():
    with jit.capture():
        with pytest.raises(RuntimeError, match="nest"):
            with jit.capture():
                pass


def test_undeferrable_op_falls_back_eagerly():
    from paddle_tpu_torch.ops.common import apply

    x = _x(tp, (4, 4))
    with jit.capture() as rec:
        y = x + 1                        # deferred
        y_data = y._data                 # a pending value leaks into a closure
        # fn ignores its input and reads the pending value: shape inference
        # cannot, so the recorder flushes and the op runs eagerly
        out = apply("closure_op", lambda a: y_data * 2, x)
        val = float(out.sum())
    assert abs(val - float(((x.numpy() + 1) * 2).sum())) < 1e-5
    assert rec.eager_ops == 1


def test_capture_preserves_tensor_metadata():
    x = _x(tp)
    with jit.capture():
        y = x.astype("float32") * 2
        assert isinstance(y._data, LazyArray)
        assert y.shape == [8, 16]        # metadata without forcing
        assert y.dtype == tp.float32
        assert y.ndim == 2
    assert isinstance(y._data, torch.Tensor)   # the end of capture materialised it


def test_amp_o2_capture_no_recursion():
    x = _x(tp)
    with tp.amp.auto_cast(level="O2", dtype="float16"):
        with jit.capture() as rec:
            y = x * 2
            z = y @ y.transpose([1, 0])  # the cast of a pending input is recorded
            assert z.dtype == torch.float16
            v = float(z.sum())
    assert np.isfinite(v)
    assert rec.eager_ops == 0


def test_aborted_capture_gives_clear_error():
    x = _x(tp)
    saved = []
    with pytest.raises(ValueError, match="boom"):
        with jit.capture():
            saved.append(x * 2)
            raise ValueError("boom")
    with pytest.raises(RuntimeError, match="aborted"):
        saved[0].numpy()


def test_model_exception_propagates_through_to_static():
    class Boom(tp.nn.Layer):
        def forward(self, x):
            y = x * 2
            if float(y.sum()) > -1e30:
                raise ValueError("bad batch")
            return y

    static = tp.jit.to_static(Boom())
    with pytest.raises(ValueError, match="bad batch"):
        static(_x(tp))
    # a model error does not de-optimise for good: the next call tries
    # fragments again and fails the same way, as eager would
    with pytest.raises(ValueError, match="bad batch"):
        static(_x(tp))


def test_escaped_lazy_astype_after_capture():
    with jit.capture():
        y = _x(tp) * 3
        t2 = tp.to_tensor(y)     # a copy during capture: reads the value
    assert isinstance(t2._data, torch.Tensor)
    z = t2.astype("float16")
    assert z.dtype == torch.float16


def test_check_nan_inf_disables_deferral():
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = _x(tp)
        with jit.capture() as rec:
            y = x * 2
            v = float(y.sum())
        assert np.isfinite(v)
        assert rec.eager_ops >= 1    # the ops ran eagerly, each checked
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})


# ---------------------------------------------------------------------------
# test_jit.py's to_static cases
# ---------------------------------------------------------------------------

def test_to_static_function_parity():
    a, b = _arr((3, 4), 1), _arr((4, 5), 2)
    outs = {}
    for P in (tp, jp):
        @P.jit.to_static
        def f(x, y):
            return P.matmul(x, y) + 1.0

        outs[P] = [f(P.to_tensor(a), P.to_tensor(b)).numpy() for _ in range(2)]
    close(outs[tp][0], a @ b + 1.0)
    close(outs[tp][1], outs[tp][0])
    close(outs[tp][0], outs[jp][0])


def test_to_static_layer_parity():
    jp.seed(0)
    jm = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.GELU(), jp.nn.Linear(16, 4))
    tm = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.GELU(), tp.nn.Linear(16, 4))
    carry(jm, tm)
    jm.eval()
    tm.eval()
    x = _arr((2, 8))
    eager = tm(tp.to_tensor(x)).numpy()
    static = tp.jit.to_static(tm)
    out = static(tp.to_tensor(x))
    close(out.numpy(), eager)
    close(out.numpy(), jp.jit.to_static(jm)(jp.to_tensor(x)).numpy())
    assert not static._fallback_sigs and len(static._programs) == 1   # recorded whole


def test_to_static_sees_weight_updates():
    m = tp.nn.Linear(4, 4, bias_attr=False)
    static = tp.jit.to_static(m)
    x = tp.ones([1, 4])
    out1 = static(x).numpy()
    m.weight.set_value(m.weight.numpy() * 2)
    out2 = static(x).numpy()
    close(out2, out1 * 2)


def test_to_static_full_graph_raises_at_a_break():
    static = tp.jit.to_static(lambda x: x * 2 if float(x.sum()) > 0 else x, full_graph=True)
    from paddle_tpu_torch.jit import _GraphBreak

    with pytest.raises(_GraphBreak):
        static(_x(tp))


def test_enable_to_static_off_runs_eagerly():
    calls = []

    @tp.jit.to_static
    def f(x):
        calls.append(1)
        return x * 2

    tp.jit.enable_to_static(False)
    try:
        for _ in range(2):
            close(f(_x(tp)).numpy(), _arr() * 2)
        assert len(calls) == 2
    finally:
        tp.jit.enable_to_static(True)
    f(_x(tp))
    f(_x(tp))
    assert len(calls) == 3       # recorded once, then replayed


def test_functional_call_matches_jax():
    jp.seed(0)
    jl = jp.nn.Linear(4, 3)
    tl = tp.nn.Linear(4, 3)
    carry(jl, tl)
    w = _arr((4, 3), 5)
    x = _arr((2, 4), 6)
    got = tp.jit.functional_call(tl, {"weight": torch.from_numpy(w), "bias": tl.bias}, {},
                                 tp.to_tensor(x))
    want = jp.jit.functional_call(jl, {"weight": jp.to_tensor(w)._data, "bias": jl.bias._data},
                                  {}, jp.to_tensor(x))
    close(got.numpy(), np.asarray(want))
    close(tl.weight.numpy(), np.asarray(jl.weight._data))    # the layer's own weight untouched


@pytest.mark.parametrize("n", [3, 5, 8])
def test_bucketed_pads_and_cuts_back(n):
    outs = {}
    for P in (tp, jp):
        @P.jit.bucketed(axes=[(0, 0)])
        def f(x):
            return x * 2 + 1

        outs[P] = f(P.to_tensor(np.arange(n * 2, dtype=np.float32).reshape(n, 2)))
    assert outs[tp].shape == [n, 2]
    close(outs[tp].numpy(), outs[jp].numpy())


def test_save_load_round_trip_of_a_layer(tmp_path):
    jp.seed(0)
    jm = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.GELU(), jp.nn.Linear(16, 4))
    tm = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.GELU(), tp.nn.Linear(16, 4))
    carry(jm, tm)
    path = str(tmp_path / "seq")
    nbytes = tp.jit.save(tm, path, input_spec=[tp.static.InputSpec([None, 8], "float32")])
    assert nbytes > 0
    loaded = tp.jit.load(path)
    assert isinstance(loaded, tp.jit.TranslatedLayer)
    for b in (2, 5):
        x = _arr((b, 8), b)
        close(loaded(tp.to_tensor(x)).numpy(), jm(jp.to_tensor(x)).numpy(), atol=1e-5)
    # the weights file is the JAX layout, readable by the port's load
    state = tp.load(path + ".pdiparams")
    assert sorted(state) == ["buffers", "params"]
    assert sorted(state["params"]) == sorted(n for n, _ in tm.named_parameters())


def test_jit_all_matches_jax():
    import paddle_tpu.jit.subgraph as jsub

    assert tp.jit.__all__ == jp.jit.__all__
    assert tp.jit.subgraph.__all__ == jsub.__all__


def test_a_call_that_needs_a_gradient_runs_eagerly():
    """Inside a capture, under enable_grad, a call on a Tensor that needs
    a gradient runs eagerly (autograd's), after a flush; the rest defers."""
    w = tp.to_tensor(_arr((16, 4)), stop_gradient=False)
    x = _x(tp)
    with jit.capture() as rec:
        y = x * 2                        # deferred
        with tp.enable_grad():
            z = tp.matmul(y, w)          # needs a gradient: eager
        assert not isinstance(z._data, LazyArray) and z._data.requires_grad
    assert rec.eager_ops == 1
    z.sum().backward()
    close(w.grad.numpy(), np.broadcast_to((_arr() * 2).sum(0)[:, None], (16, 4)), rtol=1e-5)
