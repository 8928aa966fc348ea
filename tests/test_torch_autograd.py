"""Autograd of paddle_tpu_torch (torch's tape) against paddle_tpu's eager
tape (CPU): the cases of ``tests/test_autograd.py`` and
``tests/test_double_grad.py``, ``PyLayer``, ``jacobian`` and ``hessian``,
each through both packages on the same numpy inputs.  Values, gradients,
dtypes and shapes are compared: fp32 at rtol 1e-6 (1e-5 where a chain of
transcendental functions is differentiated twice), ints and bools exact.
The errors the JAX tape raises are raised too.
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu_torch.autograd import PyLayer as TPyLayer
from paddle_tpu_torch.framework import device as tp_device

RTOL = 1e-6
RTOL_CHAIN = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _np(x):
    if isinstance(x, tp.Tensor):
        return x.numpy(), str(x.dtype).replace("torch.", ""), tuple(x.shape)
    arr = np.asarray(x._data)
    return arr, np.dtype(arr.dtype).name, tuple(arr.shape)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


class _Ref:
    """One array output of the JAX package, on the host."""

    __slots__ = ("_data",)

    def __init__(self, arr):
        self._data = np.asarray(arr)


def jax_reference(cases):
    """name -> the flat outputs of ``cases[name](paddle_tpu)``: the cases
    that trace run as one jitted program (one XLA compile instead of one an
    op: the same ops, many times faster), the rest eagerly."""
    import jax

    statics = {}

    def leaves(name, fn):
        flat = _flat(fn(jp))
        statics[name] = [_Ref if hasattr(x, "_data") else x for x in flat]
        return [x._data for x in flat if hasattr(x, "_data")]

    traced, eager = {}, {}
    for n, fn in cases.items():
        try:
            jax.make_jaxpr(functools.partial(leaves, n, fn))()
            traced[n] = fn
        except Exception:
            eager[n] = fn
    arrays = jax.jit(lambda: {n: leaves(n, fn) for n, fn in traced.items()})()
    ref = {}
    for n in traced:
        it = iter(arrays[n])
        ref[n] = [_Ref(next(it)) if s is _Ref else s for s in statics[n]]
    for n, fn in eager.items():
        ref[n] = [_Ref(x._data) if hasattr(x, "_data") else x for x in _flat(fn(jp))]
    return ref


def assert_same(got, want, rtol=RTOL, what=""):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, f"{what}[{k}]")
        return
    if want is None or not hasattr(want, "_data"):
        assert got == want, f"{what}: {got!r} != {want!r}"
        return
    (g, gd, gs), (w, wd, ws) = _np(got), _np(want)
    assert (gd, gs) == (wd, ws), f"{what}: {gd} {gs} != {wd} {ws}"
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, float(np.abs(w).max())),
                               err_msg=what)


def _v(P, v, grad=True):
    return P.to_tensor(np.asarray(v, np.float32), stop_gradient=not grad)


def _simple(P):
    x = _v(P, [2.0])
    (x * x + 3 * x).backward()
    return x.grad


def _accumulation(P):
    x = _v(P, [1.0, 2.0])
    a = x * 2
    (a + x).sum().backward()
    return x.grad


def _matmul_grad(P):
    rng = np.random.default_rng(0)
    x, w = _v(P, rng.standard_normal((3, 4))), _v(P, rng.standard_normal((4, 5)))
    P.matmul(x, w).sum().backward()
    return [x.grad, w.grad]


def _retain_graph(P):
    x = _v(P, [1.0])
    y = x * 3
    y.backward(retain_graph=True)
    y.backward()
    return x.grad


def _no_grad(P):
    x = _v(P, [1.0])
    with P.no_grad():
        y = x * 2
    return [y.stop_gradient, y._grad_node is None, P.is_grad_enabled()]


def _grad_api(P):
    x = _v(P, [3.0])
    (gx,) = P.grad(x * x, x)
    return [gx, x.grad is None, gx.stop_gradient]


def _grad_unused(P):
    x, z = _v(P, [1.0]), _v(P, [1.0])
    with pytest.raises(RuntimeError):
        P.grad(x * 2, [z])
    gx, gz = P.grad(x * 2, [x, z], allow_unused=True)
    return [gx, gz]


def _hook(P):
    x = _v(P, [1.0])
    seen = []

    def hook(g):
        seen.append(np.asarray(g).copy())
        return g * 10

    x.register_hook(hook)
    (x * 2).backward()
    return [len(seen), x.grad]


def _multi_output(P):
    x = _v(P, np.arange(6))
    vals, idx = P.topk(x, 2)
    vals.sum().backward()
    return [vals, idx, x.grad]


def _int_op(P):
    x = _v(P, [1.0, 5.0, 2.0])
    i = P.argmax(x)
    return [i, i.stop_gradient, i._grad_node is None]


def _stop_gradient_leaf(P):
    x = _v(P, [1.0], grad=False)
    y = x * 2
    return [y._grad_node is None, y.stop_gradient]


def _backward_with_seed(P):
    x = _v(P, [1.0, 2.0])
    (x * x).backward(P.to_tensor(np.array([0.5, 2.0], np.float32)))
    return x.grad


def _second_third_order(P):
    x = _v(P, 2.0)
    (g1,) = P.grad(x ** 3, x, create_graph=True)
    (g2,) = P.grad(g1, x, create_graph=True)
    (g3,) = P.grad(g2, x)
    return [g1, g2, g3]


def _composite_second(P):
    x = _v(P, 0.5)
    (g1,) = P.grad(P.sin(x) * P.exp(x), x, create_graph=True)
    (g2,) = P.grad(g1, x)
    return [g1, g2]


def _gradient_penalty(P):
    x = _v(P, [1.0, 2.0])
    (gx,) = P.grad((x ** 2).sum(), x, create_graph=True)
    (gx ** 2).sum().backward()
    return [gx, x.grad]


def _mixed_partials(P):
    x, z = _v(P, 1.5), _v(P, 0.5)
    (gx,) = P.grad(x * x * z, x, create_graph=True)
    (gxz,) = P.grad(gx, z)
    return gxz


def _create_graph_under_no_grad(P):
    x = _v(P, 2.0)
    y = x ** 3
    with P.no_grad():
        (g1,) = P.grad(y, x, create_graph=True)
    (g2,) = P.grad(g1, x)
    return g2


def _amp_leaves_taped_backward(P):
    x = _v(P, 2.0)
    y = x ** 3
    with P.amp.auto_cast(level="O2", dtype="bfloat16"):
        (g1,) = P.grad(y, x, create_graph=True)
    return g1


def _single_tuple_output(P):
    x = _v(P, [1.0, 2.0, 3.0])
    (m,) = P.meshgrid(x)
    (m * m).sum().backward()
    return x.grad


def _grad_of_grad_allow_unused(P):
    x, z = _v(P, 1.0), _v(P, 2.0)
    (gx,) = P.grad(x ** 2, x, create_graph=True)
    return P.grad(gx, z, allow_unused=True)


def _inplace_then_backward(P):
    # the namespace's in-place variants (the JAX Tensor's own ``exp_`` /
    # ``scale_`` aliases rebind without keeping the old identity, so its
    # tape loses the gradient through them; the port's keep it)
    x = _v(P, [1.0, 2.0, 3.0])
    y = x * 1.5
    P.exp_(y)
    P.scale_(y, 2.0)
    y.sum().backward()
    return [y, x.grad]


CASES = {
    "simple_backward": (_simple, RTOL), "chain_and_accumulation": (_accumulation, RTOL),
    "matmul_grad": (_matmul_grad, RTOL_CHAIN), "retain_graph": (_retain_graph, RTOL),
    "no_grad": (_no_grad, RTOL), "grad_api": (_grad_api, RTOL),
    "grad_unused_input": (_grad_unused, RTOL), "hook": (_hook, RTOL),
    "multi_output_op_grad": (_multi_output, RTOL), "int_op_no_tape": (_int_op, RTOL),
    "stop_gradient_leaf_protected": (_stop_gradient_leaf, RTOL),
    "backward_with_seed": (_backward_with_seed, RTOL),
    "second_and_third_order": (_second_third_order, RTOL),
    "composite_second_order": (_composite_second, RTOL_CHAIN),
    "gradient_penalty_backward": (_gradient_penalty, RTOL),
    "mixed_partials": (_mixed_partials, RTOL),
    "create_graph_under_no_grad": (_create_graph_under_no_grad, RTOL),
    "amp_does_not_cast_taped_backward": (_amp_leaves_taped_backward, RTOL),
    "single_tuple_output_op_backward": (_single_tuple_output, RTOL),
    "grad_of_grad_with_allow_unused": (_grad_of_grad_allow_unused, RTOL),
    "inplace_then_backward": (_inplace_then_backward, RTOL_CHAIN),
}


@pytest.fixture(scope="module")
def ref():
    return jax_reference({n: fn for n, (fn, _) in CASES.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_case_matches_jax(name, ref):
    fn, rtol = CASES[name]
    assert_same(_flat(fn(tp)), ref[name], rtol, name)


def test_inplace_methods_keep_the_gradient():
    """``y.exp_()`` / ``y.scale_()`` on a non-leaf: the gradient flows through
    both (d/dx of 2 exp(1.5 x) is 3 exp(1.5 x))."""
    x = _v(tp, [1.0, 2.0])
    y = x * 1.5
    y.exp_()
    y.scale_(2.0)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 3 * np.exp(1.5 * np.array([1.0, 2.0])),
                               rtol=RTOL_CHAIN)


@pytest.mark.parametrize("P", [tp, jp], ids=["port", "jax"])
def test_double_backward_without_retain_raises(P):
    x = _v(P, [1.0])
    y = x * 3
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    z = x + 1                      # a graph that saves no tensor
    z.backward()
    with pytest.raises(RuntimeError):
        z.backward()


@pytest.mark.parametrize("P", [tp, jp], ids=["port", "jax"])
def test_backward_on_stop_gradient_raises(P):
    with pytest.raises(RuntimeError):
        (_v(P, [1.0], grad=False) * 2).backward()


def test_second_order_through_layers_matches_jax():
    """Grad of grad through Linear + Tanh + Linear on the same weights."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn

    jp.seed(0)
    jnet = jnn.Sequential(jnn.Linear(3, 8), jnn.Tanh(), jnn.Linear(8, 1))
    tnet = tnn.Sequential(tnn.Linear(3, 8, device="cpu"), tnn.Tanh(),
                          tnn.Linear(8, 1, device="cpu"))
    tnet.set_state_dict({k: np.asarray(v._data) for k, v in jnet.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    outs = []
    for P, net in ((tp, tnet), (jp, jnet)):
        xt = P.to_tensor(x, stop_gradient=False)
        (gx,) = P.grad(net(xt).sum(), xt, create_graph=True)
        (ggx,) = P.grad(gx.sum(), xt)
        outs.append([gx, ggx])
    assert_same(outs[0], outs[1], RTOL_CHAIN, "layers")


def _cube(Base):
    class Cube(Base):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            return x * x * x * (k / 3.0)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3 * x * x

    return Cube


def _two_in_two_out(Base):
    class Mix(Base):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b, a + b

        @staticmethod
        def backward(ctx, d_prod, d_sum):
            a, b = ctx.saved_tensor
            return d_prod * b + d_sum, d_prod * a + d_sum

    return Mix


def test_pylayer_matches_jax():
    outs = []
    for P, Base in ((tp, TPyLayer), (jp, JPyLayer)):
        x = _v(P, [2.0, -1.0])
        y = _cube(Base).apply(x)
        y.sum().backward()
        a, b = _v(P, [1.0, 2.0]), _v(P, [3.0, 4.0])
        p, s = _two_in_two_out(Base).apply(a, b)
        (p * 2 + s).sum().backward()
        outs.append([y, x.grad, p, s, a.grad, b.grad, y.stop_gradient])
    assert_same(outs[0], outs[1], RTOL, "pylayer")


def test_pylayer_without_grad_and_non_differentiable_outputs():
    class Split(TPyLayer):
        @staticmethod
        def forward(ctx, x):
            idx = tp.argmax(x)
            ctx.mark_non_differentiable(idx)
            return x * 2, idx

        @staticmethod
        def backward(ctx, dy, didx):
            return dy * 2

    x = _v(tp, [1.0, 3.0])
    y, idx = Split.apply(x)
    assert not y.stop_gradient and idx.stop_gradient
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
    y2, _ = Split.apply(_v(tp, [1.0], grad=False))
    assert y2.stop_gradient


def test_jacobian_and_hessian_match_jax():
    x = np.array([0.5, -1.0, 2.0], np.float32)
    outs = []
    for P in (tp, jp):
        f = (lambda t: P.sin(t) * t)
        xt = P.to_tensor(x, stop_gradient=False)
        jac_fn = P.autograd.jacobian(f, P.to_tensor(x))
        jac_tape = P.autograd.jacobian(f(xt), xt)
        hes = P.autograd.hessian(lambda t: (t * t * t).sum(), P.to_tensor(x))
        outs.append([jac_fn, jac_tape, hes])
    assert_same(outs[0], outs[1], RTOL_CHAIN, "jacobian/hessian")


def test_saved_tensors_hooks_pack_and_unpack_tensors():
    packed = []

    def pack(t):
        assert isinstance(t, tp.Tensor)
        packed.append(t.shape)
        return t.numpy()

    def unpack(a):
        return tp.to_tensor(a)

    x = _v(tp, [1.0, 2.0])
    with tp.autograd.saved_tensors_hooks(pack, unpack):
        y = (x * x).sum()
    y.backward()
    assert packed and x.grad.numpy().tolist() == [2.0, 4.0]


def test_grad_takes_layer_parameters():
    import paddle_tpu_torch.nn as tnn

    layer = tnn.Linear(3, 2, device="cpu")
    out = layer(tp.to_tensor(np.ones((4, 3), np.float32)))
    assert isinstance(out, tp.Tensor)
    gw, gb = tp.grad(out.sum(), [layer.weight, layer.bias])
    np.testing.assert_allclose(gw.numpy(), np.full((3, 2), 4.0))
    np.testing.assert_allclose(gb.numpy(), np.full((2,), 4.0))
    assert layer.weight.grad is None
    assert isinstance(layer.weight, torch.nn.Parameter)
