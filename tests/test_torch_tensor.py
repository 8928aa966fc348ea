"""paddle_tpu_torch's Tensor against paddle_tpu's (CPU): the cases of
``tests/test_tensor.py`` and ``tests/test_strided.py``, each run through
both packages on the same numpy inputs and compared value for value, with
the dtype and the shape exact (fp32 values: rtol 1e-6, ints and bools
exact), plus the conversion policy, the device default and ``save`` /
``load`` (the port reads a file the JAX package wrote, without importing
it).
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device

RTOL = 1e-6


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
    name = np.dtype(arr.dtype).name
    return (arr.astype(np.float32) if name == "bfloat16" else arr), name, tuple(arr.shape)


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


def assert_same(got, want, what=""):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{k}]")
        return
    if not hasattr(want, "_data"):
        assert got == want, f"{what}: {got!r} != {want!r}"
        return
    (g, gd, gs), (w, wd, ws) = _np(got), _np(want)
    assert (gd, gs) == (wd, ws), f"{what}: {gd} {gs} != {wd} {ws}"
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * max(1.0, float(np.abs(w).max())
                                                                    if w.size else 1.0),
                                   err_msg=what)


def _to_tensor_basic(P):
    t = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    return [t, t.shape, t.ndim, t.size, t.stop_gradient]


def _int64_downcast(P):
    return [P.to_tensor([1, 2, 3]), P.to_tensor(np.arange(3, dtype=np.int64)),
            P.to_tensor(np.arange(3.0)), P.to_tensor(True)]


def _dtype_conversion(P):
    t = P.to_tensor([1.0, 2.5])
    u = t.astype("bfloat16")
    return [u, u.astype(P.float32), t.cast("int32"), t.astype(P.float16)]


def _scalar_item(P):
    t = P.to_tensor(3.5)
    return [t.item(), float(t), t.ndim, int(P.to_tensor(7)), bool(P.to_tensor(0.0))]


def _indexing(P):
    t = P.to_tensor(np.arange(24).reshape(2, 3, 4).astype(np.float32))
    mask = t > 11
    return [t[0], t[0, 1, 2], t[:, 1], t[..., -1], P.masked_select(t, mask), t[mask],
            t[P.to_tensor(np.array([1, 0], np.int32))], t[[0, 1], [2, 0]], t[:, ::2, 1:3],
            t[1, None]]


def _setitem(P):
    t = P.to_tensor(np.zeros((3, 3), np.float32))
    t[0, 0] = 5.0
    t[1] = P.to_tensor(np.ones(3, np.float32))
    t[2, 1:] = P.to_tensor(np.array([7, 8], np.int32))
    return t


def _setitem_grad(P):
    x = P.to_tensor(np.ones((3,), np.float32), stop_gradient=False)
    y = x * 2
    y[0] = 0.0
    y.sum().backward()
    return [y, x.grad]


def _arithmetic_dunders(P):
    a = P.to_tensor([1.0, 2.0])
    b = P.to_tensor([3.0, 4.0])
    return [a + b, a - b, a * b, b / a, a ** 2, 2 + a, -a, (a < b).all(), 3 - a, 1 / a,
            b // a, b % a, np.float32(2.0) * a]


def _methods_installed(P):
    t = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    return [t.sum(), t.mean(), t.reshape([4]), t.transpose([1, 0]), t.T, t.matmul(t),
            t.max(), t.flatten(), t.unsqueeze(0), t.exp(), t.argmax(axis=1), t.clip(1.5, 3.0),
            t.topk(1)]


def _clone_detach(P):
    t = P.to_tensor([1.0], stop_gradient=False)
    c = t.clone()
    d = t.detach()
    arr = t.numpy()
    arr[0] = 99
    return [c.stop_gradient, d.stop_gradient, t, c]


def _parameter(P):
    p = P.Parameter(np.zeros((2, 2), np.float32))
    return [p.stop_gradient, p.trainable, p.persistable, p]


def _set_value(P):
    t = P.to_tensor([1.0, 2.0])
    t.set_value(np.array([5.0, 6.0], np.float32))
    with pytest.raises(ValueError):
        t.set_value(np.zeros(3, np.float32))
    return t


def _inplace_methods(P):
    t = P.to_tensor([1.0, -2.0, 3.0])
    t.add_(P.to_tensor([1.0, 1.0, 1.0]))
    t.scale_(2.0)
    t.clip_(-1.0, 5.0)
    u = P.to_tensor([[1.0, 2.0]])
    u.squeeze_(0)
    w = P.to_tensor([2.0, 3.0])
    w.zero_()
    return [t, u, w, P.to_tensor([1.0]).fill_(4.0)]


def _iteration_and_len(P):
    t = P.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
    return [len(t), list(t), t.tolist() == [[0, 1], [2, 3], [4, 5]]]


def _as_strided(P):
    x = P.to_tensor(np.arange(48, dtype=np.float32).reshape(2, 4, 6))
    y = P.to_tensor(np.arange(10, dtype=np.float32))
    z = P.to_tensor(np.arange(6, dtype=np.float32))
    return [P.as_strided(x, [8, 6], [6, 1]), P.as_strided(y, [4, 3], [2, 1], offset=1),
            P.as_strided(z, [3], [-1], offset=5)]


def _as_strided_grad(P):
    x = P.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
    P.as_strided(x, [5, 2], [1, 1]).sum().backward()
    return x.grad


def _unfold(P):
    return [P.unfold(P.to_tensor(np.arange(9, dtype=np.float32)), 0, 2, 4),
            P.unfold(P.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 6, 2)), 1, 3, 2)]


def _unfold_grad(P):
    x = P.to_tensor(np.ones(5, np.float32), stop_gradient=False)
    P.unfold(x, 0, 3, 1).sum().backward()
    return x.grad


CASES = {
    "to_tensor_basic": _to_tensor_basic, "int64_downcast_to_int32": _int64_downcast,
    "dtype_conversion": _dtype_conversion, "scalar_item": _scalar_item, "indexing": _indexing,
    "setitem": _setitem, "setitem_grad": _setitem_grad,
    "arithmetic_dunders": _arithmetic_dunders, "tensor_methods_installed": _methods_installed,
    "clone_detach": _clone_detach, "parameter": _parameter, "set_value": _set_value,
    "inplace_methods": _inplace_methods, "iteration_and_len": _iteration_and_len,
    "as_strided_matches": _as_strided, "as_strided_overlap_gradient": _as_strided_grad,
    "unfold": _unfold, "unfold_gradient": _unfold_grad,
}


@pytest.fixture(scope="module")
def ref():
    return jax_reference(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_case_matches_jax(name, ref):
    assert_same(_flat(CASES[name](tp)), ref[name], name)


@pytest.mark.parametrize("args,match", [
    (("as_strided", [4, 3], [2, 1], 1), "out of bounds"),
    (("as_strided", [3], [-1]), "out of bounds"),
    (("unfold", 0, 2, 0), "step must be positive"),
    (("unfold", 0, 7, 1), "exceeds dim"),
])
def test_strided_validation_raises_as_jax(args, match):
    for P in (tp, jp):
        x = P.to_tensor(np.arange(6 if args[0] == "as_strided" else 5, dtype=np.float32))
        with pytest.raises(ValueError, match=match):
            getattr(P, args[0])(x, *args[1:])


def test_tensor_wraps_torch_without_patching_it():
    t = tp.to_tensor([[1.0, 2.0]])
    assert isinstance(t._data, torch.Tensor) and not isinstance(t, torch.Tensor)
    assert t.size == 2 and t.shape == [1, 2]           # Paddle's members, not torch's
    assert not hasattr(torch.Tensor, "stop_gradient")
    assert tp.float32 is torch.float32 and tp.to_dtype("bf16") is torch.bfloat16
    # an explicit int64 stays int64 (the JAX package, without x64, cannot hold it)
    assert tp.to_tensor([1, 2], dtype="int64").dtype == torch.int64


def test_to_tensor_copies_its_input():
    src = np.ones(3, np.float32)
    t = tp.to_tensor(src)
    src[0] = 5.0
    assert t.numpy()[0] == 1.0
    u = tp.to_tensor(t)
    t[1] = 9.0
    assert u.numpy()[1] == 1.0


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    tp.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.set_device("gpu")
    assert tp.set_device("cpu") == torch.device("cpu")
    assert tp.get_device() == "cpu" and tp.to_tensor([1.0]).place == torch.device("cpu")


def test_save_load_round_trip(tmp_path):
    state = {"w": tp.to_tensor([1.0, 2.0]), "nested": {"b": tp.Parameter(np.ones(2, np.float32))},
             "h": tp.to_tensor([1.5], dtype="bfloat16"), "step": 7}
    p = str(tmp_path / "ckpt.pdparams")
    tp.save(state, p)
    loaded = tp.load(p)
    np.testing.assert_allclose(loaded["w"].numpy(), [1, 2])
    assert isinstance(loaded["nested"]["b"], tp.Parameter)
    assert not loaded["nested"]["b"].stop_gradient
    assert loaded["h"].dtype == torch.bfloat16 and loaded["step"] == 7
    assert tp.load(p, return_numpy=True)["w"].tolist() == [1.0, 2.0]


def test_load_reads_what_paddle_tpu_saved(tmp_path):
    import sys

    state = {"w": jp.to_tensor([[1.0, 2.0]]), "p": jp.Parameter(np.full((2,), 3.0, np.float32)),
             "i": jp.to_tensor([4, 5]), "h": jp.to_tensor([0.5], dtype="bfloat16"),
             "meta": {"step": 3, "name": "x"}}
    path = str(tmp_path / "jax.pdparams")
    jp.save(state, path)
    before = set(sys.modules)
    got = tp.load(path)
    assert not {m for m in set(sys.modules) - before if m.startswith(("jax", "paddle_tpu."))}
    assert_same([got["w"], got["p"], got["i"], got["h"]],
                [state["w"], state["p"], state["i"], state["h"]], "load")
    assert isinstance(got["p"], tp.Parameter) and got["meta"] == {"step": 3, "name": "x"}


def test_create_parameter_trains_through_an_optimizer():
    tp.seed(0)
    w = tp.create_parameter([3, 2], "float32")
    b = tp.create_parameter([2], "float32", is_bias=True)
    assert isinstance(w, tp.Parameter) and w.shape == [3, 2] and not w.stop_gradient
    assert b.numpy().tolist() == [0.0, 0.0]
    opt = tp.optimizer.SGD(learning_rate=0.5, parameters=[w, b])
    before = w.numpy()
    (tp.matmul(tp.ones([4, 3]), w) + b).sum().backward()
    opt.step()
    np.testing.assert_allclose(w.numpy(), before - 0.5 * 4.0, rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), [-2.0, -2.0], rtol=1e-6)
    assert tp.linalg.matmul is tp.matmul and tp.linalg.norm is tp.norm


@pytest.mark.parametrize("P", [tp, jp], ids=["port", "jax"])
def test_check_nan_inf_flag_raises_on_a_nan_output(P):
    P.set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert P.get_flags("check_nan_inf")["check_nan_inf"] is True
        x = P.to_tensor([1.0, 0.0])
        with pytest.raises(FloatingPointError):
            P.log(x * 0 - 1)
    finally:
        P.set_flags({"FLAGS_check_nan_inf": False})
