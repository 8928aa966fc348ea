"""paddle_tpu_torch's ``ops.extras``, ``fft``, ``signal`` and ``regularizer``
against paddle_tpu's (CPU), and the port's name parity with the JAX package.

Each case runs on the same seeded numpy inputs through both packages
(forward values, dtypes and shapes; for a differentiable case the gradient
of a fixed weighted sum of its float outputs, as in
``test_torch_nn_functional_tail.py``, whose harness this file uses).
Tolerances: ``RTOL`` (1e-6 relative, an atol of 1e-6 of the largest
|value|) for data movement and exact arithmetic; ``SPECIAL`` (1e-5) where
XLA and torch compute a special function by other series (the gamma family,
the scaled Bessel functions, ``sinc``) or sum in another order (distances,
``logcumsumexp``, trapezoids, ``linspace``); ``FFT`` (1e-5 relative, the
atol of the largest |value|) for the transforms, pocketfft in both but
another plan; integers, booleans and Python values exact.  ``gammainc`` /
``gammaincc`` are differentiated in ``x`` only: torch has no derivative in
the shape argument.
"""

import functools

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device
from test_torch_nn_functional_tail import _run, check_port_gradient, jax_outputs_and_grads
from test_torch_ops import assert_same, jax_reference

RTOL = 1e-6
SPECIAL = 1e-5
FFT = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


rng = np.random.default_rng(1818)


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


A, B = _f(3, 3), _f(3, 3)
M1, M2, M3 = _f(3, 4), _f(4, 5), _f(3, 5)
X, Y = _f(4, 6), _f(5, 6)
P2 = _f(3, 4, lo=0.5, hi=3.0)
Q2 = _f(3, 4, lo=0.1, hi=4.0)
T3 = _f(2, 3, 4)
IDX = np.array([0, 5, -2, 11, 3], np.int32)
WIDE = np.array([0, 5, -2, 14, -15], np.int32)
INTS = rng.integers(-20, 30, (3, 4)).astype(np.int32)
DIVS = rng.integers(1, 7, (3, 4)).astype(np.int32)
SIG = _f(3, 16)
CUBE = _f(2, 6, 8)
CSIG = (_f(3, 9) + 1j * _f(3, 9)).astype(np.complex64)
CCUBE = (_f(2, 6, 5) + 1j * _f(2, 6, 5)).astype(np.complex64)
CLIP = _f(2, 400)
WIN = np.hanning(64).astype(np.float32)
WIN48 = np.hanning(48).astype(np.float32)


def _stft_np(x, n_fft=64, hop=16):
    """A one-sided STFT of ``x`` (reflect padded, Hann window) in numpy:
    istft's input."""
    xp = np.pad(x, [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    n = 1 + (xp.shape[-1] - n_fft) // hop
    frames = np.stack([xp[:, i * hop:i * hop + n_fft] for i in range(n)], 1) * WIN
    return np.swapaxes(np.fft.rfft(frames, axis=-1), -1, -2).astype(np.complex64)


SPEC = _stft_np(CLIP)


def _top(P_):
    return P_


def _t(P_, a):
    return P_.to_tensor(a)


# name -> (inputs, fn(P, P, *tensors), rtol, differentiable)
CASES = {
    # ---- ops.extras
    "addmm": ((A, B, A.T.copy()), lambda P_, _, i, x, y: [P_.addmm(i, x, y),
                                                          P_.addmm(i, x, y, 0.5, 2.0)],
              SPECIAL, True),
    "mm": ((M1, M2), lambda P_, _, a, b: P_.mm(a, b), SPECIAL, True),
    "block_diag": ((M1, M2, X[0]), lambda P_, _, a, b, c: P_.block_diag([a, b, c]), RTOL, True),
    "cdist": ((X, Y), lambda P_, _, a, b: [P_.cdist(a, b), P_.cdist(a, b, 1.0),
                                            P_.cdist(a, b, float("inf")), P_.cdist(a, b, 3.0)],
              SPECIAL, True),
    "pdist": ((X,), lambda P_, _, a: [P_.pdist(a), P_.pdist(a, 1.0)], SPECIAL, True),
    "vander": ((X[0],), lambda P_, _, a: [P_.vander(a), P_.vander(a, 3, increasing=True)],
               SPECIAL, True),
    "logcumsumexp": ((T3,), lambda P_, _, a: [P_.logcumsumexp(a), P_.logcumsumexp(a, axis=1)],
                     SPECIAL, True),
    "reduce_as": ((T3,), lambda P_, _, a: [P_.reduce_as(a, _t(P_, np.zeros((3, 1), np.float32))),
                                           P_.reduce_as(a, _t(P_, np.zeros((2, 1, 4),
                                                                           np.float32)))],
                  SPECIAL, True),
    "trapezoid": ((X, np.cumsum(np.abs(X), 1).astype(np.float32)), lambda P_, _, y, x: [
        P_.trapezoid(y), P_.trapezoid(y, dx=0.5, axis=0), P_.trapezoid(y, x=x)], SPECIAL, True),
    "cumulative_trapezoid": ((X, np.cumsum(np.abs(X), 1).astype(np.float32)),
                             lambda P_, _, y, x: [P_.cumulative_trapezoid(y),
                                                  P_.cumulative_trapezoid(y, x=x),
                                                  P_.cumulative_trapezoid(y, dx=2.0, axis=0)],
                             SPECIAL, True),
    "sinc": ((X,), lambda P_, _, a: P_.sinc(a), SPECIAL, True),
    "frexp": ((X * 100,), lambda P_, _, a: P_.frexp(a), RTOL, False),
    "isin": ((INTS, DIVS), lambda P_, _, a, b: [P_.isin(a, b), P_.isin(a, b, invert=True)],
             RTOL, False),
    "gammaln": ((P2,), lambda P_, _, a: P_.gammaln(a), SPECIAL, True),
    "gammainc": ((P2.tolist(), Q2), lambda P_, _, a, x: P_.gammainc(_t(P_, a), x), SPECIAL,
                 True),
    "gammaincc": ((P2.tolist(), Q2), lambda P_, _, a, x: P_.gammaincc(_t(P_, a), x), SPECIAL,
                  True),
    "multigammaln": ((P2 + 1.5,), lambda P_, _, a: P_.multigammaln(a, 3), SPECIAL, True),
    "i0e": ((X * 3,), lambda P_, _, a: P_.i0e(a), SPECIAL, True),
    "i1e": ((X * 3,), lambda P_, _, a: P_.i1e(a), SPECIAL, True),
    "hstack": ((M1, M3), lambda P_, _, a, b: P_.hstack([a, b]), RTOL, True),
    "vstack": ((M1, X[:2, :4]), lambda P_, _, a, b: P_.vstack([a, b]), RTOL, True),
    "dstack": ((M1, M1 * 2), lambda P_, _, a, b: P_.dstack([a, b]), RTOL, True),
    "column_stack": ((X[0], X[1]), lambda P_, _, a, b: P_.column_stack([a, b]), RTOL, True),
    "row_stack": ((X[0], X[1]), lambda P_, _, a, b: P_.row_stack([a, b]), RTOL, True),
    "hsplit": ((X,), lambda P_, _, a: [*P_.hsplit(a, 3), *P_.hsplit(a, [1, 4])], RTOL, True),
    "vsplit": ((X,), lambda P_, _, a: [*P_.vsplit(a, 2), *P_.vsplit(a, [1])], RTOL, True),
    "dsplit": ((T3,), lambda P_, _, a: P_.dsplit(a, 2), RTOL, True),
    "cartesian_prod": ((X[0, :3], X[1, :2], X[2, :2]), lambda P_, _, a, b, c: [
        P_.cartesian_prod([a, b, c]), P_.cartesian_prod([a])], RTOL, True),
    "combinations": ((X[0],), lambda P_, _, a: [P_.combinations(a),
                                                P_.combinations(a, 3, with_replacement=True)],
                     RTOL, True),
    "reverse": ((T3,), lambda P_, _, a: [P_.reverse(a, 1), P_.reverse(a, [0, 2])], RTOL, True),
    "diagonal_scatter": ((X, X[0, :4], T3, T3[0, :2, 0]), lambda P_, _, a, d, b, e: [
        P_.diagonal_scatter(a, d), P_.diagonal_scatter(a, d[:3], offset=2),
        P_.diagonal_scatter(b, e, axis1=1, axis2=2)], RTOL, True),
    "slice_scatter": ((X, X[:, ::2] * 0 + 1), lambda P_, _, a, v: P_.slice_scatter(
        a, v, [1], [0], [6], [2]), RTOL, True),
    "take": ((X, IDX, WIDE), lambda P_, _, a, i, w: [P_.take(a, i), P_.take(a, w, mode="wrap"),
                                                     P_.take(a, w, mode="clip")], RTOL, True),
    "isneginf": ((np.array([1.0, -np.inf, np.inf, np.nan], np.float32),),
                 lambda P_, _, a: P_.isneginf(a), RTOL, False),
    "isposinf": ((np.array([1.0, -np.inf, np.inf, np.nan], np.float32),),
                 lambda P_, _, a: P_.isposinf(a), RTOL, False),
    "isreal": ((X, CSIG), lambda P_, _, a, c: [P_.isreal(a), P_.isreal(c)], RTOL, False),
    "is_complex": ((X, CSIG), lambda P_, _, a, c: [P_.is_complex(a), P_.is_complex(c)], RTOL,
                   False),
    "is_floating_point": ((X, INTS), lambda P_, _, a, i: [P_.is_floating_point(a),
                                                          P_.is_floating_point(i)], RTOL, False),
    "is_integer": ((X, INTS), lambda P_, _, a, i: [P_.is_integer(a), P_.is_integer(i)], RTOL,
                   False),
    "broadcast_shape": ((), lambda P_, _: P_.broadcast_shape([2, 1, 4], [3, 1]), RTOL, False),
    "histogram_bin_edges": ((X,), lambda P_, _, a: [P_.histogram_bin_edges(a, 7),
                                                    P_.histogram_bin_edges(a, 4, -1.0, 2.0)],
                            SPECIAL, False),
    "rank": ((T3,), lambda P_, _, a: P_.rank(a), RTOL, False),
    "shape": ((T3,), lambda P_, _, a: P_.shape(a), RTOL, False),
    "tolist": ((INTS,), lambda P_, _, a: P_.tolist(a), RTOL, False),
    "finfo": ((), lambda P_, _: [sorted(vars(P_.finfo(d)).items())
                                 for d in ("float32", "bfloat16", "float16")], RTOL, False),
    "iinfo": ((), lambda P_, _: [sorted(vars(P_.iinfo(d)).items())
                                 for d in ("int32", "int8", "uint8")], RTOL, False),
    "increment": ((X[:1, :1],), lambda P_, _, a: P_.increment(a, 2.5), RTOL, False),
    "shard_index": ((np.array([[0], [7], [12], [19]], np.int32),),
                    lambda P_, _, a: P_.shard_index(a, 20, 3, 1), RTOL, False),
    "floor_mod": ((INTS, DIVS, X, np.full((4, 6), 1.5, np.float32)),
                  lambda P_, _, a, b, x, y: [P_.floor_mod(a, b), P_.floor_mod(x, y)], RTOL,
                  True),
    "where_": ((X, Y[:4]), lambda P_, _, a, b: P_.where_(a > 0, a, b), RTOL, False),
    # in-place variants of this module's own bases
    "sinc_": ((X,), lambda P_, _, a: P_.sinc_(a), SPECIAL, False),
    "gammaln_": ((P2,), lambda P_, _, a: P_.gammaln_(a), SPECIAL, False),
    "gammainc_": ((P2, Q2), lambda P_, _, a, x: P_.gammainc_(a, x), SPECIAL, False),
    "gammaincc_": ((P2, Q2), lambda P_, _, a, x: P_.gammaincc_(a, x), SPECIAL, False),
    "multigammaln_": ((P2 + 1.5,), lambda P_, _, a: P_.multigammaln_(a, 2), SPECIAL, False),
    "addmm_": ((A, B, A.T.copy()), lambda P_, _, i, x, y: P_.addmm_(i, x, y, 1.0, 0.5), SPECIAL,
               False),
    "floor_mod_": ((INTS, DIVS), lambda P_, _, a, b: P_.floor_mod_(a, b), RTOL, False),
    # ---- fft
    "fft.fft": ((SIG,), lambda P_, _, x: [P_.fft.fft(x), P_.fft.fft(x, n=20, norm="ortho"),
                                          P_.fft.fft(x, axis=0)], FFT, True),
    "fft.ifft": ((SIG,), lambda P_, _, x: [P_.fft.ifft(x), P_.fft.ifft(x, n=8, norm="forward")],
                 FFT, True),
    "fft.rfft": ((SIG,), lambda P_, _, x: [P_.fft.rfft(x), P_.fft.rfft(x, n=10)], FFT, True),
    "fft.irfft": ((CSIG,), lambda P_, _, x: [P_.fft.irfft(x), P_.fft.irfft(x, n=12)], FFT,
                  False),
    "fft.hfft": ((CSIG,), lambda P_, _, x: [P_.fft.hfft(x), P_.fft.hfft(x, n=10, norm="ortho")],
                 FFT, False),
    "fft.ihfft": ((SIG,), lambda P_, _, x: P_.fft.ihfft(x), FFT, True),
    "fft.fft2": ((CUBE,), lambda P_, _, x: [P_.fft.fft2(x), P_.fft.fft2(x, s=[4, 10])], FFT,
                 True),
    "fft.ifft2": ((CUBE,), lambda P_, _, x: P_.fft.ifft2(x, axes=(0, 2)), FFT, True),
    "fft.rfft2": ((CUBE,), lambda P_, _, x: P_.fft.rfft2(x), FFT, True),
    "fft.irfft2": ((CCUBE,), lambda P_, _, x: [P_.fft.irfft2(x), P_.fft.irfft2(x, s=[6, 6])],
                   FFT, False),
    "fft.fftn": ((CUBE,), lambda P_, _, x: [P_.fft.fftn(x), P_.fft.fftn(x, axes=[1])], FFT,
                 True),
    "fft.ifftn": ((CUBE,), lambda P_, _, x: P_.fft.ifftn(x, s=[3, 5, 8]), FFT, True),
    "fft.rfftn": ((CUBE,), lambda P_, _, x: P_.fft.rfftn(x), FFT, True),
    "fft.irfftn": ((CCUBE,), lambda P_, _, x: P_.fft.irfftn(x), FFT, False),
    "fft.fftfreq": ((), lambda P_, _: [P_.fft.fftfreq(8), P_.fft.fftfreq(7, 0.5)], RTOL, False),
    "fft.rfftfreq": ((), lambda P_, _: [P_.fft.rfftfreq(8), P_.fft.rfftfreq(9, 2.0)], RTOL,
                     False),
    "fft.fftshift": ((CUBE,), lambda P_, _, x: [P_.fft.fftshift(x), P_.fft.fftshift(x, axes=1)],
                     RTOL, True),
    "fft.ifftshift": ((CUBE,), lambda P_, _, x: P_.fft.ifftshift(x, axes=[0, 2]), RTOL, True),
    "fft.hfft2": ((CCUBE,), lambda P_, _, x: [P_.fft.hfft2(x), P_.fft.hfft2(x, s=[6, 8])], FFT,
                  False),
    "fft.hfftn": ((CCUBE,), lambda P_, _, x: P_.fft.hfftn(x), FFT, False),
    "fft.ihfft2": ((CUBE,), lambda P_, _, x: [P_.fft.ihfft2(x), P_.fft.ihfft2(x, s=[4, 6])],
                   FFT, True),
    "fft.ihfftn": ((CUBE,), lambda P_, _, x: P_.fft.ihfftn(x), FFT, True),
    # ---- signal
    "signal.stft": ((CLIP, WIN, WIN48), lambda P_, _, x, w, w48: [
        P_.signal.stft(x, 64, 16, window=w), P_.signal.stft(x, 64),
        P_.signal.stft(x[0], 64, 20, 48, w48, center=False),
        P_.signal.stft(x, 64, 16, window=w, normalized=True, onesided=False),
        P_.signal.stft(x, 32, 8, pad_mode="constant")], FFT, True),
    "signal.istft": ((SPEC, WIN), lambda P_, _, s, w: [
        P_.signal.istft(s, 64, 16, window=w), P_.signal.istft(s, 64, 16, window=w, length=300),
        P_.signal.istft(s, 64, 16, window=w, normalized=True),
        P_.signal.istft(s, 64, 16, center=False)], FFT, False),
}


@pytest.fixture(scope="module")
def ref():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    try:
        jp.seed(3)
        run = functools.partial(_run, cases=CASES, ns=_top)
        out = jax_reference({n: functools.partial(run, n) for n, c in CASES.items() if not c[3]})
        both = jax_outputs_and_grads([n for n, c in CASES.items() if c[3]], CASES, _top)
        out.update({n: o for n, (o, _) in both.items()})
        out["grads"] = {n: g for n, (_, g) in both.items()}
        return out
    finally:
        tp.set_device(prev)


def test_cases_cover_every_name_of_extras_fft_and_signal():
    from paddle_tpu.ops import extras

    import paddle_tpu.fft as jfft
    import paddle_tpu.signal as jsignal

    inplace = {n for n in tp.ops.__all__ if n[:-1] in tp.ops.extras.INPLACE_BASES}
    assert set(CASES) == (set(extras.__all__) - {"set_printoptions", "set_grad_enabled"}
                          | inplace | {f"fft.{n}" for n in jfft.__all__}
                          | {f"signal.{n}" for n in jsignal.__all__})
    assert tp.ops.extras.__all__ == extras.__all__
    assert tp.fft.__all__ == jfft.__all__ and tp.signal.__all__ == jsignal.__all__


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name, ref):
    tp.seed(0)
    assert_same(_run(name, tp, CASES, _top), ref[name], rtol=CASES[name][2], what=name)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[3]))
def test_gradient_matches_jax(name, ref):
    check_port_gradient(name, ref["grads"][name], CASES, _top)


def test_inplace_extras_return_their_tensor():
    for name in ("increment", "where_", "sinc_", "addmm_"):
        x = tp.to_tensor(A)
        args = {"increment": (1.0,), "where_": (x > 0, x, tp.to_tensor(B)),
                "sinc_": (), "addmm_": (tp.to_tensor(B), tp.to_tensor(A))}[name]
        out = getattr(tp, name)(*args) if name == "where_" else getattr(tp, name)(x, *args)
        assert out is x, name


def test_set_printoptions_and_set_grad_enabled():
    saved = np.get_printoptions()
    try:
        for P_ in (tp, jp):
            P_.set_printoptions(precision=3, sci_mode=False)
            assert np.get_printoptions()["precision"] == 3
            np.set_printoptions(**saved)
    finally:
        np.set_printoptions(**saved)
    from paddle_tpu_torch.framework import autograd

    assert tp.set_grad_enabled is autograd.set_grad_enabled is tp.ops.extras.set_grad_enabled
    x = tp.to_tensor(A, stop_gradient=False)
    with tp.set_grad_enabled(False):
        assert (x * 2).stop_gradient
    assert not (x * 2).stop_gradient


def test_stft_round_trips_through_istft():
    """(Each leg is held to the JAX one in the cases above.)"""
    x = tp.to_tensor(CLIP)
    spec = tp.signal.stft(x, 64, 16, window=tp.to_tensor(WIN))
    back = tp.signal.istft(spec, 64, 16, window=tp.to_tensor(WIN), length=400)
    np.testing.assert_allclose(back.numpy()[:, :384], CLIP[:, :384], atol=1e-5)


@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay"])
def test_regularizers_set_the_optimizers_decay_as_jax(decay):
    assert tp.regularizer.__all__ == jp.regularizer.__all__
    for P_ in (tp, jp):
        w = P_.to_tensor(A, stop_gradient=False)
        opt = P_.optimizer.Momentum(parameters=[w], weight_decay=getattr(P_.regularizer,
                                                                           decay)(0.25))
        assert opt._weight_decay == 0.25


def test_every_jax_name_of_the_slice_exists_in_the_port():
    """nn.functional, nn's classes, nn.initializer, nn.utils, ops.extras,
    fft, signal, regularizer, and the top-level ParamAttr: no exception."""
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.ops import extras

    pairs = [(jp.nn.functional, tp.nn.functional, JF.__all__),
             (jp.nn, tp.nn, [n for n in dir(jp.nn) if n[:1].isupper()]),
             (jp.nn.initializer, tp.nn.initializer, jp.nn.initializer.__all__),
             (jp.nn.utils, tp.nn.utils, jp.nn.utils.__all__),
             (extras, tp.ops.extras, extras.__all__),
             (jp.fft, tp.fft, jp.fft.__all__), (jp.signal, tp.signal, jp.signal.__all__),
             (jp.regularizer, tp.regularizer, jp.regularizer.__all__),
             (jp, tp, ["ParamAttr", "create_parameter", "fft", "signal", "regularizer"])]
    missing = [f"{jm.__name__}.{n}" for jm, tm, names in pairs for n in names
               if not hasattr(tm, n)]
    assert missing == []
