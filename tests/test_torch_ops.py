"""The op namespace of paddle_tpu_torch against paddle_tpu's (CPU).

Every name of the ported op modules' ``__all__`` (``creation``, ``math``,
``manipulation``, ``reduction``, ``logic``, ``search``, ``random``,
``linalg``; ``extras`` is held in ``test_torch_extras_fft_signal.py``)
runs on the same numpy inputs made from a seed through both packages.
Tolerances:

- integer and bool results, and every dtype and shape: exact;
- fp32 results: rtol 1e-6, with an atol of 1e-6 of the reference's largest
  magnitude (values that cancel to near zero);
- where XLA and torch compute an fp32 value by other algorithms (special
  functions, LAPACK decompositions, reductions in another order) the case
  states its own limit: ``SPECIAL`` (1e-5 relative) for the special and
  transcendental functions, ``LINALG`` (1e-4) for the decompositions and
  solves; decompositions defined up to a sign or a basis are compared by
  what is unique (the product they reconstruct, the singular values);
- random ops draw from torch's generator, not JAX's: the shape and dtype
  are exact and the values are held to the distribution's support and, on
  20,000 draws, its mean.

The in-place variants are held to their base ops, and the Tensor's
installed methods and dunders to the set the JAX package installs from the
same modules.
"""

import functools
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import ops as tp_ops
from paddle_tpu_torch.framework import device as tp_device

RTOL = 1e-6
SPECIAL = 1e-5
LINALG = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


rng = np.random.default_rng(16)
A = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)        # positive
B = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
S = rng.standard_normal((3, 4)).astype(np.float32)          # signed
U = rng.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)       # inside (-1, 1)
I = rng.integers(-6, 7, (3, 4)).astype(np.int32)
J = rng.integers(1, 7, (3, 4)).astype(np.int32)
V = rng.standard_normal(4).astype(np.float32)
W = rng.standard_normal(4).astype(np.float32)
Q = rng.standard_normal((4, 4)).astype(np.float32)
M = (Q @ Q.T + 4 * np.eye(4)).astype(np.float32)            # symmetric positive definite
LOWR = (rng.standard_normal((8, 2)) @ rng.standard_normal((2, 6))).astype(np.float32)
B3 = rng.standard_normal((2, 3, 4)).astype(np.float32)
C3 = rng.standard_normal((2, 4, 5)).astype(np.float32)
X3 = rng.standard_normal((4, 3)).astype(np.float32)         # a 3-vector a row
Y3 = rng.standard_normal((4, 3)).astype(np.float32)
NANINF = np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.0]], np.float32)
BOOL = rng.integers(0, 2, (3, 4)).astype(bool)
BOOL2 = rng.integers(0, 2, (3, 4)).astype(bool)
COUNTS = rng.integers(0, 5, 10).astype(np.int32)
DUPS = np.array([3, 1, 1, 2, 2, 2, 3, 1], np.int32)
SEQ = np.array([1.0, 3.0, 5.0, 7.0], np.float32)


def T(P, a, **kw):
    return P.to_tensor(a, **kw)


def _np(x):
    """(array, dtype name, shape) of a Tensor of either package."""
    if isinstance(x, tp.Tensor):
        return x.numpy(), str(x.dtype).replace("torch.", ""), tuple(x.shape)
    arr = np.asarray(x._data)
    name = np.dtype(arr.dtype).name
    if name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, name, tuple(arr.shape)


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
    """name -> the flat outputs of ``cases[name](paddle_tpu)``.  The cases
    that trace run as ONE jitted program (one XLA compile, where eager
    dispatch compiles every op apart: the same ops, many times faster), a
    random draw there taking its key from ``rng_guard`` (never from the
    framework's generator); the rest (host-side ops, ops that read data on
    the host) run eagerly."""
    import jax
    from paddle_tpu.framework.random import rng_guard

    statics = {}

    def leaves(name, fn):
        with rng_guard(jax.random.key(3)):
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
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), f"{what}: {len(g)} outputs against {len(w)}"
    for k, (a, b) in enumerate(zip(g, w)):
        if not hasattr(b, "_data"):
            assert a == b, f"{what}[{k}]: {a} != {b}"
            continue
        ga, gd, gs = _np(a)
        wa, wd, ws = _np(b)
        assert gd == wd, f"{what}[{k}]: dtype {gd} != {wd}"
        assert gs == ws, f"{what}[{k}]: shape {gs} != {ws}"
        if wa.dtype.kind in "biu":
            np.testing.assert_array_equal(ga, wa, err_msg=f"{what}[{k}]")
        else:
            scale = float(np.nanmax(np.abs(wa))) if wa.size and np.isfinite(wa).any() else 1.0
            np.testing.assert_allclose(ga, wa, rtol=rtol, atol=rtol * max(scale, 1e-30),
                                       equal_nan=True, err_msg=f"{what}[{k}]")


# name -> (fn(P), rtol); fn runs the op through package P on the inputs above
CASES = {
    # ---- creation
    "to_tensor": (lambda P: T(P, S), RTOL),
    "zeros": (lambda P: P.zeros([2, 3]), RTOL),
    "ones": (lambda P: P.ones([2, 3], dtype="int32"), RTOL),
    "full": (lambda P: P.full([2], 7.0), RTOL),
    "empty": (lambda P: P.empty([2, 3]), RTOL),
    "zeros_like": (lambda P: P.zeros_like(T(P, I)), RTOL),
    "ones_like": (lambda P: P.ones_like(T(P, A)), RTOL),
    "full_like": (lambda P: P.full_like(T(P, A), 2.5), RTOL),
    "empty_like": (lambda P: P.empty_like(T(P, A)), RTOL),
    "arange": (lambda P: [P.arange(0, 10, 2), P.arange(0.0, 1.0, 0.25), P.arange(5)], RTOL),
    "linspace": (lambda P: P.linspace(0, 1, 5), RTOL),
    "logspace": (lambda P: P.logspace(0, 2, 3), SPECIAL),
    "eye": (lambda P: [P.eye(3), P.eye(3, 4)], RTOL),
    "tril": (lambda P: P.tril(T(P, S)), RTOL),
    "triu": (lambda P: P.triu(T(P, S), 1), RTOL),
    "meshgrid": (lambda P: P.meshgrid(T(P, V), T(P, SEQ[:3])), RTOL),
    "diag": (lambda P: [P.diag(T(P, V)), P.diag(T(P, V), offset=1), P.diag(T(P, Q)),
                        P.diag(T(P, V), padding_value=2.0)], RTOL),
    "diagflat": (lambda P: P.diagflat(T(P, S[:2, :2]), offset=-1), RTOL),
    "assign": (lambda P: P.assign(T(P, S)), RTOL),
    "clone": (lambda P: P.clone(T(P, S)), RTOL),
    "complex": (lambda P: P.real(P.complex(T(P, A), T(P, B))), RTOL),
    "polar": (lambda P: P.imag(P.polar(T(P, A), T(P, S))), SPECIAL),
    "tril_indices": (lambda P: P.tril_indices(4, 4, 0), RTOL),
    "triu_indices": (lambda P: P.triu_indices(4, 5, 1), RTOL),
    "one_hot": (lambda P: P.one_hot(T(P, np.array([0, 2, 4, 1], np.int32)), 5), RTOL),
    # ---- math
    "add": (lambda P: [P.add(T(P, A), T(P, B)), P.add(T(P, I), 2.5), P.add(T(P, I), T(P, J))],
            RTOL),
    "subtract": (lambda P: [P.subtract(T(P, A), T(P, B)), P.subtract(3, T(P, I))], RTOL),
    "multiply": (lambda P: [P.multiply(T(P, S), T(P, B)), P.multiply(T(P, I), 2)], RTOL),
    "divide": (lambda P: [P.divide(T(P, S), T(P, B)), P.divide(T(P, I), T(P, J))], RTOL),
    "floor_divide": (lambda P: [P.floor_divide(T(P, I), T(P, J)),
                                P.floor_divide(T(P, S), T(P, B))], RTOL),
    "remainder": (lambda P: [P.remainder(T(P, I), T(P, J)), P.remainder(T(P, S), T(P, B))],
                  RTOL),
    "mod": (lambda P: P.mod(T(P, I), T(P, J)), RTOL),
    "pow": (lambda P: [P.pow(T(P, A), T(P, B)), P.pow(T(P, S), 2), P.pow(T(P, J), 2)], SPECIAL),
    "float_power": (lambda P: P.float_power(T(P, A), 3.0), SPECIAL),
    "sqrt": (lambda P: P.sqrt(T(P, A)), RTOL),
    "rsqrt": (lambda P: P.rsqrt(T(P, A)), SPECIAL),
    "exp": (lambda P: P.exp(T(P, S)), SPECIAL),
    "expm1": (lambda P: P.expm1(T(P, S)), SPECIAL),
    "log": (lambda P: P.log(T(P, A)), SPECIAL),
    "log2": (lambda P: P.log2(T(P, A)), SPECIAL),
    "log10": (lambda P: P.log10(T(P, A)), SPECIAL),
    "log1p": (lambda P: P.log1p(T(P, A)), SPECIAL),
    "abs": (lambda P: [P.abs(T(P, S)), P.abs(T(P, I))], RTOL),
    "neg": (lambda P: [P.neg(T(P, S)), P.neg(T(P, I))], RTOL),
    "sign": (lambda P: P.sign(T(P, S)), RTOL),
    "floor": (lambda P: P.floor(T(P, 3 * S)), RTOL),
    "ceil": (lambda P: P.ceil(T(P, 3 * S)), RTOL),
    "round": (lambda P: [P.round(T(P, 3 * S)), P.round(T(P, np.array([0.5, 1.5, 2.5, -0.5],
                                                                      np.float32)))], RTOL),
    "trunc": (lambda P: P.trunc(T(P, 3 * S)), RTOL),
    "frac": (lambda P: P.frac(T(P, 3 * S)), SPECIAL),
    "sin": (lambda P: P.sin(T(P, S)), SPECIAL),
    "cos": (lambda P: P.cos(T(P, S)), SPECIAL),
    "tan": (lambda P: P.tan(T(P, U)), SPECIAL),
    "asin": (lambda P: P.asin(T(P, U)), SPECIAL),
    "acos": (lambda P: P.acos(T(P, U)), SPECIAL),
    "atan": (lambda P: P.atan(T(P, S)), SPECIAL),
    "sinh": (lambda P: P.sinh(T(P, S)), SPECIAL),
    "cosh": (lambda P: P.cosh(T(P, S)), SPECIAL),
    "tanh": (lambda P: P.tanh(T(P, S)), SPECIAL),
    "asinh": (lambda P: P.asinh(T(P, S)), SPECIAL),
    "acosh": (lambda P: P.acosh(T(P, A + 1)), SPECIAL),
    "atanh": (lambda P: P.atanh(T(P, U)), SPECIAL),
    "atan2": (lambda P: P.atan2(T(P, S), T(P, B)), SPECIAL),
    "hypot": (lambda P: P.hypot(T(P, S), T(P, B)), SPECIAL),
    "deg2rad": (lambda P: P.deg2rad(T(P, S)), RTOL),
    "rad2deg": (lambda P: P.rad2deg(T(P, S)), RTOL),
    "reciprocal": (lambda P: P.reciprocal(T(P, A)), RTOL),
    "square": (lambda P: [P.square(T(P, S)), P.square(T(P, I))], RTOL),
    "maximum": (lambda P: P.maximum(T(P, S), T(P, U)), RTOL),
    "minimum": (lambda P: P.minimum(T(P, I), T(P, J)), RTOL),
    "fmax": (lambda P: P.fmax(T(P, NANINF), T(P, np.zeros((2, 3), np.float32))), RTOL),
    "fmin": (lambda P: P.fmin(T(P, NANINF), T(P, np.zeros((2, 3), np.float32))), RTOL),
    "clip": (lambda P: [P.clip(T(P, S), -0.5, 0.5), P.clip(T(P, S), min=0.0)], RTOL),
    "scale": (lambda P: [P.scale(T(P, S), 2.0, 1.0),
                         P.scale(T(P, S), 2.0, 1.0, bias_after_scale=False)], RTOL),
    "lerp": (lambda P: [P.lerp(T(P, A), T(P, B), 0.3), P.lerp(T(P, A), T(P, B), T(P, U))], RTOL),
    "erf": (lambda P: P.erf(T(P, S)), SPECIAL),
    "erfinv": (lambda P: P.erfinv(T(P, U)), SPECIAL),
    "logit": (lambda P: [P.logit(T(P, A / 2)), P.logit(T(P, A / 2), eps=0.3)], SPECIAL),
    "stanh": (lambda P: P.stanh(T(P, S)), SPECIAL),
    "multiplex": (lambda P: P.multiplex([T(P, A), T(P, B)],
                                        T(P, np.array([[0], [1], [0]], np.int32))), RTOL),
    "isnan": (lambda P: P.isnan(T(P, NANINF)), RTOL),
    "isinf": (lambda P: P.isinf(T(P, NANINF)), RTOL),
    "isfinite": (lambda P: P.isfinite(T(P, NANINF)), RTOL),
    "nan_to_num": (lambda P: [P.nan_to_num(T(P, NANINF)),
                              P.nan_to_num(T(P, NANINF), nan=1.0, posinf=9.0, neginf=-9.0)],
                   RTOL),
    "cumsum": (lambda P: [P.cumsum(T(P, S), axis=1), P.cumsum(T(P, S)), P.cumsum(T(P, I), 0)],
               SPECIAL),
    "cumprod": (lambda P: [P.cumprod(T(P, A), dim=1), P.cumprod(T(P, J), dim=0)], SPECIAL),
    "cummax": (lambda P: [P.cummax(T(P, S), axis=1), P.cummax(T(P, I))], RTOL),
    "cummin": (lambda P: [P.cummin(T(P, S), axis=0), P.cummin(T(P, I), axis=1)], RTOL),
    "add_n": (lambda P: P.add_n([T(P, A), T(P, B), T(P, S)]), RTOL),
    "logaddexp": (lambda P: P.logaddexp(T(P, S), T(P, U)), SPECIAL),
    "logsumexp": (lambda P: [P.logsumexp(T(P, S), axis=1), P.logsumexp(T(P, S)),
                             P.logsumexp(T(P, S), axis=0, keepdim=True)], SPECIAL),
    "trace": (lambda P: [P.trace(T(P, Q)), P.trace(T(P, Q), offset=1)], SPECIAL),
    "diagonal": (lambda P: [P.diagonal(T(P, Q)), P.diagonal(T(P, B3), 0, 1, 2)], RTOL),
    "kron": (lambda P: P.kron(T(P, S[:2, :2]), T(P, A[:2, :3])), RTOL),
    "inner": (lambda P: P.inner(T(P, S), T(P, A)), SPECIAL),
    "outer": (lambda P: P.outer(T(P, V), T(P, W)), RTOL),
    "heaviside": (lambda P: P.heaviside(T(P, np.array([-1.0, 0.0, 2.0], np.float32)),
                                        T(P, np.array([0.5, 0.5, 0.5], np.float32))), RTOL),
    "gcd": (lambda P: P.gcd(T(P, I), T(P, J)), RTOL),
    "lcm": (lambda P: P.lcm(T(P, I), T(P, J)), RTOL),
    "digamma": (lambda P: P.digamma(T(P, A)), SPECIAL),
    "lgamma": (lambda P: P.lgamma(T(P, A + 1)), SPECIAL),
    "polygamma": (lambda P: P.polygamma(T(P, A), 1), SPECIAL),
    "i0": (lambda P: P.i0(T(P, S)), SPECIAL),
    "i1": (lambda P: P.i1(T(P, S)), SPECIAL),
    "angle": (lambda P: P.angle(T(P, S)), RTOL),
    "conj": (lambda P: P.conj(T(P, S)), RTOL),
    "real": (lambda P: P.real(T(P, S)), RTOL),
    "imag": (lambda P: P.imag(T(P, S)), RTOL),
    "sgn": (lambda P: P.sgn(T(P, S)), RTOL),
    "ldexp": (lambda P: P.ldexp(T(P, S), T(P, J)), RTOL),
    "copysign": (lambda P: P.copysign(T(P, A), T(P, S)), RTOL),
    "nextafter": (lambda P: P.nextafter(T(P, A), T(P, B)), RTOL),
    "renorm": (lambda P: P.renorm(T(P, S), 2.0, 0, 1.0), SPECIAL),
    "diff": (lambda P: [P.diff(T(P, S)), P.diff(T(P, S), axis=0),
                        P.diff(T(P, S), prepend=T(P, A[:, :1]))], RTOL),
    "signbit": (lambda P: P.signbit(T(P, S)), RTOL),
    # ---- manipulation
    "reshape": (lambda P: [P.reshape(T(P, B3), [6, 4]), P.reshape(T(P, B3), [-1])], RTOL),
    "reshape_": (lambda P: P.reshape_(T(P, B3), [4, -1]), RTOL),
    "transpose": (lambda P: P.transpose(T(P, B3), [2, 0, 1]), RTOL),
    "flatten": (lambda P: [P.flatten(T(P, B3), 1), P.flatten(T(P, B3))], RTOL),
    "squeeze": (lambda P: [P.squeeze(T(P, S[None, :, None])), P.squeeze(T(P, S[None]), 0),
                           P.squeeze(T(P, S), 0)], RTOL),
    "unsqueeze": (lambda P: [P.unsqueeze(T(P, S), 0), P.unsqueeze(T(P, S), [0, -1])], RTOL),
    "concat": (lambda P: P.concat([T(P, A), T(P, B)], axis=1), RTOL),
    "stack": (lambda P: P.stack([T(P, A), T(P, B)], axis=1), RTOL),
    "split": (lambda P: [P.split(T(P, B3), 2, axis=2), P.split(T(P, B3), [1, -1], axis=1)],
              RTOL),
    "tensor_split": (lambda P: [P.tensor_split(T(P, S), 3, axis=1),
                                P.tensor_split(T(P, S), [1, 3], axis=1)], RTOL),
    "chunk": (lambda P: P.chunk(T(P, S), 2, axis=1), RTOL),
    "tile": (lambda P: P.tile(T(P, S), [2, 1]), RTOL),
    "expand": (lambda P: P.expand(T(P, V[None]), [3, -1]), RTOL),
    "expand_as": (lambda P: P.expand_as(T(P, V[None]), T(P, S)), RTOL),
    "broadcast_to": (lambda P: P.broadcast_to(T(P, V), [2, 4]), RTOL),
    "broadcast_tensors": (lambda P: P.broadcast_tensors([T(P, V[None]), T(P, A[:, :1])]), RTOL),
    "flip": (lambda P: [P.flip(T(P, S), 0), P.flip(T(P, B3), [1, 2])], RTOL),
    "rot90": (lambda P: [P.rot90(T(P, S)), P.rot90(T(P, S), 2)], RTOL),
    "roll": (lambda P: [P.roll(T(P, S), 1, axis=1), P.roll(T(P, S), 2)], RTOL),
    "gather": (lambda P: P.gather(T(P, S), T(P, np.array([2, 0], np.int32)), axis=0), RTOL),
    "gather_nd": (lambda P: P.gather_nd(T(P, S), T(P, np.array([[0, 1], [2, 3]], np.int32))),
                  RTOL),
    "scatter": (lambda P: [P.scatter(T(P, S), T(P, np.array([1], np.int32)), T(P, A[:1])),
                           P.scatter(T(P, S), T(P, np.array([1, 1], np.int32)), T(P, A[:2]),
                                     overwrite=False)], RTOL),
    "scatter_": (lambda P: P.scatter_(T(P, S), T(P, np.array([2], np.int32)), T(P, B[:1])),
                 RTOL),
    "scatter_nd": (lambda P: P.scatter_nd(T(P, np.array([[1], [3], [1]], np.int32)),
                                          T(P, V[:3]), [5]), RTOL),
    "scatter_nd_add": (lambda P: P.scatter_nd_add(T(P, S), T(P, np.array([[0, 1], [0, 1]],
                                                                          np.int32)),
                                                  T(P, V[:2])), RTOL),
    "index_select": (lambda P: P.index_select(T(P, S), T(P, np.array([3, 0], np.int32)),
                                              axis=1), RTOL),
    "index_add": (lambda P: P.index_add(T(P, S), T(P, np.array([0, 2, 0], np.int32)), 0,
                                        T(P, A)), RTOL),
    "index_put": (lambda P: [P.index_put(T(P, S), (T(P, np.array([0, 2], np.int32)),),
                                         T(P, A[:2])),
                             P.index_put(T(P, S), (T(P, np.array([0, 0], np.int32)),
                                                   T(P, np.array([1, 1], np.int32))),
                                         T(P, V[:2]), accumulate=True)], RTOL),
    "masked_select": (lambda P: P.masked_select(T(P, S), T(P, BOOL)), RTOL),
    "masked_fill": (lambda P: [P.masked_fill(T(P, S), T(P, BOOL), 9.0),
                               P.masked_fill(T(P, I), T(P, BOOL), -1)], RTOL),
    "masked_scatter": (lambda P: P.masked_scatter(T(P, S), T(P, BOOL), T(P, B)), RTOL),
    "where": (lambda P: [P.where(T(P, BOOL), T(P, S), T(P, A)), P.where(T(P, BOOL), T(P, S), 0.0),
                         P.where(T(P, BOOL), 1.0, T(P, A)), P.where(T(P, BOOL))], RTOL),
    "take_along_axis": (lambda P: P.take_along_axis(
        T(P, S), T(P, np.array([[0], [3], [1]], np.int32)), axis=1), RTOL),
    "put_along_axis": (lambda P: [
        P.put_along_axis(T(P, S), T(P, np.array([[0], [3], [1]], np.int32)),
                         T(P, np.array([[7.0], [8.0], [9.0]], np.float32)), axis=1),
        P.put_along_axis(T(P, S), T(P, np.array([[0, 0], [3, 1], [1, 1]], np.int32)),
                         T(P, np.ones((3, 2), np.float32)), axis=1, reduce="add")], RTOL),
    "slice": (lambda P: P.slice(T(P, B3), [1, 2], [1, -3], [3, 10]), RTOL),
    "strided_slice": (lambda P: P.strided_slice(T(P, B3), [2], [0], [4], [2]), RTOL),
    "crop": (lambda P: P.crop(T(P, S), [2, 2], [1, 1]), RTOL),
    "pad": (lambda P: [P.pad(T(P, B3), [1, 2]), P.pad(T(P, B3), [1, 0, 0, 2, 1, 1]),
                       P.pad(T(P, B3[None]), [1, 1], mode="reflect"),
                       P.pad(T(P, B3[None]), [1, 1, 2, 0], mode="replicate"),
                       P.pad(T(P, B3[None]), [1, 2], mode="circular")], RTOL),
    "unstack": (lambda P: P.unstack(T(P, B3), axis=1), RTOL),
    "unbind": (lambda P: P.unbind(T(P, S), 0), RTOL),
    "repeat_interleave": (lambda P: [P.repeat_interleave(T(P, S), 2, axis=1),
                                     P.repeat_interleave(T(P, V), T(P, np.array([1, 0, 2, 3],
                                                                               np.int32)), 0)],
                          RTOL),
    "cast": (lambda P: [P.cast(T(P, S), "int32"), P.cast(T(P, I), "float32"),
                        P.cast(T(P, S), "bfloat16")], RTOL),
    "moveaxis": (lambda P: P.moveaxis(T(P, B3), 0, 2), RTOL),
    "swapaxes": (lambda P: P.swapaxes(T(P, B3), 0, 2), RTOL),
    "unique": (lambda P: [P.unique(T(P, DUPS)),
                          P.unique(T(P, DUPS), return_index=True, return_inverse=True,
                                   return_counts=True)], RTOL),
    "unique_consecutive": (lambda P: P.unique_consecutive(T(P, DUPS), return_inverse=True,
                                                          return_counts=True), RTOL),
    "nonzero": (lambda P: [P.nonzero(T(P, BOOL)), P.nonzero(T(P, BOOL), as_tuple=True)], RTOL),
    "as_complex": (lambda P: P.imag(P.as_complex(T(P, S[:, :2]))), RTOL),
    "as_real": (lambda P: P.as_real(P.complex(T(P, A), T(P, B))), RTOL),
    "view": (lambda P: [P.view(T(P, S), [4, 3]), P.view(T(P, S), "int32")], RTOL),
    "view_as": (lambda P: P.view_as(T(P, S), T(P, Q[:, :3])), RTOL),
    "unfold": (lambda P: P.unfold(T(P, B3), 2, 2, 1), RTOL),
    "as_strided": (lambda P: [P.as_strided(T(P, S), [2, 3], [3, 1], 1),
                              P.as_strided(T(P, S), [3], [-2], 6)], RTOL),
    "flatten_": (lambda P: P.flatten_(T(P, B3), 0, 1), RTOL),
    "squeeze_": (lambda P: P.squeeze_(T(P, S[None])), RTOL),
    "unsqueeze_": (lambda P: P.unsqueeze_(T(P, S), 1), RTOL),
    "unflatten": (lambda P: P.unflatten(T(P, S), 1, [2, 2]), RTOL),
    "atleast_1d": (lambda P: [P.atleast_1d(T(P, np.float32(2.0))), P.atleast_1d(T(P, S))], RTOL),
    "atleast_2d": (lambda P: P.atleast_2d(T(P, V)), RTOL),
    "atleast_3d": (lambda P: [P.atleast_3d(T(P, V)), P.atleast_3d(T(P, S))], RTOL),
    "diag_embed": (lambda P: [P.diag_embed(T(P, S)), P.diag_embed(T(P, S), offset=1)], RTOL),
    "index_fill": (lambda P: P.index_fill(T(P, S), T(P, np.array([0, 2], np.int32)), 1, -1.0),
                   RTOL),
    "select_scatter": (lambda P: P.select_scatter(T(P, S), T(P, V), 0, 1), RTOL),
    # ---- reduction
    "sum": (lambda P: [P.sum(T(P, S)), P.sum(T(P, S), axis=1), P.sum(T(P, I), axis=0),
                       P.sum(T(P, BOOL)), P.sum(T(P, S), axis=[0, 1], keepdim=True)], SPECIAL),
    "nansum": (lambda P: P.nansum(T(P, NANINF[:, :1].repeat(3, 1))), RTOL),
    "mean": (lambda P: [P.mean(T(P, S)), P.mean(T(P, S), axis=0, keepdim=True)], SPECIAL),
    "nanmean": (lambda P: P.nanmean(T(P, np.where(BOOL, np.nan, S).astype(np.float32)), axis=1),
                SPECIAL),
    "max": (lambda P: [P.max(T(P, S)), P.max(T(P, S), axis=1), P.max(T(P, I), axis=0,
                                                                     keepdim=True)], RTOL),
    "min": (lambda P: [P.min(T(P, S)), P.min(T(P, S), axis=[0, 1])], RTOL),
    "amax": (lambda P: P.amax(T(P, S), axis=0), RTOL),
    "amin": (lambda P: P.amin(T(P, S), axis=1), RTOL),
    "prod": (lambda P: [P.prod(T(P, A)), P.prod(T(P, A), axis=0), P.prod(T(P, J), axis=1)],
             SPECIAL),
    "all": (lambda P: [P.all(T(P, BOOL)), P.all(T(P, BOOL), axis=1)], RTOL),
    "any": (lambda P: [P.any(T(P, BOOL)), P.any(T(P, BOOL), axis=0, keepdim=True)], RTOL),
    "std": (lambda P: [P.std(T(P, S)), P.std(T(P, S), axis=1, unbiased=False)], SPECIAL),
    "var": (lambda P: [P.var(T(P, S)), P.var(T(P, S), axis=0, keepdim=True)], SPECIAL),
    "median": (lambda P: [P.median(T(P, S)), P.median(T(P, S), axis=1),
                          P.median(T(P, S), axis=1, mode="min")], RTOL),
    "nanmedian": (lambda P: P.nanmedian(T(P, np.where(BOOL, np.nan, S).astype(np.float32)),
                                        axis=0), RTOL),
    "quantile": (lambda P: [P.quantile(T(P, S), 0.3), P.quantile(T(P, S), [0.25, 0.5], axis=1),
                            P.quantile(T(P, S), 0.5, axis=[0, 1], keepdim=True)], SPECIAL),
    "nanquantile": (lambda P: P.nanquantile(T(P, np.where(BOOL, np.nan, S).astype(np.float32)),
                                            0.5, axis=1), SPECIAL),
    "count_nonzero": (lambda P: [P.count_nonzero(T(P, I)), P.count_nonzero(T(P, I), axis=1)],
                      RTOL),
    "bincount": (lambda P: [P.bincount(T(P, COUNTS)), P.bincount(T(P, COUNTS), minlength=7)],
                 RTOL),
    "histogram": (lambda P: P.histogram(T(P, S), bins=5), RTOL),
    "histogramdd": (lambda P: P.histogramdd(T(P, S[:, :2]), bins=3), RTOL),
    "numel": (lambda P: P.numel(T(P, S)), RTOL),
    # ---- logic
    "equal": (lambda P: [P.equal(T(P, I), T(P, J)), P.equal(T(P, I), 2)], RTOL),
    "not_equal": (lambda P: P.not_equal(T(P, I), T(P, J)), RTOL),
    "greater_than": (lambda P: P.greater_than(T(P, S), T(P, U)), RTOL),
    "greater_equal": (lambda P: P.greater_equal(T(P, I), 0), RTOL),
    "less_than": (lambda P: P.less_than(T(P, S), 0.0), RTOL),
    "less_equal": (lambda P: P.less_equal(T(P, I), T(P, J)), RTOL),
    "logical_and": (lambda P: P.logical_and(T(P, BOOL), T(P, BOOL2)), RTOL),
    "logical_or": (lambda P: P.logical_or(T(P, BOOL), T(P, BOOL2)), RTOL),
    "logical_not": (lambda P: P.logical_not(T(P, BOOL)), RTOL),
    "logical_xor": (lambda P: P.logical_xor(T(P, BOOL), T(P, BOOL2)), RTOL),
    "bitwise_and": (lambda P: P.bitwise_and(T(P, I), T(P, J)), RTOL),
    "bitwise_or": (lambda P: P.bitwise_or(T(P, I), T(P, J)), RTOL),
    "bitwise_not": (lambda P: [P.bitwise_not(T(P, I)), P.bitwise_not(T(P, BOOL))], RTOL),
    "bitwise_xor": (lambda P: P.bitwise_xor(T(P, I), T(P, J)), RTOL),
    "bitwise_left_shift": (lambda P: P.bitwise_left_shift(T(P, J), T(P, J)), RTOL),
    "bitwise_right_shift": (lambda P: P.bitwise_right_shift(T(P, I * 16), T(P, J)), RTOL),
    "isclose": (lambda P: P.isclose(T(P, A), T(P, A + 1e-6)), RTOL),
    "allclose": (lambda P: [P.allclose(T(P, A), T(P, A)), P.allclose(T(P, A), T(P, B))], RTOL),
    "equal_all": (lambda P: [P.equal_all(T(P, I), T(P, I)), P.equal_all(T(P, I), T(P, J))],
                  RTOL),
    "is_empty": (lambda P: [P.is_empty(T(P, S)), P.is_empty(P.zeros([0, 2]))], RTOL),
    "is_tensor": (lambda P: [P.is_tensor(T(P, S)), P.is_tensor(S)], RTOL),
    # ---- search
    "argmax": (lambda P: [P.argmax(T(P, S)), P.argmax(T(P, S), axis=1),
                          P.argmax(T(P, S), axis=0, keepdim=True)], RTOL),
    "argmin": (lambda P: [P.argmin(T(P, S)), P.argmin(T(P, I), axis=1)], RTOL),
    "argsort": (lambda P: [P.argsort(T(P, S), axis=1), P.argsort(T(P, S), axis=0,
                                                                 descending=True)], RTOL),
    "sort": (lambda P: [P.sort(T(P, S), axis=1), P.sort(T(P, I), descending=True)], RTOL),
    "topk": (lambda P: [P.topk(T(P, S), 2), P.topk(T(P, S), 2, axis=0, largest=False)], RTOL),
    "searchsorted": (lambda P: [P.searchsorted(T(P, SEQ), T(P, np.array([2.0, 5.0, 9.0],
                                                                        np.float32))),
                                P.searchsorted(T(P, SEQ), T(P, np.array([3.0, 5.0], np.float32)),
                                               right=True)], RTOL),
    "bucketize": (lambda P: P.bucketize(T(P, S), T(P, np.array([-1.0, 0.0, 1.0], np.float32))),
                  RTOL),
    "kthvalue": (lambda P: [P.kthvalue(T(P, S), 2), P.kthvalue(T(P, S), 1, axis=0,
                                                               keepdim=True)], RTOL),
    "mode": (lambda P: P.mode(T(P, np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.int32))), RTOL),
    "index_sample": (lambda P: P.index_sample(T(P, S), T(P, np.array([[0, 1], [3, 3], [2, 0]],
                                                                     np.int32))), RTOL),
    # ---- linalg
    "matmul": (lambda P: [P.matmul(T(P, S), T(P, Q)), P.matmul(T(P, S), T(P, A),
                                                               transpose_y=True),
                          P.matmul(T(P, B3), T(P, C3))], SPECIAL),
    "dot": (lambda P: P.dot(T(P, S), T(P, A)), SPECIAL),
    "bmm": (lambda P: P.bmm(T(P, B3), T(P, C3)), SPECIAL),
    "mv": (lambda P: P.mv(T(P, S), T(P, V)), SPECIAL),
    "t": (lambda P: P.t(T(P, S)), RTOL),
    "norm": (lambda P: [P.norm(T(P, S)), P.norm(T(P, S), p=1, axis=1),
                        P.norm(T(P, S), p=float("inf"), axis=0),
                        P.norm(T(P, S), p="fro", axis=[0, 1]), P.norm(T(P, Q), p="nuc"),
                        P.norm(T(P, S), p=3, axis=1, keepdim=True)], LINALG),
    "vector_norm": (lambda P: P.vector_norm(T(P, S), 2.0, axis=1), SPECIAL),
    "matrix_norm": (lambda P: [P.matrix_norm(T(P, S)), P.matrix_norm(T(P, Q), p=1)], SPECIAL),
    "dist": (lambda P: [P.dist(T(P, A), T(P, B)), P.dist(T(P, A), T(P, B), p=1)], SPECIAL),
    "cholesky": (lambda P: [P.cholesky(T(P, M)), P.cholesky(T(P, M), upper=True)], LINALG),
    "cholesky_solve": (lambda P: P.cholesky_solve(T(P, S.T[:4, :2]), P.cholesky(T(P, M))),
                       LINALG),
    "qr": (lambda P: P.matmul(*P.qr(T(P, Q))), LINALG),
    "svd": (lambda P: [P.svd(T(P, S))[1]], LINALG),
    "svdvals": (lambda P: P.svdvals(T(P, S)), LINALG),
    "pinv": (lambda P: P.pinv(T(P, S)), LINALG),
    "inv": (lambda P: P.inv(T(P, M)), LINALG),
    "det": (lambda P: P.det(T(P, M)), LINALG),
    "slogdet": (lambda P: P.slogdet(T(P, Q)), LINALG),
    "solve": (lambda P: P.solve(T(P, M), T(P, S.T[:, :2].copy())), LINALG),
    "triangular_solve": (lambda P: [P.triangular_solve(T(P, np.triu(M)), T(P, X3)),
                                    P.triangular_solve(T(P, np.tril(M)), T(P, X3), upper=False,
                                                       transpose=True)], LINALG),
    "eig": (lambda P: P.sort(P.real(P.eig(T(P, M))[0])), LINALG),
    "eigh": (lambda P: P.eigh(T(P, M))[0], LINALG),
    "eigvals": (lambda P: P.sort(P.real(P.eigvals(T(P, M)))), LINALG),
    "eigvalsh": (lambda P: P.eigvalsh(T(P, M)), LINALG),
    "matrix_power": (lambda P: [P.matrix_power(T(P, Q), 3), P.matrix_power(T(P, M), -1)],
                     LINALG),
    "matrix_rank": (lambda P: [P.matrix_rank(T(P, LOWR)), P.matrix_rank(T(P, M))], RTOL),
    "einsum": (lambda P: [P.einsum("ij,jk->ik", T(P, S), T(P, Q)),
                          P.einsum("bij,bjk->bik", T(P, B3), T(P, C3))], SPECIAL),
    "cross": (lambda P: [P.cross(T(P, X3), T(P, Y3)), P.cross(T(P, X3), T(P, Y3), axis=1)],
              SPECIAL),
    "multi_dot": (lambda P: P.multi_dot([T(P, S), T(P, Q), T(P, W[:, None])]), SPECIAL),
    "cov": (lambda P: [P.cov(T(P, S)), P.cov(T(P, S), rowvar=False, ddof=False)], SPECIAL),
    "corrcoef": (lambda P: P.corrcoef(T(P, S)), SPECIAL),
    "lu": (lambda P: P.lu(T(P, M)), LINALG),
    "householder_product": (lambda P: P.householder_product(T(P, Q[:, :3]), T(P, A[0, :3])),
                            LINALG),
    "tensordot": (lambda P: [P.tensordot(T(P, B3), T(P, C3), axes=[[2], [1]]),
                             P.tensordot(T(P, S), T(P, S), axes=2)], SPECIAL),
    "cond": (lambda P: [P.cond(T(P, M)), P.cond(T(P, M), p="fro")], LINALG),
    "lstsq": (lambda P: P.lstsq(T(P, X3), T(P, Y3))[0], LINALG),
    "matrix_exp": (lambda P: P.matrix_exp(T(P, Q / 4)), LINALG),
    "cholesky_inverse": (lambda P: P.cholesky_inverse(P.cholesky(T(P, M))), LINALG),
    "lu_unpack": (lambda P: P.lu_unpack(*P.lu(T(P, M))), LINALG),
    "ormqr": (lambda P: P.ormqr(T(P, Q[:, :3]), T(P, A[0, :3]), T(P, S.T.copy())), LINALG),
}

# random ops: fn(P) -> Tensor; (support low, support high, mean) on 20,000 draws
RANDOM = {
    "uniform": (lambda P: P.uniform([20000], min=-2.0, max=2.0), (-2.0, 2.0, 0.0)),
    "uniform_": (lambda P: P.uniform_(P.zeros([20000]), 0.0, 1.0), (0.0, 1.0, 0.5)),
    "normal": (lambda P: P.normal(1.0, 2.0, [20000]), (-math.inf, math.inf, 1.0)),
    "normal_": (lambda P: P.normal_(P.zeros([20000]), -1.0, 1.0), (-math.inf, math.inf, -1.0)),
    "standard_normal": (lambda P: P.standard_normal([20000]), (-math.inf, math.inf, 0.0)),
    "randn": (lambda P: P.randn([20000]), (-math.inf, math.inf, 0.0)),
    "rand": (lambda P: P.rand([20000]), (0.0, 1.0, 0.5)),
    "randint": (lambda P: P.randint(0, 5, [20000]), (0, 4, 2.0)),
    "randint_like": (lambda P: P.randint_like(P.zeros([20000]), 0, 5), (0, 4, 2.0)),
    "randperm": (lambda P: P.randperm(20000), (0, 19999, 9999.5)),
    "bernoulli": (lambda P: P.bernoulli(P.full([20000], 0.3)), (0.0, 1.0, 0.3)),
    "bernoulli_": (lambda P: P.bernoulli_(P.zeros([20000]), 0.25), (0.0, 1.0, 0.25)),
    "multinomial": (lambda P: P.multinomial(P.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)),
                                            20000, replacement=True), (0, 2, 1.3)),
    "poisson": (lambda P: P.poisson(P.full([20000], 3.0)), (0.0, math.inf, 3.0)),
    "exponential_": (lambda P: P.exponential_(P.zeros([20000]), 2.0), (0.0, math.inf, 0.5)),
    "standard_gamma": (lambda P: P.standard_gamma(P.full([20000], 2.5)), (0.0, math.inf, 2.5)),
    "log_normal": (lambda P: P.log_normal(0.0, 0.5, [20000]), (0.0, math.inf,
                                                               math.exp(0.125))),
    "log_normal_": (lambda P: P.log_normal_(P.zeros([20000]), 0.0, 0.25),
                    (0.0, math.inf, math.exp(0.03125))),
    "cauchy_": (lambda P: P.cauchy_(P.zeros([20000])), (-math.inf, math.inf, None)),
    "geometric_": (lambda P: P.geometric_(P.zeros([20000]), 0.5), (1.0, math.inf, 2.0)),
    "binomial": (lambda P: P.binomial(P.full([20000], 10, dtype="int32"), P.full([20000], 0.4)),
                 (0, 10, 4.0)),
    "svd_lowrank": (None, None),
    "pca_lowrank": (None, None),
}


def test_cases_cover_every_name_of_the_ported_modules():
    # extras' names are held in tests/test_torch_extras_fft_signal.py
    names = {n for m in tp_ops.MODULES if m is not tp_ops.extras for n in m.__all__}
    assert names == set(CASES) | set(RANDOM)
    for m in tp_ops.MODULES:
        jm = __import__(f"paddle_tpu.ops.{m.__name__.rsplit('.', 1)[1]}", fromlist=["x"])
        assert m.__all__ == jm.__all__, m.__name__


@pytest.fixture(scope="module")
def ref():
    """Every case's JAX outputs, computed once for the module."""
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    try:
        jp.seed(3)
        cases = {("op", n): fn for n, (fn, _) in CASES.items()}
        cases.update({("inplace", n): functools.partial(_inplace_run, n) for n in INPLACE})
        cases.update({("expr", e): functools.partial(_expr_run, e) for e in EXPRS})
        cases.update({("random", n): fn for n, (fn, _) in RANDOM.items() if fn is not None})
        return jax_reference(cases)
    finally:
        tp.set_device(prev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name, ref):
    fn, rtol = CASES[name]
    tp.seed(0)
    assert_same(fn(tp), ref[("op", name)], rtol=rtol, what=name)


@pytest.mark.parametrize("name", sorted(n for n, (fn, _) in RANDOM.items() if fn is not None))
def test_random_op_matches_jax_in_distribution(name, ref):
    fn, (lo, hi, mean) = RANDOM[name]
    tp.seed(3)
    got, (want,) = fn(tp), ref[("random", name)]
    g, gd, gs = _np(got)
    _, wd, ws = _np(want)
    assert (gd, gs) == (wd, ws)
    assert g.min() >= lo and g.max() <= hi, (g.min(), g.max())
    if mean is not None:
        sd = max(float(g.std()), 1e-3)
        assert abs(float(g.mean()) - mean) < 5 * sd / math.sqrt(g.size), (g.mean(), mean)
    tp.seed(3)
    np.testing.assert_array_equal(_np(fn(tp))[0], g)    # seeded: the same draws again


@pytest.mark.parametrize("name", ["svd_lowrank", "pca_lowrank"])
def test_randomized_lowrank_recovers_the_jax_spectrum(name):
    """A rank-2 matrix: both packages' randomized SVD give its exact
    singular values (their random test matrices differ)."""
    x = LOWR - (LOWR.mean(0, keepdims=True) if name == "pca_lowrank" else 0)
    outs = {}
    for P in (tp, jp):
        P.seed(0)
        u, s, v = getattr(P, name)(T(P, LOWR), q=4)
        outs[P.__name__] = _np(s)
        ua, sa, va = (_np(t)[0] for t in (u, s, v))
        np.testing.assert_allclose(ua[:, :2] @ np.diag(sa[:2]) @ va[:, :2].T, x, atol=1e-4)
    (g, gd, gs), (w, wd, ws) = outs["paddle_tpu_torch"], outs["paddle_tpu"]
    assert (gd, gs) == (wd, ws)
    np.testing.assert_allclose(g[:2], w[:2], rtol=LINALG)


INPLACE = sorted(n for n in tp_ops.__all__ if n.endswith("_") and n not in CASES
                 and n not in RANDOM and n not in tp_ops.extras.__all__
                 and n[:-1] not in tp_ops.extras.INPLACE_BASES)

_INPLACE_ARGS = {
    "cast_": ("int32",), "clip_": (-0.5, 0.5), "scale_": (2.0, 1.0), "lerp_": (B, 0.3),
    "tril_": (), "triu_": (1,), "cumsum_": (1,), "cumprod_": (1,), "polygamma_": (1,),
    "renorm_": (2.0, 0, 1.0), "transpose_": ([1, 0],), "masked_fill_": (BOOL, 2.0),
    "masked_scatter_": (BOOL, B), "index_add_": (np.array([0, 2], np.int32), 0, B[:2]),
    "index_fill_": (np.array([1], np.int32), 1, 0.0),
    "index_put_": ((np.array([0, 1], np.int32),), B[:2]), "nan_to_num_": (),
    "logit_": (), "ldexp_": (J,),
}
_INT_INPLACE = {"gcd_", "lcm_", "bitwise_and_", "bitwise_or_", "bitwise_not_", "bitwise_xor_",
                "bitwise_left_shift_", "bitwise_right_shift_", "floor_divide_", "remainder_",
                "mod_"}
_BOOL_INPLACE = {"logical_and_", "logical_or_", "logical_not_", "logical_xor_"}


def _inplace_run(name, P):
    """``P.op_(x, ...)`` on a fresh Tensor; asserts it returns the same object."""
    base = name[:-1]
    if name in _INT_INPLACE:
        x, args = J, (J,) if base != "bitwise_not" else ()
    elif name in _BOOL_INPLACE:
        x, args = BOOL, (BOOL2,) if base != "logical_not" else ()
    else:
        x = A / 2 if base in ("logit", "erfinv", "asin", "acos", "atanh") else A
        one_arg = base in ("add", "subtract", "multiply", "divide", "pow", "hypot", "copysign",
                           "equal", "greater_equal", "greater_than", "less_equal", "less_than",
                           "not_equal")
        args = _INPLACE_ARGS.get(name, (B,) if one_arg else ())
    t = T(P, x)
    conv = [T(P, a) if isinstance(a, np.ndarray) else
            (tuple(T(P, v) for v in a) if isinstance(a, tuple) else a) for a in args]
    out = getattr(P, name)(t, *conv)
    assert out is t
    return out


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_variant_rebinds_to_its_base_op(name, ref):
    """``x.op_(...)``: the same object back, holding what the JAX package's
    ``op_`` gives (the base op's result)."""
    assert_same(_inplace_run(name, tp), ref[("inplace", name)], rtol=SPECIAL, what=name)


def _installed(cls):
    return {n for n in dir(cls) if not n.startswith("__") or n.endswith("__")}


def test_tensor_methods_and_dunders_match_the_jax_install():
    from paddle_tpu import ops as jax_ops
    from paddle_tpu.framework.tensor import Tensor as JT

    jax_from_modules = {n for m in ("creation", "extras", "linalg", "logic", "manipulation",
                                    "math", "random", "reduction", "search")
                        for n in getattr(jax_ops, m).__all__}
    written = {n for m in ("creation", "extras", "linalg", "logic", "manipulation", "math",
                           "random", "reduction", "search") for n in getattr(jax_ops, m).__all__}
    # the generated in-place variants over the ported modules' base ops
    jax_from_modules |= {n for n in set(jax_ops.__all__) - written
                         if n[:-1] in jax_from_modules}
    want = {n for n in jax_from_modules if hasattr(JT, n)} - {"to_tensor", "is_tensor"}
    have = {n for n in tp_ops.__all__ if hasattr(tp.Tensor, n)} - {"to_tensor", "is_tensor"}
    assert want <= have, sorted(want - have)
    assert not {n for n in have if n in jax_from_modules} - want
    aliases = {"mm", "dim", "rank", "numel", "element_size", "add_", "subtract_", "multiply_",
               "scale_", "clip_", "zero_", "fill_", "exp_", "T"}
    dunders = {"__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
               "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__", "__mod__",
               "__rmod__", "__pow__", "__rpow__", "__neg__", "__abs__", "__matmul__",
               "__rmatmul__", "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__",
               "__and__", "__or__", "__xor__", "__invert__"}
    for n in aliases | dunders:
        assert hasattr(JT, n) and hasattr(tp.Tensor, n), n
    assert not hasattr(torch.Tensor, "stop_gradient")      # torch.Tensor is never patched


EXPRS = [
    "a + b", "a - 2.5", "3 - a", "a * b", "2 * a", "a / b", "1 / a", "a // b", "a % b",
    "a ** 2", "2 ** a", "-a", "abs(a)", "a @ b.T", "a == b", "a != b", "a < b", "a <= 0.5",
    "a > b", "a >= b", "i & j", "i | j", "i ^ j", "~i", "a.T", "a[1]", "a[:, 1:3]",
    "a[..., -1]", "a[i > 0]", "a.sum()", "a.mean(axis=1)", "a.reshape([4, 3])", "a.mm(b.T)",
    "a.dim()", "a.numel()", "a.astype('bfloat16')",
]


def _expr_run(expr, P):
    env = {"a": T(P, S), "b": T(P, A), "i": T(P, I), "j": T(P, J)}
    return eval(expr, {}, env)


@pytest.mark.parametrize("expr", EXPRS)
def test_dunders_and_methods_match_jax(expr, ref):
    assert_same(_expr_run(expr, tp), ref[("expr", expr)], rtol=SPECIAL, what=expr)
