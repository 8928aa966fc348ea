"""``paddle_tpu_torch.autograd`` (port of ``paddle_tpu/autograd/__init__.py``).

:class:`PyLayer` is a ``torch.autograd.Function`` underneath: ``forward``
and ``backward`` are the user's static methods over Tensors, called with a
:class:`PyLayerContext`; the Function hands them its inputs and gradients
as Tensors and takes back their results.  The user's backward is made of
the port's ops, so a PyLayer is differentiable twice where its backward is
(the JAX package's tape refuses ``create_graph`` through a PyLayer).
:class:`saved_tensors_hooks` is ``torch.autograd.graph.saved_tensors_hooks``
over Tensors; :func:`jacobian` and :func:`hessian` take a callable (or, for
``jacobian``, an output Tensor and its input).
"""

from __future__ import annotations

from typing import List

import torch

from ..framework.autograd import (  # noqa: F401
    backward, enable_grad, grad, is_grad_enabled, no_grad,
)
from ..framework.tensor import Tensor, unwrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled", "PyLayer",
           "PyLayerContext", "saved_tensors_hooks", "jacobian", "hessian"]


class PyLayerContext:
    """Context passed to ``PyLayer.forward`` / ``backward``."""

    def __init__(self):
        self._saved: List[Tensor] = []
        self.non_differentiable = []

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable.extend(tensors)


class _Function(torch.autograd.Function):
    """The torch Function every PyLayer runs through.  Its inputs are the
    Tensor arguments' storages; ``spec`` rebuilds the user's argument list
    (Tensors where they stood, everything else as given)."""

    @staticmethod
    def forward(tctx, layer, ctx, spec, kwargs, *datas):
        args = [Tensor._wrap(datas[v]) if kind == "t" else v for kind, v in spec]
        with torch.no_grad():
            outs = layer.forward(ctx, *args, **kwargs)
        multi = isinstance(outs, (tuple, list))
        out_list = list(outs) if multi else [outs]
        tctx.layer, tctx.ctx, tctx.n_in = layer, ctx, len(datas)
        tctx.multi = multi
        raw = [unwrap(o) for o in out_list]
        non_diff = {id(t) for t in ctx.non_differentiable}
        marks = [r for o, r in zip(out_list, raw) if id(o) in non_diff]
        if marks:
            tctx.mark_non_differentiable(*marks)
        return tuple(raw) if multi else raw[0]

    @staticmethod
    def backward(tctx, *grads):
        cots = [None if g is None else Tensor._wrap(g) for g in grads]
        res = tctx.layer.backward(tctx.ctx, *cots)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = [None if r is None else unwrap(r) for r in res]
        res = (res + [None] * tctx.n_in)[:tctx.n_in]
        return (None, None, None, None, *res)


class PyLayer:
    """A custom-gradient layer with Paddle's semantics::

        class Tanh(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.tanh(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor
                return dy * (1 - y * y)

    ``backward`` returns one gradient for each Tensor argument of
    ``forward``, in order."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        spec, datas = [], []
        for a in args:
            if isinstance(a, (Tensor, torch.Tensor)):
                spec.append(("t", len(datas)))
                datas.append(unwrap(a))
            else:
                spec.append(("v", a))
        outs = _Function.apply(cls, ctx, spec, kwargs, *datas)
        if isinstance(outs, tuple):
            return tuple(Tensor._wrap(o) if isinstance(o, torch.Tensor) else o for o in outs)
        return Tensor._wrap(outs) if isinstance(outs, torch.Tensor) else outs


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """``pack_hook(tensor)`` runs on every tensor the graph saves inside the
    block and ``unpack_hook(packed)`` gives it back in the backward (Tensors
    on both sides)."""

    def __init__(self, pack_hook, unpack_hook):
        super().__init__(lambda t: pack_hook(Tensor._wrap(t)),
                         lambda p: unwrap(unpack_hook(p)))


def _raw_fn(fn):
    def raw(v):
        out = fn(Tensor._wrap(v))
        return unwrap(out)

    return raw


def jacobian(ys, xs, batch_axis=None):
    """The full Jacobian d(ys)/d(xs), shaped ``ys.shape + xs.shape``:
    ``jacobian(fn, x)`` for a callable, or an output Tensor and the input
    it was computed from (one backward per output element)."""
    if callable(ys):
        x = unwrap(xs)
        return Tensor._wrap(torch.autograd.functional.jacobian(_raw_fn(ys), x))
    y, x = unwrap(ys), unwrap(xs)
    flat = y.reshape(-1)
    rows = []
    for i in range(flat.shape[0]):
        (g,) = torch.autograd.grad(flat[i], x, retain_graph=True, allow_unused=True)
        rows.append(torch.zeros_like(x) if g is None else g)
    return Tensor._wrap(torch.stack(rows).reshape(tuple(y.shape) + tuple(x.shape)))


def hessian(func, xs, batch_axis=None):
    """The Hessian of a scalar-valued ``func`` at ``xs``."""
    def scalar(v):
        return _raw_fn(func)(v).reshape(())

    return Tensor._wrap(torch.autograd.functional.hessian(scalar, unwrap(xs)))
