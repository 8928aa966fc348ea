"""Eager autograd (port of ``paddle_tpu/framework/autograd.py``).

The JAX package records its own tape of ``jax.vjp`` closures; the port's
tape is torch's.  :func:`backward` and :func:`grad` are
``torch.autograd.backward`` / ``torch.autograd.grad`` under Paddle's
signatures and rules:

- a root that needs no gradient raises, and a second backward through a
  graph that a backward without ``retain_graph`` consumed raises, even
  where torch would not notice (a graph that saved no tensor);
- :func:`grad` leaves every ``.grad`` alone, retains the graph only when
  asked (or under ``create_graph``, whose results carry their own graph for
  double grad, under an ambient ``no_grad`` too), and an input that gets no
  gradient raises unless ``allow_unused``.

``inputs`` may be Tensors or the ``nn.Parameter`` s of a layer.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from .tensor import _CONSUMED, Tensor, unwrap

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled", "backward",
           "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _roots(tensors):
    out = []
    for t in tensors:
        d = unwrap(t)
        if not isinstance(d, torch.Tensor) or not d.requires_grad:
            raise RuntimeError("backward() on a tensor with stop_gradient=True and no graph")
        if _CONSUMED.get(id(d)) is d:
            raise RuntimeError("trying to backward through a graph a second time: "
                               "set retain_graph=True on the first backward")
        out.append(d)
    return out


def _seeds(roots, grad_tensors):
    if grad_tensors is None:
        grad_tensors = [None] * len(roots)
    return [torch.ones_like(r) if g is None else
            torch.as_tensor(unwrap(g), dtype=r.dtype, device=r.device)
            for r, g in zip(roots, grad_tensors)]


def backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
             retain_graph: bool = False):
    """Reverse-mode from ``tensors``, seeded with ones (or ``grad_tensors``),
    accumulating into the leaves' ``.grad``."""
    roots = _roots(tensors if isinstance(tensors, (list, tuple)) else [tensors])
    if grad_tensors is not None and not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(roots, _seeds(roots, grad_tensors), retain_graph=retain_graph)
    if not retain_graph:
        _CONSUMED.update((id(r), r) for r in roots)


def grad(outputs, inputs, grad_outputs=None, retain_graph: Optional[bool] = None,
         create_graph: bool = False, allow_unused: bool = False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (a list, ``None`` for an unused input under
    ``allow_unused``), without touching any ``.grad``."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    roots = _roots(outputs)
    retain = bool(create_graph) if retain_graph is None else bool(retain_graph)
    xs = [unwrap(x) for x in inputs]
    live = [i for i, x in enumerate(xs) if x.requires_grad]
    if len(live) < len(xs) and not allow_unused:
        raise RuntimeError("one of the input tensors received no gradient; pass "
                           "allow_unused=True")
    scope = torch.enable_grad() if create_graph else contextlib.nullcontext()
    with scope:
        got = torch.autograd.grad(roots, [xs[i] for i in live], _seeds(roots, grad_outputs),
                                  retain_graph=retain, create_graph=create_graph,
                                  allow_unused=True) if live else []
    if not retain:
        _CONSUMED.update((id(r), r) for r in roots)
    results = [None] * len(xs)
    for i, g in zip(live, got):
        results[i] = g
    if not allow_unused and any(g is None for g in results):
        raise RuntimeError("one of the input tensors received no gradient; pass "
                           "allow_unused=True")
    return [None if g is None else Tensor._wrap(g if create_graph else g.detach())
            for g in results]
