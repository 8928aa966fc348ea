"""The deferred value of a recorded op (the port of ``jit.subgraph``'s
``LazyArray``).

While a recorder is active (``framework.dispatch.tls.recorder``: a fragment
capture or a static Program's builder), an op reaching the seam is recorded
instead of run, and its outputs are :class:`LazyArray` s: a meta tensor
carries their shape and dtype (the counterpart of ``jax.eval_shape``'s
abstract value), ``device`` the device the value will live on.  A Tensor
wraps a LazyArray as it wraps a ``torch.Tensor``; the recorder substitutes
the value into every wrapping Tensor when it flushes.

Reading a value (``bool`` / ``int`` / ``float`` / ``item`` / ``numpy``, or a
raw device pointer) forces the recorder to flush: a graph break in a
fragment capture, an error in a static Program.  Torch functions and tensor
methods called on a LazyArray (``__torch_function__``, attribute access,
the operators) are recorded as ops of their own; once the value exists they
run on it.
"""

from __future__ import annotations

from typing import List

import torch

from .dispatch import tls

__all__ = ["LazyArray", "VALUE_READS", "EAGER", "DESCEND"]

# a recorder's answers to the seam: run the call now (it cannot be
# deferred), or enter the user-defined layer and record what it calls
EAGER = object()
DESCEND = object()

# tensor methods that read the value: they break the graph
VALUE_READS = frozenset({"item", "tolist", "numpy", "data_ptr", "untyped_storage", "storage"})
# metadata a meta tensor answers without a value
_META_ATTRS = frozenset({"shape", "dtype", "ndim", "is_sparse", "layout", "is_quantized",
                         "is_floating_point", "is_complex", "dim", "numel", "size", "stride",
                         "is_contiguous", "element_size", "nbytes", "itemsize",
                         "storage_offset", "ndimension", "nelement"})


class LazyArray:
    """A recorded op's output: shape and dtype known, value pending."""

    __slots__ = ("_recorder", "_node", "_idx", "_meta", "_device", "_value", "_tensors",
                 "_aborted", "__weakref__")

    requires_grad = False
    grad_fn = None

    def __init__(self, recorder, node, idx: int, meta: torch.Tensor, device: torch.device):
        self._recorder = recorder
        self._node = node
        self._idx = idx
        self._meta = meta
        self._device = device
        self._value = None
        self._aborted = False
        self._tensors: List = []       # weakrefs of the Tensors wrapping this value

    # -- metadata (no flush) -------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_cuda(self) -> bool:
        return self._device.type == "cuda"

    def requires_grad_(self, requires_grad: bool = True):
        return self            # a recorded program differentiates its parameters

    def __getattr__(self, name):
        if name.startswith("__") or name in ("_meta", "_value", "_recorder"):
            raise AttributeError(name)
        if name in _META_ATTRS:
            return getattr(self._meta, name)
        if name in VALUE_READS:
            return getattr(self._concrete(f"Tensor.{name}()"), name)
        attr = getattr(torch.Tensor, name, None)
        if not callable(attr):
            raise AttributeError(f"LazyArray has no attribute {name!r}")
        return lambda *args, **kwargs: self._call(name, attr, (self,) + args, kwargs)

    # -- the value ------------------------------------------------------------
    def _concrete(self, reason: str) -> torch.Tensor:
        """The value, flushing the recorder (a graph break) when it is
        pending."""
        if self._value is None:
            if self._aborted:
                raise RuntimeError(
                    "this value was pending in a fragment capture that was aborted by an "
                    "exception; it cannot be materialized")
            self._recorder.flush(reason)
        if self._value is None:
            raise RuntimeError(f"the recorder's flush did not materialize this value ({reason})")
        return self._value

    def __array__(self, dtype=None, copy=None):
        from .tensor import Tensor

        a = Tensor._wrap(self._concrete("host read (numpy/item)")).numpy()
        return a.astype(dtype) if dtype is not None else a

    def __bool__(self):
        return bool(self._concrete("bool(tensor) in Python control flow"))

    def __int__(self):
        return int(self._concrete("int(tensor)"))

    def __float__(self):
        return float(self._concrete("float(tensor)"))

    def __index__(self):
        return int(self._concrete("tensor used as index"))

    def __len__(self):
        return self._meta.shape[0]

    __hash__ = object.__hash__

    # -- recorded ops -----------------------------------------------------------
    def _call(self, name, fn, args, kwargs):
        if self._value is not None:
            args = tuple(a._value if isinstance(a, LazyArray) else a for a in args)
            return fn(*args, **kwargs)
        rec = tls.recorder
        if rec is None or rec is not self._recorder:
            # a pending value outside its recording (or inside shape
            # inference): materialize, then run the op on the value
            return self._value_call(name, fn, args, kwargs)
        return rec.record_torch(name, fn, args, kwargs)

    def _value_call(self, name, fn, args, kwargs):
        self._concrete(f"torch op '{name}' outside the recording")
        return fn(*(a._value if isinstance(a, LazyArray) else a for a in args), **kwargs)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        lazy = next((a for a in _leaves((args, kwargs)) if isinstance(a, LazyArray)), None)
        name = getattr(func, "__name__", repr(func))
        return lazy._call(name, func, args, kwargs)

    def __repr__(self):
        state = "pending" if self._value is None else "materialized"
        return (f"LazyArray(shape={list(self._meta.shape)}, dtype={self._meta.dtype}, "
                f"{state})")


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _operator(name):
    fn = getattr(torch.Tensor, name)

    def op(self, *args):
        return self._call(name, fn, (self,) + args, {})

    op.__name__ = name
    return op


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
              "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__", "__mod__",
              "__pow__", "__rpow__", "__matmul__", "__rmatmul__", "__neg__", "__abs__",
              "__invert__", "__and__", "__or__", "__xor__", "__lt__", "__le__", "__gt__",
              "__ge__", "__eq__", "__ne__", "__getitem__"):
    setattr(LazyArray, _name, _operator(_name))
del _name
