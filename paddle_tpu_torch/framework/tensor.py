"""The eager Tensor (port of ``paddle_tpu/framework/tensor.py``).

A :class:`Tensor` holds its storage in ``_data``, a ``torch.Tensor``, as
the JAX ``Tensor`` holds a ``jax.Array``.  Autograd is torch's: a Tensor
made with ``stop_gradient=False`` is a leaf whose ``_data`` requires grad,
an op's result carries ``_data.grad_fn``, :meth:`Tensor.backward` runs
``torch.autograd.backward`` and :attr:`Tensor.grad` wraps ``_data.grad``.

The class wraps rather than subclasses ``torch.Tensor``: Paddle's members
clash with torch's of the same name (``size`` is a property, ``transpose``
takes a permutation, ``max`` returns values only, ``flatten`` takes
``start_axis``), and the port's layers, models and kernels call torch's on
the tensors they are given.  Inside the port everything stays plain torch;
a Tensor is unwrapped once where user code enters it (``nn.Layer.__call__``,
the models' ``compute_loss`` / ``generate``, the op namespace) and results
are wrapped on the way out.

The JAX conversion policy holds (``to_tensor`` of Python or numpy data with
no dtype): float64 becomes float32, int64 becomes int32.  Data goes to the
device :func:`~.device.set_device` chose (the card by default).  Op
methods and dunders are installed by ``paddle_tpu_torch.ops``.

While a recorder is active (a fragment capture or a static Program, see
``framework/dispatch.py``), ``_data`` may be a
:class:`~.lazy.LazyArray`: shape and dtype known, value pending; reading
the value breaks the graph.  A layer's parameters are :class:`ParamBase` s,
``torch.nn.Parameter`` s with Paddle's members (``stop_gradient``,
``trainable``, ``name``, ``persistable``, ``optimize_attr``, ``numpy()``,
``set_value``).
"""

from __future__ import annotations

import functools
import itertools
import weakref
from typing import Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from .device import default_device
from .dispatch import tls
from .lazy import EAGER, LazyArray

__all__ = ["Tensor", "Parameter", "ParamBase", "as_param_base", "to_tensor", "unwrap", "wrap",
           "boundary", "call_unwrapped", "create_parameter"]


def _to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """``data`` as a fresh torch tensor (never aliasing the caller's
    buffer), under the JAX conversion policy."""
    target = dtype_mod.convert_dtype(dtype)
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        out = data.detach()
        dev = out.device if place is None else default_device(place)
        out = out.to(device=dev, dtype=target or out.dtype)
        return out.clone() if out.data_ptr() == data.data_ptr() and out.numel() else out
    if isinstance(data, (list, tuple)) and any(isinstance(x, (Tensor, torch.Tensor))
                                               for x in data):
        data = [np.asarray(x) for x in data]
    arr = np.asarray(data)
    if arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):   # ml_dtypes arrays
        target = target or dtype_mod.convert_dtype(arr.dtype.name)
        arr = arr.astype(np.float32)
    if target is None:
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)   # the default dtype policy: fp32
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)     # int32, as the JAX package
    out = torch.from_numpy(np.array(arr, copy=True))
    if target is not None and out.dtype != target:
        out = out.to(target)
    return out.to(default_device(place))


def unwrap(x):
    """Tensor -> its ``torch.Tensor`` (through lists, tuples and dicts)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: unwrap(v) for k, v in x.items()}
    return x


def wrap(x):
    """``torch.Tensor`` (or a pending :class:`~.lazy.LazyArray`) -> Tensor
    (through lists, tuples and dicts); a ``nn.Parameter`` is wrapped too,
    sharing its storage and graph."""
    if isinstance(x, (torch.Tensor, LazyArray)):
        return Tensor._wrap(x)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(wrap(v) for v in x)
    if isinstance(x, dict):
        return {k: wrap(v) for k, v in x.items()}
    return x


def _holds_tensor(args, kwargs) -> bool:
    for a in itertools.chain(args, kwargs.values()):
        if isinstance(a, Tensor) or (isinstance(a, (list, tuple))
                                     and any(isinstance(v, Tensor) for v in a)):
            return True
    return False


def call_unwrapped(fn, args, kwargs, name=None):
    """``fn(*args, **kwargs)`` over plain torch tensors: when a Tensor is
    among the arguments, each is unwrapped and tensor results are wrapped
    back; otherwise the call is untouched.  This is one of the recording
    seam's two entries: while a recorder is active a call holding a Tensor
    is recorded (as op ``name``, or the layer's class or the function's
    name) instead of run."""
    if not _holds_tensor(args, kwargs):
        return fn(*args, **kwargs)
    rec = tls.recorder
    if rec is not None:
        out = rec.record_call(fn, args, kwargs, name)
        if out is not EAGER:
            return out
    return wrap(fn(*unwrap(args), **unwrap(kwargs)))


def boundary(fn=None, *, name=None):
    """``fn`` taking Tensors as well as torch tensors (see
    :func:`call_unwrapped`): the port's entry points wear it; ``name`` is
    the op name a recording gives its calls."""
    if fn is None:
        return functools.partial(boundary, name=name)

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        return call_unwrapped(fn, args, kwargs, name)

    return entry


# id -> root whose graph a backward without retain_graph consumed (torch
# itself notices a second backward only where a node saved a tensor)
_CONSUMED = weakref.WeakValueDictionary()


class Tensor:
    """Eager tensor over a ``torch.Tensor``, with Paddle's surface."""

    __slots__ = ("_data", "name", "persistable", "__weakref__")

    # make Tensor win against numpy arrays in mixed arithmetic
    __array_priority__ = 100

    def __init__(self, data, dtype=None, place=None, stop_gradient: bool = True,
                 name: Optional[str] = None):
        self._data = _to_torch(data, dtype, place)
        self.name = name or ""
        self.persistable = False
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, data: torch.Tensor) -> "Tensor":
        """A Tensor over ``data`` itself (no copy, graph kept); over a
        pending value, the recorder substitutes the value in when it
        flushes."""
        t = cls.__new__(cls)
        t._data = data
        t.name = ""
        t.persistable = False
        if type(data) is LazyArray:
            data._tensors.append(weakref.ref(t))
        return t

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def place(self) -> torch.device:
        return self._data.device

    @property
    def is_leaf(self) -> bool:
        return self._data.grad_fn is None

    @property
    def _grad_node(self):
        return self._data.grad_fn

    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        d = self._data
        if value:
            if d.requires_grad:
                self._data = d.requires_grad_(False) if d.grad_fn is None else d.detach()
        elif not d.requires_grad and (d.is_floating_point() or d.is_complex()):
            self._data = (d if d.grad_fn is None else d.detach()).requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        if self._data.grad_fn is not None:
            return None          # only leaves accumulate, as in the JAX tape
        g = self._data.grad
        return None if g is None else Tensor._wrap(g.detach())

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _to_torch(value, self.dtype, self.place)

    @property
    def _grad(self):
        return None if self._data.grad_fn is not None else self._data.grad

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd

        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._data.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        if set_to_zero and self._data.grad is not None:
            self._data.grad.zero_()
        else:
            self._data.grad = None

    def register_hook(self, hook):
        """``hook(grad)`` runs on the gradient reaching this tensor (a Tensor;
        a returned Tensor or array replaces it).  Returns a handle with
        ``remove()``."""
        def torch_hook(g):
            out = hook(Tensor._wrap(g))
            if out is None or isinstance(out, torch.Tensor):
                return out
            return out._data if isinstance(out, Tensor) else torch.as_tensor(
                np.asarray(out), dtype=g.dtype, device=g.device)

        if not self._data.requires_grad:
            class _Handle:
                def remove(self):
                    pass

            return _Handle()
        return self._data.register_hook(torch_hook)

    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._data.detach())
        t.name = self.name
        return t

    def detach_(self) -> "Tensor":
        self._data = self._data.detach()
        return self

    def clone(self) -> "Tensor":
        from ..ops.common import apply

        return apply("clone", torch.clone, self)

    # -- conversion ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A writable host copy (bfloat16 widens to float32: numpy has no
        bfloat16)."""
        if isinstance(self._data, LazyArray):
            return Tensor._wrap(self._data._concrete("host read (numpy)")).numpy()
        d = self._data.detach().resolve_conj()
        if d.dtype in (torch.bfloat16, dtype_mod.float8_e4m3fn, dtype_mod.float8_e5m2):
            d = d.to(torch.float32)
        return np.array(d.cpu().numpy(), copy=True)

    def item(self, *args):
        if args or isinstance(self._data, LazyArray):
            return self.numpy().item(*args)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype) -> "Tensor":
        from ..ops.common import apply

        d = dtype_mod.convert_dtype(dtype)
        return apply("cast", lambda x: x.to(d), self)

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def to(self, *args, **kwargs):
        """``.to(dtype)``, ``.to(device)``, ``.to(device, dtype)``."""
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, torch.device) or (isinstance(a, str) and a.split(":")[0].lower()
                                               in ("cpu", "gpu", "cuda")):
                device = a
            else:
                dtype = a
        out = self
        if device is not None:
            dev = default_device(device)
            if dev != self._data.device:
                out = Tensor._wrap(self._data.to(dev))
        return out.astype(dtype) if dtype is not None else out

    def cpu(self) -> "Tensor":
        return self.to("cpu")

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        return self.to(f"gpu:{device_id or 0}")

    def pin_memory(self):
        return self

    def ndimension(self) -> int:
        return self.ndim

    # -- misc dunders -------------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        value = "(pending)" if isinstance(self._data, LazyArray) else self.numpy()
        return (f"Tensor(shape={self.shape}, dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n       "
                f"{value})")

    def _scalar(self):
        """The storage a Python scalar is read from (a pending value reads
        itself: a graph break)."""
        d = self._data
        return d if isinstance(d, LazyArray) else d.detach()

    def __bool__(self):
        return bool(self._scalar())

    def __int__(self):
        return int(self._scalar())

    def __float__(self):
        return float(self._scalar())

    def __index__(self):
        return int(self._scalar())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        from ..ops.common import apply

        idx = _unwrap_index(idx, self._data.device)
        return apply("getitem", lambda x: x[idx], self)

    def __setitem__(self, idx, value):
        """Out of place, as the JAX package's scatter: the Tensor is rebound
        to a copy with the slice written, so gradients flow through both
        the old values and ``value``."""
        from ..ops.common import apply

        idx = _unwrap_index(idx, self._data.device)

        def put(x, *v):
            out = x.clone()
            out[idx] = v[0].to(x.dtype) if v else value
            return out

        out = apply("setitem", put, self, value) if isinstance(value, Tensor) else \
            apply("setitem", put, self)
        self._data = out._data

    def _set_data(self, value):
        """Raw storage swap (optimizer updates, loading weights)."""
        self._data = value._data if isinstance(value, Tensor) else value

    def set_value(self, value):
        """Copy ``value`` in (same shape; cast to this dtype), keeping this
        Tensor's place and its ``stop_gradient``."""
        arr = _to_torch(value, self.dtype, self.place)
        if tuple(arr.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(arr.shape)} vs "
                             f"{tuple(self._data.shape)}")
        with torch.no_grad():
            if self._data.grad_fn is None:
                self._data.copy_(arr)
            else:
                self._data = arr
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)


def _unwrap_index(idx, device):
    if isinstance(idx, Tensor):
        return idx._data
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i, device) for i in idx)
    if isinstance(idx, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(idx), device=device)
    return idx


class ParamBase(torch.nn.Parameter):
    """A layer's parameter: a ``torch.nn.Parameter`` (the optimizers,
    ``TrainStep`` and autograd take it as they take any) with the Paddle
    members a program reads on it (the JAX ``Parameter``'s):
    ``stop_gradient`` (get and set, ``not requires_grad``), ``trainable``
    (its opposite), ``name``, ``persistable``, ``optimize_attr``,
    ``numpy()`` (a host copy, also of a parameter that needs grad) and
    ``set_value``.  ``nn.Layer`` makes every parameter registered on it one
    (the class of a plain ``nn.Parameter`` is switched, nothing copied)."""

    persistable = True

    def __init__(self, data=None, requires_grad: bool = True):
        self.__dict__.setdefault("optimize_attr", {"learning_rate": 1.0})

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    @property
    def name(self) -> str:
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value or ""

    def numpy(self) -> np.ndarray:
        return Tensor._wrap(self.detach()).numpy()

    @torch.no_grad()
    def set_value(self, value):
        """Copy ``value`` in (same shape, cast to this dtype), in place."""
        arr = _to_torch(value, self.dtype, self.device)
        if tuple(arr.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(arr.shape)} vs "
                             f"{tuple(self.shape)}")
        self.copy_(arr)
        return self


def as_param_base(p: torch.nn.Parameter) -> torch.nn.Parameter:
    """``p`` with the Paddle members (:class:`ParamBase`), in place."""
    if type(p) is torch.nn.Parameter:
        p.__class__ = ParamBase
        p.__dict__.setdefault("optimize_attr", {"learning_rate": 1.0})
    return p


class Parameter(Tensor):
    """Trainable tensor (reference ``EagerParamBase``): ``stop_gradient``
    defaults to False.  Its storage is a :class:`ParamBase`, so the port's
    optimizers take it as they take a layer's."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "is_distributed",
                 "no_weight_decay")

    def __init__(self, data, dtype=None, name=None, trainable: bool = True):
        super().__init__(data, dtype=dtype, name=name)
        self._data = ParamBase(self._data, requires_grad=trainable and (
            self._data.is_floating_point() or self._data.is_complex()))
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False
        self.no_weight_decay = False
        self.persistable = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a new leaf Tensor holding a copy of ``data``."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None) -> Parameter:
    """``paddle.create_parameter`` (:func:`.param_attr.create_parameter`)."""
    from .param_attr import create_parameter as create

    return create(shape, dtype, name, attr, is_bias, default_initializer)
