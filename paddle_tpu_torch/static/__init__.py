"""``paddle_tpu_torch.static`` (port of ``paddle_tpu/static/__init__.py``):
executable static-graph mode.

The Program is a recorded op tape replayed by ``Executor.run`` (see
:mod:`.graph`); ``enable_static()`` turns recording on.  The rest of this
module is the long tail of the ``paddle.static`` utility surface.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..framework.tensor import Tensor
from .graph import (  # noqa: F401  (the executable core)
    Executor, Program, data, default_main_program, default_startup_program,
    disable_static, enable_static, in_static_mode, load_inference_model, program_guard,
    save_inference_model,
)

__all__ = ["InputSpec", "Program", "default_main_program", "default_startup_program",
           "program_guard", "Executor", "gradients", "name_scope",
           "Variable", "cpu_places", "cuda_places", "xpu_places", "create_parameter",
           "create_global_var", "accuracy", "auc", "append_backward", "py_func",
           "device_guard", "ipu_shard_guard", "set_ipu_shard", "IpuStrategy",
           "IpuCompiledProgram", "BuildStrategy", "CompiledProgram", "WeightNormParamAttr",
           "Print", "ExponentialMovingAverage", "global_scope", "scope_guard", "save", "load",
           "save_to_file", "load_from_file", "serialize_program", "deserialize_program",
           "serialize_persistables", "deserialize_persistables", "save_inference_model",
           "load_inference_model", "load_program_state", "set_program_state",
           "ctr_metric_bundle", "data", "normalize_program"]


class InputSpec:
    """Shape and dtype of an input (``to_static`` signatures, ``jit.save``)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=False):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, str(tensor.dtype).replace("torch.", ""), name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


@contextlib.contextmanager
def name_scope(prefix):
    yield


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Dynamic mode: ``paddle.grad``.  Inside a recording Program the
    gradients are Executor.run's own (attach an optimizer)."""
    if in_static_mode():
        raise RuntimeError(
            "static.gradients inside a recording Program is not supported: "
            "gradients are computed by Executor.run itself; attach an "
            "optimizer with minimize(loss) or fetch the loss and differentiate "
            "in dynamic mode")
    from ..framework.autograd import grad

    return grad(targets, inputs, target_gradients, retain_graph=True, allow_unused=True)


class Variable:
    """The Tensor type under its static-namespace name (reference
    ``static.Variable``)."""

    def __new__(cls, *a, **k):
        return Tensor(*a, **k)


def cpu_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [torch.device("cpu")] * n


def cuda_places(device_ids=None):
    """The cards (reference ``cuda_places``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ids = range(n) if device_ids is None else device_ids
    return [torch.device("cuda", i) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..framework.param_attr import create_parameter as _cp

    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    from ..framework.dtype import convert_dtype, dtype_name

    t = Tensor(np.full(shape, value, dtype_name(convert_dtype(dtype))), dtype=dtype)
    t.persistable = persistable
    if name:
        t.name = name
    return t


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy (reference ``static.accuracy``), an op of the graph."""
    from ..ops.common import binary_op

    def f(pred, y):
        topk = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
        hit = (topk == y.reshape(-1, 1)).any(dim=-1)
        return hit.to(torch.float32).mean()

    return binary_op("static_accuracy", f, input, label)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1, name=None):
    """Batch AUC from predicted probabilities (reference ``static.auc``): the
    histogram formulation of ``fleet.metrics.auc``, on the host."""
    arr = input.numpy() if isinstance(input, Tensor) else np.asarray(input)
    p = arr[:, -1] if arr.ndim == 2 else arr
    y = (label.numpy() if isinstance(label, Tensor) else np.asarray(label)).reshape(-1)
    bins = np.clip((p * num_thresholds).astype(np.int64), 0, num_thresholds)
    pos = np.bincount(bins[y == 1], minlength=num_thresholds + 1).astype(float)
    neg = np.bincount(bins[y == 0], minlength=num_thresholds + 1).astype(float)
    area = tp = fp = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp, new_fp = tp + pos[i], fp + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    return Tensor(np.float32(0.0 if tp == 0 or fp == 0 else area / (tp * fp)))


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None):
    """The eager form of the static backward pass: runs backward and returns
    ``(param, grad)`` pairs.  Inside a recording Program use
    ``optimizer.minimize(loss)``: Executor.run takes the gradients itself."""
    if in_static_mode():
        raise RuntimeError(
            "append_backward inside a recording Program: use optimizer.minimize(loss); "
            "Executor.run takes the gradients itself")
    loss.backward()
    params = parameter_list or []
    return [(p, p.grad) for p in params]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-function op (reference ``static.py_func``): calls ``func``."""
    return func(*x) if isinstance(x, (list, tuple)) else func(x)


@contextlib.contextmanager
def device_guard(device=None):
    """Device placement hint (reference ``device_guard``): placement follows
    the tensors, so a scope that changes nothing."""
    yield


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise NotImplementedError("IPU sharding is Graphcore-specific")


def set_ipu_shard(layer, index=-1, stage=-1):
    raise NotImplementedError("IPU sharding is Graphcore-specific")


class IpuStrategy:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU support is Graphcore-specific")


class IpuCompiledProgram(IpuStrategy):
    pass


class BuildStrategy:
    """Graph-build options (reference ``BuildStrategy``), kept for the API:
    a recorded Program replays as recorded."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.memory_optimize = True


class CompiledProgram:
    """A Program marked for compiled execution (reference
    ``CompiledProgram``); ``Executor.run`` runs the Program it holds."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()


from ..framework.param_attr import WeightNormParamAttr  # noqa: E402,F401


def Print(input, first_n=-1, message=None, summarize=20, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Print a tensor as a passthrough op (reference ``static.Print``): in a
    Program it prints at each run."""
    from ..ops.common import unary_op

    def f(a):
        print(f"{message or 'Print'}: {a}")
        return a

    return unary_op("static_print", f, input)


def _host(p):
    d = p._data if isinstance(p, Tensor) else p
    return d.detach().to(torch.float32).cpu().numpy()


class ExponentialMovingAverage:
    """EMA of trainable parameters (reference
    ``static.ExponentialMovingAverage``): ``update()`` after each step,
    ``apply()`` to evaluate with the averages."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = {}
        self._backup = None
        self._step = 0
        self._params = None

    def _ensure(self, params):
        if self._params is None:
            self._params = list(params)
            for p in self._params:
                self._ema[id(p)] = _host(p)

    def update(self, parameters=None):
        self._ensure(parameters or self._params or [])
        self._step += 1
        # bias-corrected decay (reference: min(decay, (1 + t) / (10 + t)))
        decay = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            self._ema[id(p)] = decay * self._ema[id(p)] + (1 - decay) * _host(p)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        self._backup = {}
        with torch.no_grad():
            for p in self._params or []:
                d = p._data if isinstance(p, Tensor) else p
                self._backup[id(p)] = d.detach().clone()
                d.copy_(torch.as_tensor(self._ema[id(p)]).to(device=d.device, dtype=d.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        if self._backup:
            with torch.no_grad():
                for p in self._params or []:
                    d = p._data if isinstance(p, Tensor) else p
                    d.copy_(self._backup[id(p)])
            self._backup = None


def global_scope():
    """The variable scope (reference ``global_scope``): the default main
    Program."""
    return default_main_program()


@contextlib.contextmanager
def scope_guard(scope):
    yield


def save(program, model_path, protocol=4):
    """Save a Program's state (reference ``static.save``)."""
    from ..framework.io import save as _save

    _save(getattr(program, "state_dict", lambda: {})(), model_path + ".pdparams")


def load(program, model_path, executor=None, var_list=None):
    """Load a state ``save`` wrote and set it on ``program``."""
    from ..framework.io import load as _load

    state = _load(model_path + ".pdparams", return_numpy=True)
    set_program_state(program, state)
    return state


def save_to_file(path, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def serialize_program(feed_vars=None, fetch_vars=None, **kwargs) -> bytes:
    """The feed / fetch names (a recorded Program holds Python calls, which
    do not serialise: ``save_inference_model`` exports the program)."""
    names = [getattr(v, "name", str(i)) for i, v in enumerate(feed_vars or [])]
    fetches = [getattr(v, "name", str(i)) for i, v in enumerate(fetch_vars or [])]
    return pickle.dumps({"feed": names, "fetch": fetches})


def deserialize_program(data: bytes):
    return pickle.loads(data)


def serialize_persistables(feed_vars=None, fetch_vars=None, executor=None, **kwargs) -> bytes:
    program = kwargs.get("program") or default_main_program()
    return pickle.dumps(program.state_dict())


def deserialize_persistables(program, data, executor=None):
    state = pickle.loads(data)
    set_program_state(program, state)
    return state


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load

    path = model_path if model_path.endswith(".pdparams") else model_path + ".pdparams"
    return _load(path, return_numpy=True)


def set_program_state(program, state):
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    raise NotImplementedError(
        "ctr_metric_bundle is parameter-server CTR tooling; use static.auc for the "
        "metrics it bundles")


def normalize_program(program, feed_vars=None, fetch_vars=None, **kwargs):
    """Prune a program for serving (reference ``normalize_program``): the
    replay already runs only what the fetches need, so the program passes
    through with its feed and fetch lists recorded."""
    program._feed_vars = feed_vars
    program._fetch_vars = fetch_vars
    return program


from . import nn  # noqa: E402,F401  (static.nn layer builders + control flow)
