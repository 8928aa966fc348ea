"""Executable static graph: ``Program`` / ``Executor`` (port of
``paddle_tpu/static/graph.py``).

As in the JAX package the Program is a recorded op tape, built by the
fragment recorder of ``jit.subgraph`` at the recording seam:

- ``enable_static()`` activates a :class:`StaticBuilder` (a ``Recorder``
  that never flushes).  User code (layers, models, the functional and op
  namespaces, ``static.nn``) then records calls instead of running them;
  ``static.data`` declares named feeds (None dims allowed: they take a
  canonical size, 2, while the Program is built, and the run's size when it
  runs).
- Parameters and buffers stay eagerly initialised (the startup program is
  satisfied by construction).  A layer call is one recorded node that runs
  the layer itself, so it reads the layer's parameters and buffers as they
  are at each run, and updates buffers in place as an eager call does
  (BatchNorm's running statistics are carried by construction).  A Tensor
  used as an input is read at each run; one rebound to a recorded value at
  build time (``data_norm``'s accumulators, ``spectral_norm``'s u / v) is
  carried state: each run computes its new value and writes it back.
- ``optimizer.minimize(loss)`` records a training directive; ``Executor.run``
  then replays the tape under autograd, takes the gradients of the loss with
  respect to every trainable parameter of the Program (``requires_grad``;
  a parameter with ``stop_gradient = True`` is left alone; one the loss
  does not reach gets a zero gradient, as in the JAX package, whatever the
  run fetches) and applies the optimizer's functional update: the step of
  ``jit.TrainStep`` (``jit.grads_of`` / ``jit.apply_update``), so it
  launches the same kernels.  The optimizer's slots are keyed by the
  Program-wide names of ``Program.state_dict``.
- Reading a value at build time is an error; control flow must use
  recorded ops (``static.nn.cond`` / ``while_loop``, ``paddle.where``).
- Random ops draw at each run from their generators, so dropout takes a
  fresh mask every ``run``.

``save_inference_model`` exports the fetch graph with ``torch.export``
(``jit.save``'s artifact: ``.pt2`` program, ``.pdiparams`` weights,
``.pdmodel.json`` metadata), which ``jit.load`` and ``inference.Predictor``
open as they open ``jit.save``'s.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.device import default_device
from ..framework.dispatch import tls
from ..framework.dtype import convert_dtype
from ..framework.lazy import LazyArray
from ..framework.tensor import Tensor
from ..jit import apply_update, grads_of, subgraph
from ..jit.subgraph import Recorder, replay

__all__ = [
    "Program", "Executor", "StaticBuilder", "current_builder", "data",
    "enable_static", "disable_static", "in_static_mode", "program_guard",
    "default_main_program", "default_startup_program",
    "save_inference_model", "load_inference_model",
]

# the size a None feed dim takes while the Program is built
_CANON_DIM = 2

# ops and layers that draw at each run: an inference export refuses them
_STOCHASTIC_OPS = frozenset({"dropout", "alpha_dropout", "feature_alpha_dropout", "rrelu"})
_STOCHASTIC_LAYERS = frozenset({"Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
                                "FeatureAlphaDropout", "RReLU"})

_MODE = threading.local()


def in_static_mode() -> bool:
    return getattr(_MODE, "on", False)


def current_builder() -> Optional["StaticBuilder"]:
    rec = tls.recorder
    return rec if isinstance(rec, StaticBuilder) else None


class _FeedNode:
    """The source of a named graph input (``static.data``)."""

    __slots__ = ("name", "declared_shape", "dtype")

    def __init__(self, name, declared_shape, dtype):
        self.name = name
        self.declared_shape = tuple(declared_shape)
        self.dtype = dtype


class StaticBuilder(Recorder):
    """A Recorder that accumulates the whole Program and never replays.

    ``flush`` (forcing a value) is a build-time error: the static graph has
    no values until ``Executor.run`` feeds it."""

    allow_eager_fallback = False    # check_nan_inf checks each op when it runs

    def __init__(self, program: "Program"):
        super().__init__(name=f"program@{id(program):x}")
        self.program = weakref.ref(program)
        self.optimizer = None           # (optimizer, loss LazyArray)
        # id(Tensor) -> (Tensor, its data when first used).  Strong refs: the
        # Program owns its variables (a layer built inline and dropped keeps
        # its parameters in the Program)
        self._observed: Dict[int, Tuple[Tensor, Any]] = {}
        # id(Tensor) -> (Tensor, (node, idx) its run value comes from, data
        # before the first run); sticky once judged
        self._carried: Dict[int, tuple] = {}

    def _ext(self, tensor, data):
        self._observed.setdefault(id(tensor), (tensor, data))
        return ("e", tensor)

    def flush(self, reason: str = "explicit"):
        if not self._nodes and reason == "end of captured call":
            return
        raise RuntimeError(
            "cannot materialize a static-graph Variable at build time "
            f"({reason}). In static mode values exist only inside "
            "Executor.run(program, feed, fetch_list); fetch the variable "
            "instead of reading it, and express control flow with recorded "
            "ops (paddle.where / static.nn.cond).")

    def _not_deferrable(self, name, why):
        raise RuntimeError(f"static mode cannot record op '{name}': its shapes cannot be "
                           f"inferred without values ({why!r})")

    def set_optimizer(self, optimizer, loss: Tensor) -> None:
        d = loss._data if isinstance(loss, Tensor) else loss
        if not (isinstance(d, LazyArray) and d._recorder is self and d._value is None):
            raise ValueError("minimize(loss) in static mode needs a loss produced by ops "
                             "recorded in the current Program")
        if self.optimizer is not None:
            raise RuntimeError("this Program already has an optimizer attached")
        self.optimizer = (optimizer, d)

    def carried(self) -> Dict[int, tuple]:
        """The observed Tensors rebound to a value this Program records
        (sticky: a run's write-back makes them concrete again)."""
        for tid, (t, init) in self._observed.items():
            d = t._data
            if tid not in self._carried and isinstance(d, LazyArray) and d._recorder is self \
                    and d._value is None:
                self._carried[tid] = (t, (d._node, d._idx), init)
        return self._carried


@contextlib.contextmanager
def _suspend_capture():
    """Run real computation (Executor.run internals) without recording."""
    prev, tls.recorder = tls.recorder, None
    try:
        yield
    finally:
        tls.recorder = prev


class Program:
    """A recorded op graph and its state (reference ``base.framework.Program``)."""

    def __init__(self):
        self._builder: Optional[StaticBuilder] = None
        self._feeds: Dict[str, _FeedNode] = {}
        self._named_vars: Dict[str, Tensor] = {}
        self._opt_state: Dict[str, Any] = {}   # Program-wide parameter name -> slots
        self._exec_cache: Dict[tuple, Any] = {}
        self._state_cache: Tuple[int, Dict[str, Any]] = (-1, {})
        self._feed_vars = None                # set by normalize_program
        self._fetch_vars = None

    def _ensure_builder(self) -> StaticBuilder:
        if self._builder is None:
            self._builder = StaticBuilder(self)
        return self._builder

    @property
    def ops(self):
        return list(self._builder._nodes) if self._builder else []

    def global_block(self):
        return self

    def clone(self, for_test: bool = False):
        return self

    def _add_feed(self, name, shape, dtype) -> Tensor:
        dt = convert_dtype(dtype)
        node = _FeedNode(name, shape, dt)
        self._feeds[name] = node
        meta = torch.empty([_CANON_DIM if (s is None or s == -1) else int(s) for s in shape],
                           dtype=dt, device="meta")
        t = Tensor._wrap(LazyArray(self._ensure_builder(), node, 0, meta, default_device()))
        t.name = name
        self._named_vars[name] = t
        return t

    def _var_by_name(self, name: str) -> Tensor:
        try:
            return self._named_vars[name]
        except KeyError:
            raise KeyError(f"no variable named {name!r} in this Program "
                           f"(named: {sorted(self._named_vars)})") from None

    # -- state I/O (static.save / static.load ride these) --------------------
    def _state_tensors(self) -> Dict[str, Any]:
        """name -> the live state the recorded ops reach, in first-use
        order: the recorded layers' parameters and buffers (by their
        names), and the parameters and carried Tensors used as inputs (a
        Tensor by its name, else ``@state_<i>``)."""
        if self._builder is None:
            return {}
        out: Dict[str, Any] = {}
        seen = set()

        def add(name, obj):
            if id(obj) not in seen:
                seen.add(id(obj))
                while name in out:
                    name += "_"
                out[name] = obj

        carried = self._builder.carried()
        for node in self._builder._nodes:
            if node.module is not None:
                for n, t in itertools.chain(node.module.named_parameters(),
                                            node.module.named_buffers()):
                    add(n, t)
            for s in node.inputs:
                e = s[1] if s[0] == "e" else None
                d = e._data if isinstance(e, Tensor) else e
                if id(e) in carried or isinstance(d, torch.nn.Parameter):
                    add(getattr(e, "name", "") or f"@state_{len(out)}", e)
        return out

    def _trainable(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters a training run updates, by their Program-wide
        names (``_state_tensors``'; new ones are appended as the Program
        grows): every recorded parameter that needs grad now."""
        n = len(self._builder._nodes)
        if self._state_cache[0] != n:
            self._state_cache = (n, self._state_tensors())
        out = {}
        for name, obj in self._state_cache[1].items():
            v = self._value(obj)
            if isinstance(v, torch.nn.Parameter) and v.requires_grad:
                out[name] = v
        return out

    def _value(self, obj):
        """A state entry's tensor: a carried Tensor still pending gives the
        value it had before the first run."""
        if isinstance(obj, Tensor):
            d = obj._data
            return self._builder._carried[id(obj)][2] if isinstance(d, LazyArray) else d
        return obj

    def state_dict(self):
        return {name: Tensor._wrap(self._value(obj)).numpy()
                for name, obj in self._state_tensors().items()}

    @torch.no_grad()
    def set_state_dict(self, state):
        live = self._state_tensors()
        for k, v in state.items():
            if k in live:
                t = self._value(live[k])
                t.copy_(torch.as_tensor(np.asarray(v)).to(device=t.device, dtype=t.dtype))


# ---------------------------------------------------------------------------
# default programs + guards
# ---------------------------------------------------------------------------

_default = threading.local()


def _defaults():
    if not hasattr(_default, "main"):
        _default.main = Program()
        _default.startup = Program()
    return _default


def default_main_program() -> Program:
    return _defaults().main


def default_startup_program() -> Program:
    return _defaults().startup


def _activate(program: Program):
    """Make ``program`` the recording target; returns the previous state."""
    prev = (tls.recorder, getattr(_MODE, "no_grad_ctx", None))
    ctx = torch.no_grad()
    ctx.__enter__()
    _MODE.no_grad_ctx = ctx
    tls.recorder = program._ensure_builder()
    return prev


def _restore(prev):
    tls.recorder = prev[0]
    ctx = getattr(_MODE, "no_grad_ctx", None)
    if ctx is not None:
        ctx.__exit__(None, None, None)
    _MODE.no_grad_ctx = prev[1]


def enable_static():
    if in_static_mode():
        return
    _MODE.on = True
    _MODE.prev = _activate(default_main_program())


def disable_static():
    if not in_static_mode():
        return
    _MODE.on = False
    _restore(_MODE.prev)


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Scope recording into ``main_program`` (reference ``program_guard``).
    Outside static mode it changes nothing (the dynamic-mode shim)."""
    if not in_static_mode():
        yield
        return
    d = _defaults()
    prev_progs = (d.main, d.startup)
    d.main = main_program
    if startup_program is not None:
        d.startup = startup_program
    prev = _activate(main_program)
    try:
        yield
    finally:
        _restore(prev)
        d.main, d.startup = prev_progs


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a named graph input: a symbolic Variable in static mode, an
    ``InputSpec`` in dynamic mode (the shim ``jit.save`` callers use)."""
    if in_static_mode():
        return default_main_program()._add_feed(name, tuple(shape), dtype)
    from . import InputSpec

    return InputSpec(shape, dtype=dtype, name=name)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class _Plan:
    """The replay plan of some targets: DCE'd nodes, input specs, the
    external inputs (Tensors, read at each run) and the feeds."""

    def __init__(self, builder: StaticBuilder, targets):
        nodes = subgraph._needed(builder._nodes, [n for n, _ in targets], sources=(_FeedNode,))
        pos_of = {id(n): i for i, n in enumerate(nodes)}
        self.ext: List[Any] = []
        ext_pos: Dict[int, int] = {}
        self.feed_names: List[str] = []
        steps = []
        for n in nodes:
            ins = []
            for s in n.inputs:
                if s[0] == "l" and isinstance(s[1], _FeedNode):
                    ins.append(("f", s[1].name))
                    if s[1].name not in self.feed_names:
                        self.feed_names.append(s[1].name)
                elif s[0] == "l":
                    ins.append(("l", pos_of[id(s[1])], s[2]))
                elif s[0] == "e":
                    if id(s[1]) not in ext_pos:
                        ext_pos[id(s[1])] = len(self.ext)
                        self.ext.append(s[1])
                    ins.append(("e", ext_pos[id(s[1])]))
                else:
                    ins.append(s)
            steps.append((n.fn, n.spec, tuple(ins), tuple(n.tensor_pos)))
        self.steps = tuple(steps)
        self.targets = []
        for n, idx in targets:
            if isinstance(n, _FeedNode):
                self.targets.append(("f", n.name))
                if n.name not in self.feed_names:
                    self.feed_names.append(n.name)
            else:
                self.targets.append((pos_of[id(n)], idx))
        self.nodes = nodes
        self.stochastic = [n.name for n in nodes
                           if n.name in _STOCHASTIC_OPS or (
                               n.module is not None and n.module.training
                               and type(n.module).__name__ in _STOCHASTIC_LAYERS)]

    def ext_values(self, builder: StaticBuilder):
        """The external inputs' values for a run: a Tensor's data, or the
        value before the first run of a carried Tensor still pending."""
        out = []
        for e in self.ext:
            if isinstance(e, Tensor):
                d = e._data
                if isinstance(d, LazyArray):
                    d = builder._carried[id(e)][2] if id(e) in builder._carried else \
                        builder._observed[id(e)][1]
                out.append(d)
            else:
                out.append(e)
        return out


class Executor:
    """Run a Program (reference ``base.executor.Executor``): replay its tape
    with the feed; with an optimizer attached, the training step of
    ``jit.TrainStep`` over the tape."""

    def __init__(self, place=None):
        self.place = place

    def _device(self):
        if self.place is None:
            return default_device()
        return default_device(self.place if isinstance(self.place, (str, torch.device))
                              else str(self.place))

    def close(self):
        pass

    def run(self, program=None, feed=None, fetch_list=None, feed_var_name="feed",
            fetch_var_name="fetch", scope=None, return_numpy=True, use_prune=False):
        if program is None:
            program = default_main_program()
        from . import CompiledProgram

        if isinstance(program, CompiledProgram):
            program = program._program
        if isinstance(program, _LoadedProgram):
            return program._run(feed or {}, fetch_list, return_numpy)
        if not isinstance(program, Program) or program._builder is None \
                or not program._builder._nodes:
            return []  # the startup program: parameters are born initialised
        with _suspend_capture():
            return self._run_tape(program, feed or {}, fetch_list or [], return_numpy)

    def _run_tape(self, program: Program, feed, fetch_list, return_numpy):
        b = program._builder
        carried = list(b.carried().values())
        fetch_entries = []   # ("t", target index) | ("v", concrete value)
        targets: List[Tuple[Any, int]] = []
        for f in fetch_list:
            t = program._var_by_name(f) if isinstance(f, str) else f
            d = t._data if isinstance(t, Tensor) else t
            if isinstance(d, LazyArray) and d._value is None:
                if d._recorder is not b:
                    raise ValueError("fetch target belongs to a different Program")
                fetch_entries.append(("t", len(targets)))
                targets.append((d._node, d._idx))
            else:
                fetch_entries.append(("v", d))
        train = b.optimizer is not None
        loss_pos = None
        if train:
            optimizer, loss_lz = b.optimizer
            loss_pos = len(targets)
            targets.append((loss_lz._node, loss_lz._idx))
        carried_base = len(targets)
        targets.extend(target for _, target, _ in carried)

        key = (len(b._nodes), tuple((id(n), i) for n, i in targets), train)
        plan = program._exec_cache.get(key)
        if plan is None:
            plan = program._exec_cache[key] = _Plan(b, targets)
        missing = [n for n in plan.feed_names if n not in feed]
        if missing:
            raise KeyError(f"Executor.run missing feeds: {missing}")
        dev = self._device()
        feeds = {}
        for name, arr in feed.items():
            node = program._feeds.get(name)
            v = arr._data if isinstance(arr, Tensor) else arr
            v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            feeds[name] = v.to(device=dev, dtype=None if node is None else node.dtype)
        ext = plan.ext_values(b)
        if train:
            optimizer, _ = b.optimizer
            init_fn, update_fn = optimizer.functional()
            params = program._trainable()
            new = {n: p for n, p in params.items() if n not in program._opt_state}
            if new:      # the first run, or parameters recorded since the last
                program._opt_state.update(init_fn(new))    # (before the step, as TrainStep)
            with torch.enable_grad():
                outs = replay(plan.steps, ext, plan.targets, feeds)
                loss = outs[loss_pos]
                grads = grads_of(loss if loss.dim() == 0 else loss.sum(),
                                 list(params.values()))
            optimizer._step_count += 1
            apply_update(optimizer, update_fn, params, grads,
                         {n: program._opt_state[n] for n in params}, optimizer.get_lr(),
                         optimizer._step_count)
        else:
            with torch.no_grad():
                outs = replay(plan.steps, ext, plan.targets, feeds)
        for j, (t, _, _) in enumerate(carried):
            t._data = outs[carried_base + j].detach()
        results = []
        for kind, v in fetch_entries:
            val = outs[v] if kind == "t" else v
            if isinstance(val, torch.Tensor):
                val = val.detach()
            results.append(Tensor._wrap(val).numpy() if return_numpy and
                           isinstance(val, torch.Tensor) else
                           Tensor._wrap(val) if isinstance(val, torch.Tensor) else val)
        return results


# ---------------------------------------------------------------------------
# inference model save/load: the jit.save artifact
# ---------------------------------------------------------------------------

class ProgramModule(torch.nn.Module):
    """A replay plan as a module over its feeds, its state registered
    (the recorded layers as submodules ``m<k>``, the other inputs as
    buffers ``e<k>``), so ``torch.export`` can take it with its weights as
    inputs."""

    def __init__(self, plan: _Plan, ext_values, feed_names):
        super().__init__()
        self._plan = plan
        self._feed_names = list(feed_names)
        modules = []
        for n in plan.nodes:
            if n.module is not None and all(n.module is not m for m in modules):
                modules.append(n.module)
        for k, m in enumerate(modules):
            self.add_module(f"m{k}", m)
        self._n_ext = len(ext_values)
        for k, v in enumerate(ext_values):
            self.register_buffer(f"e{k}", v.detach() if isinstance(v, torch.Tensor)
                                 else torch.as_tensor(v))

    def forward(self, *feeds):
        ext = [getattr(self, f"e{k}") for k in range(self._n_ext)]
        outs = replay(self._plan.steps, ext, self._plan.targets,
                      dict(zip(self._feed_names, feeds)))
        return tuple(outs)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Export feeds -> fetches as ``jit.save``'s artifact, which ``jit.load``
    and ``inference.Predictor`` open unchanged; ``load_inference_model``
    returns it in the reference's ``(program, feed_names, fetch_targets)``
    shape."""
    from ..jit import export_artifact

    if program is None:
        program = default_main_program()
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) else [fetch_vars]
    b = program._builder
    if b is None:
        raise ValueError("save_inference_model needs a recorded Program "
                         "(build it under paddle.enable_static())")
    with _suspend_capture():
        feed_nodes = []
        for fv in feed_vars:
            d = fv._data
            if not (isinstance(d, LazyArray) and isinstance(d._node, _FeedNode)):
                raise ValueError("feed_vars must come from static.data")
            feed_nodes.append(d._node)
        plan = _Plan(b, [(fv._data._node, fv._data._idx) for fv in fetch_vars])
        if plan.stochastic:
            raise ValueError(
                "save_inference_model: the fetch graph contains stochastic ops "
                f"({sorted(set(plan.stochastic))}, drawing at each run); export an "
                "eval-mode graph")
        feed_names = [n.name for n in feed_nodes]
        missing = [n for n in plan.feed_names if n not in feed_names]
        if missing:
            raise ValueError(f"fetch_vars depend on undeclared feeds: {missing}")
        module = ProgramModule(plan, plan.ext_values(b), feed_names)
        specs = [(n.declared_shape, n.dtype) for n in feed_nodes]
        export_artifact(module, specs, path_prefix, feed_names=feed_names,
                        fetch_count=len(fetch_vars), device=default_device())


class _LoadedProgram:
    """An inference program loaded from the artifact; runnable through
    ``Executor.run(program, feed, fetch_list)``."""

    def __init__(self, path_prefix):
        from ..jit import load

        self._fn = load(path_prefix)
        self.feed_names = list(self._fn.meta.get("feed_names", []))
        self.fetch_count = int(self._fn.meta.get("fetch_count", 1))

    def _run(self, feed, fetch_list, return_numpy=True):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"Executor.run missing feeds: {missing}")
        outs = self._fn(*[feed[n] for n in self.feed_names])
        out_list = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        if fetch_list:
            out_list = [out_list[f.index if isinstance(f, _FetchTarget) else int(f)]
                        for f in fetch_list]
        return [o.numpy() if return_numpy else o for o in out_list]


class _FetchTarget:
    """An opaque fetch handle returned by ``load_inference_model``."""

    __slots__ = ("index", "name")

    def __init__(self, index, name=None):
        self.index = index
        self.name = name or f"fetch_{index}"

    def __repr__(self):
        return f"FetchTarget({self.name})"


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``[program, feed_target_names, fetch_targets]`` (reference
    ``static.load_inference_model``)."""
    prog = _LoadedProgram(path_prefix)
    return [prog, list(prog.feed_names), [_FetchTarget(i) for i in range(prog.fetch_count)]]
