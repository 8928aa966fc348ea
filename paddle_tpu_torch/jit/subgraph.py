"""Sub-graph (fragment) capture (port of ``paddle_tpu/jit/subgraph.py``).

The JAX package records at its one dispatch point, ``apply_op``; the port's
seam is the two entries every Paddle-level call passes through
(``framework.tensor.call_unwrapped``: layers, models, ``nn.functional`` and
the other ``boundary`` entries; ``ops.common.apply``: the op namespace),
plus ``__torch_function__`` and the operators of :class:`LazyArray` for
torch calls made on a pending value.  While a :class:`Recorder` is active:

- an entry does not run: it records the call into the current fragment and
  returns :class:`LazyArray` placeholders whose shape and dtype come from
  running the call on meta tensors (a module's call through
  ``torch.func.functional_call`` over meta copies of its state; each
  kernel entry's meta rule is its plain version, so no kernel is
  launched and none is skipped: the replay calls the entry itself);
- forcing a value (``bool`` / ``int`` / ``float`` / ``item`` / ``numpy``)
  is the graph break: the pending fragment is replayed eagerly, in
  recording order, with the ops no live value needs dropped, its values
  substituted into the live Tensors, and recording restarts;
- the cache plays the role of the reference's guards: the shapes inferred
  for a call are cached under its key (op, call-site identity (a layer's
  instance) and closure config, argument structure, input shapes and
  dtypes), so a fragment seen before, the same op sequence over the same
  shapes, is recorded without running any call on meta tensors: a cache
  hit.  A fragment with a call not seen before (another branch) is a miss.
  The hit saves the shape inference; the replay itself runs eagerly either
  way.

A call whose shapes cannot be inferred on meta tensors runs eagerly
(``eager_ops``), after a flush; a user-defined layer (one defined outside
this package) is entered instead, so its Paddle-level calls are recorded
one by one and a value read inside it breaks the graph there.  Under
``FLAGS_check_nan_inf`` every call runs eagerly and is checked, as in the
JAX package.  Capture implies ``no_grad``: recording applies only where no
gradient is needed (a call that needs one, under ``enable_grad`` inside a
capture, runs eagerly).  A fragment replays its recorded calls eagerly; the
kernels they reach launch as in an eager call.

Known limits, as the JAX package's: closure cells holding mutable objects
are keyed by identity; a Python number computed from a shape at record
time is fixed in the recorded call.
"""

from __future__ import annotations

import os
import traceback
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..framework import flags
from ..framework.dispatch import cast_to, checked, tls
from ..framework.lazy import DESCEND, EAGER, LazyArray
from ..framework.tensor import Tensor

__all__ = ["LazyArray", "Recorder", "capture", "current_recorder"]

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def current_recorder() -> Optional["Recorder"]:
    return tls.recorder


# ---------------------------------------------------------------------------
# structure of a call's arguments and outputs
# ---------------------------------------------------------------------------

def flatten(x, leaves: list):
    """``x``'s leaves appended to ``leaves``; returns its hashable structure
    (lists, tuples, named tuples and dicts are containers)."""
    if isinstance(x, (list, tuple)):
        fields = getattr(x, "_fields", None)
        kind = ("n", type(x)) if fields is not None else type(x)
        return (kind, tuple(flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple(x.keys()), tuple(flatten(v, leaves) for v in x.values()))
    leaves.append(x)
    return None


def unflatten(spec, it):
    if spec is None:
        return next(it)
    if spec[0] is dict:
        return dict(zip(spec[1], [unflatten(s, it) for s in spec[2]]))
    vals = [unflatten(s, it) for s in spec[1]]
    if isinstance(spec[0], tuple):           # a named tuple
        return spec[0][1](*vals)
    return spec[0](vals)


# ---------------------------------------------------------------------------
# structural keys (the guard system)
# ---------------------------------------------------------------------------

def cfg_key(v) -> tuple:
    """Hashable key of a constant argument or a closure cell."""
    if v is None or isinstance(v, (bool, int, float, str, bytes, complex)):
        return ("v", type(v).__name__, v)
    if isinstance(v, (torch.dtype, torch.device, np.dtype)):
        return ("dt", str(v))
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__, tuple(cfg_key(x) for x in v))
    if isinstance(v, dict):
        return ("map", tuple(sorted((str(k), cfg_key(x)) for k, x in v.items())))
    if isinstance(v, LazyArray):
        return ("lazy", tuple(v._meta.shape), str(v._meta.dtype))
    if isinstance(v, (torch.Tensor, np.ndarray)):
        # a tensor closed over: identity pins it (a fresh one a call misses
        # the cache: sound, but slow; pass such values as inputs)
        return ("arr", id(v), tuple(v.shape), str(v.dtype))
    if callable(v) and not isinstance(v, torch.nn.Module):
        return fn_key(v)
    return ("obj", id(v))        # a mutable object: its identity


def fn_key(fn) -> tuple:
    """Call-site identity plus closure config: a lambda or def makes its
    code object once, so ``id(__code__)`` is a stable site key; a bound
    method adds its receiver, a partial its bound arguments."""
    target, pre = fn, ()
    if hasattr(fn, "func") and hasattr(fn, "keywords"):          # functools.partial
        pre = (tuple(cfg_key(a) for a in fn.args), cfg_key(dict(fn.keywords or {})))
        target = fn.func
    if hasattr(target, "__self__"):
        pre = pre + (("self", id(target.__self__)),)
    target = getattr(target, "__func__", target)
    code = getattr(target, "__code__", None)
    if code is None:
        return ("fn", id(target), getattr(target, "__name__", "?"), pre)
    cells = ()
    if getattr(target, "__closure__", None):
        cells = tuple(cfg_key(c.cell_contents) for c in target.__closure__)
    return ("fn", id(code), cells, pre)


# ---------------------------------------------------------------------------
# nodes, shape inference, replay
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("name", "fn", "spec", "inputs", "tensor_pos", "out_lazies", "key", "module")

    def __init__(self, name, fn, spec, inputs, tensor_pos, key, module):
        self.name = name
        self.fn = fn
        self.spec = spec              # structure of (args, kwargs)
        self.inputs = inputs          # ("l", node, idx) | ("e", value) | ("c", value)
        self.tensor_pos = tensor_pos  # leaf positions of the output's tensors
        self.out_lazies: List = []    # weakrefs, one a tensor output
        self.key = key                # structural key of this call
        self.module = module          # the module a module call runs, else None


def _meta(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("meta")


def _module_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    state = {n: _meta(p) for n, p in module.named_parameters()}
    state.update((n, _meta(b)) for n, b in module.named_buffers())
    return state


# (inferred output structure and leaves, or the exception the inference
# raised; a weakref of the module of a module call) by structural key
_SHAPE_CACHE: Dict[tuple, Any] = {}
_SHAPE_CACHE_MAX = 4096


def replay(plan, ext, targets, feeds=None):
    """Run a plan (``(fn, spec, input specs, tensor positions)`` a node)
    eagerly; returns the values of ``targets`` (``(node position, output
    index)``, or ``("f", name)`` for a feed)."""
    env: Dict[tuple, Any] = {}
    for i, (fn, spec, ins, tpos) in enumerate(plan):
        leaves = [env[(s[1], s[2])] if s[0] == "l" else ext[s[1]] if s[0] == "e"
                  else feeds[s[1]] if s[0] == "f" else s[1] for s in ins]
        args, kwargs = unflatten(spec, iter(leaves))
        flat: list = []
        flatten(fn(*args, **kwargs), flat)
        for j, p in enumerate(tpos):
            env[(i, j)] = flat[p]
    return [feeds[t[1]] if t[0] == "f" else env[t] for t in targets]


class Recorder:
    """Accumulates calls into fragments; replays each fragment on flush."""

    # check_nan_inf forces calls to run eagerly (it reads values); a static
    # Program's builder turns this off: its values exist only in a run
    allow_eager_fallback = True

    def __init__(self, name: str = "capture"):
        self.name = name
        self._nodes: List[_Node] = []
        self._inferring = False
        self.breaks: List[dict] = []       # where and why each break happened
        self.fragments: List[dict] = []    # per-fragment stats
        self.ops_recorded = 0
        self.eager_ops = 0                 # calls that could not be deferred
        self.cache_hits = 0                # fragments recorded from the cache alone
        self.cache_misses = 0              # fragments with a call inferred on meta tensors
        self._inferred = False             # the pending fragment has such a call

    # -- the seam's entries ---------------------------------------------------
    def record_call(self, fn, args, kwargs, name=None):
        """``fn(*args, **kwargs)`` (a layer's ``__call__`` or a boundary
        entry, over unwrapped tensors) recorded; Tensor outputs.  Returns
        :data:`EAGER` when the call must run now (the seam runs it)."""
        module = getattr(fn, "__self__", None)
        if not isinstance(module, torch.nn.Module):
            module = None
        if name is None:
            name = type(module).__name__ if module is not None else getattr(fn, "__name__", "call")
        out = self.record(name, fn, args, kwargs, module)
        if out is DESCEND:
            return module.forward(*args, **kwargs)
        return out if out is EAGER else _wrap_lazies(out)

    def record_op(self, name, fn, datas):
        """Op ``name`` of the op namespace: ``fn`` over ``datas``, cast under
        the ``auto_cast`` of this moment and checked by name when it runs."""
        from ..framework.dispatch import amp_target

        target = amp_target(name)

        def op(*d):
            return checked(name, fn(*cast_to(target, d)))

        out = self.record(name, op, datas, {})
        return out if out is EAGER else _wrap_lazies(out)

    def record_torch(self, name, fn, args, kwargs):
        """A torch function or tensor method called on a pending value."""
        inplace = name.endswith("_") and not name.endswith("__")
        first = args[0] if args else None
        if inplace and not isinstance(first, LazyArray):
            return self._not_deferrable(name, "an in-place torch op writing a concrete tensor")
        out = self.record(name, fn, args, kwargs)
        if out is EAGER or not inplace or not isinstance(out, LazyArray):
            return out
        # the value an in-place op writes is its input's from now on
        first._node, first._idx, first._meta = out._node, out._idx, out._meta
        out._node.out_lazies[out._idx] = weakref.ref(first)
        return first

    # -- recording --------------------------------------------------------------
    def _input(self, leaf):
        """``(input spec, meta leaf, device)`` of one argument leaf."""
        if isinstance(leaf, Tensor):
            d = leaf._data
            if not isinstance(d, LazyArray):
                return self._ext(leaf, d), _meta(d), d.device
            leaf = d
        if isinstance(leaf, LazyArray):
            if leaf._value is None:
                if leaf._recorder is not self or leaf._aborted:
                    raise RuntimeError(
                        "a pending value of another (or an aborted) recording was used as an "
                        "op input; it has no value")
                return ("l", leaf._node, leaf._idx), leaf._meta, leaf._device
            leaf = leaf._value
        if isinstance(leaf, torch.Tensor):
            return ("e", leaf), _meta(leaf), leaf.device
        return ("c", leaf), leaf, None

    def _ext(self, tensor, data):
        """The input spec of a concrete Tensor: its value now (a static
        Program's builder keeps the Tensor, read at each run)."""
        return ("e", data)

    def _input_key(self, entry, meta):
        if entry[0] == "c":
            return cfg_key(entry[1])
        return (entry[0], tuple(meta.shape), str(meta.dtype))

    def record(self, name, fn, args, kwargs, module=None):
        """Record one call; returns its output structure with LazyArrays,
        :data:`EAGER`, or :data:`DESCEND` (enter the user-defined layer)."""
        if self.allow_eager_fallback and flags.get_flag("check_nan_inf"):
            self.eager_ops += 1
            self.flush(f"check_nan_inf active (op '{name}' runs eagerly)")
            return EAGER
        leaves: list = []
        spec = flatten((tuple(args), dict(kwargs)), leaves)
        if self.allow_eager_fallback and torch.is_grad_enabled() and _needs_grad(leaves, module):
            # the gradient comes from autograd over the eager op, as the JAX
            # package's tape takes an op that needs one
            return self._not_deferrable(name, "needs a gradient")
        inputs, metas, device = [], [], None
        for leaf in leaves:
            entry, meta, dev = self._input(leaf)
            inputs.append(entry)
            metas.append(meta)
            device = device or dev
        if device is None:
            p = next(module.parameters(), None) if module is not None else None
            if p is not None:
                device = p.device
            else:
                from ..framework.device import default_device

                device = default_device()
        key = (name, fn_key(fn), spec, tuple(self._input_key(e, m) for e, m in zip(inputs, metas)))
        cached = _SHAPE_CACHE.get(key)
        # a module's key holds its id: the entry stands only for that module
        fresh = cached is None or (cached[1] is not None and cached[1]() is not module)
        if not fresh:
            inferred = cached[0]
        else:
            inferred = self._infer(fn, spec, metas, module)
            if len(_SHAPE_CACHE) > _SHAPE_CACHE_MAX:
                _SHAPE_CACHE.clear()
            _SHAPE_CACHE[key] = (inferred, None if module is None else weakref.ref(module))
        if isinstance(inferred, BaseException):
            if module is not None and not type(module).__module__.startswith("paddle_tpu_torch"):
                return DESCEND
            return self._not_deferrable(name, inferred)
        out_spec, out_leaves = inferred
        tensor_pos = [i for i, o in enumerate(out_leaves) if isinstance(o, torch.Tensor)]
        node = _Node(name, fn, spec, inputs, tensor_pos, key, module)
        out, lazies = list(out_leaves), []
        for j, p in enumerate(tensor_pos):
            lz = LazyArray(self, node, j, out_leaves[p], device)
            lazies.append(lz)
            out[p] = lz
        node.out_lazies = [weakref.ref(v) for v in lazies]
        self._nodes.append(node)
        self._inferred = self._inferred or fresh
        self.ops_recorded += 1
        return unflatten(out_spec, iter(out))

    def _infer(self, fn, spec, metas, module):
        """``(output structure, output leaves)`` of the call on meta tensors,
        or the exception it raised."""
        from ..framework import dispatch

        args, kwargs = unflatten(spec, iter(metas))
        prev, tls.recorder = tls.recorder, None
        stats, dispatch.op_stats = dispatch.op_stats, None     # a run counts, not this
        self._inferring = tls.inferring = True
        try:
            with torch.no_grad():
                if module is not None:
                    out = torch.func.functional_call(module, _module_state(module), args, kwargs)
                else:
                    out = fn(*args, **kwargs)
        except Exception as e:   # noqa: BLE001  (the call is not abstractly evaluable)
            return e.with_traceback(None)     # cached: keep no frame alive
        finally:
            self._inferring = tls.inferring = False
            tls.recorder = prev
            dispatch.op_stats = stats
        leaves: list = []
        out_spec = flatten(out, leaves)
        return out_spec, leaves

    def _not_deferrable(self, name, why):
        """A call that cannot be recorded: flush, and let it run eagerly."""
        self.eager_ops += 1
        self.flush(f"op '{name}' not abstractly evaluable")
        return EAGER

    # -- flushing (a fragment replayed) -----------------------------------------
    def flush(self, reason: str = "explicit"):
        if not self._nodes:
            return
        if self._inferring:
            raise RuntimeError("fragment flush forced inside shape inference (a pending value "
                               "was used by closure instead of being passed as an input)")
        where = _break_site()
        nodes, self._nodes = self._nodes, []
        live = _live(nodes)
        needed = _needed(nodes, [v._node for v in live])
        pos_of = {id(n): i for i, n in enumerate(needed)}
        ext: List[Any] = []
        ext_pos: Dict[int, int] = {}
        ins_of = []
        for n in needed:
            ins = []
            for s in n.inputs:
                if s[0] == "l":
                    ins.append(("l", pos_of[id(s[1])], s[2]))
                elif s[0] == "e":
                    if id(s[1]) not in ext_pos:
                        ext_pos[id(s[1])] = len(ext)
                        ext.append(s[1])
                    ins.append(("e", ext_pos[id(s[1])]))
                else:
                    ins.append(s)
            ins_of.append(tuple(ins))
        targets = [(pos_of[id(v._node)], v._idx) for v in live]
        if self._inferred:
            self.cache_misses += 1
        else:
            self.cache_hits += 1
        self._inferred = False
        # the plan runs this recording's calls (a key names a module by its
        # id, which a later module may reuse)
        plan = tuple((n.fn, n.spec, ins, tuple(n.tensor_pos)) for n, ins in zip(needed, ins_of))
        prev, tls.recorder = tls.recorder, None
        try:
            results = replay(plan, ext, targets)
        finally:
            tls.recorder = prev
        for v, r in zip(live, results):
            _materialize(v, r)
        self.fragments.append({"ops": len(needed), "recorded": len(nodes), "reason": reason,
                               "site": where})
        if reason != "end of captured call":
            self.breaks.append({"reason": reason, "site": where,
                                "ops_before_break": len(needed)})

    # -- lifecycle --------------------------------------------------------------
    def __enter__(self):
        if tls.recorder is not None:
            raise RuntimeError("fragment capture cannot nest")
        # capture implies no_grad: deferral applies only where no gradient
        # is needed (TrainStep and static Programs train)
        self._no_grad = torch.no_grad()
        self._no_grad.__enter__()
        tls.recorder = self
        return self

    def __exit__(self, exc_type, exc, tb):
        tls.recorder = None
        self._no_grad.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.flush("end of captured call")
        else:
            self.abort()
        return False

    def abort(self):
        """Mark every pending value aborted (a later use raises clearly)."""
        for n in self._nodes:
            for ref in n.out_lazies:
                v = ref()
                if v is not None and v._value is None:
                    v._aborted = True
        self._nodes = []
        self._inferred = False

    def report(self) -> str:
        lines = [f"fragment capture '{self.name}': {self.ops_recorded} ops in "
                 f"{len(self.fragments)} fragment(s), {len(self.breaks)} graph break(s), "
                 f"{self.eager_ops} eager op(s), cache {self.cache_hits} hit/"
                 f"{self.cache_misses} miss"]
        for i, b in enumerate(self.breaks):
            lines.append(f"  break {i + 1}: {b['reason']} at {b['site']} "
                         f"({b['ops_before_break']} ops replayed before it)")
        return "\n".join(lines)


def _needs_grad(leaves, module) -> bool:
    for leaf in leaves:
        d = leaf._data if isinstance(leaf, Tensor) else leaf
        if isinstance(d, torch.Tensor) and d.requires_grad:
            return True
    return module is not None and any(p.requires_grad for p in module.parameters())


def _live(nodes) -> List[LazyArray]:
    """Pending values still referenced (by Tensors or user code)."""
    live, seen = [], set()
    for n in nodes:
        for ref in n.out_lazies:
            v = ref()
            if v is not None and v._value is None and id(v) not in seen:
                seen.add(id(v))
                live.append(v)
    return live


def _needed(nodes, roots, sources=()) -> list:
    """The nodes ``roots`` depend on, in recording order."""
    node_pos = {id(n): i for i, n in enumerate(nodes)}
    needed = set()
    stack = [n for n in roots if not isinstance(n, sources)]
    while stack:
        n = stack.pop()
        if id(n) in needed:
            continue
        if id(n) not in node_pos:
            raise ValueError("a target was not recorded in this recording")
        needed.add(id(n))
        stack.extend(s[1] for s in n.inputs if s[0] == "l" and not isinstance(s[1], sources))
    return [n for n in nodes if id(n) in needed]


def _materialize(v: LazyArray, value) -> None:
    """Set ``v``'s value and substitute it into every Tensor wrapping it."""
    v._value = value
    for tref in v._tensors:
        t = tref()
        if t is not None and t._data is v:
            t._data = value


def _wrap_lazies(out):
    if isinstance(out, LazyArray):
        return Tensor._wrap(out)
    if isinstance(out, (list, tuple)) and not hasattr(out, "_fields"):
        return type(out)(_wrap_lazies(v) for v in out)
    if isinstance(out, dict):
        return {k: _wrap_lazies(v) for k, v in out.items()}
    return out


def _break_site() -> str:
    """The first stack frame outside this package and torch: where user code
    forced the value."""
    for frame in reversed(traceback.extract_stack()):
        fname = frame.filename
        if not fname.startswith(_PACKAGE) and "site-packages" not in fname \
                and f"{os.sep}torch{os.sep}" not in fname:
            return f"{fname}:{frame.lineno} ({frame.name})"
    return "<unknown>"


def capture(name: str = "capture") -> Recorder:
    """Context manager: run eager code with fragment capture::

        with jit.capture("my_model") as rec:
            out = model(x)          # data-dependent branching is fine
        print(rec.report())

    Calls batch into fragments replayed at each graph break; Python control
    flow on tensor values cuts fragments (logged as graph breaks)."""
    return Recorder(name)
