"""``paddle_tpu_torch.jit`` (port of ``paddle_tpu/jit/__init__.py``).

- :class:`TrainStep`: JAX compiles forward, backward and the optimizer into
  one XLA program; the port runs them eagerly: the loss function under
  autograd, then the optimizer's functional update over the parameters, in
  place.
- :func:`to_static`: the call is recorded once per input signature at the
  recording seam (``jit.subgraph``; a layer call is one node that runs the
  layer) and the recorded program replays on every later call; where the
  Python reads a value (data-dependent control flow) the signature falls
  back to fragment capture (:func:`capture`): recorded fragments stitched
  at the graph breaks, each reported.  ``full_graph=True`` raises instead.
  A replay runs the recorded calls eagerly: the kernels they reach launch as
  in an eager call (capturing fragments into CUDA graphs is later work).
- :func:`save` exports a layer's forward with ``torch.export`` (the kernel
  entries as the custom ops of ``kernels.export_ops``), the weights as its
  inputs: ``<path>.pt2`` (the program), ``<path>.pdiparams`` (the weights,
  in the JAX package's ``{"params", "buffers"}`` layout and ``save`` format)
  and ``<path>.pdmodel.json`` (the inputs); :func:`load` runs it in a
  process that never built the layer.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from .. import to_dtype
from ..framework.device import default_device
from ..framework.dispatch import tls
from ..framework.lazy import LazyArray
from ..framework.tensor import Tensor, unwrap, wrap
from . import subgraph
from .subgraph import capture

__all__ = ["to_static", "not_to_static", "TrainStep", "functional_call", "ignore_module",
           "enable_to_static", "set_verbosity", "set_code_level", "TranslatedLayer",
           "save", "load", "bucketed", "capture"]


def functional_call(layer, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                    *args, rng_key=None, **kwargs):
    """Run ``layer`` as a function of ``(params, buffers, inputs)``
    (``torch.func.functional_call``); Tensors in, Tensors out.  Autograd
    runs through it (torch's counterpart of ``jax.grad`` over the JAX
    one).  The layers draw from their own generators: ``rng_key`` must be
    None."""
    if rng_key is not None:
        raise NotImplementedError("paddle_tpu_torch: layers draw from their generators; "
                                  "functional_call takes no rng_key")
    out = torch.func.functional_call(layer, (unwrap(params), unwrap(buffers)),
                                     tuple(unwrap(args)), unwrap(kwargs))
    return wrap(out)


class _GraphBreak(Exception):
    """Whole-graph recording met a value read (or a call it cannot record)."""


@functools.lru_cache(maxsize=None)
def _trace_builder():
    """The builder of a whole-graph recording: the static builder, with a
    break (or a call it cannot record) ending the recording.  Made at first
    use: ``static.graph`` imports this package."""
    from ..static.graph import StaticBuilder

    class TraceBuilder(StaticBuilder):
        def flush(self, reason="explicit"):
            if not self._nodes and reason == "end of captured call":
                return
            raise _GraphBreak(reason)

        def _not_deferrable(self, name, why):
            raise _GraphBreak(f"op '{name}' cannot be recorded ({why!r})")

    return TraceBuilder


class _Recorded:
    """One input signature's recorded program: its replay plan, the feed of
    each tensor argument and the output structure."""

    def __init__(self, builder, plan, feed_pos, out_spec, out_leaves):
        self.builder = builder
        self.plan = plan
        self.feed_pos = feed_pos          # leaf position of each feed, in feed order
        self.out_spec = out_spec
        self.out_leaves = out_leaves      # ("t", target index) | ("c", constant)

    def run(self, leaves):
        feeds = {f"@arg{i}": _data(leaves[p]) for i, p in enumerate(self.feed_pos)}
        with torch.no_grad():
            outs = subgraph.replay(self.plan.steps, self.plan.ext_values(self.builder),
                                   self.plan.targets, feeds)
        vals = [Tensor._wrap(outs[v]) if k == "t" else v for k, v in self.out_leaves]
        return subgraph.unflatten(self.out_spec, iter(vals))


def _data(x):
    return x._data if isinstance(x, Tensor) else x


def _is_tensor(x):
    return isinstance(x, (Tensor, torch.Tensor))


class StaticFunction:
    """A layer or function recorded once per input signature and replayed.

    Code the recording cannot take whole (a value read: data-dependent
    Python control flow, host side effects) falls back, for that signature,
    to fragment capture with a one-time warning carrying the break report;
    ``full_graph=True`` raises instead."""

    def __init__(self, fn_or_layer, input_spec=None, full_graph=False, backend=None):
        self._is_layer = isinstance(fn_or_layer, torch.nn.Module)
        self._target = fn_or_layer
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._programs: Dict[tuple, _Recorded] = {}
        self._fallback_sigs = set()
        self._reported_breaks = False
        self._last_capture = None      # the last fragment Recorder (diagnostics)

    def _signature(self, leaves):
        sig = tuple((tuple(_data(a).shape), str(_data(a).dtype), str(_data(a).device))
                    if _is_tensor(a) else subgraph.cfg_key(a) for a in leaves)
        return sig + ((self._target.training,) if self._is_layer else ())

    def _call_eager(self, args, kwargs):
        with torch.no_grad():
            return self._target(*args, **kwargs)

    def _call_fragments(self, args, kwargs):
        name = getattr(self._target, "__name__", type(self._target).__name__)
        rec = subgraph.Recorder(name)
        with rec:
            out = self._target(*_as_tensors(args), **_as_tensors(kwargs))
        self._last_capture = rec
        if not self._reported_breaks:
            self._reported_breaks = True
            import warnings

            warnings.warn(f"to_static({name}): whole-graph recording broke; running with "
                          f"fragment capture instead.\n{rec.report()}", RuntimeWarning,
                          stacklevel=3)
        return out

    def _record(self, leaves, spec):
        from ..static.graph import _FeedNode, _Plan

        builder = _trace_builder()(program=_Anchor())
        args = []
        feed_pos = []
        for i, a in enumerate(leaves):
            if _is_tensor(a):
                d = _data(a)
                node = _FeedNode(f"@arg{len(feed_pos)}", tuple(d.shape), d.dtype)
                feed_pos.append(i)
                args.append(Tensor._wrap(LazyArray(builder, node, 0, d.detach().to("meta"),
                                                   d.device)))
            else:
                args.append(a)
        call_args, call_kwargs = subgraph.unflatten(spec, iter(args))
        prev, tls.recorder = tls.recorder, builder
        try:
            with torch.no_grad():
                out = self._target(*call_args, **call_kwargs)
        finally:
            tls.recorder = prev
        out_leaves: list = []
        out_spec = subgraph.flatten(out, out_leaves)
        targets, entries = [], []
        for o in out_leaves:
            d = _data(o)
            if isinstance(d, LazyArray) and d._value is None and d._recorder is builder:
                entries.append(("t", len(targets)))
                targets.append((d._node, d._idx))
            else:
                entries.append(("c", o))
        plan = _Plan(builder, targets)
        return _Recorded(builder, plan, feed_pos, out_spec, entries)

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            return self._call_eager(args, kwargs)
        leaves: list = []
        spec = subgraph.flatten((tuple(args), dict(kwargs)), leaves)
        sig = (spec, self._signature(leaves))
        if sig in self._fallback_sigs:
            return self._call_fragments(args, kwargs)
        prog = self._programs.get(sig)
        if prog is None:
            try:
                prog = self._record(leaves, spec)
            except _GraphBreak:
                if self._full_graph:
                    raise
                self._fallback_sigs.add(sig)
                return self._call_fragments(args, kwargs)
            self._programs[sig] = prog
        return prog.run(leaves)

    # the paddle API surface
    @property
    def forward(self):
        return self

    def concrete_program_specify_input_spec(self, *a, **k):
        return None


class _Anchor:
    """What a whole-graph recording's builder points back to (no Program)."""


def _as_tensors(x):
    """torch tensors among the arguments as Tensors (the recording seam
    records calls that hold Tensors)."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_as_tensors(v) for v in x)
    if isinstance(x, dict):
        return {k: _as_tensors(v) for k, v in x.items()}
    return x


def to_static(function=None, input_spec=None, build_strategy=None, backend=None, **kwargs):
    """Decorator / wrapper recording a function or layer
    (``paddle.jit.to_static``, reference ``python/paddle/jit/api.py``)."""

    def decorate(fn):
        full_graph = bool(kwargs.get("full_graph", False))
        if isinstance(fn, torch.nn.Module):
            static = StaticFunction(fn, input_spec, full_graph=full_graph)
            fn.forward_static = static
            fn._static_function = static
            return fn if kwargs.get("inplace", False) else static
        return functools.wraps(fn)(StaticFunction(fn, input_spec, full_graph=full_graph))

    if function is not None:
        return decorate(function)
    return decorate


def bucketed(fn=None, *, axes, buckets=None, pad_value=0, out_axes=None,
             size_range=None, max_overhead=0.25):
    """Shape bucketing: pad the dynamic ``axes`` (``(arg_index, axis)``
    pairs) up to the next bucket, so one recorded program serves every size
    of a bucket, and cut the outputs back.

    ``buckets``: ascending sizes (default powers of two); ``"auto"``
    synthesises the smallest ladder over ``size_range=(lo, hi)`` whose
    padding waste stays under ``max_overhead``
    (``framework.dim_expr.synthesize_buckets``; the bound is
    ``wrapper._bucket_waste_bound``).  ``out_axes``: ``(out_axis,
    arg_index, in_axis)`` triples cut on every output; without it each
    output's first axis of a padded bucket's size is cut (the leading-batch
    convention), and two axes padded to one bucket from different lengths
    raise."""

    def decorate(f):
        static = StaticFunction(f) if not isinstance(f, StaticFunction) else f
        ladder = buckets
        waste_bound = None
        if buckets == "auto":
            from ..framework.dim_expr import synthesize_buckets

            if size_range is None:
                raise ValueError('buckets="auto" needs size_range=(lo, hi)')
            ladder, waste_bound = synthesize_buckets(int(size_range[0]), int(size_range[1]),
                                                     max_overhead=max_overhead)

        def next_bucket(n: int) -> int:
            if ladder is not None:
                for b in sorted(ladder):
                    if b >= n:
                        return int(b)
                raise ValueError(f"size {n} exceeds the largest bucket {max(ladder)}")
            b = 1
            while b < n:
                b *= 2
            return b

        @functools.wraps(f if not isinstance(f, StaticFunction) else f._target)
        def wrapper(*args, **kw):
            args = list(args)
            pads = []  # (arg_index, in_axis, bucket, original)
            for i, ax in axes:
                t = args[i]
                raw = _data(t) if _is_tensor(t) else torch.as_tensor(np.asarray(t))
                n = int(raw.shape[ax])
                b = next_bucket(n)
                if b != n:
                    widths = [0, 0] * raw.dim()
                    widths[2 * (raw.dim() - 1 - ax) + 1] = b - n
                    raw = torch.nn.functional.pad(raw, widths, value=pad_value)
                    args[i] = Tensor._wrap(raw) if isinstance(t, Tensor) else raw
                pads.append((i, ax, b, n))
            out = static(*args, **kw)

            bucket_orig: Dict[int, int] = {}
            for _, _, b, n in pads:
                if b == n:
                    continue
                if out_axes is None and b in bucket_orig and bucket_orig[b] != n:
                    raise ValueError(
                        f"ambiguous output slicing: two bucketed axes padded to bucket {b} "
                        f"from different lengths ({bucket_orig[b]} and {n}); pass "
                        f"out_axes=[...]")
                bucket_orig[b] = n

            def unslice(o):
                if isinstance(o, dict):
                    return {k: unslice(v) for k, v in o.items()}
                if isinstance(o, (list, tuple)):
                    return type(o)(unslice(v) for v in o)
                if not _is_tensor(o):
                    return o
                raw = _data(o)
                idx = [slice(None)] * raw.dim()
                cut = False
                if out_axes is not None:
                    for oax, i, iax in out_axes:
                        for pi, pax, b, n in pads:
                            if pi == i and pax == iax and b != n:
                                idx[oax] = slice(0, n)
                                cut = True
                else:
                    remaining = dict(bucket_orig)
                    for d, size in enumerate(raw.shape):
                        if size in remaining:
                            idx[d] = slice(0, remaining.pop(size))
                            cut = True
                if not cut:
                    return o
                sliced = raw[tuple(idx)]
                return Tensor._wrap(sliced) if isinstance(o, Tensor) else sliced

            return unslice(out)

        wrapper._static = static
        wrapper._buckets = tuple(sorted(ladder)) if ladder else None
        wrapper._bucket_waste_bound = waste_bound
        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


def grads_of(loss, params):
    """The gradients of ``loss`` with respect to ``params`` (a list) by
    autograd; zeros for a parameter ``loss`` does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def apply_update(optimizer, update_fn, params: Dict, grads, opt_state: Dict, lr, step) -> None:
    """The update of one training step, :class:`TrainStep`'s and a static
    Program's (``static.Executor.run``): ``optimizer``'s ``grad_clip`` over
    ``grads`` (a list in ``params``' order), then its functional
    ``update_fn`` of ``params`` and ``opt_state`` (dicts by the same names)
    in place."""
    clip = optimizer._grad_clip
    if clip is not None:
        grads = [g for _, g in clip([(None, g) for g in grads])]
    update_fn(params, dict(zip(params, grads)), opt_state, lr, step)


class TrainStep:
    """One training step: forward, backward and the optimizer update.

    Usage::

        def loss_fn(model, ids):
            return model.compute_loss(model(ids), ids)

        step = paddle_tpu_torch.jit.TrainStep(model, loss_fn, optimizer)
        loss = step(ids)                      # updates model params in place

    ``grad_dtype`` (e.g. ``"bfloat16"``) casts the gradients before the
    update.  ``accumulate_steps`` > 1: every argument carries a leading
    micro-batch axis of that length; each micro-batch's gradients are summed
    in fp32 (or ``grad_dtype``), divided by k, and one update is applied;
    the returned loss is the micro-batch mean.  The optimizer's
    ``grad_clip`` is applied before the update.

    :meth:`state_dict` / :meth:`set_state_dict` are the resume surface
    (``distributed.fleet.CheckpointManager`` saves and loads through them),
    with the JAX ``TrainStep``'s flat keys.

    Not yet ported (they raise ``NotImplementedError``): ``grads_fn`` /
    ``host_grads`` (pipeline schedules) and ``remat`` policies (use
    ``LlamaConfig.recompute``).  ``donate`` is accepted for the JAX
    signature; updates are in place.
    """

    def __init__(self, model, loss_fn, optimizer, donate: bool = True, grads_fn=None,
                 grad_dtype=None, accumulate_steps: int = 1, remat=None,
                 host_grads: bool = False):
        accumulate_steps = int(accumulate_steps)
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        if grads_fn is not None or host_grads:
            raise NotImplementedError("paddle_tpu_torch: grads_fn / host_grads come with "
                                      "the pipeline slice")
        if remat not in (None, "off"):
            raise NotImplementedError("paddle_tpu_torch: TrainStep remat policies come "
                                      "later; use LlamaConfig.recompute")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = accumulate_steps
        self.grad_dtype = None if grad_dtype is None else to_dtype(grad_dtype)
        self._params = dict(model.named_parameters())
        init_fn, self._update_fn = optimizer.functional()
        self._opt_state = init_fn(self._params)
        self._step = 0

    def _grads(self, args):
        loss = self.loss_fn(self.model, *args)
        return loss.detach(), grads_of(loss, list(self._params.values()))

    def __call__(self, *args):
        device = next(iter(self._params.values())).device
        args = tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
                     for a in args)
        self._step += 1
        lr = self.optimizer.get_lr()
        k = self.accumulate_steps
        if k > 1:
            acc_dt = self.grad_dtype or torch.float32
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            acc = None
            for i in range(k):
                mloss, mgrads = self._grads(tuple(a[i] for a in args))
                mgrads = [g.to(acc_dt) for g in mgrads]
                acc = mgrads if acc is None else [a + g for a, g in zip(acc, mgrads)]
                loss_sum = loss_sum + mloss.to(torch.float32)
            inv = 1.0 / k
            grads = [g * torch.tensor(inv, dtype=g.dtype) for g in acc]
            loss = loss_sum * inv
        else:
            loss, grads = self._grads(args)
            if self.grad_dtype is not None:
                grads = [g.to(self.grad_dtype) for g in grads]
        apply_update(self.optimizer, self._update_fn, self._params, grads, self._opt_state,
                     lr, self._step)
        return loss

    # -- checkpoint/resume surface (used by fleet.CheckpointManager) --------

    def state_dict(self):
        """Flat dict of everything a resume needs, keyed as the JAX
        ``TrainStep.state_dict``: ``param.<name>``; every optimizer slot as
        ``opt['<name>']['<slot>']`` (``jax.tree_util.keystr``'s form of its
        path, so a positional shift can never load one layer's moments into
        another); ``step``; the LR scheduler's numeric fields as
        ``lr_sched.<field>``.  Values are the live tensors on the step's
        device (the scheduler's and the step counter's new 0-d ones; floats
        in float64, so a resume reproduces the schedule's every bit)."""
        from ..optimizer.lr import LRScheduler

        device = next(iter(self._params.values())).device
        flat = {f"param.{n}": p.detach() for n, p in self._params.items()}
        for n, slots in self._opt_state.items():
            for k, t in slots.items():
                flat[f"opt{_keystr(n, k)}"] = t
        flat["step"] = torch.tensor(self._step, dtype=torch.int32, device=device)
        if isinstance(self.optimizer._lr, LRScheduler):
            for k, v in self.optimizer._lr.state_dict().items():
                if isinstance(v, (bool, int, float)):
                    dt = (torch.bool if isinstance(v, bool) else
                          torch.int64 if isinstance(v, int) else torch.float64)
                    flat[f"lr_sched.{k}"] = torch.tensor(v, dtype=dt, device=device)
        return flat

    @torch.no_grad()
    def set_state_dict(self, flat):
        """Load :meth:`state_dict`'s layout (also one the JAX ``TrainStep``
        wrote): params and slots are copied IN PLACE, each in its own dtype,
        so the optimizer's kernel table stays valid; a missing key or a
        shape that differs raises before anything is written."""
        from ..optimizer.lr import LRScheduler

        pairs = [(p, flat[f"param.{n}"]) for n, p in self._params.items()]
        pairs += [(t, flat[f"opt{_keystr(n, k)}"]) for n, slots in self._opt_state.items()
                  for k, t in slots.items()]
        for dst, src in pairs:
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"state_dict: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        for dst, src in pairs:
            dst.copy_(torch.as_tensor(np.asarray(src)) if not isinstance(src, torch.Tensor)
                      else src)
        self._step = int(flat["step"])
        if isinstance(self.optimizer._lr, LRScheduler):
            sched = self.optimizer._lr
            for k, cur in sched.state_dict().items():
                fk = f"lr_sched.{k}"
                if fk in flat and isinstance(cur, (bool, int, float)):
                    sched.__dict__[k] = type(cur)(flat[fk].item() if hasattr(flat[fk], "item")
                                                  else flat[fk])


def _keystr(name: str, slot: str) -> str:
    """``jax.tree_util.keystr`` of the path ``(name, slot)`` through a dict
    of dicts."""
    return f"[{name!r}][{slot!r}]"


# ---------------------------------------------------------------------------
# save / load: the torch.export artifact
# ---------------------------------------------------------------------------

class _Bound(torch.nn.Module):
    """``call(module, *inputs)`` as a module's forward (``module`` is its
    one submodule, so its weights are this module's under ``module.``)."""

    def __init__(self, module, call):
        super().__init__()
        self.module = module
        self._call = call

    def forward(self, *inputs):
        return self._call(self.module, *inputs)


class _Pure(torch.nn.Module):
    """``module``'s forward, or ``call(module, *inputs)``, as a function of
    its weights and inputs."""

    def __init__(self, module, call=None):
        super().__init__()
        # not a submodule: its tensors are inputs
        self._held = [module if call is None else _Bound(module, call)]
        self._prefix = "" if call is None else "module."

    def forward(self, params, buffers, *inputs):
        p = self._prefix
        return torch.func.functional_call(
            self._held[0], ({p + k: v for k, v in params.items()},
                            {p + k: v for k, v in buffers.items()}), inputs)


def _state(module):
    params = {n: p.detach() for n, p in module.named_parameters()}
    buffers = {n: b.detach() for n, b in module.named_buffers()}
    return params, buffers


def export_artifact(module, specs, path, feed_names=None, fetch_count=None, device=None,
                    call=None, meta=None):
    """Export ``module``'s forward (or ``call(module, *inputs)``) over
    inputs of ``specs`` (``(shape, dtype)``, a None or -1 dim dynamic) and
    write ``path.pt2``, ``path.pdiparams`` (``module``'s weights by their
    own names) and ``path.pdmodel.json`` (with ``meta``'s items); returns
    the bytes written."""
    from ..framework.io import save as _save
    from ..kernels import export_ops

    params, buffers = _state(module)
    if device is None:
        first = next(iter(params.values()), None)
        device = first.device if first is not None else default_device()
    examples, dynamic = [], []
    for shape, dtype in specs:
        dims = [2 if (s is None or s == -1) else int(s) for s in shape]
        examples.append(torch.zeros(dims, dtype=to_dtype(dtype), device=device))
        auto = {i: torch.export.Dim.AUTO for i, s in enumerate(shape) if s is None or s == -1}
        dynamic.append(auto or None)
    prev, tls.recorder = tls.recorder, None
    try:
        with torch.no_grad(), export_ops.export_trace():
            ep = torch.export.export(
                _Pure(module, call), (params, buffers, *examples),
                dynamic_shapes=({n: None for n in params}, {n: None for n in buffers},
                                tuple(dynamic)), strict=False)
    finally:
        tls.recorder = prev
    ep.example_inputs = None       # they hold the weights: those go to .pdiparams
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.export.save(ep, path + ".pt2")
    _save({"params": params, "buffers": buffers}, path + ".pdiparams")
    info = {"inputs": [{"shape": [None if (s is None or s == -1) else int(s) for s in shape],
                        "dtype": str(to_dtype(dtype)).replace("torch.", "")}
                       for shape, dtype in specs],
            "format": "torch.export",
            "feed_names": list(feed_names or [f"input_{i}" for i in range(len(specs))])}
    if fetch_count is not None:
        info["fetch_count"] = int(fetch_count)
    info.update(meta or {})
    with open(path + ".pdmodel.json", "w") as f:
        json.dump(info, f)
    return sum(os.path.getsize(path + ext) for ext in (".pt2", ".pdiparams", ".pdmodel.json"))


def save(layer, path, input_spec=None, **configs):
    """Export a layer's forward (reference ``paddle.jit.save``): its program
    through ``torch.export``, the kernel entries as custom ops, and its
    weights (:func:`export_artifact`).  Needs ``input_spec``
    (``static.InputSpec`` s)."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    if input_spec is None:
        raise ValueError("jit.save needs input_spec=[static.InputSpec(shape, dtype), ...] "
                         "to trace the exported program")
    return export_artifact(layer, [(spec.shape, spec.dtype) for spec in input_spec], path)


class _LoadedFunction:
    """The callable a ``jit.save`` artifact loads into."""

    def __init__(self, path, device=None):
        from .. import kernels  # noqa: F401  (registers the kernel entries' custom ops)
        from ..framework.io import load as _load

        with open(path + ".pdmodel.json") as f:
            self.meta = json.load(f)
        self._program = torch.export.load(path + ".pt2").module()
        dev = default_device(device)
        state = _load(path + ".pdiparams")
        self._params = {k: v._data.detach().to(dev) for k, v in state["params"].items()}
        self._buffers = {k: v._data.detach().to(dev) for k, v in state["buffers"].items()}
        self.device = dev

    def __call__(self, *inputs):
        raw = [_data(i) if _is_tensor(i) else torch.as_tensor(np.asarray(i)) for i in inputs]
        raw = [r.to(self.device) for r in raw]
        with torch.no_grad():
            out = self._program(self._params, self._buffers, *raw)
        return wrap(out)

    def eval(self):
        return self

    @property
    def forward(self):
        return self


def load(path, device=None, **configs):
    """Load a ``jit.save`` artifact as a callable (reference
    ``paddle.jit.load``), its weights on ``device`` (default: the current
    device)."""
    return TranslatedLayer(_LoadedFunction(path, device))


# -- reference jit utility surface ------------------------------------------

_to_static_enabled = True


def enable_to_static(enable: bool = True) -> None:
    """Globally toggle ``to_static`` (reference ``paddle.jit.enable_to_static``):
    when off, decorated functions run eagerly."""
    global _to_static_enabled
    _to_static_enabled = bool(enable)


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    """Recording log verbosity (reference ``jit.set_verbosity``)."""
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level >= 3 else logging.INFO if level >= 1 else logging.WARNING)


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """Reference ``jit.set_code_level``: here the log of recorded programs."""
    set_verbosity(3 if level else 0, also_to_stdout)


class TranslatedLayer:
    """A loaded inference program as a callable layer (reference
    ``TranslatedLayer``, what :func:`load` returns)."""

    def __init__(self, program):
        self._program = program

    @property
    def meta(self):
        return self._program.meta

    def __call__(self, *args, **kwargs):
        return self._program(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._program(*args, **kwargs)

    def eval(self):
        return self
