"""``paddle_tpu_torch.profiler`` (port of ``paddle_tpu/profiler``;
reference: ``python/paddle/profiler/`` and its C++ tracers).

Host side: ``RecordEvent`` spans are recorded by the native host tracer
(``core/csrc/host_tracer.cc``: steady-clock ns, per-thread buffers), loaded
through ``core.native.load()``; a failed native build raises, nothing falls
back to a Python store.  ``Profiler.stop()`` drains the spans into one
stream that ``summary()``, ``export_chrome_tracing`` and
``export_protobuf`` read.  Files use the JAX package's schema
(``"paddle_tpu.profiler/1"``), so each package loads the other's.

Device side: where the JAX package starts ``jax.profiler`` this starts
``torch.profiler`` (CPU and CUDA activities) when ``PADDLE_TPU_PROFILE_DIR``
is set and ``timer_only`` is false, and writes its chrome trace into that
directory at ``stop()`` (``Profiler.device_trace_path``).  ``summary()``
reads host spans only, as the JAX one does.

As in the JAX package, the ``scheduler`` is stored and not consulted:
``step()`` counts steps, and a profiler records from ``start()`` to
``stop()``.  The XLA fusion audit (``profiler.fusion_audit``) is not part
of the port.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from enum import Enum
from typing import Callable, List, Optional

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState", "make_scheduler",
           "export_chrome_tracing", "benchmark", "Timer", "SortedKeys", "SummaryView",
           "export_protobuf", "load_profiler_result", "ProfilerResult"]

SCHEMA = "paddle_tpu.profiler/1"


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    TPU = 3
    CUSTOM_DEVICE = 4


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class _EventStore:
    """The drained host spans of the last session (chrome-trace ``X``
    events, microseconds)."""

    def __init__(self):
        self.events: List[dict] = []
        self.enabled = False


_store = _EventStore()


def _native():
    from ..core import native

    return native.load()


def _drain_native_events(lib):
    """Move the spans recorded in C++ into ``_store.events``."""
    if lib.ptt_num_events() == 0:
        return
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        if lib.ptt_export_chrome(tmp.encode(), os.getpid()) != 0:
            raise RuntimeError(f"host tracer: export to {tmp} failed")
        with open(tmp) as f:
            for ev in json.load(f).get("traceEvents", []):
                if ev.get("ph") == "X":
                    ev["cat"] = "host"
                    _store.events.append(ev)
        lib.ptt_clear()
    finally:
        os.unlink(tmp)


class RecordEvent:
    """Host-side scoped annotation (reference ``phi::RecordEvent``): a span
    in the native tracer while a profiler records, nothing otherwise."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._lib = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        if _store.enabled:
            self._lib = _native()
            self._lib.ptt_begin(self.name.encode())

    def end(self):
        if self._lib is not None:
            self._lib.ptt_end()
            self._lib = None


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0, skip_first: int = 0):
    total = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None) -> Callable:
    """``on_trace_ready`` handler writing the host spans as a chrome trace."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name, f"{worker_name or 'worker'}_{int(time.time())}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": _store.events}, f)

    return handler


def _summary_table(events) -> str:
    by_name = {}
    for e in events:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"] / 1e3
        d[1] += 1
    lines = [f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}"]
    for name, (tot, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name:<40}{calls:>8}{tot:>12.3f}")
    return "\n".join(lines)


class Profiler:
    """Host spans from ``start()`` to ``stop()``; with
    ``PADDLE_TPU_PROFILE_DIR`` set (and ``timer_only`` false) also a
    ``torch.profiler`` trace of ``targets`` (default: the CPU, and CUDA
    where there is a card) written there at ``stop()``."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None, timer_only=False,
                 record_shapes=False, profile_memory=False, with_flops=False):
        self.scheduler = scheduler if callable(scheduler) else None
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=lo, ready=0, record=hi - lo, repeat=1)
        self.on_trace_ready = on_trace_ready
        self.step_num = 0
        self.timer_only = timer_only
        self.targets = targets
        self._torch_kw = dict(record_shapes=record_shapes, profile_memory=profile_memory,
                              with_flops=with_flops)
        self._device = None
        self._device_dir = None
        self.device_trace_path: Optional[str] = None

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity

        targets = (self.targets if self.targets is not None
                   else [ProfilerTarget.CPU, ProfilerTarget.GPU])
        acts = []
        if ProfilerTarget.CPU in targets:
            acts.append(ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self):
        lib = _native()
        lib.ptt_clear()
        lib.ptt_enable()
        _store.enabled = True
        _store.events.clear()
        logdir = os.environ.get("PADDLE_TPU_PROFILE_DIR")
        if logdir and not self.timer_only:
            import torch.profiler

            self._device_dir = logdir
            self._device = torch.profiler.profile(activities=self._activities(),
                                                  **self._torch_kw)
            self._device.start()

    def stop(self):
        _store.enabled = False
        lib = _native()
        lib.ptt_disable()
        _drain_native_events(lib)
        if self._device is not None:
            self._device.stop()
            os.makedirs(self._device_dir, exist_ok=True)
            self.device_trace_path = os.path.join(
                self._device_dir, f"device_{os.getpid()}_{time.time_ns()}.json")
            self._device.export_chrome_trace(self.device_trace_path)
            self._device = None
        if self.on_trace_ready:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        self.step_num += 1

    def step_info(self, unit=None):
        return f"step {self.step_num}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False, time_unit="ms"):
        return _summary_table(_store.events)


class Timer:
    """Throughput timer (reference: ``python/paddle/profiler/timer.py`` ips)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self.steps = 0
        self.samples = 0
        self.elapsed = 0.0

    def begin(self):
        self._start = time.perf_counter()

    def step(self, num_samples=1):
        if self._start is None:
            self.begin()
            return
        now = time.perf_counter()
        self.elapsed += now - self._start
        self._start = now
        self.steps += 1
        self.samples += num_samples

    def ips(self):
        return self.samples / self.elapsed if self.elapsed else 0.0

    def step_time(self):
        return self.elapsed / self.steps if self.steps else 0.0


def benchmark():
    return Timer()


class SortedKeys(Enum):
    """Sort orders for :meth:`Profiler.summary` (reference
    ``profiler_statistic.py:49``)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(Enum):
    """Summary views (reference ``profiler.py:55``)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class ProfilerResult:
    """Loaded profiler data: the host spans and their summary table (what
    :func:`load_profiler_result` returns)."""

    def __init__(self, events, meta=None):
        self.events = events
        self.meta = meta or {}

    def time_items(self):
        return self.events

    def summary(self):
        return _summary_table(self.events)


def export_protobuf(dir_name: str, worker_name: Optional[str] = None) -> Callable:
    """``on_trace_ready`` handler writing the host spans as the JAX
    package's versioned JSON container, which :func:`load_profiler_result`
    reads back."""

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name,
                            f"{worker_name or 'worker'}_{int(time.time())}.pb.json")
        with open(path, "w") as f:
            json.dump({"schema": SCHEMA, "events": _store.events,
                       "meta": {"pid": os.getpid()}}, f)

    return handler


def load_profiler_result(filename: str) -> ProfilerResult:
    """Load a file written by :func:`export_protobuf` (of either package)."""
    with open(filename) as f:
        payload = json.load(f)
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"{filename} is not a paddle_tpu profiler result "
                         f"(schema={payload.get('schema')!r})")
    return ProfilerResult(payload["events"], payload.get("meta"))
