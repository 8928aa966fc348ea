"""paddle_tpu_torch's measuring surface against paddle_tpu's (CPU):
``profiler`` (the scheduler, host spans through the native tracer, the
summary table, files that each package loads from the other), ``device``
and ``device.cuda`` without a card, the stream surface of
``framework.device`` on the CPU, ``version`` and ``sysconfig``.
"""

import io
import json
import os
import time
from contextlib import redirect_stdout

import pytest
import torch

import paddle_tpu.device as j_device
import paddle_tpu.profiler as j_prof
import paddle_tpu.version as j_version
import paddle_tpu_torch as tp
import paddle_tpu_torch.device as t_device
import paddle_tpu_torch.profiler as t_prof
import paddle_tpu_torch.version as t_version
from paddle_tpu_torch import sysconfig as t_sysconfig
from paddle_tpu_torch.core import native
from paddle_tpu_torch.framework import device as t_fdev


@pytest.fixture
def on_cpu():
    prev = t_fdev._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


# -- profiler -----------------------------------------------------------------

@pytest.mark.parametrize("closed, ready, record, repeat, skip_first", [
    (0, 0, 1, 0, 0), (1, 1, 2, 0, 0), (2, 0, 3, 1, 0), (1, 2, 1, 2, 3), (3, 1, 4, 0, 2),
])
def test_make_scheduler_states_equal_jax(closed, ready, record, repeat, skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat, skip_first=skip_first)
    j, t = j_prof.make_scheduler(**kw), t_prof.make_scheduler(**kw)
    assert [t(s).name for s in range(40)] == [j(s).name for s in range(40)]


def test_profiler_tuple_scheduler_and_step_count():
    """A (start, end) scheduler becomes make_scheduler's; step() counts
    only, as in the JAX package."""
    j, t = j_prof.Profiler(scheduler=(2, 5)), t_prof.Profiler(scheduler=(2, 5))
    assert [t.scheduler(s).name for s in range(10)] == [j.scheduler(s).name for s in range(10)]
    for p in (j, t):
        p.step()
        p.step()
    assert t.step_info() == j.step_info() == "step 2"


def _spans(prof_mod):
    prof = prof_mod.Profiler(timer_only=True)
    with prof:
        with prof_mod.RecordEvent("outer"):
            with prof_mod.RecordEvent("inner"):
                time.sleep(0.01)
        with prof_mod.RecordEvent("outer"):
            pass
    with prof_mod.RecordEvent("after"):     # no profiler running: not recorded
        pass
    return prof


def test_record_event_nesting_through_native_tracer(tmp_path, monkeypatch):
    """The spans come from the native host tracer (its library is built on
    first use), nest, and export as a chrome trace the JAX package's
    handler would write."""
    calls = []
    lib = native.load()
    begin = lib.ptt_begin
    monkeypatch.setattr(lib, "ptt_begin", lambda name: (calls.append(name), begin(name))[1])
    prof = _spans(t_prof)
    assert calls == [b"outer", b"inner", b"outer"]
    summary = prof.summary()
    assert "outer" in summary and "inner" in summary and "after" not in summary
    t_prof.export_chrome_tracing(str(tmp_path), "w0")(prof)
    (name,) = os.listdir(tmp_path)
    trace = json.load(open(tmp_path / name))
    names = [e["name"] for e in trace["traceEvents"]]
    assert sorted(names) == ["inner", "outer", "outer"]
    outer = min((e for e in trace["traceEvents"] if e["name"] == "outer"), key=lambda e: e["ts"])
    inner = next(e for e in trace["traceEvents"] if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert all(e["cat"] == "host" and e["ph"] == "X" for e in trace["traceEvents"])


def test_failed_native_build_raises(monkeypatch):
    """No Python fallback: a profiler without its native library fails."""
    def broken():
        raise RuntimeError("native build failed (exit 1)")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        t_prof.Profiler().start()


def test_summary_table_matches_jax():
    events = [{"name": n, "dur": d, "ph": "X", "ts": 0.0, "pid": 1, "tid": 1, "cat": "host"}
              for n, d in (("a", 1500.0), ("b", 250.0), ("a", 500.0), ("c", 9000.0))]
    assert t_prof.ProfilerResult(events).summary() == j_prof.ProfilerResult(events).summary()
    assert t_prof.ProfilerResult(events).time_items() == events


def test_profiler_result_files_load_across_packages(tmp_path):
    """A file written by the JAX export_protobuf loads in the port and one
    written by the port loads in the JAX package: the same events and the
    same summary."""
    jprof = _spans(j_prof)
    j_prof.export_protobuf(str(tmp_path / "jax"), "w")(jprof)
    tprof = _spans(t_prof)
    t_prof.export_protobuf(str(tmp_path / "port"), "w")(tprof)
    (jf,) = (tmp_path / "jax").iterdir()
    (tf,) = (tmp_path / "port").iterdir()
    for path in (jf, tf):
        a, b = t_prof.load_profiler_result(str(path)), j_prof.load_profiler_result(str(path))
        assert a.events == b.events and a.meta == b.meta and a.summary() == b.summary()
        assert sorted(e["name"] for e in a.events) == ["inner", "outer", "outer"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other", "events": []}))
    with pytest.raises(ValueError, match="not a paddle_tpu profiler result"):
        t_prof.load_profiler_result(str(bad))


def test_device_trace_goes_to_profile_dir(tmp_path, monkeypatch, on_cpu):
    """With PADDLE_TPU_PROFILE_DIR set, torch.profiler traces the run and
    its chrome trace lands there at stop(); summary() stays host spans;
    timer_only records no device trace."""
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path / "dev"))
    prof = t_prof.Profiler()
    with prof:
        with t_prof.RecordEvent("matmul"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    path = prof.device_trace_path
    assert path is not None and os.path.dirname(path) == str(tmp_path / "dev")
    events = json.load(open(path))["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    assert prof.summary().splitlines()[1].split()[0] == "matmul"
    quiet = t_prof.Profiler(timer_only=True)
    with quiet:
        pass
    assert quiet.device_trace_path is None


def test_timer_and_enums_match_jax():
    for mod in (j_prof, t_prof):
        timer = mod.benchmark()
        timer.step(4)            # the first call starts the clock
        timer.step(4)
        timer.step(4)
        assert timer.steps == 2 and timer.samples == 8
        assert timer.ips() == pytest.approx(8 / timer.elapsed)
        assert timer.step_time() == pytest.approx(timer.elapsed / 2)
        timer.reset()
        assert timer.ips() == 0.0 and timer.step_time() == 0.0
    for name in ("SortedKeys", "SummaryView", "ProfilerTarget", "ProfilerState"):
        j, t = getattr(j_prof, name), getattr(t_prof, name)
        assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]


# -- device, without a card ---------------------------------------------------

_CARD = torch.cuda.is_available()


@pytest.mark.skipif(_CARD, reason="answers without a card; the card's are in test_torch_gpu.py")
def test_device_cuda_answers_as_jax_without_a_card():
    for name in ("device_count", "max_memory_allocated", "max_memory_reserved",
                 "memory_allocated", "memory_reserved"):
        assert getattr(t_device.cuda, name)() == getattr(j_device.cuda, name)() == 0
    assert t_device.cuda.empty_cache() is None
    for name in ("get_device_properties", "get_device_name", "get_device_capability",
                 "synchronize"):
        for mod in (j_device.cuda, t_device.cuda):
            with pytest.raises(RuntimeError):
                getattr(mod, name)()
    with pytest.raises(RuntimeError, match="XPU"):
        t_device.xpu.synchronize()


def test_device_lists_and_compile_flags_answer_as_jax():
    cards = torch.cuda.device_count() if _CARD else 0
    assert t_device.get_all_device_type() == ["cpu"] + ["gpu"] * bool(cards)
    assert t_device.get_available_device() == ["cpu:0"] + [f"gpu:{i}" for i in range(cards)]
    if not cards:
        assert t_device.get_all_device_type() == j_device.get_all_device_type()
        # the test session gives JAX 8 host devices (tests/conftest.py's XLA
        # flags); without them it lists one, as torch has one CPU device
        assert t_device.get_available_device() == j_device.get_available_device()[:1]
    for name in ("is_compiled_with_rocm", "is_compiled_with_xpu",
                 "is_compiled_with_ipu", "is_compiled_with_cinn",
                 "is_compiled_with_distribute", "is_compiled_with_tpu"):
        assert getattr(t_device, name)() == getattr(j_device, name)(), name
    cuda_build = torch.version.cuda is not None
    assert t_device.is_compiled_with_cuda() is tp.is_compiled_with_cuda() is cuda_build
    if not cuda_build:
        assert t_device.is_compiled_with_cuda() == j_device.is_compiled_with_cuda()
    assert t_device.is_compiled_with_custom_device("npu") is False
    assert t_device.get_all_custom_device_type() == t_device.get_available_custom_device() == []
    assert tp.is_compiled_with_tpu() is False
    for place in (t_device.XPUPlace, t_device.IPUPlace):
        with pytest.raises(RuntimeError, match="unavailable"):
            place(0)


def test_events_and_streams_on_the_cpu(on_cpu):
    """Under set_device("cpu") an event is a host timestamp after a
    barrier and there is one stream, as in the JAX package's shims."""
    start, end = t_fdev.Event(), t_fdev.Event()
    start.record()
    time.sleep(0.02)
    end.record()
    assert start.query() and end.query()
    assert 15.0 <= start.elapsed_time(end) < 1000.0
    with pytest.raises(RuntimeError, match="recorded"):
        t_fdev.Event().elapsed_time(end)
    s = t_device.current_stream()
    assert s is t_device.current_stream() and s.query()
    with t_device.stream_guard(s) as g:
        assert g is s
    s.wait_event(end)
    s.wait_stream(t_device.Stream())
    assert s.record_event().query()
    assert t_device.set_stream(s) is s
    t_device.synchronize()
    assert t_device.current_device() == torch.device("cpu") and t_device.get_device() == "cpu"


@pytest.mark.skipif(_CARD, reason="a default Event is the card's where there is one")
def test_default_event_raises_without_a_card():
    prev = t_fdev._CURRENT
    tp.set_device(None)
    try:
        for make in (t_fdev.Event, t_fdev.Stream, t_fdev.current_stream, t_fdev.synchronize):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    finally:
        tp.set_device(prev)


# -- version and sysconfig ----------------------------------------------------

def test_version_fields_and_show():
    for name in ("major", "minor", "patch", "rc"):
        assert getattr(t_version, name) == getattr(j_version, name)
    assert t_version.full_version.startswith(f"{t_version.major}.{t_version.minor}.")
    assert tp.__version__ == t_version.full_version
    assert t_version.cuda() == (torch.version.cuda or "False")
    assert (t_version.cudnn() == "False") is not torch.backends.cudnn.is_available()
    assert (t_version.nccl() == "False") is not (
        torch.distributed.is_available() and torch.distributed.is_nccl_available())
    assert t_version.xpu() == t_version.cinn() == t_version.tensorrt() == "False"
    assert not hasattr(t_version, "jax_version")
    out = io.StringIO()
    with redirect_stdout(out):
        t_version.show()
    assert f"torch: {torch.__version__}" in out.getvalue()
    assert "jax" not in out.getvalue()


def test_sysconfig_points_at_the_native_runtime():
    assert os.path.isfile(os.path.join(t_sysconfig.get_include(), "host_tracer.cc"))
    assert os.path.realpath(t_sysconfig.get_lib()) == os.path.realpath(native.BUILD_DIR)
    assert os.path.realpath(native.lib_path().parent) == os.path.realpath(t_sysconfig.get_lib())

