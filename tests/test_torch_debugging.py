"""``paddle_tpu_torch.amp.debugging`` against ``paddle_tpu.amp.debugging``
(CPU): the operator statistics of one op sequence are the JAX package's,
``(op name, output dtype) -> count`` exactly; ``check_numerics`` and
``TensorChecker`` as ``tests/test_io_amp.py`` checks them; and a static
Program counts its ops when it runs, not when it is built.
"""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _sequence(P):
    F = P.nn.functional
    rng = np.random.default_rng(0)
    x = P.to_tensor(rng.normal(size=(4, 8)).astype(np.float32))
    w = P.to_tensor(rng.normal(size=(8, 3)).astype(np.float32))
    y = x + x
    y = (y * 2).astype("bfloat16")
    h = F.relu(P.matmul(x, w))
    s = F.softmax(h, axis=-1).sum()
    _ = P.exp(x).mean() + s
    _ = x * x
    with P.amp.auto_cast(level="O1", dtype="bfloat16"):
        _ = P.matmul(x, w)                  # white-listed: bf16 output
        _ = F.softmax(h)                    # black-listed: fp32


def test_operator_stats_match_jax():
    got = {}
    for P in (tp, jp):
        with P.amp.debugging.collect_operator_stats(print_table=False):
            _sequence(P)
            got[P] = P.amp.debugging.operator_stats()
    assert got[tp] == got[jp]
    assert got[tp][("matmul", "bfloat16")] == 1
    assert tp.amp.debugging.operator_stats() == {}


def test_operator_stats_collection():
    x = tp.to_tensor(np.ones((2, 2), np.float32))
    with tp.amp.debugging.collect_operator_stats(print_table=False):
        _ = x + x
        _ = (x * 2).astype("bfloat16")
        stats = tp.amp.debugging.operator_stats()
    assert stats[("add", "float32")] == 1 and stats[("cast", "bfloat16")] == 1
    _ = x + x                            # collection is off outside the context
    assert tp.amp.debugging.operator_stats() == {}


def test_operator_stats_table_prints(capsys):
    x = tp.to_tensor(np.ones((2,), np.float32))
    with tp.amp.debugging.collect_operator_stats():
        _ = x * x
    err = capsys.readouterr().err
    assert "op" in err and "multiply" in err


def test_static_program_counts_when_it_runs():
    xs = np.ones((4, 3), np.float32)
    tp.enable_static()
    try:
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [None, 3], "float32")
            with tp.amp.debugging.collect_operator_stats(print_table=False):
                out = tp.nn.functional.relu(x * 2.0).sum()
                built = tp.amp.debugging.operator_stats()
        exe = tp.static.Executor()
        with tp.amp.debugging.collect_operator_stats(print_table=False):
            exe.run(main, feed={"x": xs}, fetch_list=[out])
            ran = tp.amp.debugging.operator_stats()
    finally:
        tp.disable_static()
    assert built == {}
    assert ran == {("multiply", "float32"): 1, ("relu", "float32"): 1, ("sum", "float32"): 1}


def test_check_numerics(capsys):
    bad = tp.to_tensor(np.asarray([1.0, np.nan, np.inf, -np.inf], np.float32))
    with pytest.raises(FloatingPointError, match="probe"):
        tp.amp.debugging.check_numerics(bad, "probe", "out")
    n_nan, n_inf = tp.amp.debugging.check_numerics(bad, "probe", debug_mode="print")
    assert (n_nan, n_inf) == (1, 2)
    assert (n_nan, n_inf) == jp.amp.debugging.check_numerics(
        jp.to_tensor(bad.numpy()), "probe", debug_mode="print")
    assert "probe" in capsys.readouterr().err
    assert tp.amp.debugging.check_numerics(tp.to_tensor(np.ones(3, np.float32))) == (0, 0)
    assert tp.amp.debugging.check_numerics(tp.to_tensor(np.ones(3, np.int32))) == (0, 0)


def test_tensor_checker_toggles_flag():
    from paddle_tpu_torch.framework import flags

    tc = tp.amp.debugging.TensorChecker(enable=True)
    tc.start_check_nan_inf()
    try:
        assert flags.get_flag("check_nan_inf")
        bad = tp.to_tensor(np.asarray([1.0], np.float32))
        with pytest.raises(FloatingPointError):
            _ = bad / tp.to_tensor(np.asarray([0.0], np.float32)) * 0.0
    finally:
        tc.stop_check_nan_inf()
    assert not flags.get_flag("check_nan_inf")


def test_debugging_all_matches_jax():
    assert tp.amp.debugging.__all__ == jp.amp.debugging.__all__
