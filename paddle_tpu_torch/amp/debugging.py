"""AMP debugging tools (port of ``paddle_tpu/amp/debugging.py``): per-op
dtype call statistics and numerics checks for mixed-precision runs.

The statistics count at the seam that names ops by their JAX names
(``framework.dispatch.checked``): every op of the op namespace, every
``nn.functional`` entry and every named seam of the models (``embedding``,
``rms_norm``, ``scaled_dot_product_attention``, ``swiglu_mlp``,
``lm_head``, ``cross_entropy``), one count a tensor output, keyed by
``(op name, output dtype)``.  A recorded program counts when it runs, not
when it is built.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..framework import dispatch as _dispatch
from ..framework import flags
from ..framework.tensor import Tensor

__all__ = ["enable_operator_stats_collection", "disable_operator_stats_collection",
           "collect_operator_stats", "operator_stats", "check_numerics",
           "TensorChecker"]


def enable_operator_stats_collection():
    """Start counting every op by (name, output dtype): the reference's
    low/mid-precision op audit for ``auto_cast`` tuning."""
    _dispatch.op_stats = {}


def disable_operator_stats_collection(print_table: bool = True):
    """Stop collecting; optionally print the table.  Returns the raw stats."""
    stats = _dispatch.op_stats or {}
    _dispatch.op_stats = None
    if print_table and stats:
        _print_table(stats)
    return stats


def operator_stats() -> Dict[Tuple[str, str], int]:
    return dict(_dispatch.op_stats or {})


def _print_table(stats):
    by_op: Dict[str, Dict[str, int]] = {}
    dtypes = set()
    for (op, dt), n in stats.items():
        by_op.setdefault(op, {})[dt] = by_op.setdefault(op, {}).get(dt, 0) + n
        dtypes.add(dt)
    cols = sorted(dtypes)
    width = max(len(op) for op in by_op) + 2
    print(f"{'op':<{width}}" + "".join(f"{c:>12}" for c in cols), file=sys.stderr)
    for op in sorted(by_op):
        row = "".join(f"{by_op[op].get(c, 0):>12}" for c in cols)
        print(f"{op:<{width}}" + row, file=sys.stderr)


@contextlib.contextmanager
def collect_operator_stats(print_table: bool = True):
    """``with collect_operator_stats(): ...`` (the reference's context form)."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection(print_table)


def check_numerics(x, op_type: str = "", var_name: str = "", debug_mode="abort"):
    """Count NaN and Inf in a tensor (reference ``check_numerics``).

    ``debug_mode``: ``"abort"`` (the reference default,
    CHECK_NAN_INF_AND_ABORT: raises ``FloatingPointError`` on any
    non-finite value) or ``"print"`` (reports to stderr only).  Returns
    ``(num_nan, num_inf)``."""
    a = x._data if isinstance(x, Tensor) else x
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    if not a.is_floating_point():
        return 0, 0
    a = a.detach()
    n_nan = int(torch.isnan(a).sum())
    n_inf = int(torch.isinf(a).sum())
    if n_nan or n_inf:
        dt = str(a.dtype).replace("torch.", "")
        msg = (f"[check_numerics] {op_type or 'tensor'}:{var_name} {n_nan} NaN, "
               f"{n_inf} Inf in shape {tuple(a.shape)} {dt}")
        if debug_mode == "abort":
            raise FloatingPointError(msg)
        print(msg, file=sys.stderr)
    return n_nan, n_inf


class TensorChecker:
    """The reference-shaped config object that turns on the global NaN/Inf
    sweep (the ``FLAGS_check_nan_inf`` role)."""

    def __init__(self, enable: bool = True, debug_mode=None, output_dir=None):
        self.enable = enable

    def start_check_nan_inf(self):
        flags.set_flags({"check_nan_inf": bool(self.enable)})

    def stop_check_nan_inf(self):
        flags.set_flags({"check_nan_inf": False})
