"""Runtime flags (port of ``paddle_tpu/framework/flags.py``).

One registry of typed flags, each settable through the environment
(``FLAGS_<name>``, read when the flag is defined), :func:`set_flags`, or
read with :func:`get_flag`.  Only the flags the port reads are defined here.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags"]

_LOCK = threading.RLock()


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _parse(raw: str, ty: type) -> Any:
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return ty(raw)


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Register a flag. Environment variable ``FLAGS_<name>`` overrides the default."""
    with _LOCK:
        ty = type(default)
        env = os.environ.get("FLAGS_" + name)
        value = _parse(env, ty) if env is not None else default
        _REGISTRY[name] = _Flag(name=name, default=default, type=ty, help=help, value=value)


def get_flags(names=None) -> Dict[str, Any]:
    """``{name: value}`` of ``names`` (one name, a list, or every flag)."""
    with _LOCK:
        if names is None:
            return {k: f.value for k, f in _REGISTRY.items()}
        if isinstance(names, str):
            names = [names]
        return {n: _REGISTRY[n[len("FLAGS_"):] if n.startswith("FLAGS_") else n].value
                for n in names}


def get_flag(name: str) -> Any:
    with _LOCK:
        return _REGISTRY[name].value


def set_flags(flags: Dict[str, Any]) -> None:
    with _LOCK:
        for name, value in flags.items():
            key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
            if key not in _REGISTRY:
                raise ValueError(f"unknown flag {name!r}")
            f = _REGISTRY[key]
            f.value = (_parse(value, f.type) if isinstance(value, str) and f.type is not str
                       else f.type(value))


define_flag("kernel_admission", False,
            "Refuse a registered CUDA kernel that fails the kernel verifier "
            "(analysis.kernel_lint: the static leg, and on a CUDA tensor the "
            "dynamic leg too) before its first launch")
define_flag("check_nan_inf", False,
            "Check every output of the op namespace, of nn.functional and of "
            "the Llama model's seams for NaN/Inf (raises FloatingPointError)")
define_flag("check_nan_inf_level", 0,
            "0 raises on a NaN/Inf found by check_nan_inf; > 0 prints a warning")

# ---------------------------------------------------------------------------
# Fault-tolerance flags (consumed by distributed.fault_tolerance)
# ---------------------------------------------------------------------------
define_flag("ft_heartbeat_interval", 5.0,
            "Seconds between heartbeat lease renewals on the control store "
            "(bounds 0.05..300; validated by fault_tolerance.policy."
            "heartbeat_config — lower = faster failure detection, more "
            "store traffic)")
define_flag("ft_lease_ttl", 0.0,
            "Seconds a silent peer keeps its membership lease; 0 = 3x "
            "interval, must be >= 2x interval (worst-case detection "
            "latency is ttl + interval)")
define_flag("ft_store_max_retries", 5,
            "Reconnect attempts for a dropped control-store connection")
define_flag("ft_store_backoff_base", 0.05,
            "Base delay (s) of the store reconnect exponential backoff")
# deterministic fault injection (chaos testing) — all off by default
define_flag("ft_inject_seed", 0,
            "Seed for every fault-injection random stream (determinism)")
define_flag("ft_inject_crash_step", -1,
            "Simulate a fail-stop worker crash before this train step (-1 off)")
define_flag("ft_inject_crash_rank", -1,
            "Restrict the injected crash to this rank (-1 = every rank)")
define_flag("ft_inject_crash_signal", 0,
            "Deliver this signal (e.g. 9=SIGKILL) for the injected crash "
            "instead of os._exit — exercises the no-cleanup kill path")
define_flag("ft_inject_store_drop_rate", 0.0,
            "Probability an outgoing store op gets its connection dropped")
define_flag("ft_inject_store_delay_ms", 0,
            "Added latency per store op (simulates a slow/partitioned peer)")
define_flag("ft_inject_corrupt_step", -1,
            "Bit-flip one checkpoint shard of this step after save (-1 off)")
define_flag("ft_inject_serve_kill_round", -1,
            "Kill a serving replica at this router round (-1 off)")
define_flag("ft_inject_serve_kill_replica", -1,
            "Replica id for the injected serving kill (-1 = lowest alive)")
define_flag("ft_inject_store_kill_leader", -1,
            "Kill the replicated-store leader after it has acked this many "
            "client writes (-1 off; one-shot — fires on the first leader "
            "whose acked-write count reaches the threshold)")
define_flag("ft_inject_store_partition", "",
            "Partition replicated-store replicas: groups of comma-separated "
            "replica ids split by '|' (e.g. '0|1,2'); replica-to-replica "
            "links across groups drop, client links stay up ('' = healed)")
define_flag("ft_inject_stage_kill_tick", -1,
            "Kill the device hosting a pipeline stage at this MPMD schedule "
            "tick (-1 off; one-shot — the executor must re-plan the "
            "stage->device assignment onto survivors and restart the step)")
define_flag("ft_inject_stage_kill_stage", -1,
            "Stage index for the injected stage kill (-1 = lowest alive)")
