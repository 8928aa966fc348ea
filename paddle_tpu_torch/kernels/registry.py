"""Admission-gated kernel registry (port of ``paddle_tpu/kernels/registry.py``).

Every kernel module registers its entries here as *builders*: zero-cost
closures that return ``(specs, launch, plain, example_args)`` only when
something asks for verification; registration allocates nothing.

- ``specs``: one :class:`~paddle_tpu_torch.analysis.kernel_lint.KernelSpec`
  per CUDA kernel the entry launches (none for an entry that is certified
  kernel-free: torch ops, as XLA ops in the JAX package);
- ``launch``: the public wrapper's call; ``plain``: its plain version;
- ``example_args``: ``device -> args`` at the JAX registry's example shapes
  where the port's kernels take them.

An entry whose kernels are instantiated per dtype lists its ``dtypes``
(``"bfloat16"``, or ``"bfloat16+float32"`` for bf16 activations over fp32
weights; the first is the JAX registry's example), and its builder takes
one of them: ``build(dtype)`` gives the specs of the instantiations that
dtype launches and example arguments of it.  Checked without a dtype, the
entry is verified at every one of them.  A dtype may come again with an
``@`` tag (``"bfloat16@base"``): the same instantiations at a second
example, a production shape; the CLI checks it, and no wrapper's dtype key
selects it for admission.

Three consumers:

- ``python -m paddle_tpu_torch.kernels.registry [--device cuda|cpu]`` —
  one JSON line with per-entry findings, CUDA kernels and shared memory
  (every entry at every one of its dtypes), rc 1 on any finding.
  ``KERNEL_GATE_INJECT=write-race|parallel-carry|emit-race`` registers a
  seeded-defect entry (``injected_<kind>``), proving the gate can fail;
- :func:`check` / :func:`check_all` — ``chip_smoke.py`` and the tests;
- **admission** (``FLAGS_kernel_admission``): every public kernel wrapper
  calls :func:`ensure_admitted` before its first launch, and a registered
  entry with any finding raises :class:`KernelRejected` with the full
  report instead of running.  On a CPU tensor admission runs the static
  leg; on a CUDA tensor both legs, once per process, device type and the
  dtype the wrapper was called with (:func:`dtype_key`), so each compiled
  instantiation is admitted on its own verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "KernelEntry", "KernelRejected", "admit", "admission_seconds", "admissions", "check",
    "check_all", "dtype_key", "ensure_admitted", "entries", "load_all", "names", "register",
    "reset_admission_cache",
]

# the dynamic leg's parity tolerance: (atol, rtol, floor) with |kernel - plain|
# <= atol + rtol |plain|, the atol scaled by max(max |plain|, floor) unless
# floor is None; or a tuple of such triples, one per output; or, for an entry
# with dtypes, a dict of either by dtype
EXACT = (0.0, 0.0, None)


@dataclass
class KernelEntry:
    name: str
    build: Callable[..., tuple]      # ([dtype]) -> (specs, launch, plain, example_args)
    presets: Tuple[str, ...] = ()    # bench presets that exercise the kernel
    description: str = ""
    tol: Any = EXACT                  # the dynamic leg's parity tolerance
    dtypes: Tuple[str, ...] = ()      # () = one example, build(); else build(dtype)

    def tolerance(self, dtype: Optional[str]):
        return self.tol[dtype] if isinstance(self.tol, dict) else self.tol


_Key = Tuple[str, str, Optional[str]]   # (name, device type, dtype or None)
_REGISTRY: Dict[str, KernelEntry] = {}
_ADMITTED: set = set()
_ADMISSIONS: Dict[_Key, int] = {}
_ADMISSION_SECONDS: Dict[_Key, float] = {}
_LOCK = threading.Lock()
_ADMIT_LOCK = threading.RLock()      # one admission at a time; re-entered by its own launches
_IN_PROGRESS: set = set()


class KernelRejected(RuntimeError):
    """Raised by admission when a registered kernel fails the verifier."""


def register(name: str, build: Optional[Callable[..., tuple]] = None, *,
             presets: Tuple[str, ...] = (), description: str = "",
             tol: Any = EXACT, dtypes: Tuple[str, ...] = ()):
    """Register a kernel builder (usable as a decorator)."""
    def _do(b):
        with _LOCK:
            _REGISTRY[name] = KernelEntry(name, b, tuple(presets), description, tol,
                                          tuple(dtypes))
        return b
    return _do if build is None else _do(build)


def dtype_key(*dtypes) -> str:
    """The dtype name an admission is keyed on: the distinct dtypes of the
    tensors that select a kernel's instantiation, in order, joined by "+"
    (``dtype_key(torch.bfloat16, torch.float32) == "bfloat16+float32"``)."""
    names = [str(d).replace("torch.", "") for d in dtypes]
    return "+".join(dict.fromkeys(names))


def entries() -> Dict[str, KernelEntry]:
    return dict(_REGISTRY)


def names() -> list:
    return sorted(_REGISTRY)


def load_all() -> None:
    """Import every kernel module so its registrations run."""
    from . import adamw, decode_attention, emit, flash_attention, rms_norm, ssd_scan  # noqa: F401


def check(name: str, smem_budget: Optional[int] = None, device=None,
          dtype: Optional[str] = None):
    """Verify one registered entry -> Report: the static leg, and the
    dynamic leg too when ``device`` is CUDA; at ``dtype``, or at every
    dtype of the entry when it is None."""
    from ..analysis import kernel_lint

    rep = kernel_lint.check_kernel(_REGISTRY[name], device, smem_budget=smem_budget,
                                   dtype=dtype)
    rep.meta["registry_name"] = name
    return rep


def check_all(presets=None, smem_budget: Optional[int] = None, device=None) -> Dict[str, object]:
    """Verify every registered entry (optionally only those tagged with one
    of ``presets``) -> {name: Report}."""
    want = None if presets is None else (
        {presets} if isinstance(presets, str) else set(presets))
    out = {}
    for name in names():
        if want is not None and not (set(_REGISTRY[name].presets) & want):
            continue
        out[name] = check(name, smem_budget=smem_budget, device=device)
    return out


def admit(name: str, smem_budget: Optional[int] = None, device=None,
          dtype: Optional[str] = None):
    """Verify; raise :class:`KernelRejected` with the full report on ANY
    finding.  Returns the clean report otherwise, and records it in the
    admission cache for each dtype it covers, so :func:`ensure_admitted`
    does not verify those again."""
    entry = _REGISTRY[name]
    if dtype is not None and dtype not in entry.dtypes:
        raise KernelRejected(
            f"kernel {name!r} has no example at dtype {dtype!r} (only at {entry.dtypes}), "
            "so the instantiation it selects cannot be verified")
    with _ADMIT_LOCK:
        t0 = time.perf_counter()
        rep = check(name, smem_budget=smem_budget, device=device, dtype=dtype)
        if rep:
            raise KernelRejected(
                f"kernel {name!r} refused by the kernel verifier "
                f"({len(rep)} finding(s), legs {rep.meta.get('legs')})\n{rep.report()}")
        secs = time.perf_counter() - t0
        dtypes = rep.meta["dtypes"] or [None]
        with _LOCK:
            # admitted from inside another entry's dynamic leg: its time is that one's
            nested = any(k[0] != name for k in _IN_PROGRESS)
            for dt in dtypes:
                key = (name, _device_type(device), dt)
                _ADMITTED.add(key)
                _ADMISSIONS[key] = _ADMISSIONS.get(key, 0) + 1
                _ADMISSION_SECONDS[key] = 0.0 if nested else secs / len(dtypes)
    return rep


def _device_type(device) -> str:
    if device is None:
        return "cpu"
    import torch

    return torch.device(device).type


def _dtypes(entry: KernelEntry, dtype) -> Tuple[Optional[str], ...]:
    """The dtypes an admission of ``entry`` for ``dtype`` covers: None for
    an entry with one example; all of its dtypes for ``dtype=None``; else
    ``dtype`` (a torch dtype or a :func:`dtype_key`), which :func:`admit`
    refuses when the entry has no example of it."""
    if not entry.dtypes:
        return (None,)
    if dtype is None:
        return entry.dtypes
    return (dtype if isinstance(dtype, str) else dtype_key(dtype),)


def ensure_admitted(name: str, device=None, dtype=None) -> None:
    """Admission guard for the public kernel wrappers: verify the named
    entry once per process, device type and dtype before its first launch,
    only when ``FLAGS_kernel_admission`` is on.  Unregistered names pass; a
    failing verifier raises :class:`KernelRejected` *before* the launch.
    ``device`` is the device of the wrapper's tensors (the dynamic leg runs
    for a CUDA one) and ``dtype`` their dtype (:func:`dtype_key`; None:
    every dtype of the entry); the dynamic leg's own launches of the
    wrapper pass."""
    from ..framework import flags

    if not flags.get_flag("kernel_admission"):
        return
    entry = _REGISTRY.get(name)
    if entry is None:
        return
    dev = _device_type(device)
    for dt in _dtypes(entry, dtype):
        key = (name, dev, dt)
        with _LOCK:
            if key in _ADMITTED:
                continue
        with _ADMIT_LOCK:
            if key in _ADMITTED or key in _IN_PROGRESS:
                continue
            _IN_PROGRESS.add(key)
            try:
                admit(name, device=device if dev != "cpu" else None, dtype=dt)
            finally:
                _IN_PROGRESS.discard(key)


def admissions() -> Dict[_Key, int]:
    """How many times each (entry, device type, dtype) was admitted since
    the last :func:`reset_admission_cache`."""
    with _LOCK:
        return dict(_ADMISSIONS)


def admission_seconds() -> Dict[_Key, float]:
    """The wall time each admission took (both legs), since the last
    :func:`reset_admission_cache`; an admission made from inside another's
    dynamic leg counts in the outer one's time (0.0 here), so the values
    sum to the time admission took."""
    with _LOCK:
        return dict(_ADMISSION_SECONDS)


def reset_admission_cache() -> None:
    with _LOCK:
        _ADMITTED.clear()
        _ADMISSIONS.clear()
        _ADMISSION_SECONDS.clear()


# ---------------------------------------------------------------------------
# seeded-defect entries (KERNEL_GATE_INJECT legs — prove the gate can fail)
# ---------------------------------------------------------------------------

def _build_injected_write_race():
    from . import injected

    return injected.write_race_entry()


def _build_injected_parallel_carry():
    from . import injected

    return injected.parallel_carry_entry()


def _build_injected_emit_race(dtype="float32"):
    # the real fuse_swiglu_mlp forward, its GEMM launched from the build
    # variant whose epilogue stores every tile to tile (0, 0), under the
    # site's honest spec, at both GEMM kernels (the fp32 CUDA-core one, the
    # bf16 tensor-core one): the static leg passes, the card's must not
    from . import injected

    return injected.emit_race_entry(dtype)


_INJECTIONS = {
    "write-race": (_build_injected_write_race, ()),
    "parallel-carry": (_build_injected_parallel_carry, ()),
    "emit-race": (_build_injected_emit_race, ("float32", "bfloat16+float32")),
}


def _apply_injection(kind: str) -> None:
    if kind not in _INJECTIONS:
        raise SystemExit(f"unknown KERNEL_GATE_INJECT={kind!r} "
                         f"(known: {sorted(_INJECTIONS)})")
    build, dtypes = _INJECTIONS[kind]
    register(f"injected_{kind.replace('-', '_')}", build,
             description=f"seeded defect: {kind}", dtypes=dtypes)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="verify every registered CUDA kernel")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): both legs on the card; cpu: the static leg only")
    args = ap.parse_args(argv)
    from .. import default_device

    device = default_device(args.device)
    load_all()
    inject = os.environ.get("KERNEL_GATE_INJECT", "").strip()
    if inject:
        _apply_injection(inject)
    reports = check_all(device=device)
    kernels = {}
    total = 0
    for name, rep in sorted(reports.items()):
        kernels[name] = {
            "findings": len(rep),
            "codes": rep.counts(),
            "launches": int(rep.meta.get("kernels", 0)),
            "smem_bytes": int(rep.meta.get("kernel_smem_bytes", 0)),
            "smem_bytes_by_kernel": rep.meta.get("smem_bytes_by_kernel", {}),
            "legs": rep.meta.get("legs", []),
            "dtypes": rep.meta.get("dtypes", []),
        }
        if "dynamic" in rep.meta["legs"]:
            kernels[name].update({
                "smem_bytes_card_by_kernel": rep.meta["smem_bytes_card_by_kernel"],
                "attributes_by_kernel": rep.meta["attributes_by_kernel"],
                "gate_launches": rep.meta["gate_launches"],
                "dynamic_ms": rep.meta["dynamic_ms"],
            })
        total += len(rep)
        if rep:
            print(f"[kernel-lint] {name}:\n{rep.report()}", file=sys.stderr)
    print(json.dumps({"kernels": kernels, "kernel_count": len(kernels),
                      "total_findings": total, "device": str(device)}, sort_keys=True))
    return 1 if total else 0


if __name__ == "__main__":
    # run via the canonical module object: under ``python -m`` this file
    # executes as ``__main__`` while the kernel modules register into
    # ``paddle_tpu_torch.kernels.registry`` — two different registries otherwise
    from paddle_tpu_torch.kernels import registry as _canonical
    raise SystemExit(_canonical._main())
