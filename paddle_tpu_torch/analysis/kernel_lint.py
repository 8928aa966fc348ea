"""Verifier of the port's hand-written CUDA kernels (the ``krn-*`` findings).

The counterpart of ``paddle_tpu/analysis/pallas_lint.py``.  A kernel that
writes one output block from two CTAs, leaves a block unwritten, or carries
state from one CTA to the next runs and returns garbage instead of failing.
This module refutes each of those in two legs:

- **the static leg** (:func:`lint_kernel_spec`) reads a declared
  :class:`KernelSpec` (grid, block footprints, scratch, aliases) and proves
  or refutes each invariant without running anything.  It is the JAX
  verifier's spec model and checks, with their codes, severities and
  messages;
- **the dynamic leg** (run by :func:`check_kernel` on a CUDA device) holds
  the kernel's launches to the spec on the card: coverage, out-of-bounds
  reads, determinism, parity with the plain version, and the compiled
  kernel's shared memory.

Translating the TPU model to CUDA:

- every CUDA grid axis is ``"parallel"``: CTAs run in no guaranteed order;
- a loop that one CTA runs in order (flash attention's KV loop, the SSD
  scan's chunk loop, a GEMM's K loop) is an extra ``"arbitrary"`` axis of
  the spec, after the grid's own;
- state carried across CTAs can only live in device memory, so
  :class:`ScratchUse` has the memory space ``"global"`` beside ``"smem"``
  (shared memory) and ``"registers"`` (a CTA's own accumulators, carried
  over its in-CTA loop axes only);
- a block may be ``masked``: the kernel bounds-checks a ragged last block
  element by element (CUDA threads guard their loads), so its overhang
  reads nothing; a TPU block is moved whole and has no such form;
- ``_vmem_bytes`` becomes :func:`_smem_bytes`, the shared memory of one CTA
  (static plus dynamic), held to the H100's per-block opt-in limit
  (232,448 bytes) under ``krn-smem-over-budget``, the counterpart of
  ``krn-vmem-over-budget``.  Pipeline double-buffering is not modelled: a
  kernel declares its shared tiles (double buffers included) as scratch.

Codes (see :mod:`.findings`):

=========================  ================================================
``krn-write-race``         two grid points that differ along a ``parallel``
                           axis write the same output block; on the card:
                           two launches on the same inputs differ (an
                           observation, not a proof)
``krn-coverage-hole``      the output footprints miss elements; on the
                           card: an output element kept the NaN sentinel
``krn-oob-read``           a block outside the array (high) or an unmasked
                           ragged overhang (medium); on the card: a NaN
                           guard band beside an input reached the output
``krn-parallel-carry``     scratch read before it is written, carried
                           across an axis declared ``parallel``
``krn-alias-mismatch``     in-place operands whose shape or dtype differ
``krn-alias-raw``          an in-place input read through other blocks
                           than it is overwritten through
``krn-smem-over-budget``   a CTA's declared shared memory exceeds the
                           per-block limit
``krn-dynamic-index``      an index map that cannot be evaluated
                           (advisory)
``krn-plain-mismatch``     on the card only: the kernel's result is
                           outside its tolerance of the plain version.  No
                           TPU counterpart: the JAX verifier never runs a
                           kernel
``krn-spec-mismatch``      on the card only: the compiled kernel's shared
                           memory (``cudaFuncGetAttributes`` plus the
                           dynamic bytes its launch requests) differs from
                           the spec's, so the spec does not describe the
                           kernel that runs
=========================  ================================================

Index maps are plain callables ``(*grid_idxs) -> block_idxs`` evaluated
over the grid (at most ``ENUM_CAP`` points), or resolved forms
``("affine", dims)`` / ``("table", images)`` / ``("dynamic", reason)``.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .findings import Report

__all__ = [
    "BlockUse", "ScratchUse", "KernelSpec", "DEFAULT_SMEM_BUDGET", "ENUM_CAP",
    "KRN_CODES", "Report", "check_kernel", "cuda_semantics", "itemsize", "lint_kernel_spec",
    "sentinel_outputs", "tabulated",
]

# H100: the most shared memory one CTA may opt into (227 KiB)
DEFAULT_SMEM_BUDGET = 232448

# exhaustive-evaluation cap, as in the JAX verifier
ENUM_CAP = 4096

KRN_CODES = (
    "krn-write-race", "krn-coverage-hole", "krn-oob-read",
    "krn-parallel-carry", "krn-alias-mismatch", "krn-alias-raw",
    "krn-smem-over-budget", "krn-dynamic-index", "krn-plain-mismatch",
    "krn-spec-mismatch",
)


def itemsize(dtype) -> int:
    """Bytes an element of a torch dtype."""
    try:
        if dtype.is_floating_point:
            return torch.finfo(dtype).bits // 8
        if dtype == torch.bool:
            return 1
        return torch.iinfo(dtype).bits // 8
    except (AttributeError, TypeError):
        return 4


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# spec model
# ---------------------------------------------------------------------------

@dataclass
class BlockUse:
    """One operand's blocking: array shape/dtype + block shape + index map.

    ``memory_space`` is ``"tile"`` (a CTA reads or writes the block) or
    ``"any"`` (the kernel addresses the operand itself, e.g. paged pools
    through a block table: no footprint).  ``masked``: the kernel
    bounds-checks a ragged last block, so its overhang reads nothing."""
    shape: Tuple[int, ...]
    dtype: Any
    block_shape: Tuple[int, ...] = ()
    index_map: Any = None
    memory_space: str = "tile"
    name: str = ""
    masked: bool = False

    def itemsize(self) -> int:
        return itemsize(self.dtype)

    def nblocks(self) -> Tuple[int, ...]:
        return tuple(-(-d // b) for d, b in zip(self.shape, self.block_shape))


@dataclass
class ScratchUse:
    shape: Tuple[int, ...]
    dtype: Any
    memory_space: str = "smem"          # "smem" | "global" | "registers" | "semaphore"

    def nbytes(self) -> int:
        if self.memory_space == "semaphore":
            return 0
        return int(math.prod(self.shape)) * itemsize(self.dtype)


@dataclass
class KernelSpec:
    """Everything the verifier needs about one CUDA kernel's launch.

    ``grid`` is the CUDA grid (x, y, z as used) followed by the CTA's
    in-order loop axes.  ``cuda`` names the compiled kernel for the card's
    read-back: ``(source, kernel index, dtype code, a, b[, c])`` as
    ``kernel_attributes`` of that source takes them."""
    name: str
    grid: Tuple[int, ...]
    inputs: List[BlockUse] = field(default_factory=list)
    outputs: List[BlockUse] = field(default_factory=list)
    scratch: List[ScratchUse] = field(default_factory=list)
    # input BlockUse index -> output BlockUse index (in-place pairs)
    aliases: Dict[int, int] = field(default_factory=dict)
    # per grid axis: "parallel" | "arbitrary"; None = all arbitrary
    dimension_semantics: Optional[Tuple[str, ...]] = None
    # (scratch index, axes the carry crosses) for scratch that is read
    # before it is written on a grid step
    carried_scratch: List[Tuple[int, frozenset]] = field(default_factory=list)
    cuda: Optional[Tuple] = None

    def parallel_axes(self) -> frozenset:
        if not self.dimension_semantics:
            return frozenset()
        return frozenset(k for k, s in enumerate(self.dimension_semantics)
                         if str(s) == "parallel")


def cuda_semantics(n_grid: int, n_loops: int = 0) -> Tuple[str, ...]:
    """``dimension_semantics`` of a CUDA launch: the grid's axes parallel,
    the CTA's loops after them arbitrary."""
    return ("parallel",) * n_grid + ("arbitrary",) * n_loops


# ---------------------------------------------------------------------------
# index-map resolution
# ---------------------------------------------------------------------------

def tabulated(specs):
    """``specs`` with each callable index map over a grid larger than
    ``ENUM_CAP`` given as its table of every grid point, so the static leg
    checks a production-shape example in full."""
    for spec in specs:
        if math.prod(spec.grid) <= ENUM_CAP:
            continue
        points = list(itertools.product(*map(range, spec.grid)))
        for bu in spec.inputs + spec.outputs:
            if callable(bu.index_map):
                bu.index_map = ("table", {pt: tuple(bu.index_map(*pt)) for pt in points})
    return specs


def _resolve_index_map(bu: BlockUse, grid: Tuple[int, ...]):
    """Normalize ``bu.index_map`` to ("affine", dims) / ("table", images) /
    ("dynamic", reason) / None."""
    im = bu.index_map
    if im is None:
        return None
    if isinstance(im, tuple) and im and im[0] in ("affine", "table", "dynamic"):
        return im
    if callable(im):
        if math.prod(grid) > ENUM_CAP:
            return ("dynamic", f"grid {grid} exceeds ENUM_CAP={ENUM_CAP}")
        images = {}
        for pt in itertools.product(*map(range, grid)):
            try:
                idxs = im(*pt)
            except Exception as e:
                return ("dynamic", f"index map raised {e!r}")
            idxs = tuple(int(i) for i in (idxs if isinstance(idxs, tuple)
                                          else (idxs,)))
            images[pt] = idxs
        return ("table", images)
    return ("dynamic", f"unrecognized index map {type(im).__name__}")


def _images(resolution, grid: Tuple[int, ...]):
    """Grid point -> block-index tuple, or None when not enumerable."""
    if resolution is None or resolution[0] == "dynamic":
        return None
    if resolution[0] == "table":
        return resolution[1]
    if math.prod(grid) > ENUM_CAP:
        return None
    dims = resolution[1]
    images = {}
    for pt in itertools.product(*map(range, grid)):
        images[pt] = tuple(c if kind == "const" else pt[c]
                           for kind, c in dims)
    return images


def _affine_axes(resolution) -> Optional[frozenset]:
    """Grid axes an affine map's image depends on (None if not affine)."""
    if resolution is None or resolution[0] != "affine":
        return None
    return frozenset(c for kind, c in resolution[1] if kind == "axis")


def _affine_injective(resolution) -> bool:
    """True when each grid axis appears in at most one block dim."""
    axes = [c for kind, c in resolution[1] if kind == "axis"]
    return len(axes) == len(set(axes))


# ---------------------------------------------------------------------------
# the static checks
# ---------------------------------------------------------------------------

def _fmt_pt(pt) -> str:
    return "(" + ", ".join(str(i) for i in pt) + ")"


def _check_footprints(spec: KernelSpec, rep: Report) -> None:
    """Write-race, coverage, and OOB over every blocked operand."""
    par = spec.parallel_axes()
    for is_out, bu in ([(False, b) for b in spec.inputs]
                       + [(True, b) for b in spec.outputs]):
        if bu.memory_space == "any" or bu.index_map is None:
            continue                      # self-addressed operand: no footprint
        where = f"{spec.name}:{bu.name}"
        res = _resolve_index_map(bu, spec.grid)
        if res is not None and res[0] == "dynamic":
            rep.add("krn-dynamic-index", "low",
                    f"index map not statically evaluable ({res[1]}); "
                    "footprint checks skipped", where=where)
            continue
        nblocks = bu.nblocks()
        ragged = [d % b != 0 and not bu.masked
                  for d, b in zip(bu.shape, bu.block_shape)]

        if res[0] == "affine" and _affine_injective(res):
            _check_affine(spec, bu, res, is_out, nblocks, ragged, where,
                          par, rep)
            continue
        images = _images(res, spec.grid)
        if images is None:
            rep.add("krn-dynamic-index", "low",
                    f"grid {spec.grid} too large to enumerate a non-product "
                    "index map; footprint checks skipped", where=where)
            continue
        _check_enumerated(spec, bu, images, is_out, nblocks, ragged, where,
                          par, rep)


def _check_affine(spec, bu, res, is_out, nblocks, ragged, where, par, rep):
    """Exact per-dim reasoning for product-form maps — any grid size."""
    dims = res[1]
    rw = "written" if is_out else "read"
    for d, (kind, c) in enumerate(dims):
        nb = nblocks[d]
        if kind == "const":
            lo = hi = c
        else:
            lo, hi = 0, spec.grid[c] - 1
        if hi >= nb or lo < 0:
            rep.add("krn-oob-read", "high",
                    f"block index {hi if hi >= nb else lo} on dim {d} is "
                    f"outside the {nb}-block range of array dim "
                    f"{bu.shape[d]} (block {bu.block_shape[d]}) — "
                    f"{rw} entirely out of bounds",
                    where=where,
                    suggestion="clamp the index map or shrink the grid")
        elif not is_out and ragged[d] and hi == nb - 1:
            pad = nb * bu.block_shape[d] - bu.shape[d]
            rep.add("krn-oob-read", "medium",
                    f"last block on dim {d} overhangs the array edge by "
                    f"{pad} elements — padding lanes are read unmasked",
                    where=where,
                    suggestion="mask the tail block or pad the operand")
        if is_out and (hi - lo + 1) < nb:
            rep.add("krn-coverage-hole", "high",
                    f"dim {d} covers blocks [{lo}, {hi}] of {nb} — "
                    f"{(nb - (hi - lo + 1)) * bu.block_shape[d]} elements "
                    "per orthogonal slice are never written",
                    where=where,
                    suggestion="index every output block from some grid axis")
    if is_out and par:
        used = _affine_axes(res)
        free = [k for k in sorted(par - used) if spec.grid[k] > 1]
        if free:
            rep.add("krn-write-race", "high",
                    f"output block is revisited across grid axis(es) "
                    f"{free} declared 'parallel' — {math.prod(spec.grid[k] for k in free)} "
                    "programs store the same block in undefined order",
                    where=where,
                    suggestion="declare the axis 'arbitrary' or index the "
                               "output by it")


def _check_enumerated(spec, bu, images, is_out, nblocks, ragged, where,
                      par, rep):
    """Exhaustive check over enumerated images (non-product / eval'd maps)."""
    rw = "written" if is_out else "read"
    oob_seen = overhang_seen = False
    groups: Dict[Tuple[int, ...], list] = {}
    for pt, idxs in images.items():
        groups.setdefault(idxs, []).append(pt)
        for d, i in enumerate(idxs):
            if (i < 0 or i >= nblocks[d]) and not oob_seen:
                oob_seen = True
                rep.add("krn-oob-read", "high",
                        f"grid point {_fmt_pt(pt)} {rw}s block "
                        f"{_fmt_pt(idxs)} outside the {nblocks} block range",
                        where=where,
                        suggestion="clamp the index map or shrink the grid")
            elif (not is_out and ragged[d] and i == nblocks[d] - 1
                  and not overhang_seen):
                overhang_seen = True
                pad = nblocks[d] * bu.block_shape[d] - bu.shape[d]
                rep.add("krn-oob-read", "medium",
                        f"last block on dim {d} overhangs the array edge by "
                        f"{pad} elements — padding lanes are read unmasked",
                        where=where,
                        suggestion="mask the tail block or pad the operand")
    if is_out:
        needed = set(itertools.product(*map(range, nblocks)))
        covered = {i for i in groups if i in needed}
        missing = needed - covered
        if missing:
            ex = min(missing)
            elems = math.prod(bu.block_shape)
            rep.add("krn-coverage-hole", "high",
                    f"{len(missing)} of {len(needed)} output blocks are "
                    f"never written (e.g. block {_fmt_pt(ex)}) — "
                    f"~{len(missing) * elems} elements keep garbage",
                    where=where,
                    suggestion="make the grid x index map cover every block")
        for ax in sorted(par):
            for idxs, pts in groups.items():
                vals = {pt[ax] for pt in pts}
                if len(vals) > 1:
                    a, b = sorted(pts)[:2]
                    rep.add("krn-write-race", "high",
                            f"grid points {_fmt_pt(a)} and {_fmt_pt(b)} "
                            f"both write block {_fmt_pt(idxs)} while axis "
                            f"{ax} is 'parallel' — store order undefined",
                            where=where,
                            suggestion="declare the axis 'arbitrary' or "
                                       "index the output by it")
                    break


def _check_carry(spec: KernelSpec, rep: Report) -> None:
    par = spec.parallel_axes()
    if not par:
        return
    for si, axes in spec.carried_scratch:
        bad = sorted(axes & par)
        if not bad:
            continue
        sc = spec.scratch[si] if si < len(spec.scratch) else None
        rep.add("krn-parallel-carry", "high",
                f"scratch {si}"
                + (f" {tuple(sc.shape)} ({sc.memory_space})" if sc is not None else "")
                + f" is read before it is written — state carried across "
                  f"grid axis(es) {bad} declared 'parallel', where program "
                  "order is not guaranteed",
                where=f"{spec.name}:scratch{si}",
                bytes=sc.nbytes() if sc is not None else 0,
                suggestion="carry the state over an in-CTA loop axis "
                           "('arbitrary'), or across launches")


def _check_aliases(spec: KernelSpec, rep: Report) -> None:
    for in_idx, out_idx in sorted(spec.aliases.items()):
        if in_idx >= len(spec.inputs) or out_idx >= len(spec.outputs):
            rep.add("krn-alias-mismatch", "high",
                    f"alias pair in{in_idx}->out{out_idx} is out of range "
                    f"({len(spec.inputs)} inputs, {len(spec.outputs)} "
                    "outputs)", where=spec.name)
            continue
        bi, bo = spec.inputs[in_idx], spec.outputs[out_idx]
        where = f"{spec.name}:in{in_idx}->out{out_idx}"
        if tuple(bi.shape) != tuple(bo.shape) or bi.dtype != bo.dtype:
            rep.add("krn-alias-mismatch", "high",
                    f"aliased operands disagree: input {tuple(bi.shape)} "
                    f"{_dtype_name(bi.dtype)} vs output "
                    f"{tuple(bo.shape)} {_dtype_name(bo.dtype)} — the "
                    "in-place store reinterprets bytes",
                    where=where,
                    bytes=int(math.prod(bi.shape)) * bi.itemsize(),
                    suggestion="alias only identically-shaped/typed pairs")
            continue
        ri = _resolve_index_map(bi, spec.grid)
        ro = _resolve_index_map(bo, spec.grid)
        if any(r is not None and r[0] == "dynamic" for r in (ri, ro)):
            rep.add("krn-dynamic-index", "low",
                    "aliased pair has a dynamic index map; read-after-"
                    "overwrite check skipped", where=where)
            continue
        if ri == ro:                       # structurally identical
            continue
        ii, io = _images(ri, spec.grid), _images(ro, spec.grid)
        if ii is None or io is None:
            rep.add("krn-dynamic-index", "low",
                    "aliased pair not enumerable; read-after-overwrite "
                    "check skipped", where=where)
            continue
        bad = next((pt for pt in ii if ii[pt] != io[pt]), None)
        if bad is not None or tuple(bi.block_shape) != tuple(bo.block_shape):
            rep.add("krn-alias-raw", "high",
                    "aliased input is not read through the same blocks it "
                    "is overwritten through"
                    + (f" (grid point {_fmt_pt(bad)} reads block "
                       f"{_fmt_pt(ii[bad])} but writes "
                       f"{_fmt_pt(io[bad])})" if bad is not None else
                       " (block shapes differ)")
                    + " — a later grid point reads already-clobbered data",
                    where=where,
                    suggestion="give the aliased pair pointwise-equal "
                               "index maps")


def _smem_bytes(spec: KernelSpec) -> int:
    """Shared memory of one CTA: the declared shared scratch (static and
    dynamic alike; blocks are not staged implicitly on CUDA)."""
    return sum(s.nbytes() for s in spec.scratch if s.memory_space == "smem")


def lint_kernel_spec(spec: KernelSpec, *,
                     smem_budget: Optional[int] = None) -> Report:
    """Run every static ``krn-*`` check over one kernel spec."""
    rep = Report()
    _check_footprints(spec, rep)
    _check_carry(spec, rep)
    _check_aliases(spec, rep)
    sb = _smem_bytes(spec)
    budget = DEFAULT_SMEM_BUDGET if smem_budget is None else int(smem_budget)
    if sb > budget:
        rep.add("krn-smem-over-budget", "high",
                f"declared shared memory {sb} B a CTA exceeds the "
                f"{budget} B per-block limit",
                where=spec.name, bytes=sb - budget,
                suggestion="shrink the tiles or stage fewer of them")
    rep.meta["kernel"] = spec.name
    rep.meta["kernel_grid"] = tuple(spec.grid)
    rep.meta["kernel_smem_bytes"] = sb
    return rep


# ---------------------------------------------------------------------------
# the dynamic leg (CUDA tensors only)
# ---------------------------------------------------------------------------

_GUARD_BYTES = 4096     # NaN guard band before and after every input


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


def _guarded(a, fill):
    """A contiguous copy of tensor ``a`` placed between two guard bands of
    ``fill`` (16-byte aligned, so the kernels' vector loads stay legal);
    integer tensors and non-tensors pass through as copies."""
    if not isinstance(a, torch.Tensor):
        return a
    if not a.is_floating_point():
        return a.clone()
    g = _GUARD_BYTES // a.element_size()
    buf = torch.full((a.numel() + 2 * g,), fill, dtype=a.dtype, device=a.device)
    view = buf[g:g + a.numel()].view(a.shape)
    view.copy_(a)
    return view


@contextlib.contextmanager
def sentinel_outputs():
    """Every ``torch.empty`` in the scope filled with NaN (the integer
    maximum for integer tensors): PyTorch's deterministic mode with
    ``fill_uninitialized_memory``, warnings only; both settings restored
    on exit, also on an exception."""
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
        yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.is_floating_point():
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                       1: torch.uint8}[t.element_size()])
    return t


def _wrappers() -> dict:
    from ..kernels import GATE_WRAPPERS, WRAPPERS

    return {**WRAPPERS, **GATE_WRAPPERS}


def _wrapper_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in _wrappers().items()}


def _restore_counts(saved: Dict[str, int]) -> None:
    wrappers = _wrappers()
    for n, v in saved.items():
        wrappers[n].launches = v


def _dynamic_leg(name: str, specs, launch, plain, make_args, device, tol,
                 rep: Report, key=lambda spec: spec.name) -> None:
    """Launch the entry on the card and hold each launch to its spec.

    Three launches on guarded copies of one input: two with NaN guard
    bands, one with zero guard bands, each with every ``torch.empty``
    inside the wrappers filled with NaN (``fill_uninitialized_memory``).
    A NaN left in the zero-guard run where the plain version has none is a
    coverage hole; one only in the NaN-guard runs is an out-of-bounds read;
    the two NaN-guard runs must agree bit for bit; the zero-guard run must
    lie within ``tol`` of the plain version elsewhere.  The wrappers'
    launch counters are restored afterwards: the leg's launches land in no
    path's counts (``meta["gate_launches"]`` adds them up).  Each spec's
    compiled shared memory lands in ``meta`` under ``key(spec)``."""
    from ..kernels import _build

    t0 = time.perf_counter()
    saved = _wrapper_counts()
    base = make_args(device)
    ref = [r.detach() for r in _flat(plain(*[a.clone() if isinstance(a, torch.Tensor) else a
                                             for a in base]))]
    runs = {}
    try:
        with sentinel_outputs():
            for label, guard in (("nan", float("nan")), ("nan2", float("nan")), ("zero", 0.0)):
                args = [_guarded(a, guard) for a in base]
                runs[label] = [o.detach().clone() for o in _flat(launch(*args))]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        after = _wrapper_counts()
        _restore_counts(saved)
    gate = rep.meta.setdefault("gate_launches", {})
    for n in after:
        if after[n] != saved[n]:
            gate[n] = gate.get(n, 0) + after[n] - saved[n]

    if len(runs["zero"]) != len(ref):
        rep.add("krn-plain-mismatch", "high",
                f"the launch returns {len(runs['zero'])} tensors, the plain "
                f"version {len(ref)}", where=name)
    tols = tol if isinstance(tol[0], tuple) else (tol,) * len(ref)
    for i, (r, a, b, z) in enumerate(zip(ref, runs["nan"], runs["nan2"], runs["zero"])):
        where = f"{name}:out{i}"
        atol, rtol, floor, *slack = tols[i]
        if z.shape != r.shape or z.dtype != r.dtype:
            rep.add("krn-plain-mismatch", "high",
                    f"output {i} is {tuple(z.shape)} {_dtype_name(z.dtype)}, the plain "
                    f"version's {tuple(r.shape)} {_dtype_name(r.dtype)}", where=where)
            continue
        nbytes = z.numel() * z.element_size()
        if not torch.equal(_bits(a), _bits(b)):
            n = int((_bits(a) != _bits(b)).sum())
            rep.add("krn-write-race", "high",
                    f"two launches on the same inputs differ in {n} of {a.numel()} "
                    "elements — observed on the card, not proven: a race between "
                    "CTAs (or an unordered reduction)",
                    where=where, bytes=nbytes,
                    suggestion="give every output element one writer, in one order")
        if not z.is_floating_point():
            if not torch.equal(z, r):
                rep.add("krn-plain-mismatch", "high",
                        "integer output differs from the plain version", where=where)
            continue
        live = ~torch.isnan(r)
        hole = torch.isnan(z) & live
        oob = torch.isnan(a) & live & ~hole
        if bool(hole.any()):
            rep.add("krn-coverage-hole", "high",
                    f"{int(hole.sum())} of {z.numel()} output elements kept the NaN "
                    "sentinel — never written on the card",
                    where=where, bytes=int(hole.sum()) * z.element_size(),
                    suggestion="make the grid x index map cover every element")
        if bool(oob.any()):
            rep.add("krn-oob-read", "high",
                    f"{int(oob.sum())} of {z.numel()} output elements turn NaN only "
                    "when the inputs' guard bands hold NaN — a read outside an input",
                    where=where, bytes=int(oob.sum()) * z.element_size(),
                    suggestion="mask the tail loads")
        ok = live & ~torch.isnan(z)
        zf, rf = z.float()[ok], r.float()[ok]
        a_tol = atol
        if floor is not None:       # atol scaled by the plain output's largest |value|
            a_tol = atol * max(float(rf.abs().max()) if rf.numel() else 0.0, floor)
        limit = a_tol + rtol * rf.abs()
        if slack:                   # a further limit at each element, from the example
            limit = limit + slack[0](*base).float()[ok]
        bad = (zf - rf).abs() > limit
        if bool(bad.any()):
            err = float((zf - rf).abs().max())
            rep.add("krn-plain-mismatch", "high",
                    f"{int(bad.sum())} of {int(ok.sum())} elements outside (atol "
                    f"{a_tol:.3g}, rtol {rtol:.3g}) of the plain version; max |err| {err:.3e}",
                    where=where, bytes=nbytes,
                    suggestion="fix the kernel; the plain version is the reference")

    card = rep.meta.setdefault("smem_bytes_card_by_kernel", {})
    attrs = rep.meta.setdefault("attributes_by_kernel", {})
    for spec in specs:
        if spec.cuda is None:
            continue
        src, *query = spec.cuda
        at = _build.kernel_attributes(src, *query)
        k = key(spec)
        attrs[k] = at
        card[k] = at["static_smem"] + at["dynamic_smem"]
        if card[k] != _smem_bytes(spec):
            rep.add("krn-spec-mismatch", "high",
                    f"the compiled kernel uses {card[k]} B of shared memory "
                    f"({at['static_smem']} static + {at['dynamic_smem']} dynamic); its spec "
                    f"declares {_smem_bytes(spec)} B",
                    where=k,
                    suggestion="declare the kernel's shared tiles as they are")
    rep.meta["dynamic_ms"] = rep.meta.get("dynamic_ms", 0.0) + (time.perf_counter() - t0) * 1e3


def check_kernel(entry, device=None, *, smem_budget: Optional[int] = None,
                 dtype: Optional[str] = None) -> Report:
    """Verify one registry entry -> :class:`Report`.

    ``entry.build()`` (``entry.build(dtype)`` for an entry with
    ``dtypes``) gives ``(specs, launch, plain, example_args)``: one
    :class:`KernelSpec` per CUDA kernel the entry launches, the wrapper
    call, its plain version and a function ``device -> args``.  The static
    leg lints every spec; on a CUDA ``device`` the dynamic leg runs too.
    An entry with ``dtypes`` is verified at ``dtype``, or at each of its
    dtypes when ``dtype`` is None; its kernels are then named
    ``<kernel>@<dtype>`` in ``meta``, which carries ``kernels`` (CUDA
    kernels a launch of the entry runs), ``kernel_names``,
    ``smem_bytes_by_kernel``, ``dtypes`` and ``legs``."""
    if not entry.dtypes:
        dtypes = (None,)
    elif dtype is None:
        dtypes = tuple(entry.dtypes)
    elif dtype in entry.dtypes:
        dtypes = (dtype,)
    else:
        raise ValueError(f"{entry.name} has no example at dtype {dtype!r} "
                         f"(it has {entry.dtypes})")
    dev = torch.device("cpu" if device is None else device)
    rep = Report()
    sm: Dict[str, int] = {}
    rep.meta["kernels"] = 0
    rep.meta["legs"] = ["static"] + (["dynamic"] if dev.type == "cuda" else [])
    for dt in dtypes:
        specs, launch, plain, make_args = entry.build() if dt is None else entry.build(dt)

        def key(spec, dt=dt):
            return spec.name if dt is None else f"{spec.name}@{dt}"

        for spec in specs:
            r = lint_kernel_spec(spec, smem_budget=smem_budget)
            sm[key(spec)] = int(r.meta["kernel_smem_bytes"])
            rep.findings.extend(r.findings)
        rep.meta["kernels"] = max(rep.meta["kernels"], len(specs))
        if dev.type == "cuda":
            _dynamic_leg(entry.name if dt is None else f"{entry.name}@{dt}", specs, launch,
                         plain, make_args, dev, entry.tolerance(dt), rep, key)
    rep.meta["kernel_names"] = list(sm)
    rep.meta["kernel_smem_bytes"] = max(sm.values(), default=0)
    rep.meta["smem_bytes_by_kernel"] = sm
    rep.meta["dtypes"] = [dt for dt in dtypes if dt is not None]
    return rep
