"""Fusion sites (port of ``paddle_tpu/kernels/emit.py``).

Each :class:`FusionSite` names one model-seam region: the SwiGLU MLP
(``fuse_swiglu_mlp``: an elementwise chain between two products), the final
RMSNorm feeding the vocab projection (``fuse_rms_norm_head``: a norm+matmul
prologue) and the residual add with the post-attention RMSNorm
(``fuse_add_rms_norm``: a residual + cast epilogue).  The site references
below are the exact math of the seams they replace, as plain torch: they
round where the JAX references round, every weight is cast with
``.to(hidden.dtype)`` before its product (so an fp32 weight's gradient is a
bf16 product widened to fp32), and they are the plain versions the CPU path
and the tests run.

:func:`make_fused` builds a site's substituted callable, a
``torch.autograd.Function``.  On CUDA tensors its forward launches the
site's hand-written kernels (``csrc/fused_gemm.cu``, ``csrc/add_rms_norm.cu``;
the counterpart of the Pallas ``_row_block_call``) and saves only the
primals; its backward launches the site's backward kernels, the vjp of the
reference recomputed from the primals (the counterpart of
``_single_block_call``).  On CPU tensors both run the plain reference and
its autograd.  The six site functions carry ``launches`` counters (one a
site forward or backward, however many kernels it launches).

Substitution is scoped: :func:`activate` installs a table of sites, the
model seams (``models/llama.py``) read :func:`active` at every call and run
their stock path when a site is inactive.  :func:`verify_site` holds a
site's kernels against the plain reference before :func:`verified_activation`
installs it.

Each site registers its forward and its backward in :mod:`.registry`
(``fuse_*`` and ``fuse_*_bwd``) with the specs of every kernel the site
function launches (:func:`site_specs`); :func:`make_fused` admits both
before the first call when ``FLAGS_kernel_admission`` is on, and
:func:`verified_activation` admits both through the registry before it
verifies the site.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import default_device
from ..analysis.kernel_lint import tabulated
from . import add_rms_norm as arn
from . import fused_gemm as fg
from . import registry
from .rms_norm import rms_norm_reference

__all__ = [
    "FusionSite", "SITES", "active", "activate", "make_fused", "site_specs", "verify_site",
    "verified_activation",
]

# ---------------------------------------------------------------------------
# reference regions: the exact math of the model seams they replace
# ---------------------------------------------------------------------------


# ``x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics, in x's dtype
_rms_rows = rms_norm_reference


def _swiglu_ref(hidden, w_gate_up, w_down, *, intermediate_size):
    """models/llama.py ``mlp_fn``: fused gate_up matmul -> SwiGLU -> down."""
    gu = hidden @ w_gate_up.to(hidden.dtype)
    gate, up = torch.split(gu, [intermediate_size, gu.shape[-1] - intermediate_size], dim=-1)
    return (F.silu(gate) * up) @ w_down.to(hidden.dtype)


def _add_rms_norm_ref(x, h, w, *, epsilon):
    """Residual add + post-attention RMSNorm.  Returns (residual stream,
    normed)."""
    s = x + h
    return s, _rms_rows(s, w, epsilon)


def _rms_norm_head_ref(hidden, w_norm, w_head, *, epsilon, transpose):
    """Final RMSNorm feeding the vocab projection (norm+matmul prologue)."""
    normed = _rms_rows(hidden, w_norm, epsilon)
    wh = w_head.T if transpose else w_head
    return normed @ wh.to(normed.dtype)


# ---------------------------------------------------------------------------
# site catalogue
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusionSite:
    """One fusion region: the audit pattern it realizes, the reference
    whose math it reproduces, and how audit candidates are recognized
    (source basenames / op-name hints)."""

    name: str                      # name of the site's forward kernel
    pattern: str                   # audit pattern class this site realizes
    ref: Callable                  # plain reference region (keyword statics)
    n_row_args: int                # leading args that are rows (flattened to 2-D)
    match_sources: Tuple[str, ...] = ()
    match_hints: Tuple[str, ...] = ()
    example_static: Dict[str, object] = field(default_factory=dict)
    example_shapes: Tuple[Tuple[Tuple[int, ...], str], ...] = ()
    description: str = ""

    def matches(self, cand: Dict[str, object]) -> bool:
        # pattern agreement first: one source file can spawn regions of
        # different classes, and each must route to the site of its class
        if cand.get("pattern") and cand["pattern"] != self.pattern:
            return False
        if cand.get("source") in self.match_sources:
            return True
        return bool(set(cand.get("op_hints") or ()) & set(self.match_hints))


SITES: Dict[str, FusionSite] = {s.name: s for s in (
    FusionSite(
        name="fuse_swiglu_mlp",
        pattern="elementwise-chain",
        ref=_swiglu_ref,
        n_row_args=1,
        match_hints=("silu",),
        example_static=dict(intermediate_size=384),
        example_shapes=(((64, 128), "float32"), ((128, 768), "float32"),
                        ((384, 128), "float32")),
        description="SwiGLU MLP: gate_up matmul + silu*up chain + down matmul "
                    "in one VMEM pass (elementwise chain around the dot)"),
    FusionSite(
        name="fuse_add_rms_norm",
        pattern="cast-epilogue",
        ref=_add_rms_norm_ref,
        n_row_args=2,
        match_sources=("rms_norm.py",),
        example_static=dict(epsilon=1e-6),
        example_shapes=(((64, 128), "float32"), ((64, 128), "float32"),
                        ((128,), "float32")),
        description="residual add + RMSNorm + dtype-cast epilogue: the residual "
                    "stream and its norm leave VMEM exactly once"),
    FusionSite(
        name="fuse_rms_norm_head",
        pattern="norm-prologue",
        ref=_rms_norm_head_ref,
        n_row_args=1,
        match_sources=("rms_norm.py",),
        match_hints=("lm_head",),
        example_static=dict(epsilon=1e-6, transpose=False),
        example_shapes=(((64, 128), "float32"), ((128,), "float32"),
                        ((128, 512), "float32")),
        description="final RMSNorm feeding the vocab projection: norm+matmul "
                    "prologue, row statistics never round-trip HBM"),
)}


# ---------------------------------------------------------------------------
# each site's forward and backward, composed of the kernels' wrappers: the
# kernels on CUDA tensors; on CPU tensors each piece runs its plain version,
# which lets the CPU tests hold the composition against the reference
# ---------------------------------------------------------------------------

def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _vjp_reference(site: FusionSite, primals, cts, static):
    """Autograd of the plain reference, recomputed from the primals."""
    with torch.enable_grad():
        p = [a.detach().requires_grad_() for a in primals]
        outs = _as_tuple(site.ref(*p, **static))
        return tuple(torch.autograd.grad(outs, p, tuple(cts)))


def _count(fn, t: torch.Tensor) -> None:
    if t.is_cuda:
        fn.launches += 1


def fuse_swiglu_mlp_fwd(hidden, w_gate_up, w_down, *, intermediate_size, lib="fused_gemm"):
    """``(silu(gate) * up) @ w_down``: gate_up with the SwiGLU epilogue
    (``gu`` never stored), then the down product; ``lib`` the GEMM's
    library (a build variant only in the kernel gate's seeded defect).
    Each fp32 weight is rounded to a bf16 compute dtype once a call."""
    w_gate_up, w_down = (fg.to_compute(w, hidden.dtype) for w in (w_gate_up, w_down))
    act = fg.swiglu_gate_up(hidden, w_gate_up, intermediate_size, lib=lib)
    out = fg.matmul(act, w_down, lib=lib)
    _count(fuse_swiglu_mlp_fwd, hidden)
    return out


def fuse_swiglu_mlp_bwd(primals, cts, *, intermediate_size):
    """``(d_hidden, d_w_gate_up, d_w_down)`` for the cotangent of the
    output: five products, the recomputed gate_up carrying the SwiGLU
    backward epilogue."""
    hidden, w_gate_up, w_down = primals
    (d_out,) = cts
    wgu, wd = (fg.to_compute(w, hidden.dtype) for w in (w_gate_up, w_down))
    d_act = fg.matmul(d_out, wd, b_t=True)
    act, d_gu = fg.swiglu_gate_up_bwd(hidden, wgu, d_act, intermediate_size)
    d_w_down = fg.matmul(act, d_out, a_t=True, out_dtype=w_down.dtype)
    d_hidden = fg.matmul(d_gu, wgu, b_t=True)
    d_w_gate_up = fg.matmul(hidden, d_gu, a_t=True, out_dtype=w_gate_up.dtype)
    _count(fuse_swiglu_mlp_bwd, hidden)
    return d_hidden, d_w_gate_up, d_w_down


def fuse_add_rms_norm_fwd(x, h, w, *, epsilon):
    """``(s, normed)``, ``s = x + h``, in one pass."""
    out = arn.add_rms_norm_fwd(x, h, w, epsilon)
    _count(fuse_add_rms_norm_fwd, x)
    return out


def fuse_add_rms_norm_bwd(primals, cts, *, epsilon):
    """``(dx, dh, dw)`` for the cotangents of ``s`` and ``normed``."""
    x, h, w = primals
    d_s, d_normed = cts
    out = arn.add_rms_norm_bwd(x, h, w, d_s, d_normed, epsilon)
    _count(fuse_add_rms_norm_bwd, x)
    return out


def fuse_rms_norm_head_fwd(hidden, w_norm, w_head, *, epsilon, transpose):
    """Logits of the final RMSNorm's rows: the row statistic, then the
    vocab product with the RMS prologue (normed rows never stored)."""
    r = fg.row_rms(hidden, epsilon)
    out = fg.matmul(hidden, fg.to_compute(w_head, hidden.dtype), b_t=transpose,
                    rms=(r, w_norm, "a"))
    _count(fuse_rms_norm_head_fwd, hidden)
    return out


def fuse_rms_norm_head_bwd(primals, cts, *, epsilon, transpose):
    """``(d_hidden, d_w_norm, d_w_head)`` for the logits' cotangent: the
    normed rows' gradient, the head weight's (the RMS prologue on the
    transposed operand), then the norm's backward."""
    hidden, w_norm, w_head = primals
    (d_logits,) = cts
    d_normed = fg.matmul(d_logits, fg.to_compute(w_head, hidden.dtype), b_t=not transpose)
    r = fg.row_rms(hidden, epsilon)
    if transpose:    # w_head is the [vocab, hidden] embedding: dE = dLᵀ normed
        d_w_head = fg.matmul(d_logits, hidden, a_t=True, rms=(r, w_norm, "b"),
                             out_dtype=w_head.dtype)
    else:            # dW = normedᵀ dL
        d_w_head = fg.matmul(hidden, d_logits, a_t=True, rms=(r, w_norm, "a"),
                             out_dtype=w_head.dtype)
    d_hidden, _, d_w_norm = arn.add_rms_norm_bwd(hidden, None, w_norm, None, d_normed, epsilon)
    _count(fuse_rms_norm_head_bwd, hidden)
    return d_hidden, d_w_norm, d_w_head


_FORWARD = {"fuse_swiglu_mlp": fuse_swiglu_mlp_fwd, "fuse_add_rms_norm": fuse_add_rms_norm_fwd,
            "fuse_rms_norm_head": fuse_rms_norm_head_fwd}
_BACKWARD = {"fuse_swiglu_mlp": fuse_swiglu_mlp_bwd, "fuse_add_rms_norm": fuse_add_rms_norm_bwd,
             "fuse_rms_norm_head": fuse_rms_norm_head_bwd}
for _fn in (*_FORWARD.values(), *_BACKWARD.values()):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# fused callables
# ---------------------------------------------------------------------------

def _flatten_rows(arrays, n_row_args):
    """Collapse leading dims of the row args to 2-D (weights pass through
    untouched); returns (flat_arrays, restore)."""
    lead = arrays[0].shape[:-1]
    flat = tuple(a.reshape(-1, a.shape[-1]).contiguous() if i < n_row_args else a.contiguous()
                 for i, a in enumerate(arrays))

    def restore(v):
        return v.reshape(*lead, *v.shape[1:])

    return flat, restore


class _FusedSite(torch.autograd.Function):
    """A site's forward kernels; the backward kernels recompute from the
    saved primals, as the JAX ``custom_vjp`` saves only them.  On CPU
    tensors: the plain reference, and its autograd from the primals."""

    @staticmethod
    def forward(ctx, name, static, *arrays):
        ctx.name, ctx.static = name, static
        ctx.save_for_backward(*arrays)
        if arrays[0].device.type == "cpu":
            return SITES[name].ref(*arrays, **static)
        return _FORWARD[name](*arrays, **static)

    @staticmethod
    def backward(ctx, *cts):
        primals = ctx.saved_tensors
        cts = tuple(c.contiguous() for c in cts)
        if primals[0].device.type == "cpu":
            grads = _vjp_reference(SITES[ctx.name], primals, cts, ctx.static)
        else:
            grads = _BACKWARD[ctx.name](primals, cts, **ctx.static)
        return (None, None, *grads)


def make_fused(name: str, device=None) -> Callable:
    """The substituted callable of a site: ``call(*arrays, **static)``
    differentiable in every array.  With ``device`` set it refuses tensors
    on another device type, so a table verified for the card never runs the
    CPU path unasked."""
    site = SITES[name]
    dev_type = None if device is None else torch.device(device).type

    def call(*arrays, **static):
        if dev_type is not None and arrays[0].device.type != dev_type:
            raise ValueError(f"{name}: made for {dev_type}, called on {arrays[0].device}")
        dtype = registry.dtype_key(arrays[0].dtype, arrays[-1].dtype)   # rows, then a weight
        registry.ensure_admitted(name, arrays[0].device, dtype)
        registry.ensure_admitted(name + "_bwd", arrays[0].device, dtype)
        flat, restore = _flatten_rows(arrays, site.n_row_args)
        out = _FusedSite.apply(name, static, *flat)
        if isinstance(out, tuple):
            return tuple(restore(o) for o in out)
        return restore(out)

    call.site = site
    return call


# ---------------------------------------------------------------------------
# active-substitution table
# ---------------------------------------------------------------------------

_ACTIVE: Dict[str, Callable] = {}


def active(name: str) -> Optional[Callable]:
    """The substituted callable for a site, or None (seam runs stock)."""
    return _ACTIVE.get(name)


@contextlib.contextmanager
def activate(mapping: Dict[str, Callable]):
    """Scope a set of substitutions (site name -> fused callable); the table
    is restored on exit, also when an exception leaves the scope."""
    saved = dict(_ACTIVE)
    _ACTIVE.update(mapping)
    try:
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(saved)


# ---------------------------------------------------------------------------
# verification against the plain reference
# ---------------------------------------------------------------------------

# fp32 at the example shapes: the kernels sum in another order than the
# plain products (sums of up to 768 terms), so every output and gradient
# must lie within VERIFY_RTOL of its largest |value|; fp32 rounding of such
# sums is ~1e-6 of that scale, and a wrong term moves an entry by ~1e-2
VERIFY_RTOL = 1e-5


def _example_concrete(site: FusionSite, device, seed: int, shapes=None):
    """N(0, 0.1^2) tensors of the site's example shapes, drawn on the CPU
    (the same numbers on every device)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = shapes or [(s, torch.float32) for s, _ in site.example_shapes]
    return tuple((0.1 * torch.randn(s, generator=gen)).to(dt).to(device) for s, dt in shapes)


def verify_site(name: str, device=None) -> List[dict]:
    """Hold the site's kernels on ``device`` (default the card) against the
    plain reference at the example shapes, in three legs from local to
    global:

    1. the forward kernels against the plain reference;
    2. the backward kernels against ``torch.autograd`` of the plain
       reference, on the same cotangents;
    3. end to end: gradients through the installed Function against
       gradients through the stock path, under a data-dependent scalar loss.

    Each is held to ``VERIFY_RTOL`` of the reference's largest |value|, not
    bitwise: the hand-written products sum in another order.  Returns the
    findings (code ``fuse-verify-mismatch``); an empty list means the site
    may be activated."""
    dev = default_device(device)
    site = SITES[name]
    static = dict(site.example_static)
    args = _example_concrete(site, dev, 0)
    findings: List[dict] = []

    def hold(leg, i, got, want):
        want = want.detach()
        err = float((got.detach().float() - want.float()).abs().max())
        limit = VERIFY_RTOL * max(float(want.float().abs().max()), 1e-30)
        if got.dtype != want.dtype or got.shape != want.shape or not err <= limit:
            findings.append({
                "code": "fuse-verify-mismatch", "severity": "high", "where": f"{name}[{leg} {i}]",
                "message": f"{leg} {i} on {dev} is {err} from the plain reference "
                           f"(limit {limit})",
                "suggestion": "reject the site; the seam stays on the stock path"})

    refs = _as_tuple(site.ref(*args, **static))
    for i, (g, w) in enumerate(zip(_as_tuple(_FORWARD[name](*args, **static)), refs)):
        hold("forward output", i, g, w)
    cts = _example_concrete(site, dev, 1, [(r.shape, r.dtype) for r in refs])
    want = _vjp_reference(site, args, cts, static)
    for i, (g, w) in enumerate(zip(_BACKWARD[name](args, cts, **static), want)):
        hold("backward grad", i, g, w)
    weights = _example_concrete(site, dev, 2, [(r.shape, r.dtype) for r in refs])
    fused = make_fused(name)

    def grads(fn):
        with torch.enable_grad():
            p = [a.detach().requires_grad_() for a in args]
            loss = sum(torch.sum(o * w) for o, w in zip(_as_tuple(fn(*p, **static)), weights))
            return torch.autograd.grad(loss, p)

    for i, (g, w) in enumerate(zip(grads(fused), grads(site.ref))):
        hold("end-to-end grad", i, g, w)
    return findings


def verified_activation(device=None) -> Dict[str, Callable]:
    """Activation table of every site whose kernels pass registry admission
    (``registry.admit`` of the site's forward and backward entries at each
    of their dtypes: the kernel verifier's static leg, and on a CUDA
    ``device`` its dynamic leg; admit records them in the admission cache,
    so :func:`make_fused`'s admission under ``FLAGS_kernel_admission``
    finds them admitted) AND :func:`verify_site` on ``device`` (default the
    card).  A site that fails either is left out, so its seam runs the
    stock path, and a ``RuntimeWarning`` names it with its findings; a
    caller that needs every site compares the table's keys with ``SITES``."""
    dev = default_device(device)
    table = {}
    for name in SITES:
        try:
            registry.admit(name, device=dev)
            registry.admit(name + "_bwd", device=dev)
        except registry.KernelRejected as e:
            warnings.warn(f"{name} was refused by kernel admission on {dev} and stays on "
                          f"the stock path: {e}", RuntimeWarning, stacklevel=2)
            continue
        findings = verify_site(name, dev)
        if findings:
            warnings.warn(f"{name} failed verification on {dev} and stays on the stock path: "
                          f"{findings}", RuntimeWarning, stacklevel=2)
        else:
            table[name] = make_fused(name, dev)
    return table


# ---------------------------------------------------------------------------
# registry entries: every site's kernels pass the kernel_lint admission seam
# ---------------------------------------------------------------------------

_FUSE_PRESETS = ("tiny", "small", "base", "longctx")
# fp32 at the example shapes, bf16 rows over fp32 weights (the `base` train
# path's) and over bf16 weights, and bf16 rows over fp32 weights again at
# `base`'s widths ("@base": the launches the fused `base` step makes, so the
# card's leg checks the tensor-core GEMM at a production shape): the
# kernels' tests' tolerances, the atol scaled by the plain output's largest
# |value|
_SITE_DTYPES = ("float32", "bfloat16+float32", "bfloat16", "bfloat16+float32@base")
_BF16_SITE_TOL = (1e-3, 1.6e-2, 1e-30)
_SITE_TOL = {"float32": (1e-5, 1e-5, 1e-30), "bfloat16+float32": _BF16_SITE_TOL,
             "bfloat16": _BF16_SITE_TOL, "bfloat16+float32@base": _BF16_SITE_TOL}
# `base`'s site shapes: batch 3 x seq 2048 rows, hidden 2048, intermediate
# 5632, vocab 32000 (the untied head): (statics, primal shapes)
_BASE_EXAMPLES = {
    "fuse_swiglu_mlp": ({"intermediate_size": 5632}, ((6144, 2048), (2048, 11264), (5632, 2048))),
    "fuse_add_rms_norm": ({"epsilon": 1e-6}, ((6144, 2048), (6144, 2048), (2048,))),
    "fuse_rms_norm_head": ({"epsilon": 1e-6, "transpose": False},
                           ((6144, 2048), (2048,), (2048, 32000))),
}


def site_specs(name: str, shapes, static, backward: bool = False,
               lib: str = "fused_gemm") -> list:
    """The spec of every CUDA kernel a site's forward (or backward)
    launches, for primals of ``shapes`` ``[(shape, dtype), ...]``, in the
    order the site function launches them (on bf16 rows over fp32 weights
    first each weight's rounding, once a call)."""
    (M, H), dt = shapes[0]
    wdt = shapes[1][1]
    bf16 = torch.bfloat16

    def rounded(*weights):
        """The rounding passes of ``(label, shape, dtype)`` weights, and the
        dtype the products then read each weight in."""
        specs = [fg.prep_spec(f"round {lbl}", *shape, w) for lbl, shape, w in weights
                 if dt == bf16 and w == torch.float32]
        return specs, [bf16 if dt == bf16 else w for _, _, w in weights]

    if name == "fuse_swiglu_mlp":
        I = static["intermediate_size"]
        pre, (gdt, ddt) = rounded(("w_gate_up", (H, 2 * I), wdt), ("w_down", (I, H), wdt))
        if not backward:
            return pre + [*fg.matmul_specs("gate_up+swiglu", M, I, H, dt, b_dtype=gdt,
                                           epi=fg._EPI_SWIGLU, lib=lib),
                          *fg.matmul_specs("down", M, H, I, dt, b_dtype=ddt, lib=lib)]
        return pre + [*fg.matmul_specs("d_act", M, I, H, dt, b_dtype=ddt, b_t=True),
                      *fg.matmul_specs("gate_up+swiglu_bwd", M, I, H, dt, b_dtype=gdt,
                                       epi=fg._EPI_SWIGLU_BWD),
                      *fg.matmul_specs("d_w_down", I, H, M, dt, c_dtype=wdt, a_t=True),
                      *fg.matmul_specs("d_hidden", M, H, 2 * I, dt, b_dtype=gdt, b_t=True),
                      *fg.matmul_specs("d_w_gate_up", H, 2 * I, M, dt, c_dtype=wdt, a_t=True)]
    if name == "fuse_add_rms_norm":
        wdt = shapes[2][1]
        if not backward:
            return [arn.fwd_spec(M, H, dt, wdt)]
        return arn.bwd_specs(M, H, dt, wdt, with_h=True, with_ds=True)
    if name == "fuse_rms_norm_head":
        transpose = static["transpose"]
        w_head = shapes[2]
        V = w_head[0][0] if transpose else w_head[0][1]
        hdt = w_head[1]
        pre, (rdt,) = rounded(("w_head", w_head[0], hdt))
        if not backward:
            return [fg.row_rms_spec(M, H, dt), *pre,
                    *fg.matmul_specs("head", M, V, H, dt, b_dtype=rdt, b_t=transpose,
                                     rms_side="a")]
        if transpose:       # dE = dLᵀ normed: the prologue on the transposed B
            d_w_head = fg.matmul_specs("d_w_head", V, H, M, dt, c_dtype=hdt, a_t=True,
                                       rms_side="b")
        else:               # dW = normedᵀ dL
            d_w_head = fg.matmul_specs("d_w_head", H, V, M, dt, c_dtype=hdt, a_t=True,
                                       rms_side="a")
        return [*pre, *fg.matmul_specs("d_normed", M, H, V, dt, b_dtype=rdt,
                                       b_t=not transpose),
                fg.row_rms_spec(M, H, dt), *d_w_head,
                *arn.bwd_specs(M, H, dt, wdt, with_h=False, with_ds=False)]
    raise KeyError(name)


def _example_shapes(site: FusionSite, dtype: str = "float32"):
    """The site's example primals: its rows in ``dtype``'s first dtype,
    the weights in its last (``"bfloat16+float32"``: bf16 rows, fp32
    weights), at `base`'s widths for an ``@base`` key."""
    names, _, at = dtype.partition("@")
    names = names.split("+")
    rows, weights = getattr(torch, names[0]), getattr(torch, names[-1])
    shapes = _BASE_EXAMPLES[site.name][1] if at else [s for s, _ in site.example_shapes]
    return [(s, rows if i < site.n_row_args else weights) for i, s in enumerate(shapes)]


def _example_static(site: FusionSite, dtype: str = "float32"):
    return dict(_BASE_EXAMPLES[site.name][0] if "@" in dtype else site.example_static)


def _fwd_builder(site: FusionSite):
    def build(dtype="float32"):
        static = _example_static(site, dtype)
        shapes = _example_shapes(site, dtype)
        return (tabulated(site_specs(site.name, shapes, static)),
                lambda *a: _FORWARD[site.name](*a, **static),
                lambda *a: site.ref(*a, **static),
                lambda device: _example_concrete(site, device, 0, shapes))
    return build


def _bwd_builder(site: FusionSite):
    def build(dtype="float32"):
        static = _example_static(site, dtype)
        n = len(site.example_shapes)
        shapes = _example_shapes(site, dtype)

        def args(device):
            primals = _example_concrete(site, device, 0, shapes)
            refs = _as_tuple(site.ref(*primals, **static))
            return primals + _example_concrete(site, device, 1,
                                               [(r.shape, r.dtype) for r in refs])

        return (tabulated(site_specs(site.name, shapes, static, backward=True)),
                lambda *a: _BACKWARD[site.name](a[:n], a[n:], **static),
                lambda *a: _vjp_reference(site, a[:n], a[n:], static), args)
    return build


for _site in SITES.values():
    registry.register(_site.name, _fwd_builder(_site), presets=_FUSE_PRESETS,
                      description=f"emitted fusion kernel: {_site.description}",
                      tol=_SITE_TOL, dtypes=_SITE_DTYPES)
    registry.register(_site.name + "_bwd", _bwd_builder(_site), presets=_FUSE_PRESETS,
                      description=f"emitted vjp kernel for {_site.name} "
                                  "(recompute-from-primals, residuals in VMEM)",
                      tol=_SITE_TOL, dtypes=_SITE_DTYPES)
