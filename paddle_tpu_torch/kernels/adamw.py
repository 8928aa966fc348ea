"""Multi-tensor AdamW / Adam update (port of ``paddle_tpu/kernels/adamw.py``).

:func:`adamw_update_leaves` updates a table of leaves: on CUDA tensors it
launches the hand-written kernel of ``csrc/adamw.cu`` (the counterpart of
the Pallas ``_adamw_fused_call``, which the JAX optimizer calls once a
leaf) once for the whole table, or ``ceil(leaves / TABLE_CAP)`` times for a
larger one; on CPU tensors it runs :func:`adamw_reference` a leaf, the JAX
package's reference ported expression for expression.  Both update each
``p32``, ``m`` and ``v`` in place, as the Pallas kernel does through
``input_output_aliases``, and write the optional bf16 copy of the new
``p32`` into the leaf's ``out`` in the same pass.  :func:`adamw_update` is
one leaf, a table of one.

The per-step scalars are computed once a call, in fp32, the way the
reference computes them (``lr`` and ``t = step`` as fp32, ``c1 = 1 - beta1
** t``, ``c2 = 1 - beta2 ** t``, ``decay = 1 - lr * weight_decay``);
Python's double arithmetic cast to fp32 could differ by an ulp.  The kernel
rounds every operation on its own, so on the same inputs it gives the plain
version's bits.

A gradient may be fp32 or bf16, each leaf's its own (a bf16 model's fp32
MoE router beside bf16 weights is still one launch, with no widened copy):
the kernel widens bf16 exactly when it reads it, so it reads the bits
``g.float()`` would hold.

:class:`LeafTable` is the launch table of one set of leaves: pointers,
sizes, chunk numbering and flags, built once.  Each call fills in only the
gradients' pointers (autograd allocates them anew every step; params and
slots are updated in place, so theirs stay).  The optimizer keeps one and
hands it back each step (``table=``).

Registered in :mod:`.registry` as ``adamw_fused``: every leaf's ``p32``,
``m`` and ``v`` are declared in-place pairs, as the Pallas call's
``input_output_aliases``; each leaf and stream is a block operand whose
index map sends the chunks of other leaves to no block.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import to_dtype
from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics
from . import _build, registry

__all__ = ["adamw_reference", "adamw_update", "adamw_update_leaves", "LeafTable",
           "step_scalars", "kernel_spec", "CHUNK", "TABLE_CAP", "TRAIN_TABLES", "MOE_TABLE",
           "MOE_GRAD_DTYPES"]

_GEO = _build.GEOMETRY["adamw"]
CHUNK = _GEO["ADAMW_CHUNK"]            # elements a chunk, a CTA's work
TABLE_CAP = _GEO["ADAMW_TABLE_CAP"]    # leaves a launch
# _Leaf.flags, as csrc/adamw.cu reads them
_VEC, _COUPLED, _DECAY, _BF16_GRAD, _HEAD_SHIFT = 1, 2, 4, 8, 4
# the kernel's shared memory: its ring's slots (p, m, v, g as fp32 and the
# bf16 copy, 128-byte aligned) and their mbarriers
SMEM_BYTES = (_GEO["ADAMW_STAGES"] * (-(-18 * _GEO["ADAMW_STAGE"] // 128) * 128) + 128)


class _Leaf(ctypes.Structure):
    """One entry of the launch table: ``csrc/adamw.cu``'s ``Leaf`` (its
    pointers as 64-bit integers, so a numpy view can set a column)."""
    _fields_ = [("p", ctypes.c_uint64), ("g", ctypes.c_uint64), ("m", ctypes.c_uint64),
                ("v", ctypes.c_uint64), ("out", ctypes.c_uint64), ("n", ctypes.c_longlong),
                ("chunk0", ctypes.c_int), ("flags", ctypes.c_int),
                ("reserved", ctypes.c_longlong)]


assert ctypes.sizeof(_Leaf) == 64


def _f32(x) -> torch.Tensor:
    """A Python number or tensor as an fp32 0-d tensor (a CPU scalar for a
    number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32)


def adamw_reference(p32, g32, m, v, lr, step, *, beta1, beta2, epsilon,
                    weight_decay=0.0, decoupled=True, apply_decay=True):
    """The update the kernel must bit-match; returns ``(p_new, m_new,
    v_new)`` and leaves its inputs untouched.  ``apply_decay=False`` leaves
    the leaf undecayed in either form, as the JAX optimizer's XLA update
    does (its ``no_weight_decay``); the JAX Pallas kernel adds a coupled
    decay regardless."""
    lr = _f32(lr)
    t = _f32(step)
    if weight_decay and not decoupled and apply_decay:
        g32 = g32 + weight_decay * p32
    if weight_decay and decoupled and apply_decay:
        p32 = p32 * (1.0 - lr * weight_decay)
    m_new = beta1 * m + (1 - beta1) * g32
    v_new = beta2 * v + (1 - beta2) * torch.square(g32)
    # the divisors live on the data's device: PyTorch's CUDA division by a
    # CPU scalar multiplies by its reciprocal, one rounding more
    m_hat = m_new / (1 - beta1 ** t).to(m.device)
    v_hat = v_new / (1 - beta2 ** t).to(m.device)
    p_new = p32 - lr * m_hat / (torch.sqrt(v_hat) + epsilon)
    return p_new, m_new, v_new


def step_scalars(lr, step, beta1, beta2, weight_decay) -> Tuple[float, float, float, float]:
    """``(lr, c1, c2, decay)`` of one step, each an fp32 value computed as
    :func:`adamw_reference` computes it."""
    lr = _f32(lr).cpu()
    t = _f32(step).cpu()
    c1 = 1 - beta1 ** t
    c2 = 1 - beta2 ** t
    decay = 1.0 - lr * weight_decay
    return float(lr), float(c1), float(c2), float(decay)


def _head(ptr: int) -> int:
    """fp32 elements before the first 16-byte boundary at ``ptr``."""
    return (-ptr % 16) // 4


def _check_layout(lib) -> None:
    """Raise unless the compiled table's layout is the one ``_Leaf`` and
    this module's constants describe."""
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.adamw_layout(ctypes.addressof(out)), "adamw_layout")
    want = (ctypes.sizeof(_Leaf), TABLE_CAP, CHUNK, _GEO["ADAMW_THREADS"])
    if tuple(out) != want:
        raise RuntimeError(f"csrc/adamw.cu's table layout {tuple(out)} != the wrapper's {want}")


class LeafTable:
    """The launch table of a list of leaves: ``params32[i]``, ``ms[i]`` and
    ``vs[i]`` contiguous fp32 tensors of one size, ``outs[i]`` None or a
    contiguous bf16 tensor of that size (the copy of the new value);
    ``decay[i]``: multiply by the step's ``1 - lr * wd``; ``coupled[i]``:
    add ``wd * p`` to the gradient.  Built once; :meth:`fill` sets the
    gradients a call.  Empty leaves are left out.

    Chunk ``k`` of a leaf is its elements ``[head + k CHUNK, head + (k + 1)
    CHUNK)``, and chunk 0 also takes ``[0, head)``, where ``head`` is the
    count of elements before p's first 16-byte boundary; the chunks of all
    leaves are numbered in order, each launch (``TABLE_CAP`` leaves) from
    0."""

    def __init__(self, params32, ms, vs, outs, decay, coupled):
        dev = params32[0].device if params32 else torch.device("cpu")
        self.device = dev
        self.cast = any(o is not None for o in outs)
        self.key = self._key(params32, ms, vs, outs, decay, coupled)
        self.layout_checked = False
        rows = []
        for i, (p, m, v, o) in enumerate(zip(params32, ms, vs, outs)):
            n = p.numel()
            for name, x in (("p32", p), ("m", m), ("v", v)):
                if x.dtype != torch.float32 or x.numel() != n or x.device != dev:
                    raise ValueError(f"adamw leaf {i}: {name} must be fp32 of {n} values on "
                                     f"{dev}; got {x.dtype} {x.numel()} on {x.device}")
                if not x.is_contiguous():
                    raise ValueError(f"adamw leaf {i}: {name} must be contiguous")
            if o is not None and (o.dtype != torch.bfloat16 or o.numel() != n
                                  or o.device != dev or not o.is_contiguous()):
                raise TypeError(f"adamw leaf {i}: the copy must be a contiguous bf16 tensor of "
                                f"{n} values on {dev}; got {o.dtype} {o.numel()} on {o.device}")
            if n:
                rows.append((i, n, p, m, v, o, bool(decay[i]), bool(coupled[i])))
        # a launch group: (its ctypes array, a numpy view of it, the leaves'
        # indices, its chunks, its leaves' heads, whether their p, m, v and
        # copy share p's 16-byte phase)
        self.groups = []
        for lo in range(0, len(rows), TABLE_CAP):
            part = rows[lo:lo + TABLE_CAP]
            arr = (_Leaf * len(part))()
            chunks, heads, able = 0, [], []
            for e, (i, n, p, m, v, o, dec, cpl) in zip(arr, part):
                head = _head(p.data_ptr())
                e.p, e.m, e.v = p.data_ptr(), m.data_ptr(), v.data_ptr()
                e.out = 0 if o is None else o.data_ptr()
                e.n, e.chunk0 = n, chunks
                e.flags = (_DECAY if dec else 0) | (_COUPLED if cpl else 0) | (head << _HEAD_SHIFT)
                chunks += max(1, -(-max(n - head, 0) // CHUNK))
                heads.append(head)
                able.append(all(_head(x.data_ptr()) == head for x in (m, v))
                            and (o is None or (o.data_ptr() + 2 * head) % 16 == 0))
            self.groups.append((arr, np.ctypeslib.as_array(arr), [r[0] for r in part], chunks,
                                np.array(heads, np.uint64), np.array(able)))

    @staticmethod
    def _key(params32, ms, vs, outs, decay, coupled):
        return (tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(),
                       None if o is None else o.data_ptr())
                      for p, m, v, o in zip(params32, ms, vs, outs)),
                tuple(decay), tuple(coupled))

    def fits(self, params32, ms, vs, outs, decay, coupled) -> bool:
        """Whether the table was built for these tensors, where they lie
        now, and these flags."""
        return self._key(params32, ms, vs, outs, decay, coupled) == self.key

    def fill(self, grads) -> Tuple[torch.dtype, ...]:
        """Point every entry at its leaf's gradient, and set its gradient
        dtype flag and its vector flag (an fp32 gradient must share p's
        16-byte phase, a bf16 one be 16-byte aligned at p's head: the
        kernel moves them by TMA); returns the gradients' dtypes, each
        once, in the order met (fp32 or bf16, mixed at will)."""
        dev = self.device
        seen = []
        for arr, view, idx, _, heads, able in self.groups:
            gs = [grads[i] for i in idx]
            for i, g, n in zip(idx, gs, view["n"].tolist()):
                if g.dtype not in (torch.float32, torch.bfloat16):
                    raise TypeError(f"adamw leaf {i}: gradients must be fp32 or bf16, not "
                                    f"{g.dtype}")
                if g.numel() != n or g.device != dev or not g.is_contiguous():
                    raise ValueError(f"adamw leaf {i}: the gradient must be a contiguous "
                                     f"tensor of {n} values on {dev}; got {g.numel()} on "
                                     f"{g.device}")
                if g.dtype not in seen:
                    seen.append(g.dtype)
            ptrs = np.array([g.data_ptr() for g in gs], np.uint64)
            bf16 = np.array([g.dtype == torch.bfloat16 for g in gs])
            same = np.where(bf16, (ptrs + 2 * heads) % 16 == 0,
                            (-ptrs.astype(np.int64) % 16) // 4 == heads)
            view["g"] = ptrs
            view["flags"] = ((view["flags"] & ~(_VEC | _BF16_GRAD))
                             | np.where(able & same, _VEC, 0) | np.where(bf16, _BF16_GRAD, 0))
        return tuple(seen)

    def launch(self, scalars, hyper) -> int:
        """Launch the kernel over every group; returns the launches."""
        lr, c1, c2, decay = scalars
        beta1, beta2, eps, wd = hyper
        lib = _build.load("adamw")
        if not self.layout_checked:
            _check_layout(lib)
            self.layout_checked = True
        launches = 0
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            for arr, _, _, chunks, _, _ in self.groups:
                err = lib.adamw_multi_launch(
                    ctypes.addressof(arr), len(arr), chunks, lr, c1, c2, decay, beta1,
                    1 - beta1, beta2, 1 - beta2, eps, wd, int(self.cast), stream)
                _build.check(lib, err, "adamw_update_leaves")
                launches += 1
        return launches


def _flags(n, weight_decay, decoupled, apply_decay):
    """``(apply, decay, coupled)`` flags a leaf."""
    apply = [True] * n if apply_decay is None else [bool(a) for a in apply_decay]
    if len(apply) != n:
        raise ValueError(f"apply_decay has {len(apply)} flags for {n} leaves")
    wd = bool(weight_decay)
    return (apply, [wd and decoupled and a for a in apply],
            [wd and not decoupled and a for a in apply])


def dtype_key(g_dtype, cast: bool) -> str:
    """The registry dtype of a launch: the gradients' dtype, ``+copy`` when
    a bf16 copy is written."""
    return str(g_dtype).replace("torch.", "") + ("+copy" if cast else "")


def adamw_update_leaves(params32: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                        ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                        outs: Sequence[Optional[torch.Tensor]], lr, step, *, beta1, beta2,
                        epsilon, weight_decay=0.0, decoupled=True,
                        apply_decay: Optional[Sequence[bool]] = None,
                        table: Optional[LeafTable] = None) -> Optional[LeafTable]:
    """One Adam/AdamW step over a table of leaves, IN PLACE: every
    ``params32[i]``, ``ms[i]`` and ``vs[i]`` (fp32, contiguous, of one size
    a leaf) from ``grads[i]`` (fp32 or bf16, each leaf's own); where
    ``outs[i]`` is a bf16 tensor it receives the new value rounded.
    ``apply_decay[i]`` False leaves leaf ``i`` undecayed (default: every
    leaf decays).  ``lr`` and ``step`` are Python numbers or 0-d tensors.

    On CUDA tensors: ``ceil(leaves / TABLE_CAP)`` launches (one for up to
    ``TABLE_CAP`` leaves); ``table``, a :class:`LeafTable` an earlier call
    returned for the same tensors, is reused (rebuilt when they moved).
    Returns the table used (None on the CPU)."""
    n = len(params32)
    if not (len(grads) == len(ms) == len(vs) == len(outs) == n):
        raise ValueError("adamw_update_leaves: params32, grads, ms, vs and outs differ in length")
    if n == 0:
        return table
    dev = params32[0].device
    apply, decay, coupled = _flags(n, weight_decay, decoupled, apply_decay)
    with torch.no_grad():
        if dev.type == "cpu":
            cast = any(o is not None for o in outs)
            for g_dtype in dict.fromkeys(g.dtype for g in grads):
                registry.ensure_admitted("adamw_fused", dev, dtype_key(g_dtype, cast))
            for p, g, m, v, o, a in zip(params32, grads, ms, vs, outs, apply):
                p_new, m_new, v_new = adamw_reference(
                    p, g.to(torch.float32), m, v, lr, step, beta1=beta1, beta2=beta2,
                    epsilon=epsilon, weight_decay=weight_decay, decoupled=decoupled,
                    apply_decay=a)
                p.copy_(p_new)
                m.copy_(m_new)
                v.copy_(v_new)
                if o is not None:
                    o.copy_(p_new)
            return None
        if dev.type != "cuda":
            raise ValueError(f"adamw_update_leaves: unsupported device {dev}")
        if table is None or not table.fits(params32, ms, vs, outs, decay, coupled):
            table = LeafTable(params32, ms, vs, outs, decay, coupled)
        for g_dtype in table.fill(grads):
            registry.ensure_admitted("adamw_fused", dev, dtype_key(g_dtype, table.cast))
        scalars = step_scalars(lr, step, beta1, beta2, weight_decay)
        hyper = (float(beta1), float(beta2), float(epsilon), float(weight_decay))
        adamw_update_leaves.launches += table.launch(scalars, hyper)
        return table


adamw_update_leaves.launches = 0


def adamw_update(p32, g32, m, v, lr, step, *, beta1, beta2, epsilon,
                 weight_decay=0.0, decoupled=True, apply_decay=True,
                 out_dtype=None) -> Tuple[torch.Tensor, ...]:
    """One Adam/AdamW step over one leaf (a table of one, one launch on
    CUDA tensors); ``p32``, ``m``, ``v`` are fp32 tensors of one shape,
    updated IN PLACE, ``g32`` fp32 or bf16.  Returns ``(p32, m, v,
    p_out)``, where ``p_out`` is the ``out_dtype`` copy of the new ``p32``
    written in the same pass (``p_out is p32`` when no cast is asked
    for)."""
    out_dtype = None if out_dtype is None else to_dtype(out_dtype)
    cast = out_dtype is not None and out_dtype != torch.float32
    if cast and p32.device.type == "cuda" and out_dtype != torch.bfloat16:
        raise TypeError(f"adamw_update kernel casts to bfloat16 only, not {out_dtype}")
    out = torch.empty(p32.shape, dtype=out_dtype, device=p32.device) if cast else None
    adamw_update_leaves([p32], [g32], [m], [v], [out], lr, step, beta1=beta1, beta2=beta2,
                        epsilon=epsilon, weight_decay=weight_decay, decoupled=decoupled,
                        apply_decay=[apply_decay])
    return p32, m, v, (out if cast else p32)


# ---------------------------------------------------------------------------
# kernel-registry entry (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def kernel_spec(sizes: Sequence[int], cast=False, g_dtype=torch.float32) -> List[KernelSpec]:
    """The launches of ``adamw_multi_kernel`` over 16-byte aligned leaves of
    ``sizes`` (head 0), one spec a launch of up to ``TABLE_CAP`` leaves: a
    grid of one CTA a chunk (parallel), chunks numbered leaf after leaf.
    Every leaf and stream is a block operand of ``CHUNK``-element blocks
    whose table holds only its own chunks: another leaf's CTA maps to no
    block.  p, m and v are written in place through the blocks they are
    read through."""
    f32 = torch.float32
    specs = []
    sizes = [int(n) for n in sizes if n]
    for lo in range(0, len(sizes), TABLE_CAP):
        part = sizes[lo:lo + TABLE_CAP]
        inputs, outputs, aliases, chunks = [], [], {}, 0
        for i, n in enumerate(part):
            table = ("table", {(c,): (c - chunks,) for c in range(chunks, chunks - (-n // CHUNK))})
            chunks -= -n // CHUNK

            def leaf(name, dtype=f32):
                return BlockUse((n,), dtype, (CHUNK,), table, name=f"{name}[{lo + i}]",
                                masked=True)

            for name, dtype in (("p", f32), ("g", g_dtype), ("m", f32), ("v", f32)):
                inputs.append(leaf(name, dtype))
            for k in (0, 2, 3):                     # p, m, v: in place
                aliases[len(inputs) - 4 + k] = len(outputs)
                outputs.append(leaf("pgmv"[k]))
            if cast:
                outputs.append(leaf("out", torch.bfloat16))
        specs.append(KernelSpec(
            f"adamw_multi_kernel[{lo // TABLE_CAP}]", grid=(chunks,), inputs=inputs,
            outputs=outputs, aliases=aliases, dimension_semantics=cuda_semantics(1),
            scratch=[ScratchUse((SMEM_BYTES,), torch.uint8)],
            cuda=("adamw", 0, _build.dtype_code(g_dtype), int(cast), 0)))
    return specs


_HYPER = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01, decoupled=True)
# the production tables' examples are cut to 1/EXAMPLE_CUT of their elements
# (leaf count, order and relative sizes kept), so that the gate's four
# concurrent processes fit on one card; chip_smoke.py holds the kernel at
# the full sizes
EXAMPLE_CUT = 16


def _table(vocab: int, hidden: int, layer: List[int], layers: int) -> List[int]:
    """A causal LM's leaf sizes in its parameters' order: the untied head,
    the embedding, ``layers`` x ``layer``, the final norm."""
    return [hidden * vocab, vocab * hidden] + layer * layers + [hidden]


# the leaf sizes of the training paths' tables, the models' widths written
# out (tests/test_torch_optim.py holds them to the models): `base` (vocab
# 32000, hidden 2048, 16 query heads of 128 over 8, ffn 5632, 12 layers: a
# layer's norm, qkv, o, norm, gate | up, down) and `ssd_train` (ssd_8b:
# vocab 128256, hidden 4096, 64 heads of 64, state 128, 8 layers: a block's
# norm, in_proj z | x | B | C | dt, dt_bias, d_skip, out_proj)
TRAIN_TABLES = {
    "base": _table(32000, 2048, [2048, 2048 * 4096, 2048 * 2048, 2048, 2048 * 2 * 5632,
                                 5632 * 2048], 12),
    "ssd_train": _table(128256, 4096, [4096, 4096 * (2 * 64 * 64 + 2 * 64 * 128 + 64), 64, 64,
                                       64 * 64 * 4096], 8),
}
# the `moe` training step's leaves (vocab 32000, hidden 1024, 16 query heads
# of 64 over 8, 8 experts of 1408, 12 layers: a layer's norm, qkv, o, norm,
# router, w_gate_up, w_down), each with its gradient's dtype: bf16 (a bf16
# parameter over an fp32 master, written as its bf16 copy) but the fp32
# routers'; tests/test_torch_moe.py holds it to the model
MOE_TABLE = _table(32000, 1024, [1024, 1024 * 2048, 1024 * 1024, 1024, 1024 * 8,
                                 8 * 1024 * 2 * 1408, 8 * 1408 * 1024], 12)
MOE_GRAD_DTYPES = [torch.float32 if n == 1024 * 8 else torch.bfloat16 for n in MOE_TABLE]


def _registry_example(dtype="float32+copy"):
    """The JAX registry's 2048-value fp32 leaf at lr 3e-4, step 3: with the
    bf16 copy (``float32+copy``, the JAX example) or without, with fp32 or
    bf16 gradients; ``float32@base`` / ``float32@ssd_train``: the tables of
    those paths' 75 / 43 leaves (cut by EXAMPLE_CUT), fp32 gradients and
    no copy, as their training steps launch them."""
    kind, _, tag = dtype.partition("@")
    sizes = [-(-n // EXAMPLE_CUT) for n in TRAIN_TABLES[tag]] if tag else [2048]
    cast = kind.endswith("+copy")
    g_dtype = to_dtype(kind.replace("+copy", ""))
    lr, step, L = 3e-4, 3, len(sizes)

    def args(device):
        gen = torch.Generator().manual_seed(0)
        out = []
        for scale, fn in ((1.0, torch.randn), (1.0, torch.randn), (0.1, torch.randn),
                          (1e-3, torch.rand)):
            out += [(scale * fn(n, generator=gen)).to(device) for n in sizes]
        for i in range(L, 2 * L):           # the gradients, in their dtype
            out[i] = out[i].to(g_dtype)
        return out

    def split(a):
        return a[:L], a[L:2 * L], a[2 * L:3 * L], a[3 * L:]

    def launch(*a):
        p, g, m, v = split(a)
        outs = [torch.empty(n, dtype=torch.bfloat16, device=p[0].device) if cast else None
                for n in sizes]
        adamw_update_leaves(p, g, m, v, outs, lr, step, **_HYPER)
        return list(p) + list(m) + list(v) + (outs if cast else [])

    def plain(*a):
        p, g, m, v = split(a)
        res = [adamw_reference(*x, lr, step, **_HYPER)
               for x in zip(p, [x.float() for x in g], m, v)]
        cols = [list(c) for c in zip(*res)]
        return cols[0] + cols[1] + cols[2] + ([x.to(torch.bfloat16) for x in cols[0]]
                                               if cast else [])

    return kernel_spec(sizes, cast=cast, g_dtype=g_dtype), launch, plain, args


registry.register(
    "adamw_fused", _registry_example,
    presets=("tiny", "small", "base", "longctx", "moe", "ocr"),
    description="single-pass fused AdamW: p/m/v aliased in place + bf16 "
                "cast epilogue",
    # bitwise: the kernel rounds as the plain version
    dtypes=("float32+copy", "float32", "bfloat16", "bfloat16+copy", "float32@base",
            "float32@ssd_train"))
