"""SSD (state-space duality) chunked scan (port of
``paddle_tpu/kernels/ssd_scan.py``).

The training-time form of the Mamba-2-style selective state-space layer
(``models/ssd.py``): the linear recurrence

    S_t = a_t * S_{t-1} + B_t x_t^T        (state [N, P], decay a_t in (0,1])
    y_t = C_t^T S_t

computed in chunks of ``L`` tokens: within a chunk a masked ``[L, L]``
"attention" form, across chunks the ``[N, P]`` state carried in order.  The
caller flattens (batch, heads) into one leading ``G`` axis of independent
recurrences.

:func:`ssd_chunk_outputs` and :func:`ssd_chunk_state` are the JAX helpers
batched over ``G``; :func:`ssd_scan_reference` (a loop over chunks, through
:func:`ssd_scan_states`, which also keeps the boundary states the prefill
reads) is the plain version and :func:`ssd_recurrence_reference` the
token-by-token oracle.  :func:`ssd_scan` is differentiable through :class:`_SSDScan`: its
forward launches the hand-written kernel ``csrc/ssd_scan.cu`` (the
counterpart of the Pallas ``_ssd_scan_call``) on CUDA tensors and runs the
plain version on CPU tensors; its backward recomputes the plain version
under autograd and returns its VJP, as ``_ssd_scan_diff_bwd`` does (the JAX
package has no backward kernel for the scan).

Registered in :mod:`.registry` as ``ssd_scan``: the state carried over the
CTA's own chunk loop, the counterpart of the Pallas call's sequential chunk
axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse
from . import _build, registry

__all__ = ["ssd_chunk_outputs", "ssd_chunk_state", "ssd_scan_states", "ssd_scan_reference",
           "ssd_recurrence_reference", "ssd_scan", "column_block"]

# what the kernel (csrc/ssd_scan.cu) is instantiated for: P split into column
# blocks of the widest of these that divides it, one CTA each; N and L
# (chunk) from these sets.  Every such (block, N, L) fits shared memory.
COLUMN_BLOCKS = (64, 32, 8)
KERNEL_N = (4, 8, 16, 32, 64, 128)
KERNEL_L = (16, 32, 64, 128)


def column_block(P: int, N: int, L: int) -> int:
    """The column block the kernel runs ``(P, N, chunk L)`` with; raises
    ``ValueError`` naming the limit a shape the kernel does not take
    breaks."""
    if N not in KERNEL_N:
        raise ValueError(f"ssd_scan kernel: N={N} not in {KERNEL_N}")
    if L not in KERNEL_L:
        raise ValueError(f"ssd_scan kernel: chunk={L} not in {KERNEL_L}")
    for pb in COLUMN_BLOCKS:
        if P > 0 and P % pb == 0:
            return pb
    raise ValueError(f"ssd_scan kernel: P={P} is not a multiple of {COLUMN_BLOCKS[-1]} "
                     f"(column blocks of {COLUMN_BLOCKS})")


def ssd_chunk_outputs(s, x, b, c, la):
    """Outputs of one chunk per ``g`` given the inbound state ``s``.

    ``s`` [G, N, P]; ``x`` [G, L, P]; ``b``/``c`` [G, L, N]; ``la`` [G, L]
    (log-decay, <= 0).  Returns y [G, L, P] where

        y_t = sum_{s<=t} (prod_{u=s+1..t} a_u) (C_t . B_s) x_s
              + (prod_{u<=t} a_u) C_t^T S_in

    The masked entries are cleared BEFORE exp, so the upper triangle's
    positive log-sums never overflow.  Rows with ``x = b = c = 0, la = 0``
    are exact no-ops on every other row's output."""
    L = x.shape[1]
    cum = torch.cumsum(la, dim=-1)                                  # [G, L], inclusive
    idx = torch.arange(L, device=x.device)
    mask = idx[None, :] <= idx[:, None]                             # [t, s]: s <= t
    seg = torch.where(mask, cum[:, :, None] - cum[:, None, :], 0.0)
    cb = torch.bmm(c, b.transpose(1, 2))                            # [G, L, L]
    m = torch.where(mask, cb * torch.exp(seg), 0.0)
    y = torch.bmm(m, x)
    inter = torch.bmm(c, s)
    return y + torch.exp(cum)[:, :, None] * inter


def ssd_chunk_state(s, x, b, la):
    """State after one chunk: ``S' = (prod a) S + sum_s (prod_{u>s} a_u)
    B_s x_s^T``, per ``g``."""
    cum = torch.cumsum(la, dim=-1)
    total = cum[:, -1:]                                             # [G, 1]
    w = torch.exp(total - cum)                                      # [G, L]
    bw = b * w[:, :, None]
    ds = torch.bmm(bw.transpose(1, 2), x)                           # [G, N, P]
    return torch.exp(total)[:, :, None] * s + ds


def ssd_scan_states(x, b, c, la, chunk: int):
    """The plain chunked scan with its boundary states: ``x`` [G, T, P],
    ``b``/``c`` [G, T, N], ``la`` [G, T], ``T % chunk == 0`` (callers
    zero-pad, which is exact).  Returns ``(y [G, T, P], states)`` where
    ``states[i]`` [G, N, P] is the state after the first ``i`` chunks
    (``states[0]`` zero, ``states[-1]`` the final one).  The chunks are taken
    by ``unbind``, whose backward is one stack: a per-chunk index would give
    every chunk a full-size zero gradient to add up."""
    G, T, P = x.shape
    N = b.shape[-1]
    nc = T // chunk
    chunks = zip(x.reshape(G, nc, chunk, P).unbind(1), b.reshape(G, nc, chunk, N).unbind(1),
                 c.reshape(G, nc, chunk, N).unbind(1), la.reshape(G, nc, chunk).unbind(1))
    states = [torch.zeros((G, N, P), dtype=torch.float32, device=x.device)]
    ys = []
    for xc, bc, cc, lc in chunks:
        ys.append(ssd_chunk_outputs(states[-1], xc, bc, cc, lc))
        states.append(ssd_chunk_state(states[-1], xc, bc, lc))
    return torch.cat(ys, dim=1), states


def ssd_scan_reference(x, b, c, la, chunk: int):
    """The plain chunked scan (the kernel's plain version): ``(y [G, T, P],
    s_final [G, N, P])``, as :func:`ssd_scan_states`."""
    y, states = ssd_scan_states(x, b, c, la, chunk)
    return y, states[-1]


def ssd_recurrence_reference(x, b, c, la):
    """Token-by-token recurrence: the semantic oracle the chunked form is
    dual to (equal up to float reassociation, not bitwise)."""
    G, T, P = x.shape
    N = b.shape[-1]
    s = torch.zeros((G, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        s = torch.exp(la[:, t])[:, None, None] * s + b[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.bmm(c[:, t, None, :], s)[:, 0])
    return torch.stack(ys, dim=1), s


def _launch(x, b, c, la, chunk: int):
    G, T, P = x.shape
    N = b.shape[-1]
    column_block(P, N, chunk)
    for name, t in (("x", x), ("b", b), ("c", c), ("la", la)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ssd_scan kernel: {name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")
    y = torch.empty((G, T, P), dtype=torch.float32, device=x.device)
    s = torch.empty((G, N, P), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_launch(x.data_ptr(), b.data_ptr(), c.data_ptr(), la.data_ptr(),
                                  y.data_ptr(), s.data_ptr(), G, T, P, N, int(chunk), stream)
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, s


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, c, la, chunk):
        ctx.save_for_backward(x, b, c, la)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return ssd_scan_reference(x, b, c, la, chunk)
        return _launch(x, b, c, la, chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        # the plain version's VJP at the same inputs (the kernel computes the
        # same function), as the JAX package's custom_vjp does
        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, s = ssd_scan_reference(*args, ctx.chunk)
        grads = torch.autograd.grad((y, s), args, (dy, ds))
        return (*grads, None)


def ssd_scan(x, b, c, la, *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over ``G`` independent recurrences, differentiable in
    all four inputs: ``x`` [G, T, P], ``b``/``c`` [G, T, N], ``la`` [G, T],
    taken as fp32; ``T`` must be a multiple of ``chunk``.  Returns ``(y [G,
    T, P], s_final [G, N, P])`` in fp32: the CUDA kernel for CUDA inputs,
    the plain version for CPU inputs."""
    registry.ensure_admitted("ssd_scan", x.device)
    if x.shape[1] % chunk:
        raise ValueError(f"T={x.shape[1]} not a multiple of chunk={chunk}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    args = [t.to(torch.float32).contiguous() for t in (x, b, c, la)]
    return _SSDScan.apply(*args, int(chunk))


ssd_scan.launches = 0


# ---------------------------------------------------------------------------
# kernel-registry entry (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def kernel_spec(G: int, T: int, P: int, N: int, L: int,
                chunk_axis: str = "arbitrary") -> KernelSpec:
    """``ssd_scan_kernel``'s launch: grid (G * P / PB,), one CTA a
    (recurrence, column block), the blocks of one recurrence adjacent; the
    chunk loop inside the CTA as axis 1 (``chunk_axis``: declared
    ``"parallel"`` it is the bug class the verifier refuses).  Scratch 0 is
    the block's [N, PB] columns of the state, carried across the chunk axis
    only; the rest are the chunk's tiles (csrc/ssd_scan.cu Shape<L, N,
    PB>)."""
    f32 = torch.float32
    pb = column_block(P, N, L)
    nb = P // pb
    rt = min(L, 32)

    def cols(name):     # x, y: the CTA's column block of each chunk row
        return BlockUse((G, T, P), f32, (1, L, pb), lambda gb, c: (gb // nb, c, gb % nb),
                        name=name)

    def rows(name):     # b, c: whole rows, read by every column block
        return BlockUse((G, T, N), f32, (1, L, N), lambda gb, c: (gb // nb, c, 0), name=name)

    return KernelSpec(
        "ssd_scan_kernel", grid=(G * nb, T // L),
        inputs=[cols("x"), rows("b"), rows("c"),
                BlockUse((G, T), f32, (1, L), lambda gb, c: (gb // nb, c), name="la")],
        outputs=[cols("y"),
                 BlockUse((G, N, P), f32, (1, N, pb), lambda gb, c: (gb // nb, 0, gb % nb),
                          name="s_final")],
        scratch=[ScratchUse((N, pb), f32),           # the carried state's columns
                 ScratchUse((L, pb), f32),           # the chunk's x columns
                 ScratchUse((rt, N), f32),           # a row tile of C
                 ScratchUse((rt, L), f32),           # the row tile of M
                 ScratchUse((L, N + 1), f32),        # the chunk's B, rows padded
                 ScratchUse((2, L), f32)],           # log-decay prefix sum, state weights
        dimension_semantics=("parallel", chunk_axis),
        carried_scratch=[(0, frozenset({1}))],
        cuda=("ssd_scan", 0, 0, pb, N, L))


def _registry_example():
    # the JAX registry's example: G 2, T 128, P 8, N 4, chunk 64
    G, T, P, N, L = 2, 128, 8, 4, 64

    def args(device):
        g = torch.Generator().manual_seed(0)
        x, b, c = (torch.randn(G, T, w, generator=g).to(device) for w in (P, N, N))
        la = -torch.nn.functional.softplus(torch.randn(G, T, generator=g)).to(device)
        return x, b, c, la

    return ([kernel_spec(G, T, P, N, L)], lambda x, b, c, la: ssd_scan(x, b, c, la, chunk=L),
            lambda x, b, c, la: ssd_scan_reference(x, b, c, la, L), args)


registry.register(
    "ssd_scan", _registry_example, presets=("ssd",),
    description="chunked SSD scan: VMEM state carried across the "
                "sequential chunk axis",
    tol=(1e-5, 0.0, 1e-30))   # atol 1e-5 of the largest |value|: another sum order
