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
token-by-token oracle.  :func:`ssd_scan` is differentiable through
:class:`_SSDScan`.  Its forward launches the kernels of ``csrc/ssd_scan.cu``
(the counterpart of the Pallas ``_ssd_scan_call``: the chunks' state
increments, the state pass, the chunks' outputs) on CUDA tensors and runs
the plain version on CPU tensors, and saves every state entering a chunk.
Its backward is :func:`ssd_scan_bwd`: the kernels of ``csrc/ssd_scan_bwd.cu``
on CUDA tensors, :func:`ssd_scan_bwd_reference` on CPU ones, the closed
form of the VJP that the JAX package's ``_ssd_scan_diff_bwd`` takes of its
plain scan with ``jax.vjp``.  No CUDA tensor reaches a plain version.

Registered in :mod:`.registry` as ``ssd_scan`` and ``ssd_scan_bwd`` (the
JAX registry has the first only), each at the JAX registry's example and
at the ``ssd_train`` shape: the state carried over the state pass's chunk
loop inside its CTA, the counterpart of the Pallas call's sequential chunk
axis; every other launch parallel over (recurrence, chunk, block).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse
from . import _build, registry

__all__ = ["ssd_chunk_outputs", "ssd_chunk_state", "ssd_scan_states", "ssd_scan_reference",
           "ssd_recurrence_reference", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_reference",
           "column_block"]

# what the kernels (csrc/ssd_scan.cu, csrc/ssd_scan_bwd.cu) take: P split
# into column blocks of the widest of these that divides it, one CTA each;
# N and L (chunk) from these sets.  Every such (block, N, L) fits shared
# memory.
COLUMN_BLOCKS = (64, 32, 8)
KERNEL_N = (4, 8, 16, 32, 64, 128)
KERNEL_L = (16, 32, 64, 128)


def column_block(P: int, N: int, L: int) -> int:
    """The column block the kernels run ``(P, N, chunk L)`` with; raises
    ``ValueError`` naming the limit a shape the kernels do not take
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
    states = [torch.zeros((G, N, P), dtype=x.dtype, device=x.device)]
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
    s = torch.zeros((G, N, P), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        s = torch.exp(la[:, t])[:, None, None] * s + b[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.bmm(c[:, t, None, :], s)[:, 0])
    return torch.stack(ys, dim=1), s


def ssd_scan_bwd_reference(x, b, c, la, states, dy, ds, chunk: int):
    """The scan's VJP in closed form (the backward kernel's plain version),
    batched over chunks: its one Python loop is the reverse state pass.
    ``states`` [G, nc + 1, N, P] are the states entering each chunk and the
    final one (the forward's, or ``torch.stack(ssd_scan_states(...)[1],
    1)``); ``dy`` [G, T, P] and ``ds`` [G, N, P] the cotangents of y and
    s_final.  Returns ``(dx, db, dc, dla)``.

    Per chunk, with S the state entering it, G' the gradient of the state
    leaving it, e_t = exp(cum_t), w_s = exp(cum_{L-1} - cum_s), a =
    exp(cum_{L-1}): G = a G' + C^T (e dy) (reverse pass); dx = M^T dy +
    (B w) G'; dCB = mask (dy x^T) exp(cum_t - cum_s); dC = dCB B + e (dy
    S^T); dB = dCB^T C + w (x G'^T); dcum = rowsum(C dC) - rowsum(B dB),
    plus sum(B w (x G'^T)) + a sum(G' S) at the chunk's last row, formed
    without the pairs of terms that cancel exactly (dCB's diagonal, the w
    term of row L-1); dla is dcum's reverse cumulative sum inside the
    chunk."""
    G, T, P = x.shape
    N = b.shape[-1]
    L = chunk
    nc = T // L
    xr, dyr = x.reshape(G, nc, L, P), dy.reshape(G, nc, L, P)
    br, cr = b.reshape(G, nc, L, N), c.reshape(G, nc, L, N)
    # the prefix sums in fp64 (exact, or all but, in any order), then every
    # exponent rounded to the working type once: at a log-decay near -20 a
    # token an fp32 cum reaches -2560, its differences lose 2^-12 of their
    # ~-20, and dla, made of exactly those terms, would depend on the order
    # of summation (csrc/ssd_tile.cuh chunk_cumsum)
    cum = la.reshape(G, nc, L).to(torch.float64).cumsum(-1)
    tot = cum[..., -1:]                                             # [G, nc, 1]
    e, w, a = (torch.exp(v.to(x.dtype)) for v in (cum, tot - cum, tot))
    idx = torch.arange(L, device=x.device)
    mask = idx[None, :] <= idx[:, None]                             # [t, s]: s <= t
    seg = torch.where(mask, cum[..., :, None] - cum[..., None, :], 0.0).to(x.dtype)
    decay = torch.where(mask, torch.exp(seg), 0.0)                  # [G, nc, L, L]
    m = (cr @ br.transpose(-1, -2)) * decay
    s_in = states[:, :nc]                                           # [G, nc, N, P]
    q = (cr * e[..., None]).transpose(-1, -2) @ dyr                 # C^T (e dy)
    grads = [ds]
    for k in reversed(range(nc)):
        grads.append(a[:, k, :, None] * grads[-1] + q[:, k])
    g_out = torch.stack(grads[-2::-1], dim=1)                       # G' of each chunk
    bw = br * w[..., None]
    dx = m.transpose(-1, -2) @ dyr + bw @ g_out
    # dCB's diagonal apart: the diagonal's share of dcum_t comes in with +
    # and - and cancels exactly, so it is left out of both row sums rather
    # than formed twice and subtracted (at a log-decay near -20 the true
    # dcum is ~1e-7 against diagonal terms of ~100)
    dcb = (dyr @ xr.transpose(-1, -2)) * decay
    diag = dcb.diagonal(0, -2, -1)[..., None]                      # [G, nc, L, 1]
    dcb = torch.where(idx[None, :] < idx[:, None], dcb, 0.0)       # s < t
    dc_in, db_in = dcb @ br, dcb.transpose(-1, -2) @ cr
    dys = e[..., None] * (dyr @ s_in.transpose(-1, -2))
    xg = w[..., None] * (xr @ g_out.transpose(-1, -2))
    dc = dc_in + diag * br + dys
    db = db_in + diag * cr + xg
    # the state's w terms: row s (s < L-1) gives -B_s . w_s xg_s to dcum_s
    # and + the same to dcum_{L-1}; row L-1's pair cancels exactly
    wterm = (br * xg).sum(-1)[..., :-1]                             # [G, nc, L - 1]
    dcum = (cr * (dc_in + dys)).sum(-1) - (br * db_in).sum(-1)
    end = wterm.sum(-1) + a[..., 0] * (g_out * s_in).sum((-1, -2))
    dcum = torch.cat([dcum[..., :-1] - wterm, dcum[..., -1:] + end[..., None]], dim=-1)
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    return (dx.reshape(G, T, P), db.reshape(G, T, N), dc.reshape(G, T, N),
            dla.reshape(G, T))


def _check_operands(name, tensors, chunk):
    x = tensors[0]
    G, T, P = x.shape
    column_block(P, tensors[1].shape[-1], chunk)
    for i, t in enumerate(tensors):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: operand {i} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")


def _launch(x, b, c, la, chunk: int):
    """The forward kernels: ``(y, s_final, states [G, nc + 1, N, P])``."""
    _check_operands("ssd_scan", (x, b, c, la), chunk)
    G, T, P = x.shape
    N = b.shape[-1]
    nc = T // chunk
    y = torch.empty((G, T, P), dtype=torch.float32, device=x.device)
    s = torch.empty((G, N, P), dtype=torch.float32, device=x.device)
    states = torch.empty((G, nc + 1, N, P), dtype=torch.float32, device=x.device)
    tot = torch.empty((G, nc, P // column_block(P, N, chunk)), dtype=torch.float32,
                      device=x.device)
    lib = _build.load("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_launch(x.data_ptr(), b.data_ptr(), c.data_ptr(), la.data_ptr(),
                                  y.data_ptr(), s.data_ptr(), states.data_ptr(), tot.data_ptr(),
                                  G, T, P, N, int(chunk), stream)
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, s, states


def _launch_bwd(x, b, c, la, states, dy, ds, chunk: int):
    """The backward kernels: ``(dx, db, dc, dla)``."""
    _check_operands("ssd_scan_bwd", (x, b, c, la, states, dy, ds), chunk)
    G, T, P = x.shape
    N = b.shape[-1]
    nc = T // chunk
    if tuple(states.shape) != (G, nc + 1, N, P) or tuple(ds.shape) != (G, N, P) \
            or tuple(dy.shape) != (G, T, P):
        raise ValueError(f"ssd_scan_bwd kernel: states {tuple(states.shape)}, dy "
                         f"{tuple(dy.shape)}, ds {tuple(ds.shape)} do not fit x {tuple(x.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, db, dc, dla = (torch.empty(t.shape, **f32) for t in (x, b, c, la))
    gstates = torch.empty((G, nc + 1, N, P), **f32)
    tot = torch.empty((G, nc, P // column_block(P, N, chunk)), **f32)
    lib = _build.load("ssd_scan_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), la.data_ptr(), states.data_ptr(),
            dy.data_ptr(), ds.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dla.data_ptr(), gstates.data_ptr(), tot.data_ptr(), G, T, P, N, int(chunk), stream)
    _build.check(lib, err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, db, dc, dla


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, c, la, chunk):
        ctx.chunk = chunk
        if x.device.type == "cpu":
            y, states = ssd_scan_states(x, b, c, la, chunk)
            s, states = states[-1], torch.stack(states, dim=1)
        else:
            y, s, states = _launch(x, b, c, la, chunk)
        ctx.save_for_backward(x, b, c, la, states)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        # the backward kernels on the card, their plain version on the CPU:
        # the VJP the JAX package's custom_vjp takes of its plain scan
        x, b, c, la, states = ctx.saved_tensors
        grads = ssd_scan_bwd(x, b, c, la, states, dy.contiguous(), ds.contiguous(),
                             chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, b, c, la, *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over ``G`` independent recurrences, differentiable in
    all four inputs: ``x`` [G, T, P], ``b``/``c`` [G, T, N], ``la`` [G, T],
    taken as fp32; ``T`` must be a multiple of ``chunk``.  Returns ``(y [G,
    T, P], s_final [G, N, P])`` in fp32: the CUDA kernels for CUDA inputs
    (forward and backward), the plain versions for CPU inputs."""
    registry.ensure_admitted("ssd_scan", x.device, torch.float32)
    if x.shape[1] % chunk:
        raise ValueError(f"T={x.shape[1]} not a multiple of chunk={chunk}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    args = [t.to(torch.float32).contiguous() for t in (x, b, c, la)]
    return _SSDScan.apply(*args, int(chunk))


ssd_scan.launches = 0


def ssd_scan_bwd(x, b, c, la, states, dy, ds, *, chunk: int = 64):
    """The scan's backward, ``(dx, db, dc, dla)``, from the forward's inputs,
    its states [G, nc + 1, N, P] and the cotangents ``dy``, ``ds``: the CUDA
    kernels (``csrc/ssd_scan_bwd.cu``) for CUDA inputs, the plain
    :func:`ssd_scan_bwd_reference` for CPU ones."""
    registry.ensure_admitted("ssd_scan_bwd", x.device, torch.float32)
    if x.device.type == "cpu":
        return ssd_scan_bwd_reference(x, b, c, la, states, dy, ds, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    return _launch_bwd(x, b, c, la, states, dy, ds, chunk)


ssd_scan_bwd.launches = 0


# ---------------------------------------------------------------------------
# kernel-registry entries (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

PASS_TILE = 4 * 256     # state entries a CTA of a state pass carries (4 a thread)


BWD_STATE_BLOCKS = (8, 16, 32)   # SSD_BWD_NB the dCB kernel takes (its static_assert)


def bwd_state_block(N: int) -> int:
    """State columns of an N block of the backward's dCB kernel
    (SSD_BWD_NB, N padded to 8).  Raises ``ValueError`` for an SSD_BWD_NB
    whose [L, NB] products at chunk 128 would need more warp units than the
    CTA has warps."""
    nb = _build.GEOMETRY["ssd_scan_bwd"]["SSD_BWD_NB"]
    if nb not in BWD_STATE_BLOCKS:
        raise ValueError(f"ssd_scan_bwd kernel: SSD_BWD_NB={nb} not in {BWD_STATE_BLOCKS}")
    return min(max(N, 8), nb)


def _ld(cols):          # a tile whose rows are a fragment's rows (csrc/ssd_tile.cuh ld)
    return cols + 4


def _ldk(cols):         # a tile whose rows are the k index (ldk)
    return cols + 8


def _amap(*dims):
    """An affine index map: each dim a grid axis (int) or the block 0
    (None)."""
    return ("affine", tuple(("const", 0) if d is None else ("axis", d) for d in dims))


def _smem(*shapes):
    return [ScratchUse(s, torch.float32) for s in shapes]


def _chunk_state_spec(name, G, T, P, N, L, rows, vals, out):
    """chunk_state_kernel: grid (G * nc * P / PB,) as (G, nc, PB blocks),
    one CTA a (recurrence, chunk, column block), all parallel; ``out`` [G,
    nc, N, P] is the slice of the [G, nc + 1, N, P] states it fills."""
    f32 = torch.float32
    pb = column_block(P, N, L)
    nc, nb, NP = T // L, P // pb, max(N, 8)
    return KernelSpec(
        name, grid=(G, nc, nb),
        inputs=[BlockUse((G, T, N), f32, (1, L, N), _amap(0, 1, None), name=rows),
                BlockUse((G, T, P), f32, (1, L, pb), _amap(0, 1, 2), name=vals),
                BlockUse((G, T), f32, (1, L), _amap(0, 1), name="la")],
        outputs=[BlockUse((G, nc, N, P), f32, (1, 1, N, pb), _amap(0, 1, None, 2), name=out),
                 BlockUse((G, nc, nb), f32, (1, 1, 1), _amap(0, 1, 2), name="tot")],
        scratch=_smem((L, _ldk(NP)),      # the rows operand, weighted by the decay
                      (L, _ldk(pb)))      # the column block of x or dy
        + [ScratchUse((L,), f32 if rows == "b" else torch.float64),   # cum
           ScratchUse((L,), f32)],                                    # the decay
        dimension_semantics=("parallel",) * 3,
        cuda=("ssd_scan" if rows == "b" else "ssd_scan_bwd", 0, 0, pb, N, L))


def state_pass_spec(G: int, T: int, P: int, N: int, L: int, reverse: bool = False,
                    chunk_axis: str = "arbitrary") -> KernelSpec:
    """state_pass_kernel: grid (G * tiles,) as (G, tiles of 1024 state
    entries), with the chunk loop inside the CTA as axis 2 (``chunk_axis``:
    declared ``"parallel"`` it is the bug class the verifier refuses).  The
    state (scratch 0, in registers) is carried across the chunk axis only;
    the [G, nc, ...] slice of the states is read and rewritten in place, one
    block a chunk; the end it starts from (states[0] = 0, or states_grad[nc]
    = ds) and ``s_final`` are written once a tile."""
    f32 = torch.float32
    nc, nb = T // L, P // column_block(P, N, L)
    size = N * P
    tile = min(size, PASS_TILE)
    tiles = -(-size // tile)
    masked = size % tile != 0
    view = "states_grad[:, :nc]" if reverse else "states[:, 1:]"
    st = BlockUse((G, nc, size), f32, (1, 1, tile), _amap(0, 2, 1), name=view, masked=masked)
    inputs = [st, BlockUse((G, nc, nb), f32, (1, 1, 1), _amap(0, 2, None), name="tot")]
    ends = [BlockUse((G, size), f32, (1, tile), _amap(0, 1), name="states_grad[:, nc]",
                     masked=masked)] if reverse else [
        BlockUse((G, size), f32, (1, tile), _amap(0, 1), name="states[:, 0]", masked=masked),
        BlockUse((G, size), f32, (1, tile), _amap(0, 1), name="s_final", masked=masked)]
    if reverse:
        inputs.append(BlockUse((G, size), f32, (1, tile), _amap(0, 1), name="ds",
                               masked=masked))
    return KernelSpec(
        "state_pass_kernel<reverse>" if reverse else "state_pass_kernel",
        grid=(G, tiles, nc), inputs=inputs,
        outputs=[BlockUse(st.shape, f32, st.block_shape, st.index_map, name=view,
                          masked=masked)] + ends,
        scratch=[ScratchUse((tile,), f32, "registers")],
        aliases={0: 0},
        dimension_semantics=("parallel", "parallel", chunk_axis),
        carried_scratch=[(0, frozenset({2}))],
        cuda=("ssd_scan_bwd" if reverse else "ssd_scan", 1, 0, column_block(P, N, L), N, L))


def _chunk_apply_spec(name, G, T, P, N, L, backward):
    """chunk_apply_kernel: grid (G * nc * P / PB,) as (G, nc, PB blocks), one
    CTA a (recurrence, chunk, column block), all parallel; N swept inside
    the CTA through two buffers (scratch 0 holds them, then M and the x or
    dy block over them).  Forward: y from x, B, C and the states entering
    each chunk; backward: dx from dy, B, C and the state gradients leaving
    each chunk."""
    f32 = torch.float32
    pb = column_block(P, N, L)
    nc, NP = T // L, max(N, 8)
    nk = min(NP, 32)
    stage = 2 * L * _ld(nk) + nk * _ldk(pb)
    ldm = _ldk(L) if backward else _ld(L)
    union = max(2 * stage, L * ldm + L * _ldk(pb))
    vals, st, out = ("dy", "states_grad[:, 1:]", "dx") if backward else \
        ("x", "states[:, :nc]", "y")
    return KernelSpec(
        name, grid=(G, nc, P // pb),
        inputs=[BlockUse((G, T, P), f32, (1, L, pb), _amap(0, 1, 2), name=vals),
                BlockUse((G, T, N), f32, (1, L, N), _amap(0, 1, None), name="b"),
                BlockUse((G, T, N), f32, (1, L, N), _amap(0, 1, None), name="c"),
                BlockUse((G, T), f32, (1, L), _amap(0, 1), name="la"),
                BlockUse((G, nc, N, P), f32, (1, 1, N, pb), _amap(0, 1, None, 2), name=st)],
        outputs=[BlockUse((G, T, P), f32, (1, L, pb), _amap(0, 1, 2), name=out)],
        scratch=[ScratchUse((union,), f32),                # two N buffers; then M, x or dy
                 ScratchUse((L,), torch.float64 if backward else f32),   # cum
                 ScratchUse((L,), f32)],                   # the row weights e or w
        dimension_semantics=("parallel",) * 3,
        cuda=("ssd_scan_bwd" if backward else "ssd_scan", 2, 0, pb, N, L))


def kernel_specs(G: int, T: int, P: int, N: int, L: int):
    """The forward's three launches: the chunks' state increments, the state
    pass, the chunks' outputs (csrc/ssd_scan.cu)."""
    return [_chunk_state_spec("chunk_state_kernel", G, T, P, N, L, "b", "x", "states[:, 1:]"),
            state_pass_spec(G, T, P, N, L),
            _chunk_apply_spec("chunk_apply_kernel", G, T, P, N, L, False)]


def bwd_kernel_specs(G: int, T: int, P: int, N: int, L: int):
    """The backward's four launches (csrc/ssd_scan_bwd.cu): Q_k, the reverse
    state pass, dx, the dCB kernel (dC, dB, dcum and its reverse prefix sum
    to dla)."""
    f32 = torch.float32
    pb = column_block(P, N, L)
    nc, nb = T // L, P // pb
    NB = bwd_state_block(N)
    nnb, ncu = -(-N // NB), -(-NB // 16)
    wide = NB > N                     # N 4: blocks of 8 columns, 4 of them loaded
    dx = _chunk_apply_spec("chunk_apply_kernel<backward>", G, T, P, N, L, True)
    # one CTA a chunk; inside it, axis 2 walks the N blocks (dcum's per-row
    # sums carried across them in shared memory, scratch 15) and axis 3
    # sweeps P's column blocks (the dy x^T, dy S^T and x G'^T sums carried
    # in registers, scratch 0)
    rows = dict(masked=wide)
    dcb = KernelSpec(
        "ssd_dcb_kernel", grid=(G, nc, nnb, nb),
        inputs=[BlockUse((G, T, P), f32, (1, L, pb), _amap(0, 1, 3), name="x"),
                BlockUse((G, T, N), f32, (1, L, NB), _amap(0, 1, 2), name="b", **rows),
                BlockUse((G, T, N), f32, (1, L, NB), _amap(0, 1, 2), name="c", **rows),
                BlockUse((G, T), f32, (1, L), _amap(0, 1), name="la"),
                BlockUse((G, nc, N, P), f32, (1, 1, NB, pb), _amap(0, 1, 2, 3),
                         name="states[:, :nc]", **rows),
                BlockUse((G, nc, N, P), f32, (1, 1, NB, pb), _amap(0, 1, 2, 3),
                         name="states_grad[:, 1:]", **rows),
                BlockUse((G, T, P), f32, (1, L, pb), _amap(0, 1, 3), name="dy")],
        outputs=[BlockUse((G, T, N), f32, (1, L, NB), _amap(0, 1, 2), name="db", **rows),
                 BlockUse((G, T, N), f32, (1, L, NB), _amap(0, 1, 2), name="dc", **rows),
                 BlockUse((G, T), f32, (1, L), _amap(0, 1), name="dla")],
        scratch=[ScratchUse((L * L + 2 * L * NB,), f32, "registers")] + _smem(
            (L, _ld(L)),                                  # dCB, its diagonal left out
            (L, _ld(pb)), (L, _ld(pb)),                   # the dy and x column blocks
            (NB, _ld(pb)), (NB, _ld(pb)),                 # S_k's and G''s rows, that block
            (L, _ldk(NB)), (L, _ldk(NB))) + [             # B's and C's columns
            ScratchUse((L,), torch.float64)] + _smem(     # cum
            (L,), (L,), (L,),                             # e, w, dCB's diagonal
            (L, ncu), (L, ncu), (L, ncu),                 # an N block's row shares
            (L,), (L,), (8,)),                            # dcum, w terms by row; G' S by warp
        dimension_semantics=("parallel", "parallel", "arbitrary", "arbitrary"),
        carried_scratch=[(0, frozenset({3})), (15, frozenset({2}))],
        cuda=("ssd_scan_bwd", 3, 0, pb, N, L))
    q = _chunk_state_spec("chunk_state_kernel<backward>", G, T, P, N, L, "c", "dy",
                          "states_grad[:, :nc]")
    return [q, state_pass_spec(G, T, P, N, L, reverse=True), dx, dcb]


# the JAX registry's example (G 2, T 128, P 8, N 4, chunk 64) and, as
# "float32@ssd_train", the `ssd_train` path's launches (ssd_8b widths, batch
# 2 x 64 heads: G 128, T 4096, P 64, N 128, chunk 128), so the card's leg
# checks the scan at a production shape
_EXAMPLES = {"": (2, 128, 8, 4, 64), "ssd_train": (128, 4096, 64, 128, 128)}
_DTYPES = ("float32", "float32@ssd_train")


def _example_args(shape, device, backward):
    G, T, P, N, L = shape
    g = torch.Generator().manual_seed(0)
    x, b, c = (torch.randn(G, T, w, generator=g).to(device) for w in (P, N, N))
    la = -torch.nn.functional.softplus(torch.randn(G, T, generator=g)).to(device)
    if not backward:
        return x, b, c, la
    _, states = ssd_scan_states(x, b, c, la, L)
    dy = torch.randn(G, T, P, generator=g).to(device)
    ds = torch.randn(G, N, P, generator=g).to(device)
    return x, b, c, la, torch.stack(states, dim=1), dy, ds


def _registry_example(dtype="float32"):
    shape = _EXAMPLES[dtype.partition("@")[2]]
    L = shape[-1]
    return (kernel_specs(*shape), lambda x, b, c, la: ssd_scan(x, b, c, la, chunk=L),
            lambda x, b, c, la: ssd_scan_reference(x, b, c, la, L),
            lambda device: _example_args(shape, device, False))


def _bwd_registry_example(dtype="float32"):
    shape = _EXAMPLES[dtype.partition("@")[2]]
    L = shape[-1]
    return (bwd_kernel_specs(*shape),
            lambda *a: ssd_scan_bwd(*a, chunk=L),
            lambda *a: ssd_scan_bwd_reference(*a, L),
            lambda device: _example_args(shape, device, True))


# atol 1e-5 of each output's largest |value|: split-TF32 products and sums
# in another order (chip_smoke.py's SSD_ATOL)
registry.register(
    "ssd_scan", _registry_example, presets=("ssd",),
    description="chunked SSD scan: VMEM state carried across the "
                "sequential chunk axis",
    tol=(1e-5, 0.0, 1e-30), dtypes=_DTYPES)
registry.register(
    "ssd_scan_bwd", _bwd_registry_example, presets=("ssd",),
    description="chunked SSD scan backward: the closed-form VJP, the state "
                "gradient carried across the reverse chunk axis",
    tol=(1e-5, 0.0, 1e-30), dtypes=_DTYPES)
