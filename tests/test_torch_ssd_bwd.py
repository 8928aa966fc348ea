"""The SSD scan's backward in paddle_tpu_torch against paddle_tpu on the CPU.

``ssd_scan_bwd_reference`` (the closed-form VJP, the backward kernel's
plain version) against ``jax.vjp`` of ``paddle_tpu.kernels.ssd_scan.
ssd_scan_reference`` (default flags: the jnp reference, never the Pallas
call) and against torch autograd of the port's own plain scan, on the same
numpy-seeded inputs and cotangents.  Then a CPU emulation of the kernels'
split-TF32 products, run through the chunk-parallel form of the forward and
the backward at the ``ssd_train`` widths (L 128, N 128, P 64), held to
fp64: the limit the card's checks apply (``chip_smoke.py``'s SSD_ATOL,
1e-5 of an output's scale) holds before any card run.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import ssd_scan as jscan
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import ssd_scan as tscan

SSD_ATOL = 1e-5       # chip_smoke.py: |err| <= 1e-5 x max |value|, and per g row by norm


def _operands(G, T, N, P, seed, decay=None):
    """x, B, C standard normal; log-decay -0.1 |n| (~0.92 a token) or near
    ``decay`` a token; cotangents dy, ds standard normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, T, P)).astype(np.float32)
    b = rng.standard_normal((G, T, N)).astype(np.float32)
    c = rng.standard_normal((G, T, N)).astype(np.float32)
    n = rng.standard_normal((G, T)).astype(np.float32)
    la = -0.1 * np.abs(n) if decay is None else np.minimum(decay + 0.1 * n, 0.0)
    dy = rng.standard_normal((G, T, P)).astype(np.float32)
    ds = rng.standard_normal((G, N, P)).astype(np.float32)
    return [x, b, c, la.astype(np.float32)], dy, ds


def _assert_grads(got, want, what):
    for name, a, b in zip(("dx", "db", "dc", "dla"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), (what, name)
        # fp32 sums over a chunk and the carried state, in another order:
        # atol scaled by the largest |gradient| of that output, as
        # test_torch_ssd.py's test_scan_gradients_match_jax_grad states (dla
        # at a log-decay near -20 is ~1e-7: a floor of 1e-5 would pass 0)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"{what}: {name}")


def _autograd_fp64(ops, dy, ds, chunk):
    """torch autograd of the port's plain scan in fp64."""
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in ops]
    cts = [torch.tensor(a, dtype=torch.float64) for a in (dy, ds)]
    return torch.autograd.grad(tscan.ssd_scan_reference(*args, chunk), args, cts)


@pytest.mark.parametrize("decay", [None, -20.0], ids=["decay-0.1", "decay-20"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_bwd_reference_matches_jax_vjp_and_autograd(chunk, decay):
    """The closed form in fp32 against jax.vjp and torch autograd of the
    plain scans in fp32, and against torch autograd in fp64.  At a log-decay
    near -20 the fp32 VJPs' dla is their own rounding (it differs from the
    fp64 one by more than its own scale: their cum reaches -2560 and its
    differences keep 2^-12 of their ~-20), so there dla is held to fp64
    alone, as every output is at both decays."""
    ops, dy, ds = _operands(G=2, T=128, N=8, P=16, seed=chunk, decay=decay)
    _, vjp = jax.vjp(lambda *a: jscan.ssd_scan_reference(*a, chunk=chunk), *map(jnp.asarray, ops))
    want_j = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    t = [torch.tensor(a) for a in ops]
    _, states = tscan.ssd_scan_states(*t, chunk)
    got = tscan.ssd_scan_bwd_reference(*t, torch.stack(states, dim=1), torch.tensor(dy),
                                       torch.tensor(ds), chunk)
    got = [g.numpy() for g in got]
    fp32 = slice(None) if decay is None else slice(0, 3)
    _assert_grads(got[fp32], want_j[fp32], "against jax.vjp")
    args = [a.clone().requires_grad_() for a in t]
    y, s = tscan.ssd_scan_reference(*args, chunk)
    want_t = torch.autograd.grad((y, s), args, (torch.tensor(dy), torch.tensor(ds)))
    _assert_grads(got[fp32], [g.numpy() for g in want_t][fp32], "against autograd")
    _assert_grads(got, [g.numpy() for g in _autograd_fp64(ops, dy, ds, chunk)],
                  "against autograd in fp64")


def test_bwd_reference_is_the_exact_vjp_in_fp64():
    """In fp64 the closed form and autograd of the plain scan agree to
    rounding (1e-12 of each output's scale): the formula, not a near miss."""
    ops, dy, ds = _operands(G=2, T=96, N=16, P=8, seed=3)
    t = [torch.tensor(a, dtype=torch.float64) for a in ops]
    _, states = tscan.ssd_scan_states(*t, 32)
    got = tscan.ssd_scan_bwd_reference(*t, torch.stack(states, dim=1),
                                       torch.tensor(dy, dtype=torch.float64),
                                       torch.tensor(ds, dtype=torch.float64), 32)
    for a, b in zip(got, _autograd_fp64(ops, dy, ds, 32)):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.parametrize("seed", [3, 5, 7])
def test_bwd_reference_is_the_exact_vjp_in_fp64_at_decay_minus_20(seed):
    """At a log-decay near -20 a token, in fp64, each output of the closed
    form within 1e-5 of its own scale of autograd's (dla ~1e-7; a dla of 0,
    or one missing a term, is off by its whole scale).  dx, db, dc agree to
    1e-12; dla only to ~1e-7 of its scale, the rounding of autograd's own
    fp64 dla, which forms the pairs of ~100 that cancel and subtracts them."""
    ops, dy, ds = _operands(G=2, T=96, N=16, P=8, seed=seed, decay=-20.0)
    t = [torch.tensor(a, dtype=torch.float64) for a in ops]
    _, states = tscan.ssd_scan_states(*t, 32)
    got = tscan.ssd_scan_bwd_reference(*t, torch.stack(states, dim=1),
                                       torch.tensor(dy, dtype=torch.float64),
                                       torch.tensor(ds, dtype=torch.float64), 32)
    want = _autograd_fp64(ops, dy, ds, 32)
    assert float(want[3].abs().max()) < 1e-6          # the regime: dla ~1e-7
    for name, a, b, rel in zip(("dx", "db", "dc", "dla"), got, want, (1e-12,) * 3 + (1e-5,)):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max()), name


def test_scan_backward_runs_the_bwd_wrapper():
    """On CPU tensors ``ssd_scan``'s backward runs ``ssd_scan_bwd`` (its
    plain version: no launch is counted), and the launch table names the
    backward counter."""
    ops, dy, ds = _operands(G=2, T=64, N=4, P=8, seed=4)
    reset_launch_counts()
    args = [torch.tensor(a, requires_grad=True) for a in ops]
    y, s = tscan.ssd_scan(*args, chunk=16)
    got = torch.autograd.grad((y, s), args, (torch.tensor(dy), torch.tensor(ds)))
    ref = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(tscan.ssd_scan_reference(*ref, 16), ref,
                               (torch.tensor(dy), torch.tensor(ds)))
    _assert_grads([g.numpy() for g in got], [g.numpy() for g in want], "ssd_scan on the CPU")
    counts = launch_counts()
    assert counts["ssd_scan"] == 0 and counts["ssd_scan_bwd"] == 0
    with pytest.raises(ValueError, match="N=256"):
        tscan._launch_bwd(*[torch.zeros(1, 128, w) for w in (8, 256, 256)], torch.zeros(1, 128),
                          torch.zeros(1, 2, 256, 8), torch.zeros(1, 128, 8),
                          torch.zeros(1, 256, 8), chunk=64)


@pytest.mark.parametrize("nb", [8, 16, 32, 64, 24])
def test_bwd_state_block_fits_the_dcb_kernels_warps(nb, monkeypatch):
    """The dCB kernel's [L, NB] products hold one 32 x 16 unit a warp, 8
    warps: at chunk 128 an SSD_BWD_NB takes 4 x ceil(NB / 16) units, so 64
    would leave half of dB and dC unwritten.  bwd_state_block refuses what
    the kernel's static_assert refuses (NB 8, 16 or 32) before any build."""
    from paddle_tpu_torch.kernels import _build

    fits = nb % 8 == 0 and nb & (nb - 1) == 0 and (128 // 32) * -(-nb // 16) <= 8
    assert (nb in tscan.BWD_STATE_BLOCKS) == fits
    monkeypatch.setitem(_build.GEOMETRY["ssd_scan_bwd"], "SSD_BWD_NB", nb)
    if fits:
        assert tscan.bwd_state_block(128) == nb and tscan.bwd_state_block(4) == 8
    else:
        with pytest.raises(ValueError, match=f"SSD_BWD_NB={nb}"):
            tscan.bwd_state_block(128)
        with pytest.raises(ValueError, match=f"SSD_BWD_NB={nb}"):
            tscan.bwd_kernel_specs(1, 256, 64, 128, 128)
    src = (Path(tscan.__file__).parent / "csrc" / "ssd_scan_bwd.cu").read_text()
    assert "static_assert(kNB >= 8 && kNB % 8 == 0" in src


@pytest.mark.parametrize("fault", [None, "carry", "end", "mask"])
def test_chip_smoke_backward_faults_on_the_cpu(fault):
    """chip_smoke.py's planted backward faults, on CPU tensors at a small
    shape and its log-decay of -0.01 |n| a token: without a fault its copy
    of the closed form is ssd_scan_bwd_reference bit for bit (so each fault
    is planted in the current formula), and the backward's checks reject
    each fault."""
    import chip_smoke as cs

    ops, dy, ds = _operands(G=2, T=256, N=16, P=32, seed=21)
    x, b, c, la = (torch.tensor(a) for a in ops)
    la = la / 10
    _, states = tscan.ssd_scan_states(x, b, c, la, 64)
    args = (x, b, c, la, torch.stack(states, dim=1), torch.tensor(dy), torch.tensor(ds))
    want = tscan.ssd_scan_bwd_reference(*args, 64)
    got = cs._ssd_bwd_faulted(*args, 64, fault)
    if fault is None:
        assert all(torch.equal(a, r) for a, r in zip(got, want))
    else:
        assert cs._ssd_grad_rejects(cs._ssd_grad_errors(got, want)), fault


# ---------------------------------------------------------------------------
# split TF32, emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32(v):
    """cvt.rna.tf32.f32: round to 10 stored mantissa bits, ties away from
    zero (add half of the dropped part to the magnitude, then truncate)."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(v):
    """The mma's reading of an fp32 operand: its low 13 bits ignored."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """The kernels' product: a = ah + al, b = bh + bl, hi rounded to TF32
    and lo = v - hi read by the mma to TF32 (truncated); the three products
    lo.hi + hi.lo + hi.hi each exact in fp32 (11-bit significands) and
    summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _decays(la, G, nc, L, dtype, wide):
    """cum's exponentials: e_t, w_s, a, and the masked [L, L] decay, from
    prefix sums in fp32 (the forward) or fp64 (``wide``: the backward),
    every exponent rounded to ``dtype`` once."""
    cum = la.reshape(G, nc, L).to(torch.float64 if wide else la.dtype).cumsum(-1)
    tot = cum[..., -1:]
    idx = torch.arange(L)
    mask = idx[None, :] <= idx[:, None]
    seg = torch.where(mask, cum[..., :, None] - cum[..., None, :], 0.0).to(dtype)
    e, w, a = (torch.exp(v.to(dtype)) for v in (cum, tot - cum, tot))
    return e, w, a, torch.where(mask, torch.exp(seg), 0.0)


def _chunk_parallel(x, b, c, la, dy, ds, L, mm):
    """The kernels' phases with products ``mm``: forward (a) the chunks'
    state increments, (b) the state pass, (c) the chunks' outputs; backward
    (a) Q_k, (b) the reverse pass, (c1) dx, (c2) dC, dB and dcum (dCB's
    diagonal and row L-1's w term, pairs that cancel, left out), (d) dla."""
    G, T, P = x.shape
    N = b.shape[-1]
    nc = T // L
    xr, dyr = x.reshape(G, nc, L, P), dy.reshape(G, nc, L, P)
    br, cr = b.reshape(G, nc, L, N), c.reshape(G, nc, L, N)
    T_ = lambda t: t.transpose(-1, -2)  # noqa: E731
    e, w, a, decay = _decays(la, G, nc, L, x.dtype, False)
    u = mm(T_(br * w[..., None]), xr)                       # (a) [G, nc, N, P]
    states = [torch.zeros_like(u[:, 0])]
    for k in range(nc):                                     # (b)
        states.append(a[:, k, :, None] * states[-1] + u[:, k])
    st = torch.stack(states, dim=1)
    y = mm(mm(cr, T_(br)) * decay, xr) + e[..., None] * mm(cr, st[:, :nc])    # (c)
    e, w, a, decay = _decays(la, G, nc, L, x.dtype, True)
    q = mm(T_(cr * e[..., None]), dyr)                      # backward (a)
    grads = [ds]
    for k in reversed(range(nc)):                           # (b)
        grads.append(a[:, k, :, None] * grads[-1] + q[:, k])
    g_out = torch.stack(grads[-2::-1], dim=1)
    m = mm(cr, T_(br)) * decay
    dx = mm(T_(m), dyr) + mm(br * w[..., None], g_out)      # (c1)
    dcb = mm(dyr, T_(xr)) * decay                           # (c2)
    diag = dcb.diagonal(0, -2, -1)[..., None]
    idx = torch.arange(L)
    dcb = torch.where(idx[None, :] < idx[:, None], dcb, 0.0)
    dc_in, db_in = mm(dcb, br), mm(T_(dcb), cr)
    dys = e[..., None] * mm(dyr, T_(st[:, :nc]))
    xg = w[..., None] * mm(xr, T_(g_out))
    dc = dc_in + diag * br + dys
    db = db_in + diag * cr + xg
    wterm = (br * xg).sum(-1)[..., :-1]
    dcum = (cr * (dc_in + dys)).sum(-1) - (br * db_in).sum(-1)
    end = wterm.sum(-1) + a[..., 0] * (g_out * st[:, :nc]).sum((-1, -2))
    dcum = torch.cat([dcum[..., :-1] - wterm, dcum[..., -1:] + end[..., None]], dim=-1)
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    return (y.reshape(G, T, P), st[:, -1], dx.reshape(G, T, P), db.reshape(G, T, N),
            dc.reshape(G, T, N), dla.reshape(G, T))


def _errors(got, ref):
    """(max |err| / max |ref|, largest per-g |err| / |ref| by norm)."""
    elem = float((got - ref).abs().max() / ref.abs().max())
    d = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return elem, float(d.max())


@pytest.mark.parametrize("decay", [None, -20.0], ids=["decay-0.1", "decay-20"])
def test_split_tf32_chunk_math_within_ssd_atol(decay):
    """At the `ssd_train` widths (L 128, N 128, P 64; G 2, two chunks) the
    split-TF32 products, fp32 elsewhere, stay within SSD_ATOL of fp64 in
    every output of the forward and the backward, elementwise and per g row
    by norm, as the plain fp32 version does, at a log-decay near -20 a token
    too (where dla is ~1e-7, made of off-diagonal terms only: the backward's
    prefix sums in fp64 keep it there).  Plain TF32 products do not: the
    check that would reject them rejects them here."""
    ops, dy, ds = _operands(G=2, T=256, N=128, P=64, seed=11, decay=decay)
    f32 = [torch.tensor(a) for a in (*ops, dy, ds)]
    f64 = [t.double() for t in f32]
    ref = _chunk_parallel(*f64, 128, torch.matmul)
    split = _chunk_parallel(*f32, 128, _mm3)
    plain = _chunk_parallel(*f32, 128, torch.matmul)
    one = _chunk_parallel(*f32, 128, lambda a, b: _tf32(a) @ _tf32(b))
    worst_one = 0.0
    for name, s, p, o, r in zip(("y", "s", "dx", "db", "dc", "dla"), split, plain, one, ref):
        es, ep = _errors(s.double(), r), _errors(p.double(), r)
        assert es[0] <= SSD_ATOL and es[1] <= SSD_ATOL, (name, es, ep)
        assert ep[0] <= SSD_ATOL and ep[1] <= SSD_ATOL, (name, ep)
        worst_one = max(worst_one, *_errors(o.double(), r))
    assert worst_one > SSD_ATOL, worst_one


def test_tf32_rounding_matches_the_instruction():
    """_tf32 keeps 10 mantissa bits, rounds to nearest with ties away from
    zero, and hi + lo, lo read by the mma (truncated to TF32), recovers fp32
    values to 2^-21 of their size."""
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    hi = _tf32(v)
    assert hi.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    h = _tf32(x)
    rest = (x.double() - h.double() - _trunc_tf32(x - h).double()).abs()
    assert bool((rest <= 2.0 ** -21 * x.double().abs()).all())
