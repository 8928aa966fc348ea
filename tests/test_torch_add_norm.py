"""The RMSNorm backward (the add + RMSNorm backward kernel of
``paddle_tpu_torch/kernels/csrc/add_rms_norm.cu``), on the CPU.

``bwd_plan`` picks the ring kernel or the wide one and its geometry;
``_bwd_rows`` mirrors the ring kernel's row -> CTA -> team assignment
(``bwd_ring`` in the source), which fixes the order dw is summed in.  The
tests hold the plan to the port's training widths and to the card's shared
memory, the mirror to covering every row once in a fixed order, the
registry's norm-only specs to a clean static leg, and the three plain
backwards (the kernel's norm-only reference, ``rms_norm_backward`` and
``jax.vjp`` of the JAX RMSNorm) to one another.  The kernel runs on the card only: ``tests/test_torch_gpu.py``
holds it to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.kernels import rms_norm as jrms
from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.kernels import _build, registry
from paddle_tpu_torch.kernels import add_rms_norm as arn
from paddle_tpu_torch.kernels import rms_norm as trms

GEO = _build.GEOMETRY["add_rms_norm"]
BF16, FP32 = torch.bfloat16, torch.float32
# the ring kernel's static shared memory: the full and empty mbarriers, a
# team's row sums by warp for two rows
STATIC_SMEM = 2 * GEO["ARN_MAX_SLOTS"] * 8 + 2 * GEO["ARN_CONSUMER_WARPS"] * 8

registry.load_all()


def _bwd_rows(rows, ctas, teams):
    """``out[c][t]``: the rows whose ``d_normed s_hat`` team ``t`` of CTA
    ``c`` sums in its registers, in that order.  CTA ``c`` of ``ctas``
    takes the rows ``[c rows / ctas, (c + 1) rows / ctas)``, its local row
    ``j`` going to team ``j % teams`` (and ring slot ``j % slots``); a CTA's
    partial row adds its teams' in team order, ``dw_reduce_kernel`` the
    CTAs' in CTA order."""
    out = []
    for c in range(ctas):
        r0, r1 = c * rows // ctas, (c + 1) * rows // ctas
        out.append([list(range(r0 + t, r1, teams)) for t in range(teams)])
    return out


# (a) the plan ------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,dtype,site,warps,teams", [
    (3 * 2048, 2048, BF16, False, 2, 4),     # `base`, the stock backward
    (3 * 2048, 2048, BF16, True, 2, 4),      # `base`, the fuse_add_rms_norm site
    (16384, 2048, BF16, False, 2, 4),        # `longctx`
    (2 * 4096, 4096, BF16, False, 4, 2),     # `ssd_train` (ssd_8b widths)
    (2 * 4096, 4096, BF16, True, 4, 2),
    (512, 256, FP32, False, 1, 8),           # the parity phase's narrow Llama
    (1037, 264, BF16, False, 1, 8),          # a ragged row: 33 vectors
])
def test_plan_takes_the_ring_at_the_training_widths(rows, d, dtype, site, warps, teams):
    plan = arn.bwd_plan(rows, d, dtype, with_h=site, with_ds=site)
    assert plan.kind == "ring"
    assert (plan.warps, plan.teams) == (warps, teams)
    assert plan.ctas == min(rows, arn.H100_SMS * GEO["ARN_CTAS_PER_SM"])
    slot = (2 + 2 * site) * d * dtype.itemsize
    assert plan.slots == min(GEO["ARN_MAX_SLOTS"], GEO["ARN_RING_BYTES"] // slot) >= 2
    assert plan.smem_bytes == plan.slots * slot
    assert plan.teams <= plan.slots                       # the teams' dw rows fit the ring
    assert plan.smem_bytes + STATIC_SMEM <= tlint.DEFAULT_SMEM_BUDGET
    # every vector of a row has a lane: warps x 32 lanes x ARN_LANE_VECTORS
    assert plan.warps * 32 * GEO["ARN_LANE_VECTORS"] * 16 >= d * dtype.itemsize


@pytest.mark.parametrize("dtype,edge", [(BF16, 8192), (FP32, 4096)])
@pytest.mark.parametrize("site", [False, True])
def test_plan_ring_edge_then_wide_then_refused(dtype, edge, site):
    """d <= 8192 in bf16 (4096 in fp32) takes the ring in every mode; the
    next width (8 more) takes the wide kernel, up to the forward's 4096
    vectors a row; past that, or off a multiple of 8, ValueError."""
    kw = dict(with_h=site, with_ds=site)
    ring = arn.bwd_plan(100, edge, dtype, **kw)
    assert ring.kind == "ring" and ring.warps == GEO["ARN_CONSUMER_WARPS"]
    assert ring.smem_bytes + STATIC_SMEM <= tlint.DEFAULT_SMEM_BUDGET
    wide = arn.bwd_plan(100, edge + 8, dtype, **kw)
    assert wide.kind == "wide" and wide.smem_bytes == (edge + 8) * 4
    limit = arn.MAX_ROW_VECTORS * 16 // dtype.itemsize
    assert arn.bwd_plan(100, limit, dtype, **kw).kind == "wide"
    with pytest.raises(ValueError, match="4096 16-byte vectors"):
        arn.bwd_plan(100, limit + 8, dtype, **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        arn.bwd_plan(100, 260, dtype, **kw)


def test_wide_plan_keeps_the_parents_row_groups():
    for rows in (1, 511, 512, 513, 1037, 6144):
        plan = arn.bwd_plan(rows, 16384, BF16)
        per = -(-rows // min(rows, GEO["ADD_RMS_NORM_GROUPS"]))
        assert plan.ctas == -(-rows // per) <= min(rows, GEO["ADD_RMS_NORM_GROUPS"])


@pytest.mark.parametrize("d", [8, 264, 2048, 4096, 8192])
@pytest.mark.parametrize("stock", [False, True])
def test_ring_specs_declare_the_plan(d, stock):
    rows = 300
    site = not stock
    plan = arn.bwd_plan(rows, d, BF16, with_h=site, with_ds=site)
    ring, reduce = arn.bwd_specs(rows, d, BF16, FP32, site, site, stock=stock)
    assert ring.name == ("rms_norm_bwd_ring_kernel" if stock else "add_rms_norm_bwd_ring_kernel")
    assert reduce.name == ("rms_norm_bwd_dw_kernel" if stock else "dw_reduce_kernel")
    assert ring.grid == (plan.ctas, -(-rows // plan.ctas))
    assert ring.cuda == ("add_rms_norm", 4 if stock else 3, 1, 0, d,
                         plan.slots * 4 + (0 if stock else 3))
    rep = tlint.lint_kernel_spec(ring)
    assert not rep, rep.report()
    assert rep.meta["kernel_smem_bytes"] == plan.smem_bytes + STATIC_SMEM
    assert not tlint.lint_kernel_spec(reduce)


# (b) the row -> CTA -> team mirror ----------------------------------------------

@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 3000), sms=st.integers(1, 400), d=st.sampled_from([8, 264, 2048]),
       site=st.booleans())
def test_every_row_goes_to_one_team_in_a_fixed_order(rows, sms, d, site):
    """Every row is summed into dw by exactly one (CTA, team), CTAs take
    contiguous runs of rows in CTA order, a team its CTA's rows in order,
    CTAs differ by at most one row, and the assignment is a function of
    (rows, CTAs, teams) alone: dw's order of summation is fixed."""
    plan = arn.bwd_plan(rows, d, BF16, with_h=site, with_ds=site, sms=sms)
    assert plan.ctas == min(rows, sms * GEO["ARN_CTAS_PER_SM"]) >= 1
    order = _bwd_rows(rows, plan.ctas, plan.teams)
    assert order == _bwd_rows(rows, plan.ctas, plan.teams)
    assert len(order) == plan.ctas and all(len(c) == plan.teams for c in order)
    seen = [r for cta in order for team in cta for r in team]
    assert sorted(seen) == list(range(rows))
    runs = [sorted(r for team in cta for r in team) for cta in order]
    assert all(run == list(range(run[0], run[-1] + 1)) for run in runs)   # contiguous
    assert [run[0] for run in runs] == sorted(run[0] for run in runs)     # in CTA order
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
    for cta, run in zip(order, runs):
        for t, team in enumerate(cta):
            assert team == run[t::plan.teams]                             # rows t, t + teams, ...


def test_mirrored_dw_order_is_within_the_fp32_limit():
    """dw summed in the kernel's order (a team's rows in order, its CTA's
    teams, then dw_reduce_kernel's eight strided groups and the eight in
    order) in fp32, at `base`'s rows, against an fp64 sum: well inside the
    RMS_DW_ATOL limit of chip_smoke.py (1e-5 of the largest |dw|)."""
    rng = np.random.default_rng(7)
    rows, cols = 3 * 2048, 64
    terms = rng.standard_normal((rows, cols)).astype(np.float32) * \
        rng.standard_normal((rows, cols)).astype(np.float32)
    plan = arn.bwd_plan(rows, 2048, BF16, with_h=False, with_ds=False)
    partial = np.zeros((plan.ctas, cols), np.float32)
    for c, cta in enumerate(_bwd_rows(rows, plan.ctas, plan.teams)):
        team_sums = []
        for team in cta:
            acc = np.zeros(cols, np.float32)
            for r in team:
                acc += terms[r]
            team_sums.append(acc)
        total = np.zeros(cols, np.float32)
        for acc in team_sums:
            total += acc
        partial[c] = total
    strided = []
    for wy in range(8):
        acc = np.zeros(cols, np.float32)
        for g in range(wy, plan.ctas, 8):
            acc += partial[g]
        strided.append(acc)
    dw = np.zeros(cols, np.float32)
    for acc in strided:
        dw += acc
    want = terms.astype(np.float64).sum(0)
    assert np.abs(dw - want).max() <= 1e-6 * np.abs(want).max()


# (c) the registry's norm-only entry -----------------------------------------------

def test_rms_norm_bwd_entry_admits_clean_at_its_examples():
    entry = registry.entries()["rms_norm_bwd"]
    assert {"bfloat16+float32@base", "bfloat16+float32@longctx", "bfloat16+float32@ssd_train",
            "bfloat16+float32@ragged", "bfloat16", "float32"} <= set(entry.dtypes)
    # every (rows, weight) pair the forward's kernels take has an example
    for x_dt in ("float32", "bfloat16"):
        for w_dt in ("float32", "bfloat16", "float16"):
            assert registry.dtype_key(getattr(torch, x_dt), getattr(torch, w_dt)) in entry.dtypes
    rep = registry.check("rms_norm_bwd")
    assert not rep, rep.report()
    assert rep.meta["legs"] == ["static"] and rep.meta["kernels"] == 2
    shapes = {"base": (6144, 2048), "longctx": (16384, 2048), "ssd_train": (8192, 4096),
              "ragged": (1037, 264)}
    for at, (rows, d) in shapes.items():
        specs = entry.build(f"bfloat16+float32@{at}")[0]
        assert [s.name for s in specs] == ["rms_norm_bwd_ring_kernel", "rms_norm_bwd_dw_kernel"]
        assert specs[0].inputs[0].shape == (rows, d)


def test_stock_backward_admitted_on_the_cpu_at_its_dtype():
    from paddle_tpu_torch.framework import flags

    registry.reset_admission_cache()
    flags.set_flags({"kernel_admission": True})
    try:
        x = torch.randn(3, 5, 256, requires_grad=True)
        w = torch.ones(256, dtype=BF16, requires_grad=True)
        trms.rms_norm(x.to(BF16), w).float().sum().backward()
        assert ("rms_norm_bwd", "cpu", "bfloat16") in registry.admissions()
    finally:
        flags.set_flags({"kernel_admission": False})
        registry.reset_admission_cache()


# (d) the plain backwards against one another and against JAX ---------------------

# fp32: sums in another order (rtol and atol 1e-5); bf16 dx: both round the
# same fp32 expression once, so two bf16 ulps (rtol 1.6e-2, atol 1e-3); dw
# stays fp32 (an fp32 weight) at 1e-5 of its largest |value|
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_only_backwards_agree_with_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 37, 256)).astype(np.float32)
    dy = rng.standard_normal((3, 37, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b, 1e-6), xj, jnp.asarray(w))
    gx, gw = vjp(dyj)
    gx = np.asarray(gx.astype(jnp.float32))
    gw = np.asarray(gw)
    xt, dyt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt), torch.from_numpy(w)
    dx_k, _, dw_k = arn.add_rms_norm_bwd_reference(xt.reshape(-1, 256), None, wt, None,
                                                   dyt.reshape(-1, 256), 1e-6)
    dx_p, dw_p = trms.rms_norm_backward(xt, wt, dyt, 1e-6)
    dx_r, dw_r = trms.rms_norm_backward_reference(xt, wt, dyt, 1e-6)
    assert torch.equal(dx_p, dx_r) and torch.equal(dw_p, dw_r)   # the CPU path is the plain one
    assert dx_p.dtype == tdt and dw_p.dtype == FP32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1e-3)
    for dx in (dx_k.reshape(x.shape), dx_p):
        np.testing.assert_allclose(dx.float().numpy(), gx, **tol)
    for dw in (dw_k, dw_p):
        np.testing.assert_allclose(dw.numpy(), gw, rtol=0, atol=1e-5 * np.abs(gw).max())
