"""paddle_tpu_torch CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test skips without CUDA (the decision is made inside
the fixture, never at import).  On a machine with a card run
``python -m pytest --noconftest tests/test_torch_gpu.py -q`` (the shared
``conftest.py`` imports JAX, which this file does not need);
``python3 chip_smoke.py`` covers the same ground at the serving and
training paths' full shapes.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_plain(cuda, dtype):
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(37, 264, generator=g, device=cuda).to(dtype)
    w = torch.randn(264, generator=g, device=cuda)          # fp32 weight, any x dtype
    before = rms_norm.launches
    y = rms_norm(x, w)
    assert rms_norm.launches == before + 1
    # fp32: rsqrt ulps; bf16: two bf16 ulps of the plain value
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-3)
    torch.testing.assert_close(y, rms_norm_reference(x, w), **tol)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_match_plain_under_nan_trash(cuda, d, dtype):
    from paddle_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(1)
    B, H, Hk, bs, NB, MAXB = 5, 8, 2, 16, 40, 24
    q = torch.randn(B, 1, H, d, generator=g, device=cuda).to(dtype)
    kp = torch.randn(NB, Hk, bs, d, generator=g, device=cuda).to(dtype)
    vp = torch.randn(NB, Hk, bs, d, generator=g, device=cuda).to(dtype)
    lengths = torch.tensor([0, 1, 16, 17, 300], dtype=torch.int32, device=cuda)
    tbl = torch.zeros(B, MAXB, dtype=torch.int32)
    nxt = 1
    for b, L in enumerate(lengths.tolist()):
        n = -(-L // bs)
        tbl[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        if L % bs:
            kp[tbl[b, n - 1], :, L % bs:] = float("nan")
            vp[tbl[b, n - 1], :, L % bs:] = float("nan")
    kp[0] = vp[0] = float("nan")
    tbl = tbl.to(cuda)
    sm = d ** -0.5
    out = da.paged_decode_attention(q, kp, vp, tbl, lengths)
    ref = da._paged_pool_reference(q, kp, vp, tbl, lengths, sm)
    assert bool(torch.isfinite(out.float()).all())
    assert bool((out[0] == 0).all())
    # bf16: two bf16 ulps of the plain value (outputs are O(sqrt(1/L)), so a
    # dropped or double-counted key moves them far past this)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-3)
    torch.testing.assert_close(out, ref, **tol)
    # dense layout: the same sequences gathered into [B, C, Hk, D]
    kd = da._gather_pool(kp, tbl).contiguous()
    vd = da._gather_pool(vp, tbl).contiguous()
    out_d = da.masked_multihead_attention(q, kd, vd, lengths)
    ref_d = da._decode_reference(q, kd, vd, lengths, sm)
    torch.testing.assert_close(out_d[1:], ref_d[1:], **tol)


# RMSNorm at row counts that take each kernel (a CTA a row up to 131 rows, a
# warp a row at 4096) and widths from 32 vectors (256) to 16 KB (8192), a
# ragged vector group (264) among them, over each weight dtype
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [256, 264, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 7, 131, 4096])
def test_rms_norm_kernels_at_every_row_count_and_width(cuda, rows, d, w_dtype):
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(rows, d, generator=g, device=cuda).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(w_dtype)
    before = rms_norm.launches
    y = rms_norm(x, w)
    assert rms_norm.launches == before + 1
    # two bf16 ulps of the plain value
    torch.testing.assert_close(y, rms_norm_reference(x, w), rtol=1.6e-2, atol=1e-3)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 264, 2048, 4096])
def test_rms_norm_row_and_cta_kernels_give_the_same_bits(cuda, monkeypatch, x_dtype, d):
    """Both kernels sum a row in one order, so the warp-a-row kernel's
    result is the CTA-a-row kernel's to the bit."""
    from paddle_tpu_torch.kernels import rms_norm as rn

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(1031, d, generator=g, device=cuda).to(x_dtype)
    w = torch.randn(d, generator=g, device=cuda)
    assert rn.plan(1031, d, x_dtype)[0] == "rows"
    rows = rn.rms_norm(x, w)
    monkeypatch.setattr(rn, "plan", lambda *a: ("cta", 0))
    cta = rn.rms_norm(x, w)
    assert torch.equal(rows.view(torch.int16 if x_dtype == torch.bfloat16 else torch.int32),
                       cta.view(torch.int16 if x_dtype == torch.bfloat16 else torch.int32))


def _decode_both_ways(cuda, rep, d, dtype, bs, MAXB, lengths, seed):
    """Paged decode over pools with NaN in the trash block and every stale
    tail, and dense decode over the same sequences gathered, each against
    its plain version, with launch counts, zeros for L == 0 and the same
    bits from both addressings."""
    from paddle_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(seed)
    Hk = 2
    B, H = len(lengths), rep * Hk
    NB = 1 + sum(-(-L // bs) for L in lengths) + 3
    q = torch.randn(B, 1, H, d, generator=g, device=cuda).to(dtype)
    kp = torch.randn(NB, Hk, bs, d, generator=g, device=cuda).to(dtype)
    vp = torch.randn(NB, Hk, bs, d, generator=g, device=cuda).to(dtype)
    tbl = torch.zeros(B, MAXB, dtype=torch.int32)
    nxt = 1
    for b, L in enumerate(lengths):
        n = -(-L // bs)
        tbl[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        if L % bs:
            kp[tbl[b, n - 1], :, L % bs:] = float("nan")
            vp[tbl[b, n - 1], :, L % bs:] = float("nan")
    kp[0] = vp[0] = float("nan")
    tbl = tbl.to(cuda)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    sm = d ** -0.5
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-3)
    before = da.paged_decode_attention.launches
    out = da.paged_decode_attention(q, kp, vp, tbl, len_t)
    assert da.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    assert bool((out[0] == 0).all())
    torch.testing.assert_close(out, da._paged_pool_reference(q, kp, vp, tbl, len_t, sm), **tol)
    # dense: the same sequences gathered, trash and stale tails included
    kd = da._gather_pool(kp, tbl).contiguous()
    vd = da._gather_pool(vp, tbl).contiguous()
    before = da.masked_multihead_attention.launches
    out_d = da.masked_multihead_attention(q, kd, vd, len_t)
    assert da.masked_multihead_attention.launches == before + 1
    assert bool(torch.isfinite(out_d.float()).all())
    assert bool((out_d[0] == 0).all())
    torch.testing.assert_close(out_d[1:], da._decode_reference(q, kd, vd, len_t, sm)[1:], **tol)
    # one kernel, two addressings: the same bits
    assert torch.equal(out_d.float(), out.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_kernels_at_ragged_lengths(cuda, rep, d, dtype):
    """Paged and dense decode at lengths around a 48-key block (a multiple
    of 16 that is not one of 32: tiles straddle blocks) and at the table's
    capacity (more than two 256-key splits), every query-row count a kv-head
    takes, NaN in the trash block and every stale tail."""
    bs, MAXB = 48, 12
    _decode_both_ways(cuda, rep, d, dtype, bs, MAXB,
                      [0, 1, 15, 16, 17, bs - 1, bs, bs + 1, bs * MAXB], seed=5)


@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float32, 128),
                                     (torch.float32, 256)])
def test_decode_kernels_over_rounds_of_resident_tiles(cuda, dtype, d, rep):
    """Where fewer tiles than a split's fit shared memory (bf16 at D 256,
    fp32 at D 128 and 256), a split takes rounds of tiles, and a split of
    129-255 live keys ending off a 32-key tile ends with a tile copied by
    cp.async into a slot whose earlier tiles came by TMA: blocks of 128
    keys (whole tiles by TMA) at lengths 200, 500 and 1000."""
    _decode_both_ways(cuda, rep, d, dtype, 128, 8, [0, 200, 500, 1000, 1024], seed=6)


# fp32: sums in another order than the plain version; bf16: both compute in
# fp32 from the same bf16 inputs and round once, so two bf16 ulps of the
# plain value plus an atol a little above an ulp of the O(1) outputs' small
# entries
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1.6e-2, atol=1e-3)}
# gradients also tile by tile: |kernel - plain| / |plain| (Frobenius) in
# every (batch, head, 64-row tile) block, so a tile whose gradients are
# small (late keys under the causal mask) is held to its own scale: the
# elementwise rtol for fp32, one bf16 ulp (2^-8) for bf16
FLASH_TILE_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}


def _tile_rel_err(a, b, tile=64):
    B, S, H, D = b.shape
    pad = -S % tile
    a, b = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, -1, tile, H, D)
            for x in (a, b))
    num = (a - b).square().sum((2, 4)).sqrt()
    return float((num / b.square().sum((2, 4)).sqrt().clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200), (False, 200, 200),
                                          (True, 77, 200), (True, 200, 77),
                                          (True, 1000, 1000)])
def test_flash_kernels_match_plain(cuda, dtype, d, causal, sq, sk):
    """Forward and both backward passes against the plain versions, with
    4 query heads over 2 kv-heads (a missing group sum in dK/dV shows) and
    ragged tiles on both sides; with Sq > Sk the first Sq - Sk rows see no
    key (the mean of all of V, no gradient to their scores), and 1000 rows
    walk many ragged tiles under the causal mask."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, Hk = 2, 4, 2
    q = torch.randn(B, sq, H, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, sk, Hk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, sk, Hk, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, sq, H, d, generator=g, device=cuda).to(dtype)
    sm = d ** -0.5
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, sm)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal, sm)
    torch.testing.assert_close(o, o_ref, **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal, sm)
    refs = fa._flash_bwd_reference(q, k, v, o_ref, lse_ref, do, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        scale = float(b.float().abs().max())
        tol = dict(FLASH_TOL[dtype])
        tol["atol"] *= max(scale, 1.0)
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{name}: {m}")
        assert _tile_rel_err(a, b) <= FLASH_TILE_RTOL[dtype], name
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)


def test_flash_attention_autograd_on_strided_qkv(cuda):
    """q, k, v as views of one fused projection (the model's layout) go
    through autograd with no copies, and agree with the oracle's grads."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, H, Hk, D = 2, 130, 4, 2, 64
    qkv = torch.randn(B, S, (H + 2 * Hk) * D, generator=g, device=cuda, requires_grad=True)
    q, k, v = torch.split(qkv, [H * D, Hk * D, Hk * D], dim=-1)
    q, k, v = q.reshape(B, S, H, D), k.reshape(B, S, Hk, D), v.reshape(B, S, Hk, D)
    o = fa.flash_attention(q, k, v, causal=True)
    ref = fa._attention_reference(q, k.repeat_interleave(2, dim=2),
                                  v.repeat_interleave(2, dim=2), True, None, D ** -0.5)
    torch.testing.assert_close(o, ref, rtol=2e-5, atol=2e-5)
    do = torch.randn(o.shape, generator=g, device=cuda)
    (ga,) = torch.autograd.grad(o, qkv, do)
    (gb,) = torch.autograd.grad(ref, qkv, do)
    torch.testing.assert_close(ga, gb, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, mask=torch.ones(S, S, dtype=torch.bool, device=cuda))


def _flash_fp32_case(cuda, B, sq, sk, H, Hk, d, causal, seed):
    """q, k, v, do fp32 on the card from ``seed`` and the softmax scale."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, sq, H, d, generator=g, device=cuda)
    k = torch.randn(B, sk, Hk, d, generator=g, device=cuda)
    v = torch.randn(B, sk, Hk, d, generator=g, device=cuda)
    do = torch.randn(B, sq, H, d, generator=g, device=cuda)
    return q, k, v, do, d ** -0.5


def _assert_flash_fp32_matches_plain(q, k, v, do, causal, sm):
    """The fp32 kernels forward and backward against the plain versions,
    held as test_flash_kernels_match_plain holds them."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, causal, sm)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal, sm)
    torch.testing.assert_close(o, o_ref, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal, sm)
    refs = fa._flash_bwd_reference(q, k, v, o_ref, lse_ref, do, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        tol = dict(FLASH_TOL[torch.float32])
        tol["atol"] *= max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{name}: {m}")
        assert _tile_rel_err(a, b) <= FLASH_TILE_RTOL[torch.float32], name


def test_flash_fp32_at_ernie_geometry(cuda):
    """ERNIE-base's attention as `ernie_train` launches it (S 512, 12 heads
    of 64, non-causal, fp32), at B 2, against the plain versions, one
    launch of each wrapper."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do, sm = _flash_fp32_case(cuda, 2, 512, 512, 12, 12, 64, False, seed=7)
    f0, b0 = fa.flash_attention_fwd.launches_noncausal, fa.flash_attention_bwd.launches_noncausal
    _assert_flash_fp32_matches_plain(q, k, v, do, False, sm)
    assert (fa.flash_attention_fwd.launches_noncausal,
            fa.flash_attention_bwd.launches_noncausal) == (f0 + 1, b0 + 1)


@pytest.mark.parametrize("causal,sq,sk,H,Hk,d", [(False, 512, 512, 12, 12, 64),
                                                 (True, 150, 1100, 4, 2, 64),
                                                 (True, 300, 200, 4, 2, 128)])
def test_flash_fp32_gives_the_same_bits_on_every_launch(cuda, causal, sq, sk, H, Hk, d):
    """No float atomics and a fixed order for every sum (the dQ shares
    slot by slot, in k-tile order, across groups too): two launches of the
    forward and of the backward give the same bits, at ERNIE's geometry,
    over two dQ groups, and with rows that see no key."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v, do, sm = _flash_fp32_case(cuda, 2, sq, sk, H, Hk, d, causal, seed=8)
    o1, lse1 = fa.flash_attention_fwd(q, k, v, causal, sm)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, sm)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    g1 = fa.flash_attention_bwd(q, k, v, o1, lse1, do, causal, sm)
    g2 = fa.flash_attention_bwd(q, k, v, o1, lse1, do, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), g1, g2):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("extra", [0, 37])
def test_flash_fp32_backward_on_both_sides_of_the_group_rule(cuda, d, causal, extra):
    """The fp32 backward's dQ workspace holds FLASH32_DQ_SLOTS k-tiles'
    shares: at that many k-tiles one group of launches, past it two, the
    second adding to dq.  Both against the plain versions, 150 causal rows
    over the keys (the later k-tiles skip q-tiles and zero their slots)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    geo = _build.GEOMETRY["flash_attention"]
    sk = geo["FLASH32_DQ_SLOTS"] * geo[f"FLASH32_DKDV_K_ROWS_D{d}"] + extra
    assert fa.dq_groups(sk, d) == (geo["FLASH32_DQ_SLOTS"], 1 if extra == 0 else 2)
    q, k, v, do, sm = _flash_fp32_case(cuda, 1, 150, sk, 4, 2, d, causal, seed=9)
    _assert_flash_fp32_matches_plain(q, k, v, do, causal, sm)


@pytest.mark.parametrize("n,offset", [(4096 * 3 + 5, 0), (1000, 1)])
@pytest.mark.parametrize("kw", [dict(weight_decay=0.1, decoupled=True, out_dtype=None),
                                dict(weight_decay=0.1, decoupled=True, apply_decay=False,
                                     out_dtype=torch.bfloat16),
                                dict(weight_decay=0.01, decoupled=False, out_dtype=None)])
@pytest.mark.parametrize("step", [1, 1000])
def test_adamw_kernel_matches_reference_bitwise(cuda, n, offset, kw, step):
    """The kernel rounds each operation on its own, as the plain version's
    separate kernels do: bit-equal p, m, v and cast copy, vectorised or
    (misaligned by one element) scalar."""
    from paddle_tpu_torch.kernels.adamw import adamw_reference, adamw_update, adamw_update_leaves

    g = torch.Generator(device=cuda).manual_seed(4)

    def leaf():
        return torch.randn(n + offset, generator=g, device=cuda)[offset:]

    p, grad, m = leaf(), leaf(), leaf() * 0.1
    v = leaf().abs() * 0.01
    hyper = dict(beta1=0.9, beta2=0.95, epsilon=1e-8)
    ref = adamw_reference(p, grad, m, v, 3e-4, step, **hyper,
                          **{k: x for k, x in kw.items() if k != "out_dtype"})
    before = adamw_update_leaves.launches
    p2, m2, v2, p_out = adamw_update(p, grad, m, v, 3e-4, step, **hyper, **kw)
    assert adamw_update_leaves.launches == before + 1       # one launch a call
    assert p2 is p and m2 is m and v2 is v                 # in place
    for a, b in zip((p, m, v), ref):
        assert torch.equal(a, b)
    if kw["out_dtype"] is not None:
        assert torch.equal(p_out, ref[0].to(torch.bfloat16))
    else:
        assert p_out is p


def test_rms_norm_gradients_on_the_card(cuda):
    """The kernel's output is part of the autograd graph, and its gradients
    equal the plain version's (the same backward expression on both)."""
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(6, 33, 256, generator=g, device=cuda, requires_grad=True)
    w = (1 + 0.1 * torch.randn(256, generator=g, device=cuda)).requires_grad_()
    dy = torch.randn(6, 33, 256, generator=g, device=cuda)
    y = rms_norm(x, w, 1e-6)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    xc, wc = x.detach().cpu().requires_grad_(), w.detach().cpu().requires_grad_()
    dxc, dwc = torch.autograd.grad(rms_norm(xc, wc, 1e-6), (xc, wc), dy.cpu())
    dxr, dwr = torch.autograd.grad(rms_norm_reference(x, w, 1e-6), (x, w), dy)
    torch.testing.assert_close(dx.cpu(), dxc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw.cpu(), dwc, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dx, dxr, rtol=1e-5, atol=1e-5)   # autograd of the plain forward
    torch.testing.assert_close(dw, dwr, rtol=1e-5, atol=1e-4)
    xb = x.detach().to(torch.bfloat16).requires_grad_()
    yb = rms_norm(xb, w, 1e-6)
    dxb, dwb = torch.autograd.grad(yb, (xb, w), dy.to(torch.bfloat16))
    assert dxb.dtype == torch.bfloat16 and dwb.dtype == torch.float32


def _ssd_operands(dev, G, T, P, N, seed, decay=0.1):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(G, T, P, generator=g, device=dev)
    b = torch.randn(G, T, N, generator=g, device=dev)
    c = torch.randn(G, T, N, generator=g, device=dev)
    la = -torch.randn(G, T, generator=g, device=dev).abs() * decay
    return x, b, c, la


# (P, N, L) of ssd_tiny_config and ssd_8b_config; SSDConfig()'s defaults
# (two column blocks a recurrence), bench.py's on-chip case and the JAX
# registry's example (a column block of 8, N < 32)
SSD_SHAPES = [(32, 16, 16), (64, 128, 128), (128, 64, 64), (128, 128, 128), (8, 4, 64)]


@pytest.mark.parametrize("P,N,L", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, P, N, L):
    from paddle_tpu_torch.kernels import ssd_scan as ts

    x, b, c, la = _ssd_operands(cuda, 6, 4 * L, P, N, seed=6)
    before = ts.ssd_scan.launches
    y, s = ts.ssd_scan(x, b, c, la, chunk=L)
    assert ts.ssd_scan.launches == before + 1
    y_ref, s_ref = ts.ssd_scan_reference(x, b, c, la, L)
    # fp32 sums of up to L + N split-TF32 products a term in another order,
    # and the log-decay prefix sum in another order: chip_smoke.py's
    # SSD_ATOL, 1e-5 of the output's scale (read 1.52e-6 at the 8B shape)
    for a, r in ((y, y_ref), (s, s_ref)):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5 * float(r.abs().max()))
    with pytest.raises(ValueError, match="not a multiple of 8"):   # P + 4 columns
        ts.ssd_scan(torch.cat([x, x[..., :4]], dim=-1), b, c, la, chunk=L)
    wide = torch.zeros(*b.shape[:2], 256, device=cuda)
    with pytest.raises(ValueError, match="N=256"):       # a state that cannot fit
        ts.ssd_scan(x, wide, wide, la, chunk=L)


@pytest.mark.parametrize("P,N,L", SSD_SHAPES)
def test_ssd_scan_zero_rows_are_exact_noops_on_the_card(cuda, P, N, L):
    """Zero rows (x = b = c = 0, la = 0) after the valid ones, inside a chunk
    and as a whole chunk, leave every valid output and the state
    bit-identical."""
    from paddle_tpu_torch.kernels import ssd_scan as ts

    ops = _ssd_operands(cuda, 4, 2 * L, P, N, seed=7)
    ops = [t.clone() for t in ops]
    cut = 2 * L - 5
    for t in ops:
        t[:, cut:] = 0
    y0, s0 = ts.ssd_scan(*ops, chunk=L)
    pad = [torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in ops]
    y1, s1 = ts.ssd_scan(*pad, chunk=L)
    assert torch.equal(y0, y1[:, :2 * L]) and torch.equal(s0, s1)
    assert bool((y1[:, 2 * L:] == 0).all())


def test_default_shaped_ssd_model_trains_on_the_card(cuda):
    """SSDConfig()'s mixer shape (P 128, N 64, chunk 64) in a narrow model
    (2 heads, 2 layers): a TrainStep step on the card launches the scan's
    forward and backward kernels once a layer each and gives the CPU's loss
    (the plain scan) on the same weights."""
    import numpy as np
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import ssd_scan as ts
    from paddle_tpu_torch.models import (SSDForCausalLM, load_paddle_tpu_params,
                                         to_paddle_tpu_params)
    from paddle_tpu_torch.models.ssd import SSDConfig
    from paddle_tpu_torch.optimizer import AdamW

    cfg = SSDConfig(vocab_size=512, hidden_size=256, num_heads=2, num_hidden_layers=2,
                    max_position_embeddings=256)
    assert (cfg.head_dim, cfg.state_size, cfg.chunk_size) == (128, 64, 64)
    cpu = SSDForCausalLM(cfg, device="cpu", seed=0)
    gpu = SSDForCausalLM(cfg, device=cuda, seed=0)
    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 512, (2, 128)))
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        step = TrainStep(model, lambda m, x: m.compute_loss(m(x), x),
                         AdamW(learning_rate=1e-3, weight_decay=0.1,
                               parameters=model.parameters()))
        before, before_bwd = ts.ssd_scan.launches, ts.ssd_scan_bwd.launches
        losses.append(float(step(ids.to(dev))))
        launched = ts.ssd_scan.launches - before
        launched_bwd = ts.ssd_scan_bwd.launches - before_bwd
    assert launched == 2                              # the card's step: once a layer
    assert launched_bwd == 2                          # and its backward kernels once a layer
    # fp32 on both sides, sums in another order (cuBLAS, the scan kernel)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert all(np.isfinite(p.detach().cpu().numpy()).all() for p in gpu.parameters())


def _adamw_table(cuda, sizes, offset=0, g_dtype=torch.float32, seed=5):
    """p, g, m, v a leaf of ``sizes``; ``g_dtype`` "mixed": bf16 and fp32
    gradients leaf by leaf in turn."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dtypes = ([torch.bfloat16, torch.float32] * len(sizes) if g_dtype == "mixed"
              else [g_dtype] * len(sizes))

    def leaf(n, scale):
        return scale * torch.randn(n + offset, generator=gen, device=cuda)[offset:]

    return [(leaf(n, 0.02), leaf(n, 1e-3).to(dt), leaf(n, 3e-4), leaf(n, 1e-3) ** 2)
            for n, dt in zip(sizes, dtypes)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16, "mixed"])
@pytest.mark.parametrize("copies", [False, True])
def test_adamw_table_matches_reference_bitwise(cuda, offset, g_dtype, copies):
    """One launch over a ragged table (sizes 1, 3, 4097, an empty leaf,
    2048, three chunks and a tail), aligned or at views of offset 1, fp32
    or bf16 gradients or both in one table, with or without bf16 copies
    (a bf16 param over its fp32 master), one leaf undecayed: every leaf bit
    for bit the plain version on the widened gradient."""
    from paddle_tpu_torch.kernels import adamw

    sizes = [1, 3, 4097, 0, 2048, 3 * adamw.CHUNK + 5]
    leaves = _adamw_table(cuda, sizes, offset, g_dtype)
    apply = [True, False, True, True, True, True]
    outs = [torch.empty(n, dtype=torch.bfloat16, device=cuda) if copies else None
            for n in sizes]
    hyper = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
    ref = [adamw.adamw_reference(p, g.float(), m, v, 3e-4, 7, apply_decay=a, **hyper)
           for (p, g, m, v), a in zip(leaves, apply)]
    p, g, m, v = (list(c) for c in zip(*leaves))
    before = adamw.adamw_update_leaves.launches
    adamw.adamw_update_leaves(p, g, m, v, outs, 3e-4, 7, apply_decay=apply, **hyper)
    assert adamw.adamw_update_leaves.launches == before + 1
    for got, want, o in zip(zip(p, m, v), ref, outs):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if o is not None:
            assert torch.equal(o, want[0].to(torch.bfloat16))


def test_adamw_table_past_one_launch(cuda):
    """A table larger than one launch's capacity takes ceil(leaves /
    TABLE_CAP) launches, still bit for bit."""
    from paddle_tpu_torch.kernels import adamw

    sizes = [5] * (2 * adamw.TABLE_CAP + 7)
    leaves = _adamw_table(cuda, sizes)
    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01, decoupled=False)
    ref = [adamw.adamw_reference(*x, 1e-3, 3, **hyper) for x in leaves]
    before = adamw.adamw_update_leaves.launches
    adamw.adamw_update_leaves(*(list(c) for c in zip(*leaves)), [None] * len(sizes), 1e-3, 3,
                              **hyper)
    assert adamw.adamw_update_leaves.launches == before + 3
    for (p, _, m, v), want in zip(leaves, ref):
        assert all(torch.equal(a, b) for a, b in zip((p, m, v), want))


def test_adamw_one_launch_a_step(cuda):
    """The optimizer takes one launch a step over every leaf, in the eager
    step and through TrainStep (bf16 gradients too), and reuses its launch
    table."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import adamw
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(llama_tiny_config(), device=cuda, seed=0)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.1, parameters=model.parameters())
    ids = torch.randint(0, 512, (2, 64), device=cuda)
    for grad_dtype in (None, "bfloat16"):
        step = TrainStep(model, lambda m, x: m.compute_loss(m(x), x), opt, grad_dtype=grad_dtype)
        before = adamw.adamw_update_leaves.launches
        for _ in range(3):
            step(ids)
        assert adamw.adamw_update_leaves.launches == before + 3
    model.compute_loss(model(ids), ids).backward()
    before = adamw.adamw_update_leaves.launches
    opt.step()
    assert adamw.adamw_update_leaves.launches == before + 1
    assert len(opt._tables) == 2          # eager, functional: one whatever the grads' dtype


def test_adamw_takes_bf16_params_without_masters(cuda):
    """``multi_precision=False`` bf16 parameters go through the kernel (an
    fp32 working copy, the parameter written as its bf16 copy): one launch,
    the plain version's bits; a layout the kernel cannot take (an fp16
    parameter, a non-contiguous one) raises on the card."""
    from paddle_tpu_torch.kernels import adamw
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device=cuda).manual_seed(11)
    ps = [torch.nn.Parameter((0.02 * torch.randn(n, generator=gen, device=cuda))
                             .to(torch.bfloat16)) for n in (3, 4097, 2048)]
    gs = [(1e-3 * torch.randn(p.shape, generator=gen, device=cuda)).to(torch.bfloat16)
          for p in ps]
    start = [p.detach().float() for p in ps]
    opt = AdamW(learning_rate=1e-3, weight_decay=0.1, parameters=ps, multi_precision=False)
    for p, g in zip(ps, gs):
        p.grad = g
    before = adamw.adamw_update_leaves.launches
    opt.step()
    assert adamw.adamw_update_leaves.launches == before + 1
    for p, g, p0, s in zip(ps, gs, start, opt._state):
        assert "master" not in s
        z = torch.zeros_like(p0)
        want, m, v = adamw.adamw_reference(p0, g.float(), z, z, 1e-3, 1, beta1=0.9,
                                           beta2=0.999, epsilon=1e-8, weight_decay=0.1)
        assert torch.equal(p.detach(), want.to(torch.bfloat16))
        assert torch.equal(s["m"], m) and torch.equal(s["v"], v)
    for bad, mp in ((torch.zeros(8, dtype=torch.float16, device=cuda), True),
                    (torch.zeros(8, dtype=torch.float16, device=cuda), False),
                    (torch.zeros(4, 6, device=cuda).t(), True)):
        bad = torch.nn.Parameter(bad)
        bad.grad = torch.zeros_like(bad)
        with pytest.raises((TypeError, ValueError)):
            AdamW(parameters=[bad], multi_precision=mp).step()


@pytest.mark.parametrize("name,args", [("ClipGradByNorm", (1.0,)),
                                       ("ClipGradByGlobalNorm", (2.0,)),
                                       ("clip_grad_norm_", (1.5, 2.0)),
                                       ("clip_grad_norm_", (1.5, float("inf")))])
def test_bf16_clips_on_the_card_are_the_cpu_bits(cuda, name, args):
    """bf16 gradients whose squares sum exactly in any order (multiples of
    1/8), so the norms are the same bits on both devices: the card's clip
    rounds each product once from fp32, as the CPU's (and JAX's) does."""
    from paddle_tpu_torch import nn as tnn

    gen = torch.Generator().manual_seed(13)
    grads = [(torch.randint(-24, 25, s, generator=gen) / 8).to(torch.bfloat16)
             for s in ((6, 5), (5,), (3, 2, 4))]
    out = {}
    for dev in ("cpu", cuda):
        gs = [g.to(dev) for g in grads]
        if name == "clip_grad_norm_":
            ps = [torch.nn.Parameter(torch.zeros_like(g)) for g in gs]
            for p, g in zip(ps, gs):
                p.grad = g
            tnn.clip_grad_norm_(ps, *args)
            out[str(dev)] = [p.grad.cpu() for p in ps]
        else:
            out[str(dev)] = [g.cpu() for _, g in getattr(tnn, name)(*args)(
                [(None, g) for g in gs])]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_ssd_scan_gradients_on_the_card(cuda):
    """The kernel's outputs are in the autograd graph, and its gradients
    (the backward kernels) equal autograd through the plain scan."""
    from paddle_tpu_torch.kernels import ssd_scan as ts

    ops = [t.requires_grad_() for t in _ssd_operands(cuda, 4, 64, 32, 16, seed=8)]
    y, s = ts.ssd_scan(*ops, chunk=16)
    assert y.grad_fn is not None and s.grad_fn is not None
    g = torch.Generator(device=cuda).manual_seed(9)
    dy, ds = torch.randn(y.shape, generator=g, device=cuda), torch.randn(s.shape, generator=g,
                                                                          device=cuda)
    got = torch.autograd.grad((y, s), ops, (dy, ds))
    y_r, s_r = ts.ssd_scan_reference(*ops, 16)
    want = torch.autograd.grad((y_r, s_r), ops, (dy, ds))
    for name, a, r in zip(("x", "b", "c", "la"), got, want):
        assert bool(torch.isfinite(a).all()), name
        # split-TF32 products and sums in another order: SSD_ATOL, 1e-5 of
        # the gradient's scale
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()))


def _ssd_backward_case(cuda, G, T, P, N, L, seed, decay=0.1):
    from paddle_tpu_torch.kernels import ssd_scan as ts

    x, b, c, la = _ssd_operands(cuda, G, T, P, N, seed=seed, decay=decay)
    y, s, states = ts._launch(x, b, c, la, L)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    ds = torch.randn(s.shape, generator=g, device=cuda)
    return (x, b, c, la, states, dy, ds)


@pytest.mark.parametrize("P,N,L", SSD_SHAPES)
def test_ssd_scan_backward_kernel_matches_plain(cuda, P, N, L):
    """The backward kernels against ssd_scan_bwd_reference on the same
    inputs, the forward kernel's states and the same cotangents: each of dx,
    db, dc, dla within SSD_ATOL (1e-5) of its largest |value|, also at a
    log-decay of ~0.5 a token; one launch counted a call."""
    from paddle_tpu_torch.kernels import ssd_scan as ts

    for seed, decay in ((10, 0.1), (11, 5.0)):
        ops = _ssd_backward_case(cuda, 4, 4 * L, P, N, L, seed, decay)
        before = ts.ssd_scan_bwd.launches
        got = ts.ssd_scan_bwd(*ops, chunk=L)
        assert ts.ssd_scan_bwd.launches == before + 1
        want = ts.ssd_scan_bwd_reference(*ops, L)
        for name, a, r in zip(("dx", "db", "dc", "dla"), got, want):
            assert bool(torch.isfinite(a).all()), name
            torch.testing.assert_close(a, r, rtol=0, atol=1e-5 * float(r.abs().max()),
                                       msg=lambda m: f"{name} {(P, N, L)}: {m}")


@pytest.mark.parametrize("P,N,L", SSD_SHAPES)
def test_ssd_scan_backward_zero_rows_on_the_card(cuda, P, N, L):
    """Zero rows past the valid ones (x = b = c = 0, la = 0, dy = 0, ds =
    0), inside a chunk and as a whole chunk: their dx, db, dc, dla are
    exactly 0, and the valid rows' gradients are bit for bit those without
    the appended chunk."""
    from paddle_tpu_torch.kernels import ssd_scan as ts

    x, b, c, la, _, dy, _ = _ssd_backward_case(cuda, 3, 2 * L, P, N, L, 12)
    cut = 2 * L - 5
    ops = [t.clone() for t in (x, b, c, la, dy)]
    for t in ops:
        t[:, cut:] = 0
    x, b, c, la, dy = ops

    def grads(x, b, c, la, dy):
        _, s, states = ts._launch(x, b, c, la, L)
        return ts.ssd_scan_bwd(x, b, c, la, states, dy, torch.zeros_like(s), chunk=L)

    g0 = grads(x, b, c, la, dy)
    g1 = grads(*[torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in (x, b, c, la, dy)])
    for a, r in zip(g0, g1):
        assert torch.equal(a, r[:, :2 * L])
        assert bool((r[:, cut:] == 0).all())


# the fusion sites' kernels (csrc/fused_gemm.cu, csrc/add_rms_norm.cu).
# fp32: true fp32 sums in another order than cuBLAS's; bf16: both sum in
# fp32 and round once, so two bf16 ulps of the plain value plus an atol of
# 1e-3 of the output's largest |value|
FUSE_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1.6e-2)}


def _fuse_close(got, ref, dtype):
    atol, rtol = FUSE_TOL[dtype]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol * max(float(ref.float().abs().max()), 1e-30))


# (a_t, b_t): NN X W, NT dY Wᵀ (and the tied head X Eᵀ), TN Xᵀ dY (the
# weight gradients), TT; 77 rows (ragged against the 128-row tile) on an
# outer dimension, feature widths multiples of 8 but not of the tile
GEMM_LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def _gemm_operands(dev, dtype, w_dtype, a_t, b_t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    R, F1, F2 = 77, 136, 200
    if a_t and b_t:                     # Aᵀ [F1, 80] from [80, F1], Bᵀ from [F2, 80]
        a_shape, b_shape = (80, F1), (F2, 80)
    elif a_t:                           # Aᵀ [F1, R] from [R, F1], B [R, F2]
        a_shape, b_shape = (R, F1), (R, F2)
    else:                               # A [R, F1], B [F1, F2] or from [F2, F1]
        a_shape, b_shape = (R, F1), ((F2, F1) if b_t else (F1, F2))
    a = torch.randn(a_shape, generator=g, device=dev).to(dtype)
    b = (0.1 * torch.randn(b_shape, generator=g, device=dev)).to(w_dtype)
    return a, b


@pytest.mark.parametrize("a_t,b_t", GEMM_LAYOUTS, ids=["NN", "NT", "TN", "TT"])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("out", ["compute", "float32"])
def test_fused_gemm_matches_plain(cuda, a_t, b_t, dtype, w_dtype, out):
    from paddle_tpu_torch.kernels import fused_gemm as fg

    a, b = _gemm_operands(cuda, dtype, w_dtype, a_t, b_t, 7)
    out_dtype = None if out == "compute" else torch.float32
    got = fg.matmul(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype)
    _fuse_close(got, fg.matmul_reference(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype), dtype)
    if out_dtype is not None and dtype == torch.bfloat16:
        # a weight gradient: the bf16 product widened to fp32
        assert torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gemm_rms_prologue_matches_plain(cuda, side, dtype):
    """The head's products: X normed (prologue on A), normedᵀ dL (A
    transposed) and dLᵀ normed (prologue on B), with fp32 row statistics
    from ``row_rms``."""
    from paddle_tpu_torch.kernels import fused_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(8)
    x = (2.0 * torch.randn(77, 136, generator=g, device=cuda)).to(dtype)
    w_norm = 1 + 0.1 * torch.randn(136, generator=g, device=cuda)
    r = fg.row_rms(x, 1e-6)
    torch.testing.assert_close(r, fg.row_rms_reference(x, 1e-6), rtol=1e-6, atol=0)
    other = torch.randn(77, 200, generator=g, device=cuda).to(dtype)
    w = (0.1 * torch.randn(136, 200, generator=g, device=cuda))
    rms = (r, w_norm, side)
    cases = ([dict(a=x, b=w), dict(a=x, b=other, a_t=True, out_dtype=torch.float32)]
             if side == "a" else [dict(a=other, b=x, a_t=True, out_dtype=torch.float32)])
    for kw in cases:
        got = fg.matmul(rms=rms, **kw)
        _fuse_close(got, fg.matmul_reference(rms=rms, **kw), dtype)


@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32)])
def test_swiglu_epilogues_match_plain(cuda, dtype, w_dtype):
    from paddle_tpu_torch.kernels import fused_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(9)
    M, H, I = 77, 136, 200
    x = torch.randn(M, H, generator=g, device=cuda).to(dtype)
    w_gu = (0.1 * torch.randn(H, 2 * I, generator=g, device=cuda)).to(w_dtype)
    d_act = torch.randn(M, I, generator=g, device=cuda).to(dtype)
    _fuse_close(fg.swiglu_gate_up(x, w_gu, I), fg.swiglu_gate_up_reference(x, w_gu, I), dtype)
    for got, ref in zip(fg.swiglu_gate_up_bwd(x, w_gu, d_act, I),
                        fg.swiglu_gate_up_bwd_reference(x, w_gu, d_act, I)):
        _fuse_close(got, ref, dtype)


# bf16 runs the tensor-core kernel (128 x 256 output tiles, 128 x 128 for
# the SwiGLU epilogues, K steps of 64): a single row, one row past a tile,
# K not a multiple of 64 (8, 200), N and I not multiples of the tile; for
# TN the ragged extent is the stored rows (K; TT's B holds K contiguous)
TC_SHAPES = {"NN": [(1, 200, 264), (129, 8, 8), (129, 520, 1000)],
             "NT": [(1, 200, 264), (129, 8, 8), (129, 520, 1000)],
             "TN": [(136, 1, 200), (264, 129, 8), (520, 200, 1000)],
             "TT": [(136, 8, 200), (264, 136, 8), (520, 200, 1000)]}


def _tc_operands(dev, layout, M, K, N, seed):
    a_t, b_t = layout[0] == "T", layout[1] == "T"
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((K, M) if a_t else (M, K), generator=g, device=dev).to(torch.bfloat16)
    b = 0.1 * torch.randn((N, K) if b_t else (K, N), generator=g, device=dev)
    return a, b, a_t, b_t


@pytest.mark.parametrize("layout", list(TC_SHAPES))
@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_fused_gemm_ragged_shapes_on_the_tensor_cores(cuda, layout, case, w_dtype):
    """Every layout at ragged M, K and N, a weight-gradient store (the bf16
    product widened to fp32) and a bf16 one."""
    from paddle_tpu_torch.kernels import fused_gemm as fg

    M, K, N = TC_SHAPES[layout][case]
    a, b, a_t, b_t = _tc_operands(cuda, layout, M, K, N, 12 + case)
    b = b.to(w_dtype)
    for out_dtype in (None, torch.float32):
        got = fg.matmul(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype)
        _fuse_close(got, fg.matmul_reference(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype),
                    torch.bfloat16)
        if out_dtype is not None:
            assert torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("M,H,I", [(1, 72, 8), (129, 200, 136), (300, 520, 264)])
def test_swiglu_epilogues_at_ragged_shapes(cuda, M, H, I):
    """The gate / up boxes at I not a multiple of the 128 output columns of
    a tile (the up half starts at column I of gate_up), K not a multiple of
    64, one row and one row past a tile."""
    from paddle_tpu_torch.kernels import fused_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(M + I)
    x = torch.randn(M, H, generator=g, device=cuda).to(torch.bfloat16)
    w_gu = 0.1 * torch.randn(H, 2 * I, generator=g, device=cuda)
    d_act = torch.randn(M, I, generator=g, device=cuda).to(torch.bfloat16)
    _fuse_close(fg.swiglu_gate_up(x, w_gu, I), fg.swiglu_gate_up_reference(x, w_gu, I),
                torch.bfloat16)
    for got, ref in zip(fg.swiglu_gate_up_bwd(x, w_gu, d_act, I),
                        fg.swiglu_gate_up_bwd_reference(x, w_gu, d_act, I)):
        _fuse_close(got, ref, torch.bfloat16)


def test_fused_gemm_launches_are_bit_equal(cuda):
    """No split-K and one writer an element: two launches of every bf16
    instantiation on the same inputs agree to the bit."""
    from paddle_tpu_torch.kernels import fused_gemm as fg

    runs = []
    for layout in TC_SHAPES:
        a, b, a_t, b_t = _tc_operands(cuda, layout, *TC_SHAPES[layout][2], 20)
        runs.append(lambda a=a, b=b, a_t=a_t, b_t=b_t: (fg.matmul(a, b, a_t=a_t, b_t=b_t),))
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(300, 520, generator=g, device=cuda).to(torch.bfloat16)
    w_gu = 0.1 * torch.randn(520, 528, generator=g, device=cuda)
    d_act = torch.randn(300, 264, generator=g, device=cuda).to(torch.bfloat16)
    runs.append(lambda: (fg.swiglu_gate_up(x, w_gu, 264),))
    runs.append(lambda: fg.swiglu_gate_up_bwd(x, w_gu, d_act, 264))
    for run in runs:
        for one, two in zip(run(), run()):
            assert torch.equal(one.view(torch.int16), two.view(torch.int16))


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_preparation_passes_are_exact(cuda, src_dtype):
    """The rounding pass gives .to(bfloat16)'s bits, the normed pass the
    plain prologue's (x r) w rounded once, bit for bit; rows past a CTA's
    block of rows included."""
    from paddle_tpu_torch.kernels import fused_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(22)
    x = (3 * torch.randn(77, 264, generator=g, device=cuda)).to(src_dtype)
    if src_dtype == torch.float32:
        assert torch.equal(fg.to_compute(x, torch.bfloat16), x.to(torch.bfloat16))
    assert fg.to_compute(x.to(torch.bfloat16), torch.bfloat16).dtype == torch.bfloat16
    r = fg.row_rms(x, 1e-6)
    w = 1 + 0.1 * torch.randn(264, generator=g, device=cuda)
    want = ((x.float() * r[:, None]) * w).to(torch.bfloat16)
    assert torch.equal(fg._prep(x, (r, w, "a")), want)


@pytest.mark.parametrize("with_h", [True, False], ids=["add_norm", "norm_only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_kernels_match_plain(cuda, with_h, dtype):
    from paddle_tpu_torch.kernels import add_rms_norm as arn

    g = torch.Generator(device=cuda).manual_seed(10)
    M, H = 1037, 264          # more rows than the 512 dw groups: 3 rows a group
    x, h, d_s, dn = (torch.randn(M, H, generator=g, device=cuda).to(dtype) for _ in range(4))
    w = 1 + 0.1 * torch.randn(H, generator=g, device=cuda)
    if with_h:
        for got, ref in zip(arn.add_rms_norm_fwd(x, h, w, 1e-6),
                            arn.add_rms_norm_fwd_reference(x, h, w, 1e-6)):
            _fuse_close(got, ref, dtype)
    args = (x, h if with_h else None, w, d_s if with_h else None, dn, 1e-6)
    got = arn.add_rms_norm_bwd(*args)
    ref = arn.add_rms_norm_bwd_reference(*args)
    if with_h:
        assert got[1] is got[0]                 # dx = dh, stored once
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            _fuse_close(a, b, dtype)
    again = arn.add_rms_norm_bwd(*args)
    assert torch.equal(again[2], got[2])       # dw in a fixed order: deterministic


# the RMSNorm backward (csrc/add_rms_norm.cu: the ring kernel up to 8192
# bf16 / 4096 fp32 values a row, the wide kernel past it): `base`'s,
# `longctx`'s and `ssd_train`'s rows, the parity phase's fp32 rows, a ragged
# row (33 vectors), one row, d 8, the ring's widest row and two past it
NORM_BWD_SHAPES = [(6144, 2048), (16384, 2048), (8192, 4096), (512, 256), (1037, 264),
                   (1, 2048), (5, 8), (300, 8192), (300, 8200), (64, 16384)]
NORM_BWD_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                  (torch.float32, torch.float16), (torch.bfloat16, torch.float32),
                  (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float16)]


def _norm_bwd_close(got, ref, slack=None):
    """dx: fp32 rtol 1e-5, atol 1e-5 x max(1, max |plain|) (sums in another
    order); bf16 two ulps (rtol 1.6e-2, atol 1e-3) plus ``slack``.  dw: fp32
    within 1e-5 of its largest |value| (rows summed in another order; see
    chip_smoke.RMS_DW_ATOL); a 2-byte dw two ulps."""
    (dx, dw), (rdx, rdw) = got, ref
    assert dx.dtype == rdx.dtype and dx.shape == rdx.shape
    assert dw.dtype == rdw.dtype and dw.shape == rdw.shape
    assert bool(torch.isfinite(dx.float()).all() and torch.isfinite(dw.float()).all())
    err = (dx.float() - rdx.float()).abs()
    if dx.dtype == torch.float32:
        limit = 1e-5 * max(1.0, float(rdx.abs().max())) + 1e-5 * rdx.abs()
    else:
        limit = 1e-3 + 1.6e-2 * rdx.float().abs() + (0 if slack is None else slack)
    assert bool((err <= limit).all()), float(err.max())
    if dw.dtype == torch.float32:
        torch.testing.assert_close(dw, rdw, rtol=0, atol=1e-5 * float(rdw.abs().max()))
    else:
        torch.testing.assert_close(dw.float(), rdw.float(), rtol=1.6e-2, atol=1e-3)


@pytest.mark.parametrize("dtype,w_dtype", NORM_BWD_PAIRS)
@pytest.mark.parametrize("rows,d", NORM_BWD_SHAPES)
def test_stock_rms_norm_backward_kernel_matches_plain(cuda, rows, d, dtype, w_dtype):
    """rms_norm_backward on CUDA tensors launches the kernel (its counter
    moves one a call) for every (rows, weight) dtype pair the forward takes;
    dx and dw agree with the plain version, dw is the same bits in two
    calls."""
    from paddle_tpu_torch.kernels import rms_norm as rn

    g = torch.Generator(device=cuda).manual_seed(30)
    x, dy = (torch.randn(rows, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    w = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(w_dtype)
    before = rn.rms_norm_backward.launches
    got = rn.rms_norm_backward(x, w, dy, 1e-6)
    again = rn.rms_norm_backward(x, w, dy, 1e-6)
    assert rn.rms_norm_backward.launches == before + 2
    _norm_bwd_close(got, rn.rms_norm_backward_reference(x, w, dy, 1e-6))
    assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.parametrize("mode", ["h, d_s", "h", "d_s", "neither"])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("rows,d", [(6144, 2048), (8192, 4096), (1037, 264), (1, 2048), (5, 8),
                                    (300, 8192), (64, 16384)])
def test_add_rms_norm_backward_modes_match_plain(cuda, rows, d, dtype, w_dtype, mode):
    """add_rms_norm_bwd in each of its modes (h and d_s given or not)
    against the plain reference's autograd; dx with one bf16 ulp of the
    rounded norm gradient more where d_s is added (emit.add_norm_slack); dw
    deterministic."""
    from paddle_tpu_torch.kernels import add_rms_norm as arn
    from paddle_tpu_torch.kernels import emit

    g = torch.Generator(device=cuda).manual_seed(31)
    x, h, d_s, dn = (torch.randn(rows, d, generator=g, device=cuda).to(dtype) for _ in range(4))
    w = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(w_dtype)
    h = h if "h" in mode.split(", ") else None
    d_s = d_s if "d_s" in mode else None
    args = (x, h, w, d_s, dn, 1e-6)
    dx, dh, dw = arn.add_rms_norm_bwd(*args)
    rdx, _, rdw = arn.add_rms_norm_bwd_reference(*args)
    assert (dh is dx) if h is not None else dh is None
    slack = None if d_s is None else emit.add_norm_slack(x, h, w, d_s, dn, epsilon=1e-6)
    _norm_bwd_close((dx, dw), (rdx, rdw), slack)
    assert torch.equal(arn.add_rms_norm_bwd(*args)[2], dw)


def test_rms_norm_autograd_runs_the_backward_kernel(cuda):
    """_RMSNorm's backward on CUDA tensors launches the kernel once, for a
    3-D non-contiguous x over an fp32 weight, and its gradients are the
    plain backward's."""
    from paddle_tpu_torch.kernels import rms_norm as rn

    g = torch.Generator(device=cuda).manual_seed(32)
    base = torch.randn(2048, 3, 2, generator=g, device=cuda).to(torch.bfloat16)
    x = base.permute(1, 2, 0).detach().requires_grad_()      # [3, 2, 2048], not contiguous
    w = (1 + 0.1 * torch.randn(2048, generator=g, device=cuda)).requires_grad_()
    dy = torch.randn(3, 2, 2048, generator=g, device=cuda).to(torch.bfloat16)
    before = (rn.rms_norm.launches, rn.rms_norm_backward.launches)
    rn.rms_norm(x, w, 1e-6).backward(dy)
    assert (rn.rms_norm.launches, rn.rms_norm_backward.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    _norm_bwd_close((x.grad, w.grad), rn.rms_norm_backward_reference(x.detach(), w.detach(),
                                                                     dy, 1e-6))


@pytest.mark.parametrize("name,transpose", [("fuse_swiglu_mlp", None),
                                            ("fuse_add_rms_norm", None),
                                            ("fuse_rms_norm_head", False),
                                            ("fuse_rms_norm_head", True)])
def test_fused_sites_on_the_card(cuda, name, transpose):
    """Every site verifies on the card (fp32 at its example shapes), and in
    bf16 with fp32 weights over 77 ragged rows the Function's forward and
    gradients agree with the plain reference and its autograd; each site
    forward and backward counts one launch."""
    from paddle_tpu_torch.kernels import emit

    assert emit.verify_site(name, cuda) == []
    site = emit.SITES[name]
    static = dict(site.example_static)
    shapes = [s for s, _ in site.example_shapes]
    if transpose is not None:
        static["transpose"] = transpose
        if transpose:
            shapes[2] = shapes[2][::-1]
    shapes = [((77,) + s[1:]) if i < site.n_row_args else s for i, s in enumerate(shapes)]
    g = torch.Generator(device=cuda).manual_seed(11)
    args = [(0.1 * torch.randn(s, generator=g, device=cuda)).to(
        torch.bfloat16 if i < site.n_row_args else torch.float32) for i, s in enumerate(shapes)]
    fwd, bwd = emit._FORWARD[name], emit._BACKWARD[name]
    f0, b0 = fwd.launches, bwd.launches
    p = [a.clone().requires_grad_() for a in args]
    outs = emit._as_tuple(emit.make_fused(name, cuda)(*p, **static))
    refs = emit._as_tuple(site.ref(*args, **static))
    cts = [torch.randn(r.shape, generator=g, device=cuda).to(r.dtype) for r in refs]
    grads = torch.autograd.grad(outs, p, cts)
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1)
    for o, r in zip(outs, refs):
        _fuse_close(o.detach(), r, torch.bfloat16)
    for gr, w in zip(grads, emit._vjp_reference(site, args, cts, static)):
        _fuse_close(gr, w, torch.bfloat16)


# ---------------------------------------------------------------------------
# the kernel gate (kernels/registry.py, analysis/kernel_lint.py)
# ---------------------------------------------------------------------------

def test_seeded_kernels_against_their_plain_versions(cuda):
    """The seeded defects run, and are wrong exactly where they are meant
    to be: write-race stores to tile 0 only (each element one CTA's doubled
    value: the CTAs race element by element) and the sentinel stays in the
    other tiles; parallel-carry's first tile of each row (which reads no
    carried state) is its input."""
    from paddle_tpu_torch.analysis.kernel_lint import sentinel_outputs
    from paddle_tpu_torch.kernels import injected

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(32, 128, generator=g, device=cuda)
    with sentinel_outputs():
        y = injected.write_race(x)
    ref = injected.write_race_reference(x)
    tiles = ref.reshape(4, 8, 128)
    assert bool((y[:8][None] == tiles).any(0).all())
    assert bool(torch.isnan(y[8:]).all())
    x3 = torch.randn(2, 32, 128, generator=g, device=cuda)
    y3 = injected.parallel_carry(x3)
    assert torch.equal(y3[:, :8], x3[:, :8])


@pytest.mark.parametrize("kind,codes", [
    ("write-race", {"krn-write-race", "krn-coverage-hole"}),
    ("parallel-carry", {"krn-parallel-carry"}),
    ("emit-race", {"krn-coverage-hole"}),
])
def test_gate_refuses_each_seeded_defect_on_the_card(cuda, kind, codes):
    from paddle_tpu_torch.kernels import registry

    registry.load_all()
    registry._apply_injection(kind)
    name = "injected_" + kind.replace("-", "_")
    try:
        rep = registry.check(name, device=cuda)
    finally:
        registry._REGISTRY.pop(name)
    assert codes <= set(rep.counts()), rep.report()
    assert rep.meta["legs"] == ["static", "dynamic"]
    if kind == "emit-race":            # the honest spec: only the card sees the defect
        assert not registry.check("fuse_swiglu_mlp")
        # refused at both GEMM kernels: the fp32 CUDA-core and the bf16 tensor-core one
        holes = {f.where.split(":")[0] for f in rep.findings if f.code == "krn-coverage-hole"}
        assert holes == {f"{name}@float32", f"{name}@bfloat16+float32"}, rep.report()


def test_every_entry_is_clean_on_the_card(cuda):
    from paddle_tpu_torch.analysis.kernel_lint import _smem_bytes
    from paddle_tpu_torch.kernels import launch_counts, registry

    registry.load_all()
    before = launch_counts()
    reports = registry.check_all(device=cuda)
    assert launch_counts() == before           # the gate's launches land in no path
    assert len(reports) == 20
    for name, rep in reports.items():
        assert not rep, rep.report()
        assert rep.meta["legs"] == ["static", "dynamic"]
        entry = registry.entries()[name]
        for dt in entry.dtypes or (None,):       # every dtype's instantiations
            for spec in entry.build(dt)[0] if dt else entry.build()[0]:
                key = spec.name if dt is None else f"{spec.name}@{dt}"
                assert rep.meta["smem_bytes_card_by_kernel"][key] == _smem_bytes(spec)


# ---------------------------------------------------------------------------
# the MoE slice and the incubate ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tf32", [True, False], ids=["tf32", "fp32"])
@pytest.mark.parametrize("gate", ["switch", "gshard"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, gate, tf32):
    """The router computes in full fp32 whatever the global TF32 setting, so
    the card routes as the CPU does; with TF32 off, outputs, aux and
    gradients within fp32 limits too (with it on, the expert products are
    TF32's)."""
    from paddle_tpu_torch.incubate.moe import MoELayer

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        cpu = MoELayer(64, 96, 8, gate=gate, capacity_factor=1.0, device="cpu", seed=2)
        card = MoELayer(64, 96, 8, gate=gate, capacity_factor=1.0, device=cuda, seed=3)
        with torch.no_grad():
            for a, b in zip(card.parameters(), cpu.parameters()):
                a.copy_(b)
        g = torch.Generator().manual_seed(4)
        x = torch.randn(4, 64, 64, generator=g)
        u = torch.rand(256, generator=g)
        outs = {}
        for name, layer in (("cpu", cpu), ("cuda", card)):
            xi = x.detach().to(layer.gate_weight.device).requires_grad_(True)
            out, aux = layer.forward_with_aux(xi, u.to(xi.device))
            (out.square().sum() + aux).backward()
            outs[name] = (out.detach().cpu(), aux.detach().cpu(), xi.grad.cpu(),
                          [p.grad.cpu() for p in layer.parameters()], layer.last_routing)
        assert torch.backends.cuda.matmul.allow_tf32 == tf32   # the router's scope restored it
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rc, rg = outs["cpu"][4], outs["cuda"][4]
    assert torch.equal(rc.expert, rg.expert.cpu()) and torch.equal(rc.kept, rg.kept.cpu())
    assert not bool(rc.kept.all())                    # capacity dropped some
    if tf32:
        return
    for a, b in zip(outs["cuda"][:3], outs["cpu"][:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(outs["cuda"][3], outs["cpu"][3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_moe_dispatch_backward_is_the_same_bits_twice(cuda):
    from paddle_tpu_torch.incubate.moe import dispatch, top_k_gating

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4096, 256, generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    r = top_k_gating(torch.randn(4096, 8, generator=g, device=cuda), 2, 1280, "naive")
    out = dispatch(x, r)
    dy = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    (a,) = torch.autograd.grad(out, x, dy, retain_graph=True)
    (b,) = torch.autograd.grad(out, x, dy)
    assert torch.equal(a, b)
    rows = torch.cat([dy.reshape(-1, 256), torch.zeros(1, 256, dtype=dy.dtype, device=cuda)])
    want = (rows[r.slot[:, 0]].float() + rows[r.slot[:, 1]].float()).to(torch.bfloat16)
    assert torch.equal(a, want)


def test_bf16_moe_step_launches_adamw_once(cuda):
    """A bf16 MoE model has fp32 routers beside bf16 weights: one AdamW launch
    a step all the same, and a step run twice from one state gives the same
    bits."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import adamw
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(llama_tiny_config(moe_num_experts=4, dtype="bfloat16"),
                             device=cuda, seed=0)
    step = TrainStep(model, lambda m, x: m.compute_loss(m(x), x),
                     AdamW(learning_rate=1e-3, parameters=model.parameters()))
    ids = torch.randint(0, 512, (2, 128), device=cuda)
    before = adamw.adamw_update_leaves.launches
    step(ids)
    assert adamw.adamw_update_leaves.launches == before + 1
    start = {k: v.clone() for k, v in step.state_dict().items()}
    gen = model.generator.get_state()
    ends = []
    for _ in range(2):
        step.set_state_dict(start)
        model.generator.set_state(gen)
        loss = step(ids)
        ends.append((loss, {k: v.clone() for k, v in step.state_dict().items()}))
    assert torch.equal(ends[0][0], ends[1][0])
    assert all(torch.equal(ends[0][1][k], ends[1][1][k]) for k in start)


def test_incubate_ops_launch_their_kernels(cuda):
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    g = torch.Generator(device=cuda).manual_seed(6)
    B, H, Hk, D, bs, nb = 3, 8, 2, 64, 16, 4
    x = torch.randn(B, 1, 256, generator=g, device=cuda)
    w = torch.randn(256, generator=g, device=cuda)
    before = rms_norm.launches
    torch.testing.assert_close(IF.fused_rms_norm(x, w), rms_norm_reference(x, w),
                               rtol=1e-5, atol=1e-5)
    assert rms_norm.launches == before + 1
    q = torch.randn(B, 1, H, D, generator=g, device=cuda)
    kp = torch.randn(B * nb + 2, bs, Hk, D, generator=g, device=cuda)
    vp = torch.randn(B * nb + 2, bs, Hk, D, generator=g, device=cuda)
    table = torch.randperm(B * nb + 2, generator=g, device=cuda)[:B * nb].reshape(B, nb)
    lengths = torch.tensor([1, 30, 64], dtype=torch.int32, device=cuda)
    before = da.masked_multihead_attention.launches
    got = IF.block_multihead_attention(q, kp, vp, table.int(), lengths)
    assert da.masked_multihead_attention.launches == before + 1
    k, v = (p[table].reshape(B, -1, Hk, D) for p in (kp, vp))
    torch.testing.assert_close(got, da._decode_reference(q, k, v, lengths, D ** -0.5),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(IF.masked_multihead_attention(q, k, v, lengths), got,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the stock nn library and its recipes (ERNIE, PP-OCR det + rec)
# ---------------------------------------------------------------------------

def test_sdpa_runs_the_flash_kernels_unmasked_and_the_plain_path_masked(cuda):
    """``nn.functional.scaled_dot_product_attention`` on a CUDA tensor: no
    mask at head dim 64 launches the flash kernels (forward, and backward
    under autograd) and agrees with the plain reference; with a mask, or
    at head dim 26, it launches nothing."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=cuda, requires_grad=True)
               for _ in range(3))
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out = F.scaled_dot_product_attention(q, k, v)
    out.square().sum().backward()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    ref = fa._attention_reference(q, k, v, False, None, 64 ** -0.5)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    mask = torch.zeros(2, 1, 1, 128, device=cuda)
    mask[1, ..., 100:] = -1e9
    F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    q26 = torch.randn(2, 16, 4, 26, device=cuda)
    F.scaled_dot_product_attention(q26, q26, q26)
    assert fa.flash_attention_fwd.launches == f0 + 1


def _cpu_copy(model_fn, gpu):
    from paddle_tpu_torch.models import load_paddle_tpu_params, to_paddle_tpu_params

    cpu = model_fn("cpu")
    load_paddle_tpu_params(cpu, to_paddle_tpu_params(gpu))
    return cpu


@pytest.mark.parametrize("net", ["dbnet", "crnn", "ernie-64", "ernie-tiny"])
def test_recipe_models_on_the_card_match_the_cpu(cuda, net):
    """Each recipe's tiny model, fp32 with TF32 off, card against CPU on
    the same weights: training-mode outputs and BatchNorm statistics within
    1e-5, parameter gradients within 1e-4 of their scale.  A gradient that
    is zero in exact arithmetic (a key bias, which the softmax's shift
    removes; DBNet's ``head.up1.bias``, which its BatchNorm subtracts
    again) is rounding on both sides and is held to zero: within 1e-4 of
    the model's largest gradient."""
    from paddle_tpu_torch.models import ErnieForSequenceClassification, ernie_tiny_config
    from paddle_tpu_torch.models.ocr import ocr_det_tiny, ocr_rec_tiny

    g = torch.Generator().manual_seed(8)
    if net == "dbnet":
        make, x = (lambda d: ocr_det_tiny(device=d)), torch.randn(2, 3, 48, 48, generator=g)
    elif net == "crnn":
        make, x = (lambda d: ocr_rec_tiny(device=d)), torch.randn(2, 3, 32, 64, generator=g)
    else:
        kw = (dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
              if net == "ernie-64" else {})
        cfg = ernie_tiny_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0, **kw)
        make = lambda d: ErnieForSequenceClassification(cfg, device=d)     # noqa: E731
        x = torch.randint(0, cfg.vocab_size, (2, 96), generator=g)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gpu = make(cuda)
        cpu = _cpu_copy(make, gpu)
        outs = [m(x.to(d)) for m, d in ((cpu, "cpu"), (gpu, cuda))]
        torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-5, atol=1e-5)
        for o in outs:
            o.square().sum().backward()
        largest = max(float(p.grad.abs().max()) for p in cpu.parameters())
        for (n, a), (_, b) in zip(gpu.named_parameters(), cpu.named_parameters()):
            if n.endswith(("k_proj.bias", "head.up1.bias")):
                assert max(float(a.grad.abs().max()), float(b.grad.abs().max())) <= 1e-4 * largest
                continue
            scale = max(float(b.grad.abs().max()), 1e-30)
            torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-4, atol=1e-4 * scale,
                                       msg=lambda m: f"{n}: {m}")
        for (n, a), (_, b) in zip(gpu.named_buffers(), cpu.named_buffers()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_ctc_loss_on_the_card_matches_the_cpu(cuda):
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator().manual_seed(9)
    logits = torch.randn(20, 3, 11, generator=g)
    labels = torch.tensor([[1, 2, 2, 3], [4, 0, 0, 0], [5, 6, 7, 8]])
    in_len, lab_len = torch.tensor([20, 9, 3]), torch.tensor([4, 1, 4])
    losses = []
    for d in ("cpu", cuda):
        lg = logits.detach().clone().to(d).requires_grad_()
        loss = F.ctc_loss(lg, labels, in_len, lab_len, reduction="none")
        (loss * torch.tensor([1.0, 1.0, 0.0], device=d)).sum().backward()
        losses.append((loss.detach().cpu(), lg.grad.cpu()))
    assert float(losses[1][0][2]) > 1e29                    # row 2 cannot fit: huge, finite
    torch.testing.assert_close(losses[1][0], losses[0][0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(losses[1][1], losses[0][1], rtol=1e-5, atol=1e-5)


def test_hf_roundtrip_on_the_card_keeps_the_logits_bits(cuda):
    from paddle_tpu_torch.models import (ErnieForSequenceClassification, LlamaForCausalLM,
                                         ernie_from_transformers, ernie_tiny_config,
                                         ernie_to_transformers_state_dict,
                                         llama_from_transformers, llama_tiny_config,
                                         llama_to_transformers_state_dict)

    ids = torch.randint(0, 512, (2, 32), device=cuda)
    llama = LlamaForCausalLM(llama_tiny_config(), device=cuda)
    back = llama_from_transformers(llama_to_transformers_state_dict(llama),
                                   config=llama.config, device=cuda, seed=1)
    cfg = ernie_tiny_config(num_hidden_layers=2)
    ernie = ErnieForSequenceClassification(cfg, device=cuda).eval()
    ernie_back = ernie_from_transformers(ernie_to_transformers_state_dict(ernie), config=cfg,
                                         layer_norm_eps=1e-5, device=cuda, seed=1).eval()
    with torch.no_grad():
        assert torch.equal(llama(ids), back(ids))
        assert torch.equal(ernie(ids), ernie_back(ids))


def test_model_fit_on_the_card_matches_the_cpu(cuda):
    """``hapi.Model.fit`` of an MLP under Adam (the AdamW kernel on the
    card, its plain version on the CPU): the history within 1e-5, then
    ``evaluate`` and ``predict`` too."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch.framework import device as tp_device

    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 3))
    x = rng.normal(size=(128, 8)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    out = {}
    prev = tp_device._CURRENT
    try:
        for dev in ("cpu", "gpu"):
            tp.set_device(dev)
            tp.seed(0)
            torch.manual_seed(0)
            net = tp.nn.Sequential(tp.nn.Linear(8, 32, device="cpu"), tp.nn.ReLU(),
                                   tp.nn.Linear(32, 3, device="cpu")).to(tp.get_device()
                                                                         .replace("gpu", "cuda"))
            model = tp.Model(net)
            model.prepare(tp.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters()),
                          tp.nn.CrossEntropyLoss(), tp.metric.Accuracy())
            ds = tp.io.TensorDataset([tp.to_tensor(x), tp.to_tensor(y)])
            hist = model.fit(ds, epochs=3, batch_size=32, shuffle=False, verbose=0)
            logs = model.evaluate(ds, batch_size=32, verbose=0)
            pred = model.predict(ds, batch_size=32, stack_outputs=True)[0]
            out[dev] = (hist["loss"], logs, pred)
    finally:
        tp.set_device(prev)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["gpu"][1]["loss"], out["cpu"][1]["loss"], rtol=1e-5)
    assert out["gpu"][1]["acc"] == out["cpu"][1]["acc"]
    np.testing.assert_allclose(out["gpu"][2], out["cpu"][2], atol=1e-5, rtol=0)


def _launches(fn):
    """(result of ``fn()``, the kernel launches it made)."""
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


@pytest.mark.parametrize("entry", ["F.rms_norm", "nn.RMSNorm"])
def test_rms_norm_entries_launch_the_kernels_where_jax_does(cuda, entry):
    """A width divisible by 128: one forward and one backward launch,
    values and gradients as the plain versions'; width 200: the plain
    version, no launch (the JAX function's rule)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels.rms_norm import (rms_norm_backward_reference,
                                                   rms_norm_reference)

    g = torch.Generator(device=cuda).manual_seed(3)
    for d, want in ((256, {"rms_norm": 1, "rms_norm_bwd": 1}), (200, {})):
        x = torch.randn(37, d, generator=g, device=cuda).to(torch.bfloat16).requires_grad_()
        dy = torch.randn(37, d, generator=g, device=cuda).to(torch.bfloat16)
        if entry == "nn.RMSNorm":
            layer = nn.RMSNorm(d, device=cuda)
            w = layer.weight
            with torch.no_grad():
                w.normal_(generator=g)
            call = layer
        else:
            w = torch.randn(d, generator=g, device=cuda).requires_grad_()
            call = lambda t, w=w: nn.functional.rms_norm(t, w)   # noqa: E731

        def run(x=x, dy=dy, w=w, call=call):
            y = call(x)
            return (y, *torch.autograd.grad(y, (x, w), dy))

        (y, dx, dw), counts = _launches(run)
        assert counts == want, (d, counts)
        ref_dx, ref_dw = rms_norm_backward_reference(x.detach(), w.detach(), dy)
        tol = dict(rtol=1.6e-2, atol=1e-3)
        torch.testing.assert_close(y, rms_norm_reference(x.detach(), w.detach()), **tol)
        torch.testing.assert_close(dx, ref_dx, **tol)
        torch.testing.assert_close(dw, ref_dw, rtol=1e-4, atol=1e-4 * float(ref_dw.abs().max()))


def test_flash_attn_qkvpacked_launches_one_forward_and_one_backward(cuda):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 96, 3, 4, 64, generator=g, device=cuda).to(torch.bfloat16)
    qkv.requires_grad_()

    def run():
        o = F.flash_attn_qkvpacked(qkv, causal=True)[0]
        return o, torch.autograd.grad(o.float().sum(), qkv)[0]

    (o, dqkv), counts = _launches(run)
    assert counts == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    q, k, v = (qkv.detach()[:, :, i] for i in range(3))
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, True, 64 ** -0.5)
    refs = fa._flash_bwd_reference(q, k, v, o_ref, lse_ref, torch.ones_like(o_ref), True,
                                   64 ** -0.5)
    tol = dict(rtol=1.6e-2, atol=2e-2)
    torch.testing.assert_close(o, o_ref, **tol)
    for i, r in enumerate(refs):
        torch.testing.assert_close(dqkv[:, :, i], r, **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_launches_once_a_segment(cuda, causal):
    """Four packed sequences: four forward and four backward launches, the
    output and gradients as the masked attention over the packed length;
    the varlen packed form gives the same bits."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=cuda).manual_seed(5)
    lengths = [17, 64, 5, 40]
    cu = torch.tensor([0, 17, 81, 86, 126], dtype=torch.int32, device=cuda)
    q, k, v = (torch.randn(126, 4, 32, generator=g, device=cuda).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))

    def run():
        o = F.flash_attn_unpadded(q, k, v, cu, cu, 64, 64, 0.2, causal=causal)[0]
        return o, torch.autograd.grad(o.float().sum(), (q, k, v))

    (o, grads), counts = _launches(run)
    mode = "" if causal else "_noncausal"
    assert counts == {f"flash_attention_fwd{mode}": 4, f"flash_attention_bwd{mode}": 4}
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o_ref = F._varlen_reference(qf, kf, vf, cu.tolist(), cu.tolist(), causal, 0.2)
    g_ref = torch.autograd.grad(o_ref.sum(), (qf, kf, vf))
    tol = dict(rtol=1.6e-2, atol=2e-2)
    torch.testing.assert_close(o.float(), o_ref, **tol)
    for a, b in zip(grads, g_ref):
        torch.testing.assert_close(a.float(), b, **tol)
    packed, counts = _launches(lambda: F.flash_attn_varlen_qkvpacked(
        torch.stack([q.detach(), k.detach(), v.detach()], 1), cu, cu, 64, 64, 0.2,
        causal=causal)[0])
    assert counts == {f"flash_attention_fwd{mode}": 4} and torch.equal(packed, o.detach())
    assert sum(lengths) == 126


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_with_query_boundaries_apart(cuda, causal):
    """Query boundaries apart from the keys': a segment with more keys, two
    with more queries (causal: rows that see no key), one without keys.
    One forward and one backward launch for each segment with keys, none
    for the key-less one; values and gradients as the masked attention
    over the packed length."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=cuda).manual_seed(6)
    cu_q = torch.tensor([0, 17, 81, 86, 126, 135], dtype=torch.int32, device=cuda)
    cu_k = torch.tensor([0, 20, 68, 68, 108, 111], dtype=torch.int32, device=cuda)
    q, k, v = (torch.randn(n, 4, 32, generator=g, device=cuda).to(torch.bfloat16)
               .requires_grad_() for n in (135, 111, 111))

    def run():
        o = F.flash_attn_unpadded(q, k, v, cu_q, cu_k, 64, 48, 0.2, causal=causal)[0]
        return o, torch.autograd.grad(o.float().sum(), (q, k, v))

    (o, grads), counts = _launches(run)
    mode = "" if causal else "_noncausal"
    assert counts == {f"flash_attention_fwd{mode}": 4, f"flash_attention_bwd{mode}": 4}
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o_ref = F._varlen_reference(qf, kf, vf, cu_q.tolist(), cu_k.tolist(), causal, 0.2)
    g_ref = torch.autograd.grad(o_ref.sum(), (qf, kf, vf))
    tol = dict(rtol=1.6e-2, atol=2e-2)
    torch.testing.assert_close(o.float(), o_ref, **tol)
    for a, b in zip(grads, g_ref):
        torch.testing.assert_close(a.float(), b, **tol)


# ---------------------------------------------------------------------------
# the compiled-graph layer: static Programs, to_static, jit.save / Predictor
# ---------------------------------------------------------------------------

def _tiny_llama(cuda, dtype="float32"):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config

    return LlamaForCausalLM(llama_tiny_config(dtype=dtype), device=cuda, seed=0)


def _launched(fn):
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in launch_counts().items() if n}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_tape_launches_what_eager_launches(cuda, dtype):
    """to_static's replay and a static Program's forward run launch the
    eager forward's kernels, no more and no fewer, with its bits."""
    import numpy as np
    import paddle_tpu_torch as paddle

    model = _tiny_llama(cuda, dtype)
    ids_np = np.random.default_rng(0).integers(0, 512, size=(2, 64)).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(cuda)
    with torch.no_grad():
        eager, want = _launched(lambda: model(ids))
        static = paddle.jit.to_static(model)
        first, first_n = _launched(lambda: static(ids)._data)
        again, again_n = _launched(lambda: static(ids)._data)
    L = model.config.num_hidden_layers
    assert want == {"rms_norm": 2 * L + 1, "flash_attention_fwd": L}
    assert first_n == want and again_n == want
    assert torch.equal(first, eager) and torch.equal(again, eager)
    paddle.set_device("gpu")
    try:
        paddle.enable_static()
        try:
            main = paddle.static.Program()
            with paddle.static.program_guard(main):
                x = paddle.static.data("ids", [None, 64], "int32")
                logits = model(x)
        finally:
            paddle.disable_static()
        exe = paddle.static.Executor()
        (got,), got_n = _launched(lambda: exe.run(main, feed={"ids": ids_np},
                                                  fetch_list=[logits], return_numpy=False))
    finally:
        paddle.set_device(None)
    assert got_n == want
    assert torch.equal(got._data, eager)


def test_static_step_one_is_train_steps_bits(cuda):
    """A static Program's training run from the same weights and batch is
    TrainStep's step: the same loss bits, the same launches."""
    import numpy as np
    import paddle_tpu_torch as paddle

    ids_np = np.random.default_rng(1).integers(0, 512, size=(2, 64)).astype(np.int32)
    model = _tiny_llama(cuda)
    step = paddle.jit.TrainStep(
        model, lambda m, i: m.compute_loss(m(i), i),
        paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters()))
    ts = [_launched(lambda: float(step(torch.from_numpy(ids_np).to(cuda)))) for _ in range(2)]

    model = _tiny_llama(cuda)
    paddle.set_device("gpu")
    try:
        paddle.enable_static()
        try:
            main = paddle.static.Program()
            with paddle.static.program_guard(main):
                x = paddle.static.data("ids", [None, 64], "int32")
                loss = model.compute_loss(model(x), x)
                paddle.optimizer.AdamW(learning_rate=1e-3).minimize(loss)
        finally:
            paddle.disable_static()
        exe = paddle.static.Executor()
        st = [_launched(lambda: float(exe.run(main, feed={"ids": ids_np}, fetch_list=[loss])[0]))
              for _ in range(2)]
    finally:
        paddle.set_device(None)
    L = model.config.num_hidden_layers
    want = {"rms_norm": 2 * L + 1, "rms_norm_bwd": 2 * L + 1, "flash_attention_fwd": L,
            "flash_attention_bwd": L, "adamw": 1}
    assert st[0][0] == ts[0][0]
    assert abs(st[1][0] - ts[1][0]) <= 1e-5 * abs(ts[1][0])
    assert [n for _, n in st] == [want, want] == [n for _, n in ts]


def test_predictor_output_is_eager_bits(cuda, tmp_path):
    """jit.save, then a Predictor from the artifact alone: the eager
    forward's bits and launches."""
    import numpy as np
    import paddle_tpu_torch as paddle

    model = _tiny_llama(cuda, "bfloat16")
    ids_np = np.random.default_rng(2).integers(0, 512, size=(2, 64)).astype(np.int32)
    with torch.no_grad():
        eager, want = _launched(lambda: model(torch.from_numpy(ids_np).to(cuda)))
    prefix = str(tmp_path / "tiny")
    paddle.jit.save(model, prefix, input_spec=[paddle.static.InputSpec([2, 64], "int32")])
    pred = paddle.inference.create_predictor(paddle.inference.Config(prefix))
    pred.get_input_handle("input_0").copy_from_cpu(ids_np)
    _, got_n = _launched(pred.run)
    out = pred.get_output_handle("output_0")._value
    assert out.is_cuda and got_n == want
    assert torch.equal(out, eager)


def test_loader_workers_feed_a_cuda_step_without_initialising_cuda(cuda):
    """Spawned DataLoader workers (``torch_worker_data.InfoDS``) feed a step
    on the card: every batch arrives as a CUDA Tensor, the AdamW kernel
    launches each step, and each worker reports CUDA never initialised in
    it."""
    import os

    import numpy as np
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.kernels import adamw
    from torch_worker_data import InfoDS, mark_init

    tp.set_device("gpu")
    try:
        net = tp.nn.Linear(7, 1, device="cpu").to(cuda)
        opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
        before = adamw.adamw_update_leaves.launches
        rows = []
        loader = tp.io.DataLoader(InfoDS(), batch_size=3, num_workers=2,
                                  worker_init_fn=mark_init)
        for batch in loader:
            assert batch._data.is_cuda
            rows.append(batch.numpy())
            loss = net(batch.astype("float32") * 1e-6).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            assert np.isfinite(float(loss))
    finally:
        tp.set_device(None)
    rows = np.concatenate(rows)
    np.testing.assert_array_equal(rows[:, 0], np.arange(12))
    assert not rows[:, 6].any()                           # CUDA never initialised in a worker
    assert os.getpid() not in set(rows[:, 4].tolist())
    assert adamw.adamw_update_leaves.launches == before + 4
