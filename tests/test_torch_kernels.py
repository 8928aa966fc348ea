"""paddle_tpu_torch kernels against their paddle_tpu originals on the CPU.

Same numpy inputs through the JAX function (its Pallas kernel in interpret
mode where it has one) and the port's wrapper, which on CPU tensors runs
its plain PyTorch version.  fp32 throughout; tolerances are stated per test.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels import rms_norm as jrms
from paddle_tpu.kernels import rope as jrope
from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.kernels import adamw as tadamw
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.kernels import rope as trope
from paddle_tpu_torch.kernels.ssd_scan import ssd_scan

# fp32 against fp32 with sums taken in another order by XLA and torch
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# (a) rms_norm --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 256), (2, 3, 128)])
def test_rms_norm_matches_pallas_interpret_and_reference(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    ref = jrms._rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-6)
    pallas = jrms._rms_norm_fwd_kernel_call(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                            interpret=True)
    out = trms.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np(out), np.asarray(pallas), **TOL)


def test_rms_norm_bf16_keeps_fp32_statistics():
    rng = np.random.RandomState(1)
    x = rng.randn(8, 256).astype(np.float32)
    w = rng.randn(256).astype(np.float32)
    ref = jrms._rms_norm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-6)
    out = trms.rms_norm(_t(x).to(torch.bfloat16), _t(w), 1e-6)
    assert out.dtype == torch.bfloat16
    # same fp32 expression, one final rounding to bf16: at most one bf16 ulp
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-6)


# the launcher's choice of kernel over (rows, D): the row kernel where the
# row is at most 32 groups of 32 16-byte vectors (16 KB) and the rows fill
# the card, with its groups rounded up to a power of two (at least 4, the
# vectors a lane; a row takes nv / 4 warps)
@pytest.mark.parametrize("rows,d,dtype,want", [
    (0, 4096, torch.bfloat16, ("cta", 0)),
    (8, 4096, torch.bfloat16, ("cta", 0)),              # a decode step
    (256, 4096, torch.bfloat16, ("cta", 0)),            # a prefill of 2 x 128 or 1 x 256
    (383, 4096, torch.bfloat16, ("cta", 0)),
    (384, 4096, torch.bfloat16, ("rows", 16)),
    (512, 4096, torch.bfloat16, ("rows", 16)),          # the Engine's prefill forwards
    (2048, 4096, torch.bfloat16, ("rows", 16)),
    (4096, 4096, torch.bfloat16, ("rows", 16)),
    (6144, 2048, torch.bfloat16, ("rows", 8)),          # a `base` training step
    (4096, 256, torch.bfloat16, ("rows", 4)),
    (4096, 264, torch.bfloat16, ("rows", 4)),           # 33 vectors: two groups
    (4096, 8192, torch.bfloat16, ("rows", 32)),         # 16 KB: the widest a warp takes
    (4096, 8200, torch.bfloat16, ("cta", 0)),
    (4096, 16384, torch.bfloat16, ("cta", 0)),
    (4096, 4096, torch.float32, ("rows", 32)),
    (4096, 4104, torch.float32, ("cta", 0)),
])
def test_rms_norm_plan_over_rows_and_widths(rows, d, dtype, want):
    assert trms.plan(rows, d, dtype) == want
    kind, nv = want
    spec = trms.kernel_spec(rows, d, dtype, torch.float32)
    assert spec.name == {"rows": "rms_norm_rows_kernel", "cta": "rms_norm_kernel"}[kind]
    if kind == "rows":
        vectors = d * dtype.itemsize // 16
        assert 32 * nv >= vectors and (nv == 4 or 16 * nv < vectors)
        assert spec.grid == (rows,) and spec.cuda[-1] == nv
        assert spec.scratch[0].nbytes() == 4 * nv      # the row's group sums
        assert not tlint.lint_kernel_spec(spec).findings


# (b) rope ------------------------------------------------------------------

def test_rope_matches_jax():
    rng = np.random.RandomState(2)
    cos_j, sin_j = jrope.rope_freqs(64, 512, 500000.0)
    cos_t, sin_t = trope.rope_freqs(64, 512, 500000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-6, atol=1e-6)
    q = rng.randn(2, 5, 4, 64).astype(np.float32)
    k = rng.randn(2, 5, 2, 64).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [100, 101, 102, 103, 104]], np.int32)
    for p in (None, pos):
        qj, kj = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j,
                                  None if p is None else jnp.asarray(p))
        qt, kt = trope.apply_rope(_t(q), _t(k), cos_t, sin_t,
                                  None if p is None else _t(p).long())
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)


# (c) dense and paged decode --------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_dense_decode_matches_pallas_interpret(d):
    rng = np.random.RandomState(3)
    B, H, Hk, C = 3, 8, 2, 256
    q = rng.randn(B, 1, H, d).astype(np.float32)
    k = rng.randn(B, C, Hk, d).astype(np.float32)
    v = rng.randn(B, C, Hk, d).astype(np.float32)
    lengths = np.array([1, 130, 256], np.int32)
    sm = 1.0 / np.sqrt(d)
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    fused = jda._pallas_decode_fused(*args, sm, block_k=128, interpret=True)
    per_head = jda._pallas_decode(*args, sm, interpret=True)
    out = tda.masked_multihead_attention(_t(q), _t(k), _t(v), _t(lengths))
    # online softmax (Pallas) against one-shot softmax (port): fp32 reorder
    np.testing.assert_allclose(_np(out), np.asarray(fused), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(out), np.asarray(per_head), rtol=2e-5, atol=2e-5)
    # scalar lengths broadcast like the JAX wrapper's
    out_s = tda.masked_multihead_attention(_t(q), _t(k), _t(v), 130)
    ref_s = jda.masked_multihead_attention(*args[:3], 130)
    np.testing.assert_allclose(_np(out_s), np.asarray(ref_s), **TOL)


def _paged_case(seed, poison, d=64):
    rng = np.random.RandomState(seed)
    B, H, Hk, bs, NB, MAXB = 4, 8, 2, 128, 12, 3
    q = rng.randn(B, 1, H, d).astype(np.float32)
    kp = rng.randn(NB, Hk, bs, d).astype(np.float32)
    vp = rng.randn(NB, Hk, bs, d).astype(np.float32)
    tbl = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.array([300, 129, 1, 0], np.int32)
    if poison:
        # NaN in the trash block and in every stale tail past a live length
        kp[0] = vp[0] = np.nan
        for b, L in enumerate(lengths):
            if L % bs:
                blk = tbl[b, L // bs]
                kp[blk, :, L % bs:] = vp[blk, :, L % bs:] = np.nan
    return q, kp, vp, tbl, lengths


def test_paged_decode_matches_pallas_interpret():
    q, kp, vp, tbl, lengths = _paged_case(4, poison=False)
    sm = 1.0 / np.sqrt(q.shape[-1])
    args = [jnp.asarray(a) for a in (q, kp, vp, tbl, lengths)]
    fused = np.asarray(jda._pallas_paged_decode_fused(*args, sm, interpret=True))
    per_head = np.asarray(jda._pallas_paged_decode(*args, sm, interpret=True))
    out = _np(tda.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tbl, lengths))))
    np.testing.assert_array_equal(out[3], 0.0)       # lengths == 0 -> exact zeros
    np.testing.assert_allclose(out, fused, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, per_head, rtol=2e-5, atol=2e-5)


def test_paged_decode_nan_trash_never_leaks():
    """NaN in the trash block and in stale block tails: the port's output
    equals the JAX gather reference (which zeroes V under the mask) and the
    output on clean pools."""
    sm = 1.0 / 8.0
    clean = _paged_case(4, poison=False)
    dirty = _paged_case(4, poison=True)
    out_dirty = _np(tda.paged_decode_attention(*(_t(a) for a in dirty)))
    out_clean = _np(tda.paged_decode_attention(*(_t(a) for a in clean)))
    assert np.isfinite(out_dirty).all(), "NaN trash leaked into the output"
    np.testing.assert_array_equal(out_dirty[3], 0.0)
    np.testing.assert_allclose(out_dirty, out_clean, **TOL)
    ref = jda._paged_pool_reference(*(jnp.asarray(a) for a in dirty), sm)
    np.testing.assert_allclose(out_dirty, np.asarray(ref), **TOL)


def test_cpu_wrappers_run_plain_versions_without_launching():
    reset_launch_counts()
    q, kp, vp, tbl, lengths = _paged_case(5, poison=False)
    tda.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tbl, lengths)))
    trms.rms_norm(torch.ones(2, 64, requires_grad=True), torch.ones(64)).sum().backward()
    tda.masked_multihead_attention(torch.ones(1, 1, 4, 64), torch.ones(1, 128, 2, 64),
                                   torch.ones(1, 128, 2, 64), 3)
    x = torch.ones(1, 128, 2, 64, requires_grad=True)
    tfa.flash_attention(x, x[:, :, :1], x[:, :, :1], causal=True).sum().backward()
    one = torch.ones(8)
    tadamw.adamw_update(one.clone(), one, one.clone(), one.clone(), 1e-3, 1,
                        beta1=0.9, beta2=0.999, epsilon=1e-8)
    xs = torch.ones(2, 32, 32, requires_grad=True)
    y, s = ssd_scan(xs, torch.ones(2, 32, 16), torch.ones(2, 32, 16), torch.zeros(2, 32),
                    chunk=16)
    (y.sum() + s.sum()).backward()
    from paddle_tpu_torch.kernels import emit

    h = torch.ones(2, 3, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    s_, n_ = emit.make_fused("fuse_add_rms_norm")(h, h, w, epsilon=1e-6)
    out = emit.make_fused("fuse_swiglu_mlp")(n_, torch.ones(64, 32), torch.ones(16, 64),
                                             intermediate_size=16)
    emit.make_fused("fuse_rms_norm_head")(s_ + out, w, torch.ones(64, 8), epsilon=1e-6,
                                          transpose=False).sum().backward()
    assert launch_counts() == {"rms_norm": 0, "rms_norm_bwd": 0, "decode_attention_dense": 0,
                               "decode_attention_paged": 0, "flash_attention_fwd": 0,
                               "flash_attention_bwd": 0, "adamw": 0, "ssd_scan": 0,
                               "flash_attention_fwd_noncausal": 0,
                               "flash_attention_bwd_noncausal": 0,
                               "ssd_scan_bwd": 0, "fuse_swiglu_mlp": 0, "fuse_swiglu_mlp_bwd": 0,
                               "fuse_add_rms_norm": 0, "fuse_add_rms_norm_bwd": 0,
                               "fuse_rms_norm_head": 0, "fuse_rms_norm_head_bwd": 0}


def test_cached_attention_reference_matches_jax():
    rng = np.random.RandomState(6)
    q = rng.randn(2, 5, 4, 64).astype(np.float32)
    kc = rng.randn(2, 128, 2, 64).astype(np.float32)
    vc = rng.randn(2, 128, 2, 64).astype(np.float32)
    ref = jda.cached_attention_reference(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), 7)
    out = tda.cached_attention_reference(_t(q), _t(kc), _t(vc), 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (d) write_paged_* round trips ------------------------------------------------

def test_write_paged_round_trips_match_jax():
    rng = np.random.RandomState(7)
    Hk, D, bs, NB = 2, 64, 128, 8
    kp = rng.randn(NB, Hk, bs, D).astype(np.float32)
    vp = rng.randn(NB, Hk, bs, D).astype(np.float32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    # prefill: 2 blocks into [5, 2]
    blocks = np.array([5, 2], np.int32)
    ks = rng.randn(2 * bs, Hk, D).astype(np.float32)
    vs = rng.randn(2 * bs, Hk, D).astype(np.float32)
    jk, jv = jda.write_paged_prefill(jk, jv, jnp.asarray(blocks), jnp.asarray(ks),
                                     jnp.asarray(vs))
    r = tda.write_paged_prefill(tk, tv, _t(blocks), _t(ks), _t(vs))
    assert r[0] is tk and r[1] is tv                     # updated in place
    # one token per sequence at lengths [200, 0] (0 -> trash block)
    tbl = np.array([[5, 2, 0], [0, 0, 0]], np.int32)
    lengths = np.array([200, 0], np.int32)
    kn = rng.randn(2, 1, Hk, D).astype(np.float32)
    vn = rng.randn(2, 1, Hk, D).astype(np.float32)
    jk, jv = jda.write_paged_token(jk, jv, jnp.asarray(tbl), jnp.asarray(lengths),
                                   jnp.asarray(kn), jnp.asarray(vn))
    tda.write_paged_token(tk, tv, _t(tbl), _t(lengths), _t(kn), _t(vn))
    np.testing.assert_array_equal(tk[2, :, 200 % bs].numpy(), kn[0, 0])
    # a block-aligned chunk of 128 tokens at context 256 (table entry 2 -> trash)
    tbl3 = np.array([[5, 2, 7]], np.int32)
    kc = rng.randn(1, bs, Hk, D).astype(np.float32)
    vc = rng.randn(1, bs, Hk, D).astype(np.float32)
    ctx = np.array([256], np.int32)
    jk, jv = jda.write_paged_chunk(jk, jv, jnp.asarray(tbl3), jnp.asarray(ctx),
                                   jnp.asarray(kc), jnp.asarray(vc))
    tda.write_paged_chunk(tk, tv, _t(tbl3), _t(ctx), _t(kc), _t(vc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# (e) paged_chunk_attention --------------------------------------------------

def test_paged_chunk_attention_matches_jax_under_nan_trash():
    rng = np.random.RandomState(8)
    B, S, H, Hk, D, bs, NB = 2, 128, 4, 2, 64, 128, 8
    q = rng.randn(B, S, H, D).astype(np.float32)
    kp = rng.randn(NB, Hk, bs, D).astype(np.float32)
    vp = rng.randn(NB, Hk, bs, D).astype(np.float32)
    kp[0] = vp[0] = np.nan
    tbl = np.array([[3, 4, 0], [5, 0, 0]], np.int32)
    ctx = np.array([128, 0], np.int32)
    ref = jda.paged_chunk_attention(*(jnp.asarray(a) for a in (q, kp, vp, tbl, ctx)))
    out = tda.paged_chunk_attention(*(_t(a) for a in (q, kp, vp, tbl, ctx)))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (g) the flash kernels' build inputs and specs ------------------------------

def test_wgmma_header_is_generated():
    """csrc/wgmma.cuh is the generator's output (the wgmma wrappers list
    every accumulator register, so they are written out, not hand-kept)."""
    from paddle_tpu_torch.kernels import _build, _wgmma_gen

    assert (_build.CSRC / "wgmma.cuh").read_text() == _wgmma_gen.header()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_specs_walk_every_key_for_rows_that_see_none(dtype):
    """Causal with Sq > Sk: a q-tile holding a row that sees no key walks
    every k-tile (the row is the mean of all of V), and the dK/dV pass
    starts at q-tile 0 for every k-tile; with Sq <= Sk the walk ends at the
    diagonal.  The maps the specs declare are the kernels' walks."""
    B, H, Hk, D = 1, 2, 1, 64
    assert tfa._kv_tiles(0, 128, 64, 200, 77, True) == 2           # every k-tile
    assert tfa._kv_tiles(0, 128, 64, 200, 200, True) == 2          # rows 0..127
    assert tfa._kv_tiles(128, 128, 64, 200, 200, True) == 4
    assert tfa._kv_tiles(0, 64, 64, 77, 200, True) == 3            # diagonal offset 123
    fwd, = tfa.kernel_specs(B, 200, 77, H, Hk, D, True, dtype)
    kmap = fwd.inputs[1].index_map
    first_q = [pt for pt in itertools.product(*map(range, fwd.grid))
               if fwd.inputs[0].index_map(*pt)[1] == 0]
    assert {kmap(*pt)[1] for pt in first_q} == set(range(-(-77 // fwd.inputs[1].block_shape[1])))
    dkdv, _ = tfa.kernel_specs(B, 200, 77, H, Hk, D, True, dtype, backward=True)
    qmap = dkdv.inputs[2].index_map
    assert min(qmap(*pt)[1] for pt in itertools.product(*map(range, dkdv.grid))) == 0
    assert not tlint.lint_kernel_spec(fwd) and not tlint.lint_kernel_spec(dkdv)
