"""paddle_tpu_torch's fusion sites (``kernels/emit.py``) against paddle_tpu's
on the CPU.

The JAX side is built from ``emit.make_fused(name, interpret=True)`` (its
emitted Pallas kernels in interpret mode) with kernel admission off, its
default: never through ``verified_activation`` or ``plan_transform``,
whose registry admission cannot trace the emitted kernels on jax 0.9.0.
The same numpy-seeded inputs go through both; the port runs its plain
versions on CPU tensors.  fp32 throughout; each tolerance is stated where it
is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.kernels import emit as jemit
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import SSDForCausalLM as JaxSSD
from paddle_tpu.models import llama_tiny_config as jax_tiny
from paddle_tpu.models import ssd_tiny_hybrid_config as jax_hybrid
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import emit
from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_params, ssd_tiny_hybrid_config,
                                     to_paddle_tpu_opt_state)
from paddle_tpu_torch.models.llama import LlamaDecoderLayer, mlp_fn
from paddle_tpu_torch.optimizer import AdamW

# (site, static) cases: every site at its example shapes, the head untied
# and tied (the embedding [vocab, hidden] read transposed)
CASES = [("fuse_swiglu_mlp", {}), ("fuse_add_rms_norm", {}),
         ("fuse_rms_norm_head", {"transpose": False}),
         ("fuse_rms_norm_head", {"transpose": True})]
CASE_IDS = ["swiglu", "add_rms_norm", "head", "head_tied"]


def _jax_table():
    return {n: jemit.make_fused(n, interpret=True) for n in jemit.SITES}


def _case(name, static, seed=0):
    site = emit.SITES[name]
    static = {**site.example_static, **static}
    shapes = [s for s, _ in site.example_shapes]
    if static.get("transpose"):
        shapes[2] = shapes[2][::-1]
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes], static


def _close(a, b, rel, what=""):
    """|a - b| within ``rel`` of b's largest |value|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(float(np.abs(b).max()), 1e-30),
                               err_msg=what)


def _tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


# (a) each site, forward and backward, against the JAX emitted kernels

@pytest.mark.parametrize("name,static", CASES, ids=CASE_IDS)
def test_site_forward_matches_jax_fused_and_reference(name, static):
    arrays, static = _case(name, static)
    got = _tuple(emit.make_fused(name)(*(torch.from_numpy(a) for a in arrays), **static))
    jf = _tuple(jemit.make_fused(name, interpret=True)(*(jnp.asarray(a) for a in arrays),
                                                      **static))
    jr = _tuple(jemit.SITES[name].ref(*(jnp.asarray(a) for a in arrays), **static))
    assert len(got) == len(jf) == len(jr)
    for g, f, r in zip(got, jf, jr):
        # fp32 products of up to 768 terms summed in another order than XLA's
        _close(g.detach().numpy(), np.asarray(f), 1e-5, f"{name} vs JAX fused")
        _close(g.detach().numpy(), np.asarray(r), 1e-5, f"{name} vs JAX reference")


@pytest.mark.parametrize("name,static", CASES, ids=CASE_IDS)
def test_site_backward_matches_jax_vjp_of_fused(name, static):
    arrays, static = _case(name, static)
    jfused = jemit.make_fused(name, interpret=True)
    outs, vjp = jax.vjp(lambda *a: jfused(*a, **static), *(jnp.asarray(a) for a in arrays))
    rng = np.random.default_rng(1)
    cts = [(0.1 * rng.standard_normal(o.shape)).astype(np.float32) for o in _tuple(outs)]
    want = vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1 else jnp.asarray(cts[0]))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = _tuple(emit.make_fused(name)(*ts, **static))
    grads = torch.autograd.grad(got, ts, [torch.from_numpy(c) for c in cts])
    for i, (g, w) in enumerate(zip(grads, want)):
        # fp32: the weight gradients sum 64 rows, dx sums up to 768 terms
        _close(g.numpy(), np.asarray(w), 1e-5, f"{name} grad {i}")


@pytest.mark.parametrize("name,static", CASES, ids=CASE_IDS)
def test_kernel_composition_matches_reference_on_cpu(name, static):
    """The launches each site makes on the card, here composed of their plain
    versions (operand order, transposes, the prologue's side): forward
    against the reference, backward against its autograd."""
    arrays, static = _case(name, static, seed=2)
    site = emit.SITES[name]
    ts = tuple(torch.from_numpy(a) for a in arrays)
    for g, w in zip(_tuple(emit._FORWARD[name](*ts, **static)), _tuple(site.ref(*ts, **static))):
        _close(g.numpy(), w.numpy(), 1e-6, f"{name} forward")
    cts = [0.1 * torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
           for o in _tuple(site.ref(*ts, **static))]
    want = emit._vjp_reference(site, ts, cts, static)
    for i, (g, w) in enumerate(zip(emit._BACKWARD[name](ts, cts, **static), want)):
        # fp32 products of the same terms grouped otherwise
        _close(g.numpy(), w.numpy(), 1e-6, f"{name} grad {i}")
    assert all(fn.launches == 0 for fn in (*emit._FORWARD.values(), *emit._BACKWARD.values()))


def test_site_catalogue_matches_jax():
    assert list(emit.SITES) == list(jemit.SITES)
    cands = [{"pattern": "elementwise-chain", "op_hints": ["silu"]},
             {"pattern": "cast-epilogue", "source": "rms_norm.py"},
             {"pattern": "norm-prologue", "source": "rms_norm.py"},
             {"pattern": "norm-prologue", "op_hints": ["lm_head"]},
             {"source": "llama.py", "op_hints": ["silu"]},
             {"pattern": "elementwise-chain", "source": "rms_norm.py"}]
    for name, site in emit.SITES.items():
        ref = jemit.SITES[name]
        for attr in ("pattern", "n_row_args", "match_sources", "match_hints",
                     "example_static", "example_shapes"):
            assert getattr(site, attr) == getattr(ref, attr), (name, attr)
        assert [site.matches(c) for c in cands] == [ref.matches(c) for c in cands], name


def test_verify_site_and_verified_activation_on_cpu():
    for name in emit.SITES:
        assert emit.verify_site(name, "cpu") == []
    table = emit.verified_activation("cpu")
    assert sorted(table) == sorted(emit.SITES)
    made_for_card = emit.make_fused("fuse_add_rms_norm", "cuda")
    with pytest.raises(ValueError, match="made for cuda"):
        made_for_card(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8), epsilon=1e-6)


def test_verified_activation_warns_about_a_site_it_leaves_out(monkeypatch):
    finding = {"code": "fuse-verify-mismatch", "where": "fuse_swiglu_mlp[forward output 0]"}
    real = emit.verify_site
    monkeypatch.setattr(emit, "verify_site",
                        lambda name, dev: [finding] if name == "fuse_swiglu_mlp" else real(name, dev))
    with pytest.warns(RuntimeWarning, match="fuse_swiglu_mlp failed verification.*"
                                            "fuse-verify-mismatch"):
        table = emit.verified_activation("cpu")
    assert sorted(table) == ["fuse_add_rms_norm", "fuse_rms_norm_head"]


# (b) the activation scope and the model seams

def test_activate_restores_the_table_also_after_an_exception():
    outer = {"fuse_swiglu_mlp": emit.make_fused("fuse_swiglu_mlp")}
    with emit.activate(outer):
        with pytest.raises(RuntimeError):
            with emit.activate({"fuse_add_rms_norm": emit.make_fused("fuse_add_rms_norm")}):
                assert emit.active("fuse_add_rms_norm") is not None
                raise RuntimeError("leave the scope")
        assert emit.active("fuse_add_rms_norm") is None
        assert emit.active("fuse_swiglu_mlp") is outer["fuse_swiglu_mlp"]
    assert all(emit.active(n) is None for n in emit.SITES)


def _grads(fn, inputs):
    ps = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ps)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    return out.detach(), torch.autograd.grad(torch.sum(out * w), ps)


def test_mlp_and_decoder_layer_seams_equal_the_stock_path():
    g = torch.Generator().manual_seed(5)
    h = 0.1 * torch.randn(2, 8, 128, generator=g)
    wgu, wd = 0.1 * torch.randn(128, 768, generator=g), 0.1 * torch.randn(384, 128, generator=g)
    table = emit.verified_activation("cpu")
    stock = _grads(lambda *a: mlp_fn(*a, 384), (h, wgu, wd))
    with emit.activate(table):
        fused = _grads(lambda *a: mlp_fn(*a, 384), (h, wgu, wd))
    # the same ops in the same order on the CPU: the forward to the bit
    torch.testing.assert_close(fused[0], stock[0], rtol=0, atol=0)
    for a, b in zip(fused[1], stock[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

    layer = LlamaDecoderLayer(llama_tiny_config(), "cpu", torch.Generator().manual_seed(6))
    from paddle_tpu_torch.kernels import rope
    cos, sin = rope.rope_freqs(32, 256, 10000.0, device="cpu")
    ln_w = layer.post_attention_layernorm.weight
    x = torch.randn(2, 8, 128, generator=g)

    def run(xx):
        return layer(xx, cos, sin)

    stock = _grads(run, (x,))
    sg = torch.autograd.grad(torch.sum(run(x.clone().requires_grad_())), ln_w)[0]
    with emit.activate(table):
        fused = _grads(run, (x,))
        fg = torch.autograd.grad(torch.sum(run(x.clone().requires_grad_())), ln_w)[0]
    torch.testing.assert_close(fused[0], stock[0], rtol=0, atol=0)
    # the stock norm's closed-form backward against autograd of the
    # reference: fp32 rounding of the same sums
    torch.testing.assert_close(fused[1][0], stock[1][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fg, sg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_causal_lm_head_seam_equals_the_stock_path(tie):
    model = LlamaForCausalLM(llama_tiny_config(tie_word_embeddings=tie), device="cpu", seed=7)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (2, 24)))
    calls = []
    head = emit.make_fused("fuse_rms_norm_head")

    def counted(*a, **kw):
        calls.append(kw["transpose"])
        return head(*a, **kw)

    stock = model(ids)
    sg = torch.autograd.grad(model.compute_loss(stock, ids), list(model.parameters()))
    with emit.activate({"fuse_rms_norm_head": counted}):
        fused = model(ids)
        fgr = torch.autograd.grad(model.compute_loss(fused, ids), list(model.parameters()))
        with torch.no_grad():
            model.generate(ids[:1, :5], max_new_tokens=2)   # a cache: the stock head
    assert calls == [tie]
    torch.testing.assert_close(fused, stock, rtol=0, atol=0)
    for a, b in zip(fgr, sg):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# (c) training and the hybrid SSD stack under activation, against JAX

NARROW = dict(vocab_size=512, hidden_size=128, intermediate_size=384, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
LR = 1e-3


@pytest.fixture
def pallas_interpret():
    flags.set_flags({"pallas_interpret": True})
    try:
        yield
    finally:
        flags.set_flags({"pallas_interpret": False})


def _counting(table, calls):
    def wrap(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    return {n: wrap(n, fn) for n, fn in table.items()}


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_fused_train_step_matches_jax_fused_train_step(pallas_interpret, tie):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW, tie_word_embeddings=tie))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW, tie_word_embeddings=tie), device="cpu")
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    js = paddle.jit.TrainStep(jm, loss_fn, paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.1, parameters=jm.parameters()))
    ts = TrainStep(tm, loss_fn, AdamW(learning_rate=LR, weight_decay=0.1,
                                      parameters=tm.parameters()))
    ids = np.random.default_rng(6).integers(0, 512, (2, 64)).astype(np.int32)
    calls = {}
    with jemit.activate(_jax_table()), emit.activate(_counting(emit.verified_activation("cpu"),
                                                               calls)):
        for step in range(3):
            lj = float(np.asarray(js(paddle.to_tensor(ids))._data))
            lt = float(ts(ids))
            # as tests/test_torch_train.py: fp32 forward of the same weights
            np.testing.assert_allclose(lt, lj, rtol=1e-5, err_msg=f"step {step + 1}")
    # every seam took its site: two layers, one head a forward
    assert calls == {"fuse_swiglu_mlp": 6, "fuse_add_rms_norm": 6, "fuse_rms_norm_head": 3}
    for n, p in tm.named_parameters():
        # as tests/test_torch_train.py: AdamW moves an element by about +-lr
        # a step whatever the gradient's size, so 2 lr a step
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(js._params[n]), rtol=0,
                                   atol=2 * LR * 3, err_msg=n)
    slots = to_paddle_tpu_opt_state(ts)["slots"]
    for n, s in slots.items():
        for k in ("m", "v"):
            ref = np.asarray(js._opt_state[n][k])
            # three steps of fp32 moments from gradients of parameters
            # already that far apart: within 1e-3 of the slot's largest
            # |value| (chip_smoke.py's PARITY_SLOT_TOL)
            _close(s[k], ref, 1e-3, f"slot {k} of {n}")


def test_hybrid_ssd_under_activation_matches_jax_and_keeps_its_head():
    paddle.seed(1)
    jm = JaxSSD(jax_hybrid())
    tm = SSDForCausalLM(ssd_tiny_hybrid_config(), device="cpu", seed=5)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    ids = np.random.default_rng(8).integers(1, 512, (2, 48)).astype(np.int32)
    calls = {}
    table = _counting(emit.verified_activation("cpu"), calls)

    def refuse(*a, **kw):
        raise AssertionError("the SSD family keeps its stock head")

    table["fuse_rms_norm_head"] = refuse
    from paddle_tpu.jit import _get_state, functional_call

    params, buffers = _get_state(jm)

    def loss_of(params):
        logits = functional_call(jm, params, buffers, jnp.asarray(ids))
        return paddle.jit.unwrap(jm.compute_loss(paddle.jit.wrap(logits), ids)), logits

    with jemit.activate(_jax_table()):
        (loss_j, logits_j), gj = jax.value_and_grad(loss_of, has_aux=True)(params)
    with emit.activate(table):
        t = torch.from_numpy(ids)
        logits_t = tm(t)
        loss_t = tm.compute_loss(logits_t, t)
        names, ps = zip(*tm.named_parameters())
        gt = torch.autograd.grad(loss_t, ps)
    n_attn = ssd_tiny_hybrid_config().types.count("attention")
    assert n_attn > 0 and calls == {"fuse_swiglu_mlp": n_attn, "fuse_add_rms_norm": n_attn}
    # as tests/test_torch_ssd.py: fp32 through a scan and the layers
    _close(logits_t.detach().numpy(), np.asarray(logits_j), 1e-5, "logits")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    for n, g in zip(names, gt):
        _close(g.numpy(), np.asarray(gj[n]), 1e-5, n)


# ---------------------------------------------------------------------------
# chip_smoke.py's check of the add + RMSNorm backward, on the CPU
# ---------------------------------------------------------------------------

def _exact_add_norm_dx(args, cts, eps):
    """d_s + g with the norm's gradient g taken in fp64 from the same bf16
    operands and the sum rounded to bf16 once: the exactly computed
    gradient a kernel may return."""
    x, h, w = args
    s = (x + h).double().requires_grad_()
    w64 = w.double()
    normed = s * torch.rsqrt(s.square().mean(-1, keepdim=True) + eps) * w64
    (g,) = torch.autograd.grad(normed, s, cts[1].double())
    return (cts[0].double() + g).to(x.dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_norm_backward_check_counts_the_rounded_norm_gradient(seed):
    """At `base` widths (1024 rows of 2048, bf16): the old elementwise limit
    rejects the exactly computed, once-rounded dx, which sits a bf16 ulp of
    the norm gradient from the plain version's (it rounds that gradient
    before the residual add); the limit with that ulp added accepts it.
    The planted faults, a new one in this very output among them, are all
    still rejected (chip_smoke's own check raises otherwise)."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(seed)
    args, st = cs._site_args(gen, "fuse_add_rms_norm", 1024, torch.bfloat16, device="cpu")
    cts = tuple(torch.randn(a.shape, generator=gen).to(a.dtype) for a in args[:2])
    want = emit._vjp_reference(emit.SITES["fuse_add_rms_norm"], args, cts, st)[0]
    exact = _exact_add_norm_dx(args, cts, st["epsilon"])
    slack = cs.fuse_add_norm_slack(args, cts, st)
    assert cs._fuse_rejects(exact, want, False)
    assert not cs._fuse_rejects(exact, want, False, slack)
    faults = cs._fuse_planted_faults(torch.Generator().manual_seed(seed), M=64, device="cpu")
    assert len(faults) == 4 and not any(f["elementwise_check_passes"] and f["tile_norm_err"]
                                        <= cs.FUSE_TILE_RTOL for f in faults.values())
