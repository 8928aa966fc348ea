"""paddle_tpu_torch's training slice against paddle_tpu on the CPU.

The same numpy-seeded inputs go through the JAX function (its Pallas kernel
in interpret mode where it has one) and the port, whose wrappers run their
plain PyTorch versions on CPU tensors.  fp32 throughout; each tolerance is
stated where it is used.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.kernels import adamw as jadamw
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import rms_norm as jrms
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import adamw as tadamw
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_opt_state, load_paddle_tpu_params,
                                     to_paddle_tpu_opt_state, to_paddle_tpu_params)
from paddle_tpu_torch.models import presets
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# (a) flash attention: plain forward and autograd against the Pallas kernels

def _jax_flash(q, k, v, do, causal):
    """o, lse [B, H, Sq] and (dq, dk, dv) of the JAX flash attention, its
    Pallas kernels in interpret mode (GQA by repeated kv-heads)."""
    B, Sq, H, D = q.shape
    sm = 1.0 / np.sqrt(D)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                   block_q=128, block_k=128)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))

    def bh(x):      # [B, S, Hx, D] -> [B*H, S, D], kv-heads repeated
        x = jnp.repeat(jnp.asarray(x), H // x.shape[2], axis=2)
        return jnp.swapaxes(x, 1, 2).reshape(B * H, x.shape[1], D)

    _, lse = jfa._flash_fwd_impl(bh(q), bh(k), bh(v), causal, sm, 128, 128, True)
    return np.asarray(o), np.asarray(lse).reshape(B, H, Sq), [np.asarray(g) for g in grads]


def _flash_case(sq, sk, causal, seed):
    rng = np.random.default_rng(seed)
    B, H, Hk, D = 2, 4, 2, 64
    q, do = (rng.standard_normal((B, sq, H, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, sk, Hk, D), dtype=np.float32) for _ in range(2))
    o_j, lse_j, g_j = _jax_flash(q, k, v, do, causal)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o_t = tfa.flash_attention(qt, kt, vt, causal=causal)
    g_t = torch.autograd.grad(o_t, (qt, kt, vt), _t(do))
    _, lse_t = tfa.flash_attention_fwd(qt.detach(), kt.detach(), vt.detach(), causal,
                                       1.0 / np.sqrt(D))
    # fp32 both sides; the Pallas kernels' online softmax over 128-key blocks
    # against one logsumexp, and fp32 sums of 256 products in another order
    np.testing.assert_allclose(o_t.detach().numpy(), o_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=2e-5, atol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        # grads sum 256 rows (dk, dv over the group's 2 heads too)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret_fwd_and_grads(causal):
    _flash_case(256, 256, causal, seed=0)


def test_flash_plain_matches_pallas_causal_shorter_queries():
    _flash_case(128, 256, True, seed=1)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_streamed_variants(monkeypatch, causal):
    monkeypatch.setattr(jfa, "_VMEM_RESIDENT_BYTES", 1)   # _flash_fwd/bwd_stream
    _flash_case(256, 256, causal, seed=2)


@pytest.mark.parametrize("sq,sk", [(200, 77), (130, 64)])
def test_flash_plain_matches_jax_reference_causal_longer_queries(sq, sk):
    """Causal with Sq > Sk: the first Sq - Sk query rows see no key.  JAX's
    flash_attention takes its reference path at these shapes (the one-shot
    softmax of _attention_reference, differentiated by jax.vjp): such a row
    is the mean of all of V and passes no gradient to q or k.  The port's
    plain forward and backward (the kernels' plain versions) must agree."""
    rng = np.random.default_rng(5)
    B, H, Hk, D = 2, 4, 2, 64
    q, do = (rng.standard_normal((B, sq, H, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, sk, Hk, D), dtype=np.float32) for _ in range(2))
    o_j, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal=True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o_t = tfa.flash_attention(qt, kt, vt, causal=True)
    g_t = torch.autograd.grad(o_t, (qt, kt, vt), _t(do))
    blind = sq - sk
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), H // Hk, axis=2)
    # fp32 both sides: one softmax over at most sk keys, sums in another order
    np.testing.assert_allclose(o_t.detach().numpy()[:, :blind], np.broadcast_to(
        mean_v, (B, blind, H, D)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    assert not g_t[0][:, :blind].any()
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        # grads sum up to 200 rows (dk, dv over the group's 2 heads too)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# (b) RMSNorm gradients against jax.grad through the Pallas forward

def test_rms_norm_grads_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 256), dtype=np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    dy = rng.standard_normal((2, 5, 256), dtype=np.float32)

    def f(x, w):
        return jnp.sum(jrms.rms_norm(x, w, 1e-6, interpret=True) * dy)

    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    y = trms.rms_norm(xt, wt, 1e-6)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(dy))
    # the same fp32 expression; dw sums 10 rows
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-5)


# (c) AdamW: the port's reference against the JAX reference and the Pallas kernel

@pytest.mark.parametrize("kw", [dict(weight_decay=0.1, decoupled=True),
                                dict(weight_decay=0.1, decoupled=True, apply_decay=False),
                                dict(weight_decay=0.01, decoupled=False)])
@pytest.mark.parametrize("step", [1, 1000])
def test_adamw_matches_jax_reference_and_pallas_interpret(kw, step):
    rng = np.random.default_rng(4)
    p, g = (rng.standard_normal(3000, dtype=np.float32) for _ in range(2))
    m = 0.1 * rng.standard_normal(3000, dtype=np.float32)
    v = 0.01 * np.abs(rng.standard_normal(3000, dtype=np.float32))
    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, **kw)
    lr = jnp.asarray(3e-4, jnp.float32)
    ref_j = jadamw.adamw_reference(*(jnp.asarray(a) for a in (p, g, m, v)), lr,
                                   jnp.asarray(step, jnp.int32), **hyper)
    ker_j = jadamw.adamw_update(*(jnp.asarray(a) for a in (p, g, m, v)), lr, step,
                                out_dtype="bfloat16", interpret=True, **hyper)
    ref_t = tadamw.adamw_reference(*(_t(a) for a in (p, g, m, v)), 3e-4, step, **hyper)
    pt, mt, vt = _t(p), _t(m), _t(v)
    out = tadamw.adamw_update(pt, _t(g), mt, vt, 3e-4, step, out_dtype=torch.bfloat16,
                              **hyper)
    assert out[0] is pt and out[1] is mt and out[2] is vt     # in place
    for a, b, c, d in zip(ref_t, out[:3], ref_j, ker_j[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())  # the CPU path is the reference
        # fp32 pow of beta ** t and XLA's FMA contraction: a few ulps of the
        # O(1) operands (an element of p near 0 keeps p's absolute error)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a.numpy(), np.asarray(d), rtol=1e-6, atol=1e-7)
    assert out[3].dtype == torch.bfloat16
    np.testing.assert_array_equal(out[3].float().numpy(),
                                  np.asarray(jnp.asarray(out[0].numpy()).astype(jnp.bfloat16),
                                             np.float32))


# (d) the loss

def test_compute_loss_with_ignore_index_matches_jax():
    rng = np.random.default_rng(5)
    logits = 3 * rng.standard_normal((2, 9, 64), dtype=np.float32)
    labels = rng.integers(0, 64, (2, 9)).astype(np.int32)
    labels[0, 3] = labels[1, 8] = labels[1, 1] = -100
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(vocab_size=64))
    ref = np.asarray(jm.compute_loss(paddle.to_tensor(logits), labels)._data)
    tm = LlamaForCausalLM(llama_tiny_config(vocab_size=64), device="cpu")
    lt = _t(logits, True)
    loss = tm.compute_loss(lt, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    (g,) = torch.autograd.grad(loss, lt)
    assert float(g[0, 2].abs().sum()) == 0.0     # predicts the ignored label 3
    assert float(g[0, 8].abs().sum()) == 0.0     # the last position has no label


# (e) TrainStep against paddle_tpu.jit.TrainStep with the JAX fused AdamW

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


def _trainers(accum=1, grad_dtype=None, clip=False):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu")
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.1, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    topt = AdamW(learning_rate=LR, weight_decay=0.1, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0) if clip else None)

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    js = paddle.jit.TrainStep(jm, loss_fn, jopt, accumulate_steps=accum, grad_dtype=grad_dtype)
    ts = TrainStep(tm, loss_fn, topt, accumulate_steps=accum, grad_dtype=grad_dtype)
    return js, ts


def _ids(accum, seed=6):
    shape = (accum, 2, 64) if accum > 1 else (2, 64)
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _check_params(js, ts, steps):
    # AdamW's first steps move each element by about +-lr whatever the
    # gradient's size, so a near-zero gradient whose sign differs by rounding
    # moves it by 2 lr: the bound is 2 lr per step
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(js._params[n]),
                                   rtol=0, atol=2 * LR * steps, err_msg=n)


@pytest.mark.parametrize("accum,grad_dtype,clip", [(1, None, False), (2, None, False),
                                                   (1, None, True), (1, "bfloat16", False)],
                         ids=["plain", "accum2", "clip", "bf16grads"])
def test_train_step_matches_jax_train_step(pallas_interpret, accum, grad_dtype, clip):
    js, ts = _trainers(accum, grad_dtype, clip)
    ids = _ids(accum)
    for step in range(3):
        lj = float(np.asarray(js(paddle.to_tensor(ids))._data))
        lt = float(ts(ids))
        # fp32 forward of the same weights: sums in another order
        np.testing.assert_allclose(lt, lj, rtol=1e-5, err_msg=f"step {step + 1}")
    assert js._step == ts._step == 3
    _check_params(js, ts, 3)


def test_train_step_grads_match_jax():
    """Step-1 gradients of the whole model, against jax.grad of the JAX
    loss on the same weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu")
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    ids = _ids(1)
    from paddle_tpu.jit import _get_state, functional_call

    params, buffers = _get_state(jm)

    def loss_of(params):
        logits = functional_call(jm, params, buffers, jnp.asarray(ids))
        return paddle.jit.unwrap(jm.compute_loss(paddle.jit.wrap(logits), ids))

    gj = jax.grad(loss_of)(params)
    loss = tm.compute_loss(tm(torch.from_numpy(ids)), torch.from_numpy(ids))
    names, ps = zip(*tm.named_parameters())
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        # fp32 sums in another order through two layers
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[n]), rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_opt_state_exchange_resumes_mid_run(pallas_interpret):
    """Two JAX steps, then both trainers start step 3 from the JAX state."""
    js, ts = _trainers()
    ids = _ids(1, seed=7)
    for _ in range(2):
        js(paddle.to_tensor(ids))
    load_paddle_tpu_params(ts.model, {n: np.asarray(a) for n, a in js._params.items()})
    load_paddle_tpu_opt_state(ts, {"step": js._step, "slots": {
        n: {k: np.asarray(a) for k, a in s.items()} for n, s in js._opt_state.items()}})
    back = to_paddle_tpu_opt_state(ts)
    assert back["step"] == 2
    np.testing.assert_array_equal(back["slots"]["lm_head"]["m"],
                                  np.asarray(js._opt_state["lm_head"]["m"]))
    lj = float(np.asarray(js(paddle.to_tensor(ids))._data))
    lt = float(ts(ids))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert ts._step == 3
    for n, s in ts._opt_state.items():
        # one step of fp32 moment updates from equal states and close grads
        np.testing.assert_allclose(s["m"].numpy(), np.asarray(js._opt_state[n]["m"]),
                                   rtol=1e-4, atol=1e-7, err_msg=n)
    _check_params(js, ts, 1)
    assert to_paddle_tpu_params(ts.model).keys() == js._params.keys()


# (f) recompute, presets, schedulers, entry points

def test_recompute_gives_equal_grads():
    ids = torch.from_numpy(_ids(1))
    grads = []
    for rc in (dict(), dict(recompute=True), dict(recompute_layers=1)):
        tm = LlamaForCausalLM(llama_tiny_config(**NARROW, **rc), device="cpu", seed=3)
        loss = tm.compute_loss(tm(ids), ids)
        grads.append(torch.autograd.grad(loss, list(tm.parameters())))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)   # the same ops again


@pytest.mark.parametrize("preset", ["tiny", "small", "base", "longctx"])
def test_presets_match_bench(preset):
    import bench

    for dtype in ("float32", "bfloat16"):
        assert presets.build_config(preset, dtype).__dict__ == \
            bench.build_config(preset, dtype).__dict__
    assert presets.DEFAULTS[preset] == bench.DEFAULTS[preset]
    cfg = presets.build_config(preset, "bfloat16")
    seq = presets.DEFAULTS[preset][1]
    assert presets.model_flops_per_token(cfg, seq) == bench.model_flops_per_token(cfg, seq)


def test_build_pretrain_step_tiny_on_cpu_trains():
    step, ids, model, cfg, (b, s, n) = presets.build_pretrain_step("tiny", "cpu", steps=3)
    assert ids.shape == (4, 128) and ids.dtype == torch.int32 and cfg.dtype == "float32"
    losses = [float(step(ids)) for _ in range(n)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_lr_schedulers_match_jax():
    from paddle_tpu.optimizer import lr as jlr

    pairs = [(CosineAnnealingDecay(0.1, T_max=10, eta_min=0.01),
              jlr.CosineAnnealingDecay(0.1, T_max=10, eta_min=0.01)),
             (LinearWarmup(CosineAnnealingDecay(0.1, 10), 3, 0.0, 0.1),
              jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.1, 10), 3, 0.0, 0.1))]
    for t, j in pairs:
        for _ in range(15):
            assert t() == pytest.approx(j(), rel=1e-12)
            t.step()
            j.step()
    opt = AdamW(learning_rate=pairs[0][0], parameters=[torch.nn.Parameter(torch.ones(2))])
    assert opt.get_lr() == pairs[0][0]()


def test_eager_step_honours_no_weight_decay():
    a = torch.nn.Parameter(torch.ones(4))
    b = torch.nn.Parameter(torch.ones(4))
    b.no_weight_decay = True
    opt = AdamW(learning_rate=0.1, weight_decay=0.5, parameters=[a, b])
    (a.sum() * 0 + b.sum() * 0).backward()       # zero gradients: only decay moves
    opt.step()
    opt.clear_grad()
    assert a.grad is None
    torch.testing.assert_close(a.detach(), torch.full((4,), 0.95))
    torch.testing.assert_close(b.detach(), torch.ones(4))
    sd = opt.state_dict()
    assert sd["step"] == 1 and sorted(sd["slots"][0]) == ["m", "v"]


def test_training_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        presets.build_pretrain_step("tiny")
    step, ids, model, _, _ = presets.build_pretrain_step("tiny", device="cpu")
    assert ids.device.type == "cpu" and model.device.type == "cpu"
    with pytest.raises(NotImplementedError):
        TrainStep(model, lambda m, x: m(x).sum(), step.optimizer, grads_fn=lambda *a: a)
    with pytest.raises(NotImplementedError):
        step.optimizer.shard_update()
