"""paddle_tpu_torch's Mixture-of-Experts against paddle_tpu's (CPU).

Routing (``top_k_gating``) for each gate, expanded to the JAX package's
dense ``[T, E, C]`` combine and dispatch: dispatch equal, combine within
two fp32 ulps (the softmax's ``exp`` differs in the last bit between XLA's
CPU and torch).  ``MoELayer`` outputs, aux loss and gradients against
paddle_tpu's autograd (``jax.vjp``) in fp32 (rtol 1e-5).  The tiny MoE
Llama (4 experts, top-2) on weights carried across by ``models/convert``:
logits (1e-4, as the dense model's), loss with aux, TrainStep, recompute,
and greedy tokens of ``generate`` and the Engine under the switch gate.
The gshard gate's draws come from JAX's own keys: the JAX layers' key is
fixed by patching ``paddle_tpu.incubate.moe.next_key``, and the port's
layers are handed ``jax.random.uniform`` of the same key.
"""

import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.moe as jax_moe
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import GenRequest as JaxRequest
from paddle_tpu_torch import to_dtype
from paddle_tpu_torch.incubate.moe import MoELayer, expand_routing, top_k_gating
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import emit
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_params, to_paddle_tpu_params)
from paddle_tpu_torch.models import presets
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, GenRequest

COMBINE_ATOL = 1.2e-7         # two fp32 ulps of a weight in [0.5, 1)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KEYS = [jax.random.key(100 + i) for i in range(4)]


def _uniforms(key, T):
    return torch.from_numpy(np.array(jax.random.uniform(key, (T,))))


def _capacity(cf, k, T, E):
    return max(int(math.ceil(cf * k * T / E)), 1)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5], ids=["ample", "default", "overflow"])
@pytest.mark.parametrize("gate", ["naive", "switch", "gshard"])
def test_top_k_gating_matches_jax(gate, cf):
    T, E = 64, 8
    k = {"switch": 1, "gshard": 2}.get(gate, 2)
    cap = _capacity(cf, k, T, E)
    logits = np.random.default_rng(1).normal(size=(T, E)).astype(np.float32)
    key = KEYS[0] if gate == "gshard" else None
    jc, jd, ja = jax_moe.top_k_gating(jax.numpy.asarray(logits), 2, cap, gate, key)
    r = top_k_gating(torch.from_numpy(logits), 2, cap, gate,
                     _uniforms(key, T) if key is not None else None)
    combine, dispatch = expand_routing(r)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=0, atol=COMBINE_ATOL)
    np.testing.assert_allclose(float(r.aux_loss), float(ja), rtol=1e-6)
    dropped = int((r.weight > 0).sum() - r.kept.sum())
    if cf != 1.25:              # no drop at capacity T, some at half the load
        assert (dropped > 0) == (cf < 1), dropped
    if gate == "gshard":        # the draws dropped some second experts
        assert int((r.weight[:, 1] == 0).sum()) > 0


def test_top_k_gating_ties_go_to_the_lower_expert():
    logits = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0], [3.0, 0.0, 3.0, 3.0],
                       [0.5, 0.5, 0.5, 0.5]], np.float32)
    r = top_k_gating(torch.from_numpy(logits), 2, 8, "naive")
    assert r.expert.tolist() == [[0, 1], [1, 2], [0, 2], [0, 1]]
    _, jd, _ = jax_moe.top_k_gating(jax.numpy.asarray(logits), 2, 8, "naive")
    np.testing.assert_array_equal(expand_routing(r)[1].numpy(), np.asarray(jd))


def test_capacity_queue_runs_across_slots_in_token_order():
    # every token's first choice is expert 0, its second expert 1: the
    # second-slot arrivals queue behind all of the first slot's
    logits = np.tile(np.array([[4.0, 2.0, 0.0, 0.0]], np.float32), (6, 1))
    logits[4] = [2.0, 4.0, 0.0, 0.0]       # token 4 prefers expert 1
    r = top_k_gating(torch.from_numpy(logits), 2, 3, "naive")
    assert r.position[:, 0].tolist() == [0, 1, 2, 3, 0, 4]
    assert r.position[:, 1].tolist() == [1, 2, 3, 4, 5, 5]
    assert r.kept.tolist() == [[True, True], [True, True], [True, False], [False, False],
                               [True, False], [False, False]]
    _, jd, _ = jax_moe.top_k_gating(jax.numpy.asarray(logits), 2, 3, "naive")
    np.testing.assert_array_equal(expand_routing(r)[1].numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# MoELayer
# ---------------------------------------------------------------------------

def _layer_pair(gate, cf=1.0):
    paddle.seed(0)
    jl = jax_moe.MoELayer(32, 48, 4, top_k=2, capacity_factor=cf, gate=gate)
    tl = MoELayer(32, 48, 4, top_k=2, capacity_factor=cf, gate=gate, device="cpu")
    load_paddle_tpu_params(tl, {n: np.asarray(p._data) for n, p in jl.named_parameters()})
    return jl, tl


@pytest.mark.parametrize("cf", [1.0, 0.5], ids=["cf1", "overflow"])
@pytest.mark.parametrize("gate", ["naive", "switch", "gshard"])
def test_moe_layer_output_aux_and_grads_match_jax(monkeypatch, gate, cf):
    jl, tl = _layer_pair(gate, cf)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    R = rng.normal(size=(2, 16, 32)).astype(np.float32)
    monkeypatch.setattr(jax_moe, "next_key", lambda: KEYS[1])
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout, jaux = jl.forward_with_aux(jx)
    ((jout * paddle.to_tensor(R)).sum() + 0.1 * jaux).backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = tl.forward_with_aux(tx, _uniforms(KEYS[1], 32) if gate == "gshard" else None)
    ((tout * torch.from_numpy(R)).sum() + 0.1 * taux).backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data), **GRAD_TOL)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp[n].grad._data),
                                   err_msg=n, **GRAD_TOL)
    kept = tl.last_routing.kept
    assert bool(kept.all()) is False or cf >= 1.0


def test_dispatch_backward_sums_a_tokens_slots():
    """Each token's gradient is the sum of its kept slot rows' gradients;
    dropped pairs and empty slots add nothing."""
    torch.manual_seed(0)
    x = torch.randn(12, 8, dtype=torch.float64, requires_grad=True)
    r = top_k_gating(torch.randn(12, 4), 2, 3, "naive")
    from paddle_tpu_torch.incubate.moe import dispatch

    out = dispatch(x, r)
    _, dense = expand_routing(r)
    want = torch.einsum("tec,td->ecd", dense.to(torch.float64), x)
    assert torch.equal(out, want)
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, x, g)
    assert torch.allclose(dx, torch.einsum("tec,ecd->td", dense.to(torch.float64), g))


# ---------------------------------------------------------------------------
# the MoE Llama
# ---------------------------------------------------------------------------

def _llama_pair(**over):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(moe_num_experts=4, **over))
    tm = LlamaForCausalLM(llama_tiny_config(moe_num_experts=4, **over), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _fix_gshard_draws(monkeypatch, tm):
    """JAX layer i (in forward order) draws KEYS[i]; the port's layer i is
    handed uniform(KEYS[i])."""
    L = tm.config.num_hidden_layers
    calls = iter(range(10 ** 6))
    monkeypatch.setattr(jax_moe, "next_key", lambda: KEYS[next(calls) % L])
    for i, layer in enumerate(tm.llama.layers):
        monkeypatch.setattr(layer.mlp, "draw_uniforms", lambda T, i=i: _uniforms(KEYS[i], T))


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(1, 512, size=shape).astype(np.int32)


def test_moe_llama_builds_with_the_jax_parameter_layout():
    jm, tm = _llama_pair()
    assert tm.config.moe_gate == "gshard"
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(n for n, _ in jm.named_parameters())
    mlp = "llama.layers.0.mlp."
    assert params[mlp + "gate_weight"].dtype == torch.float32
    assert tuple(params[mlp + "gate_weight"].shape) == (128, 4)
    assert tuple(params[mlp + "w_gate_up"].shape) == (4, 128, 768)
    assert tuple(params[mlp + "w_down"].shape) == (4, 384, 128)
    # experts in config.dtype, not param_dtype; the router stays fp32
    cfg = llama_tiny_config(moe_num_experts=4, dtype="bfloat16", param_dtype="float32")
    p = dict(LlamaForCausalLM(cfg, device="cpu").named_parameters())
    assert p[mlp + "w_gate_up"].dtype == torch.bfloat16
    assert p[mlp + "gate_weight"].dtype == torch.float32
    assert p["llama.layers.0.self_attn.qkv_proj"].dtype == torch.float32


def test_moe_weight_exchange_round_trips():
    jm, tm = _llama_pair()
    jp = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    back = to_paddle_tpu_params(tm)
    for n, v in jp.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)
    tm2 = LlamaForCausalLM(llama_tiny_config(moe_num_experts=4), device="cpu", seed=7)
    load_paddle_tpu_params(tm2, back)
    for (n, a), (_, b) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("gate", ["gshard", "switch", "naive"])
def test_moe_llama_logits_and_loss_with_aux_match_jax(monkeypatch, gate):
    jm, tm = _llama_pair(moe_gate=gate)
    _fix_gshard_draws(monkeypatch, tm)
    ids = _ids((2, 40))
    jl = jm(paddle.to_tensor(ids))
    jloss = float(np.asarray(jm.compute_loss(jl, paddle.to_tensor(ids))._data))
    jaux = float(np.asarray(jm._moe_aux._data)) if gate != "naive" else 0.0
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids))
        tloss = float(tm.compute_loss(tl, torch.from_numpy(ids)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), **LOGIT_TOL)
    np.testing.assert_allclose(float(tm._moe_aux), jaux, rtol=1e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    if gate != "naive":        # the aux term is in the loss
        assert float(tm._moe_aux) > 0.5


# the port's parameters against JAX's after two AdamW steps at lr 1e-3:
# ~10x the largest gap read on the CPU (3.6e-5 under switch, 3.1e-5 under
# gshard: 16 of the experts' 1.2 M values, whose gradients are small enough
# beside Adam's epsilon that their last-bit differences move the step),
# and below a third of the ~2e-3 that two early Adam steps move every leaf,
# so a leaf left unupdated in either step fails
TRAIN_PARAM_ATOL = 3.5e-4
TRAIN_LR = 1e-3


def _moe_train_pair(monkeypatch, gate):
    """Two AdamW steps of the tiny MoE Llama through each package's
    TrainStep on the same weights, ids and (gshard) draws: the losses a
    step, then the port's parameters, JAX's and the starting ones by
    name."""
    jm, tm = _llama_pair(moe_gate=gate)
    _fix_gshard_draws(monkeypatch, tm)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jopt = paddle.optimizer.AdamW(learning_rate=TRAIN_LR, parameters=jm.parameters())
    topt = AdamW(learning_rate=TRAIN_LR, parameters=tm.parameters())

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    js = paddle.jit.TrainStep(jm, loss_fn, jopt)
    ts = TrainStep(tm, loss_fn, topt)
    ids = _ids((2, 64), seed=6)
    losses = [(float(ts(ids)), float(np.asarray(js(paddle.to_tensor(ids))._data)))
              for _ in range(2)]
    port = {n: p.detach() for n, p in tm.named_parameters()}
    jax_params = {n: torch.from_numpy(np.array(js._params[n])) for n in port}
    return losses, port, jax_params, start


def _check_moe_train(losses, port, jax_params, start):
    for step, (lt, lj) in enumerate(losses):
        np.testing.assert_allclose(lt, lj, rtol=1e-5, err_msg=f"step {step + 1}")
    for n, p in port.items():
        moved = float((jax_params[n] - start[n]).abs().max())
        assert moved > 3 * TRAIN_PARAM_ATOL, (n, moved)      # JAX's steps moved every leaf
        np.testing.assert_allclose(p.numpy(), jax_params[n].numpy(), rtol=0,
                                   atol=TRAIN_PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_train_step_matches_jax(monkeypatch, gate):
    """Both steps' losses (rtol 1e-5) and every parameter after them
    (``TRAIN_PARAM_ATOL``), the fp32 router among them, against JAX."""
    _check_moe_train(*_moe_train_pair(monkeypatch, gate))


def test_moe_train_step_check_rejects_a_skipped_leaf(monkeypatch):
    """The planted fault: the optimizer skips layer 0's router update in
    both steps (the leaf put back after each call).  The check above must
    fail on it: on step 2's loss, and on the router's parameter alone (the
    other leaves' step 2 moves off JAX's too, through the gradients)."""
    import paddle_tpu_torch.optimizer.optimizer as opt_mod

    wrapper = opt_mod.adamw_update_leaves
    router = {}

    def skip_router(p32, *a, **kw):
        before = [p.clone() for p in p32]
        out = wrapper(p32, *a, **kw)
        i = router.setdefault("index", next(i for i, p in enumerate(p32)
                                            if tuple(p.shape) == (128, 4)))
        p32[i].copy_(before[i])
        return out

    monkeypatch.setattr(opt_mod, "adamw_update_leaves", skip_router)
    losses, port, jax_params, start = _moe_train_pair(monkeypatch, "switch")
    assert torch.equal(port["llama.layers.0.mlp.gate_weight"],
                       start["llama.layers.0.mlp.gate_weight"])
    with pytest.raises(AssertionError, match="step 2"):
        _check_moe_train(losses, port, jax_params, start)
    r = "llama.layers.0.mlp.gate_weight"
    with pytest.raises(AssertionError, match=r):
        _check_moe_train([], {r: port[r]}, jax_params, start)


def test_moe_recompute_gives_equal_grads_under_gshard():
    """The gshard draws are taken outside the checkpoint: a recomputed layer
    routes as its forward did, so the gradients are the same bits."""
    ids = torch.from_numpy(_ids((2, 64), seed=2))
    grads, routes = [], []
    for rc in (dict(), dict(recompute=True), dict(recompute_layers=1)):
        tm = LlamaForCausalLM(llama_tiny_config(moe_num_experts=4, moe_capacity_factor=0.75,
                                                **rc), device="cpu", seed=3)
        loss = tm.compute_loss(tm(ids), ids)
        grads.append(torch.autograd.grad(loss, list(tm.parameters())))
        routes.append([layer.mlp.last_routing.kept.clone() for layer in tm.llama.layers])
    assert not bool(routes[0][0].all())          # capacity and the draws dropped some
    for other, r in zip(grads[1:], routes[1:]):
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(routes[0], r):
            assert torch.equal(a, b)


def test_moe_takes_no_fusion_site_even_when_activated():
    calls = []

    def spy(name):
        def site(*a, **kw):
            calls.append(name)
            raise AssertionError(f"{name} taken by a MoE model")
        return site

    ids = torch.from_numpy(_ids((2, 32), seed=4))
    tm = LlamaForCausalLM(llama_tiny_config(moe_num_experts=4, moe_gate="switch"),
                          device="cpu", seed=5)
    want = tm.compute_loss(tm(ids), ids)
    with emit.activate({n: spy(n) for n in emit.SITES}):
        got = tm.compute_loss(tm(ids), ids)
    assert calls == [] and torch.equal(got, want)


# ---------------------------------------------------------------------------
# serving (switch gate: the JAX Engine freezes its gshard draw at trace time)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def switch_pair():
    return _llama_pair(moe_gate="switch")


def test_moe_generate_greedy_tokens_match_jax(switch_pair):
    jm, tm = switch_pair
    ids = _ids((2, 24), seed=3)
    ref = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=10)._data)
    out = tm.generate(ids, max_new_tokens=10)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tm._moe_aux is None               # the cache paths keep no aux


def test_moe_engine_tokens_match_jax_engine(switch_pair):
    """Four slots, three requests: the idle slot's row is routed with the
    others, as in the JAX Engine, so capacity is shared the same way."""
    jm, tm = switch_pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 512, size=(n,)).astype(np.int32) for n in (17, 60, 33)]
    kw = dict(max_batch=4, num_blocks=16, block_size=128, prefill_buckets=(128,),
              decode_chunk=4)
    outs = []
    for eng_cls, req_cls, model, extra in ((JaxEngine, JaxRequest, jm, {}),
                                           (Engine, GenRequest, tm, dict(device="cpu"))):
        eng = eng_cls(model, **kw, **extra)
        reqs = [req_cls(prompt_ids=p, max_new_tokens=8) for p in prompts]
        for r in reqs:
            eng.add_request(r)
        done = {o.request_id: o.output_ids for o in eng.run_to_completion()}
        outs.append([done[r.request_id] for r in reqs])
    assert outs[1] == outs[0]
    # the last forward was a decode step over every slot, the idle one too
    assert tm.llama.layers[0].mlp.last_routing.expert.shape[0] == 4


# ---------------------------------------------------------------------------
# the moe preset
# ---------------------------------------------------------------------------

def test_moe_preset_matches_bench(monkeypatch):
    import bench
    import paddle_tpu.models as jax_models

    seen = {}

    class Stub:
        def __init__(self, cfg):
            seen["cfg"] = cfg

        def parameters(self):
            return []

    monkeypatch.setattr(jax_models, "LlamaForCausalLM", Stub)
    monkeypatch.setattr(paddle.optimizer, "AdamW", lambda **kw: seen.setdefault("opt", kw))
    monkeypatch.setattr(paddle.jit, "TrainStep", lambda *a, **kw: None)
    for on_card in (True, False):
        _, ids, _, cfg, shape = bench.build_moe_step(on_card)
        assert presets.moe_config(on_card).__dict__ == cfg.__dict__
        assert presets.MOE_DEFAULTS["cuda" if on_card else "cpu"] == shape
    assert seen["opt"]["learning_rate"] == 3e-4 and "weight_decay" not in seen["opt"]


def test_moe_flops_count_the_routed_work():
    cfg = presets.moe_config(True)
    dense = presets.model_flops_per_token(
        llama_tiny_config(**{k: v for k, v in cfg.__dict__.items()
                             if not k.startswith("moe_")}), 2048)
    routed = presets.model_flops_per_token(cfg, 2048)
    per_layer_expert = 1024 * 2 * 1408 + 1408 * 1024
    # top-2 experts instead of one dense FFN, plus the router
    assert routed - dense == 6.0 * 12 * (per_layer_expert + 1024 * 8)
    switch = presets.model_flops_per_token(type(cfg)(**{**cfg.__dict__, "moe_gate": "switch"}),
                                           2048)
    assert routed - switch == 6.0 * 12 * per_layer_expert


def test_build_moe_step_on_cpu_trains():
    step, ids, model, cfg, (b, s, n) = presets.build_moe_step("cpu", steps=3)
    assert ids.shape == (2, 128) and cfg.moe_num_experts == 4 and cfg.dtype == "float32"
    losses = [float(step(ids)) for _ in range(n)]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert step.optimizer._weight_decay == 0.01


def test_adamw_takes_a_mixed_dtype_step_in_one_call(monkeypatch):
    """A bf16 MoE model's router is fp32: its gradient is fp32 beside bf16
    ones.  The step still makes one call of the kernel's wrapper (one launch
    on the card), each gradient in its own dtype (no widened copy), and
    gives the bits of a call a dtype."""
    import paddle_tpu_torch.optimizer.optimizer as opt_mod

    calls = []
    wrapper = opt_mod.adamw_update_leaves
    monkeypatch.setattr(opt_mod, "adamw_update_leaves",
                        lambda *a, **kw: calls.append([g.dtype for g in a[1]]) or wrapper(*a, **kw))
    gen = torch.Generator().manual_seed(0)
    start = [torch.randn(40, generator=gen).to(torch.bfloat16), torch.randn(7, generator=gen)]
    grads = [torch.randn(40, generator=gen).to(torch.bfloat16), torch.randn(7, generator=gen)]
    together = [torch.nn.Parameter(t.clone()) for t in start]
    apart = [torch.nn.Parameter(t.clone()) for t in start]
    opts = [AdamW(learning_rate=1e-2, parameters=together)]
    opts += [AdamW(learning_rate=1e-2, parameters=[p]) for p in apart]
    for _ in range(2):
        for p, g in zip(together + apart, grads + grads):
            p.grad = g.clone()
        for o in opts:
            o.step()
    # a step: the mixed optimizer's one call, then one a dtype apart
    assert calls == [[torch.bfloat16, torch.float32], [torch.bfloat16], [torch.float32]] * 2
    for a, b in zip(together, apart):
        assert torch.equal(a, b)
    for sa, sb in zip(opts[0]._state, [opts[1]._state[0], opts[2]._state[0]]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def _moe_leaves(c):
    """An MoE Llama's (leaf size, gradient dtype) in its parameters' order,
    from its config: the experts in ``dtype``, the router fp32, the rest in
    the parameter dtype."""
    pd, dt, f32 = (to_dtype(c.pdtype), to_dtype(c.dtype), torch.float32)
    d, E, f = c.hidden_size, c.moe_num_experts, c.intermediate_size
    qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * c.head_dim
    layer = [(d, pd), (d * qkv, pd), (c.num_attention_heads * c.head_dim * d, pd), (d, pd),
             (d * E, f32), (E * d * 2 * f, dt), (E * f * d, dt)]
    return ([(d * c.vocab_size, pd), (c.vocab_size * d, pd)] + layer * c.num_hidden_layers
            + [(d, pd)])


def test_adamw_moe_table_is_the_moe_models_leaves():
    """``adamw.MOE_TABLE`` / ``MOE_GRAD_DTYPES`` (chip_smoke's AdamW case
    at `moe`) are the `moe` preset's leaves and gradient dtypes: the rule
    held to a bf16 tiny MoE model's parameters, then applied to the
    preset's config."""
    from paddle_tpu_torch.kernels import adamw

    tiny = llama_tiny_config(moe_num_experts=4, dtype="bfloat16")
    model = LlamaForCausalLM(tiny, device="cpu")
    assert [(p.numel(), p.dtype) for p in model.parameters()] == _moe_leaves(tiny)
    assert list(zip(adamw.MOE_TABLE, adamw.MOE_GRAD_DTYPES)) == _moe_leaves(
        presets.moe_config(True))


def test_moe_and_incubate_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    from paddle_tpu_torch.incubate.nn import FusedFeedForward

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: MoELayer(8, 16, 4), presets.build_moe_step,
                  lambda: FusedFeedForward(8, 16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert MoELayer(8, 16, 4, device="cpu").gate_weight.device.type == "cpu"


def test_layer_aux_loss_attribute_trains_the_router_as_in_jax():
    """tests/test_moe.py's pattern: ``loss + 0.01 * layer.aux_loss`` after a
    plain forward gives the router a gradient, in both packages alike."""
    jl, tl = _layer_pair("switch", cf=4.0)
    x = np.random.default_rng(3).normal(size=(2, 8, 32)).astype(np.float32)
    jout = jl(paddle.to_tensor(x))
    ((jout ** 2).mean() + 0.01 * jl.aux_loss).backward()
    tout = tl(torch.from_numpy(x))
    ((tout ** 2).mean() + 0.01 * tl.aux_loss).backward()
    np.testing.assert_allclose(tl.gate_weight.grad.numpy(),
                               np.asarray(jl.gate_weight.grad._data), **GRAD_TOL)
    assert float(tl.gate_weight.grad.abs().sum()) > 0
