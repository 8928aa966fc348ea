"""paddle_tpu_torch's SSD (Mamba-2) family against paddle_tpu on the CPU.

The same numpy-seeded inputs go through the JAX function and the port,
whose ``ssd_scan`` runs its plain version on CPU tensors.  The JAX side runs
with its default flags: on the CPU its models take the jnp reference scan,
never the Pallas call.  fp32 throughout; each tolerance is stated where it
is used.  The port's decode is held to the full forward within fp32
rounding, not bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import ssd_scan as jscan
from paddle_tpu.models import SSDForCausalLM as JaxSSD
from paddle_tpu.models import ssd_tiny_config as jax_tiny
from paddle_tpu.models import ssd_tiny_hybrid_config as jax_hybrid
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import GenRequest as JaxRequest
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import ssd_scan as tscan
from paddle_tpu_torch.models import (SSDForCausalLM, load_paddle_tpu_params,
                                     ssd_tiny_config, ssd_tiny_hybrid_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, GenRequest, HybridCache, RecurrentState


def _operands(G=3, T=32, N=8, P=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, T, P)).astype(np.float32)
    b = rng.standard_normal((G, T, N)).astype(np.float32)
    c = rng.standard_normal((G, T, N)).astype(np.float32)
    la = -np.abs(rng.standard_normal((G, T)).astype(np.float32)) * 0.1
    return x, b, c, la


def _t(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# (a) the scan

@pytest.mark.parametrize("chunk", [8, 16])
def test_plain_scan_matches_jax_reference(chunk):
    ops = _operands()
    y_j, s_j = jscan.ssd_scan_reference(*map(jnp.asarray, ops), chunk=chunk)
    y_t, s_t = tscan.ssd_scan_reference(*_t(ops), chunk)
    # fp32 sums of 8-16 products per chunk, in another order
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)


def test_plain_scan_matches_jax_reference_at_default_widths():
    """SSDConfig()'s widths (P 128, N 64, chunk 64), which the kernel now
    runs as two column blocks, at a small G and T."""
    ops = _operands(G=2, T=128, N=64, P=128, seed=1)
    y_j, s_j = jscan.ssd_scan_reference(*map(jnp.asarray, ops), chunk=64)
    y_t, s_t = tscan.ssd_scan_reference(*_t(ops), 64)
    # fp32 sums of up to 64 + 64 products a term, in another order: y reaches
    # ~126 here, so atol 1e-4 is ~1e-6 of its scale (read 3.8e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-4)
    assert tscan.column_block(128, 64, 64) == 64


def test_plain_scan_matches_recurrence_and_is_chunk_size_invariant():
    ops = _t(_operands())
    y8, s8 = tscan.ssd_scan_reference(*ops, 8)
    y16, s16 = tscan.ssd_scan_reference(*ops, 16)
    y_r, s_r = tscan.ssd_recurrence_reference(*ops)
    # the chunked form against the token-by-token recurrence it is dual to:
    # reassociation only, as test_ssd.py holds the JAX pair
    for a, b in ((y8, y_r), (s8, s_r), (y8, y16), (s8, s16)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)
    y_jr, _ = jscan.ssd_recurrence_reference(*map(jnp.asarray, _operands()))
    np.testing.assert_allclose(y_r.numpy(), np.asarray(y_jr), rtol=2e-5, atol=2e-5)
    # the boundary states the prefill reads: the state after 16 tokens is the
    # recurrence's, whichever chunk size reached it
    y8s, st8 = tscan.ssd_scan_states(*ops, 8)
    _, st16 = tscan.ssd_scan_states(*ops, 16)
    _, s_r16 = tscan.ssd_recurrence_reference(*[t[:, :16] for t in ops])
    assert torch.equal(y8s, y8) and torch.equal(st8[-1], s8) and len(st8) == 5
    assert not st8[0].any()
    for a in (st8[2], st16[1]):
        np.testing.assert_allclose(a.numpy(), s_r16.numpy(), rtol=2e-5, atol=2e-5)


def test_zero_padded_rows_are_exact_noops():
    ops = _operands(T=16)
    pad = [np.concatenate([a, np.zeros((a.shape[0], 16) + a.shape[2:], np.float32)], axis=1)
           for a in ops]
    y0, s0 = tscan.ssd_scan_reference(*_t(ops), 16)
    y1, s1 = tscan.ssd_scan_reference(*_t(pad), 16)
    assert torch.equal(y0, y1[:, :16]) and torch.equal(s0, s1)
    # zero rows inside a chunk too: the last 5 rows of the chunk zeroed
    part = [a.copy() for a in ops]
    for a in part:
        a[:, 11:] = 0
    y2, _ = tscan.ssd_scan_reference(*_t(part), 16)
    y3, _ = tscan.ssd_scan_reference(*_t([np.concatenate([a, np.zeros_like(a)], axis=1)
                                          for a in part]), 16)
    assert torch.equal(y2, y3[:, :16])


def test_scan_gradients_match_jax_grad():
    ops = _operands(G=2, T=16, N=4, P=8)

    def loss_j(*a):
        y, s = jscan.ssd_scan_reference(*a, chunk=8)
        return jnp.sum(y * y) + jnp.sum(s)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, ops))
    args = _t(ops, grad=True)
    y, s = tscan.ssd_scan(*args, chunk=8)
    assert y.grad_fn is not None
    g_t = torch.autograd.grad((y * y).sum() + s.sum(), args)
    for name, a, b in zip(("x", "b", "c", "la"), g_t, g_j):
        assert bool(torch.isfinite(a).all()), name
        # fp32 sums over chunks of 8 rows and the carried state, in another
        # order: gradients reach ~150 here, so the atol scales with the
        # largest |gradient| (an fp32 ulp there is ~1.5e-5)
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(b).max()), err_msg=name)
    with pytest.raises(ValueError, match="not a multiple"):
        tscan.ssd_scan(*_t(_operands(T=20)), chunk=16)


# (b) the model, on weights carried from JAX

def _pair(which):
    jcfg, tcfg = {"ssd": (jax_tiny, ssd_tiny_config),
                  "hybrid": (jax_hybrid, ssd_tiny_hybrid_config)}[which]
    paddle.seed(0 if which == "ssd" else 1)
    jm = JaxSSD(jcfg())
    tm = SSDForCausalLM(tcfg(), device="cpu", seed=5)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module", params=["ssd", "hybrid"])
def pair(request):
    return (request.param, *_pair(request.param))


def _ids(n, batch=1, seed=0):
    return np.random.default_rng(seed).integers(1, 512, size=(batch, n)).astype(np.int32)


def test_logits_and_loss_match_jax(pair):
    _, jm, tm = pair
    ids = _ids(37, batch=2, seed=1)
    lj = np.asarray(jm(paddle.to_tensor(ids))._data)
    lt = tm(torch.from_numpy(ids))
    # fp32 forward of the same weights through a scan and two layers
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=0, atol=1e-5 * np.abs(lj).max())
    loss_j = float(np.asarray(jm.compute_loss(paddle.to_tensor(lj), ids)._data))
    loss_t = float(tm.compute_loss(lt.detach(), torch.from_numpy(ids)))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-6)


LR = 1e-3


def test_train_step_matches_jax_train_step(pair):
    which, _, _ = pair
    jm, tm = _pair(which)       # fresh weights: this test updates them

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    js = paddle.jit.TrainStep(jm, loss_fn, paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.1, parameters=jm.parameters()))
    ts = TrainStep(tm, loss_fn, AdamW(learning_rate=LR, weight_decay=0.1,
                                      parameters=tm.parameters()))
    ids = _ids(48, batch=2, seed=2)
    lj = float(np.asarray(js(paddle.to_tensor(ids))._data))
    lt = float(ts(ids))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)        # sums in another order
    assert js._step == ts._step == 1
    # as tests/test_torch_train.py: AdamW's first step moves each element by
    # about +-lr whatever the gradient's size, so a near-zero gradient whose
    # sign differs by rounding moves it by 2 lr
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(js._params[n]),
                                   rtol=0, atol=2 * LR, err_msg=n)


def test_train_step_grads_match_jax(pair):
    """Step-1 gradients of every parameter (in_proj, dt_bias through the
    softplus, d_skip, out_proj, the norms, embedding, head; the hybrid's
    attention block too), against jax.grad of the JAX loss on the same
    weights."""
    from paddle_tpu.jit import _get_state, functional_call

    _, jm, tm = pair
    ids = _ids(48, batch=2, seed=2)
    params, buffers = _get_state(jm)

    def loss_of(params):
        logits = functional_call(jm, params, buffers, jnp.asarray(ids))
        return paddle.jit.unwrap(jm.compute_loss(paddle.jit.wrap(logits), ids))

    gj = jax.grad(loss_of)(params)
    loss = tm.compute_loss(tm(torch.from_numpy(ids)), torch.from_numpy(ids))
    names, ps = zip(*tm.named_parameters())
    assert set(names) == set(gj)
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        ref = np.asarray(gj[n])
        assert bool(torch.isfinite(g).all()) and np.abs(ref).max() > 0, n
        # fp32 sums in another order through the scan and two layers: within
        # 1e-5 of the leaf's largest |gradient|
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=n)


def test_prefill_then_decode_matches_full_forward(pair):
    which, _, tm = pair
    ids = torch.from_numpy(_ids(37, seed=3))
    with torch.no_grad():
        full = tm(ids)
        cache = tm.init_cache(1, 64)
        logits, cache = tm(ids[:, :13], cache=cache)      # 13: not a chunk multiple
        steps = [logits]
        for t in range(13, 37):
            step, cache = tm(ids[:, t:t + 1], cache=cache)
            steps.append(step)
    got = torch.cat(steps, dim=1)
    # pure SSD: the decode step and the full scan sum in another order (fp32
    # rounding); hybrid: as test_ssd.py holds the JAX hybrid
    tol = dict(rtol=0, atol=1e-5) if which == "ssd" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **tol)


def test_generate_matches_jax(pair):
    _, jm, tm = pair
    # prompts whose greedy paths keep a top-1 gap far above fp32 rounding
    # (a random tiny model can tie: seed 4 at 9 tokens meets a 6e-8 gap)
    for seed, n in ((7, 9), (5, 21)):
        ids = _ids(n, seed=seed)
        out_j = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=10)._data)
        out_t = tm.generate(ids, max_new_tokens=10)
        assert out_t.dtype == torch.int32
        np.testing.assert_array_equal(out_t.numpy(), out_j)


# (c) the Engine's recurrent and hybrid paths

KW = dict(num_blocks=32, block_size=16, max_batch=4, prefill_buckets=(32, 64), decode_chunk=4)


def _engine_run(engine_cls, req_cls, model, prompts, **kw):
    eng = engine_cls(model, **KW, **kw)
    for i, p in enumerate(prompts):
        eng.add_request(req_cls(prompt_ids=p, max_new_tokens=8, temperature=0.0,
                                request_id=f"r{i}"))
    outs = {o.request_id: o.output_ids for o in eng.run_to_completion()}
    return eng, [outs[f"r{i}"] for i in range(len(prompts))]


def test_engine_matches_jax_engine_and_generate(pair):
    which, jm, tm = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 512, size=(n,)).astype(np.int32) for n in (7, 13, 24, 40, 5)]
    j_eng, j_out = _engine_run(JaxEngine, JaxRequest, jm, prompts)
    t_eng, t_out = _engine_run(Engine, GenRequest, tm, prompts, device="cpu")
    assert t_out == j_out
    for p, o in zip(prompts, t_out):
        assert tm.generate(p[None], max_new_tokens=8)[0, len(p):].tolist() == o
    for key in ("prefills", "prefill_tokens", "decode_steps", "generated_tokens"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert not t_eng.prefix_cache and t_eng.backend.kind == j_eng.backend.kind
    assert isinstance(t_eng.backend, RecurrentState if which == "ssd" else HybridCache)
    # both ledgers clean: KV blocks reclaimed and state slots released
    assert t_eng._pages._ref == {} and t_eng._rstate._live == {}
    assert len(t_eng._free) == t_eng._pages.num_blocks - 1
    plan, j_plan = t_eng.memory_plan(), j_eng.memory_plan()
    for key in ("state_bytes", "kv_pool_bytes", "per_seq_cache_bytes"):
        assert plan[key] == j_plan[key], key
    curve = plan["per_seq_cache_bytes"]
    if which == "ssd":
        assert plan["kv_pool_bytes"] == 0 and plan["state_bytes"] > 0
        assert curve[4096] == curve[16384] == curve[65536]        # flat
    else:
        assert curve[65536] > curve[16384] > curve[4096]          # the attention share grows


def test_memory_plan_refuses_oversized_state():
    tm = SSDForCausalLM(ssd_tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="exceeds hbm_budget_bytes"):
        Engine(tm, device="cpu", num_blocks=4, block_size=16, max_batch=4,
               prefill_buckets=(32,), hbm_budget_bytes=100_000)
    wide = Engine(tm, device="cpu", max_batch=64, num_blocks=16, block_size=16,
                  prefill_buckets=(32, 64), hbm_budget_bytes=16 << 20)
    assert wide.backend.free_slots() == 64
    assert wide.memory_plan()["total_bytes"] <= 16 << 20
