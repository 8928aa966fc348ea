"""paddle_tpu_torch serving Engine against paddle_tpu's Engine (CPU).

Both engines serve the same requests over the same weights (narrow config:
vocab 512, hidden 256, intermediate 512, 2 layers, 4 heads, 2 kv-heads,
fp32).  Greedy outputs and the scheduler's integer stats must be equal
exactly: the scheduler is the same host code, and the device math agrees to
fp32 rounding.  JAX engines stay small (one 128 bucket, decode_chunk 4) to
bound compile time.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import GenRequest as JaxRequest
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.serving import Engine, GenRequest, prefix_block_hashes

NARROW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512)
INT_STATS = ("prefills", "prefill_tokens", "prefix_hit_blocks", "prefix_lookup_blocks",
             "evictions", "chunk_prefills", "decode_steps", "generated_tokens")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _prompts(lengths, seed, prefix_len=128):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 512, size=(prefix_len,)).astype(np.int32)
    out = []
    for P in lengths:      # negative: the shared prefix + |P| fresh tokens
        ids = rng.integers(1, 512, size=(abs(P),)).astype(np.int32)
        out.append(np.concatenate([prefix, ids]) if P < 0 else ids)
    return out


def _run(engine_cls, req_cls, model, prompts, max_new, **kw):
    eng = engine_cls(model, **kw)
    reqs = [req_cls(prompt_ids=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.add_request(r)
    outs = {o.request_id: o.output_ids for o in eng.run_to_completion()}
    return [outs[r.request_id] for r in reqs], eng


def _both(pair, prompts, max_new, **kw):
    jm, tm = pair
    j_out, j_eng = _run(JaxEngine, JaxRequest, jm, prompts, max_new, **kw)
    t_out, t_eng = _run(Engine, GenRequest, tm, prompts, max_new, device="cpu", **kw)
    return j_out, j_eng, t_out, t_eng


def _assert_same(j_out, j_eng, t_out, t_eng):
    assert t_out == j_out
    for key in INT_STATS:
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert not t_eng._ref
    assert sorted(list(t_eng._free) + list(t_eng._lru.values())) == \
        list(range(1, t_eng.num_blocks))


def test_engine_matches_jax_engine_with_prefix_hits(pair):
    """Batched prefill over 3 slots, two prompts sharing a cached block."""
    prompts = _prompts((17, 33, 64, 100, -20, -40), seed=0)
    res = _both(pair, prompts, 12, max_batch=3, num_blocks=32, block_size=128,
                prefill_buckets=(128,), decode_chunk=4)
    _assert_same(*res)
    assert res[3].stats["prefix_hit_blocks"] >= 1
    assert res[3].stats["prefills"] == 6
    # the port's Engine agrees with the port's own generate
    _, tm = pair
    for p, o in zip(prompts[:2], res[2]):
        assert tm.generate(p[None], max_new_tokens=12)[0, len(p):].tolist() == o


def test_engine_matches_jax_engine_under_eviction_and_chunked_prefill(pair):
    """Four usable blocks force an eviction; a 200-token prompt prefills in
    128-token chunks."""
    prompts = _prompts((120, 126, 100), seed=3)
    res = _both(pair, prompts, 16, max_batch=3, num_blocks=5, block_size=128,
                prefill_buckets=(128,), decode_chunk=4)
    _assert_same(*res)
    assert res[3].stats["evictions"] >= 1
    prompts = _prompts((200, 20), seed=7)
    res = _both(pair, prompts, 6, max_batch=2, num_blocks=8, block_size=128,
                prefill_buckets=(128,), decode_chunk=4, prefill_chunk=128)
    _assert_same(*res)
    assert res[3].stats["chunk_prefills"] >= 2


def test_engine_nan_trash_block_never_leaks(pair):
    _, tm = pair
    prompts = _prompts((20, 100), seed=5)
    clean, _ = _run(Engine, GenRequest, tm, prompts, 8, device="cpu",
                    max_batch=2, num_blocks=8, prefill_buckets=(128,))
    eng = Engine(tm, device="cpu", max_batch=2, num_blocks=8, prefill_buckets=(128,))
    for kp, vp in zip(eng.k_pools, eng.v_pools):
        kp[0] = float("nan")
        vp[0] = float("nan")
    reqs = [GenRequest(prompt_ids=p, max_new_tokens=8) for p in prompts]
    for r in reqs:
        eng.add_request(r)
    outs = {o.request_id: o.output_ids for o in eng.run_to_completion()}
    assert [outs[r.request_id] for r in reqs] == clean


def test_engine_eos_and_sampling(pair):
    _, tm = pair
    prompts = _prompts((24, 40), seed=9)
    greedy, _ = _run(Engine, GenRequest, tm, prompts, 10, device="cpu",
                     max_batch=2, num_blocks=8, prefill_buckets=(128,))
    eng = Engine(tm, device="cpu", max_batch=2, num_blocks=8, prefill_buckets=(128,))
    eos = greedy[0][3]
    eng.add_request(GenRequest(prompt_ids=prompts[0], max_new_tokens=10,
                               eos_token_id=eos, request_id="e"))
    eng.add_request(GenRequest(prompt_ids=prompts[1], max_new_tokens=10,
                               temperature=0.7, top_k=1, request_id="k1"))
    outs = {o.request_id: o for o in eng.run_to_completion()}
    assert outs["e"].finish_reason == "stop"
    assert outs["e"].output_ids == greedy[0][:greedy[0].index(eos)]
    assert outs["k1"].output_ids == greedy[1]      # top_k=1 sampling is greedy


def test_memory_plan_and_hashes_match_jax(pair):
    from paddle_tpu.serving import prefix_block_hashes as jax_hashes

    jm, tm = pair
    kw = dict(max_batch=4, num_blocks=16, block_size=128, prefill_buckets=(128, 256),
              prefill_chunk=128)
    assert Engine(tm, device="cpu", **kw).memory_plan() == JaxEngine(jm, **kw).memory_plan()
    ids = _prompts((300,), seed=11)[0]
    assert prefix_block_hashes(ids, 128) == jax_hashes(ids, 128)


def test_engine_refuses_recurrent_models(pair):
    """Recurrent and hybrid stacks are no longer refused: as the JAX Engine,
    the port's picks ``RecurrentState`` for a pure ``ssd`` cache spec and
    ``HybridCache`` for a mixed one, with prefix caching and chunked prefill
    forced off, and keeps the attention family on ``PagedKV``."""
    from paddle_tpu.models import SSDForCausalLM as JaxSSD
    from paddle_tpu.models import ssd_tiny_config as jax_ssd_tiny
    from paddle_tpu.models import ssd_tiny_hybrid_config as jax_ssd_hybrid
    from paddle_tpu_torch.models import (SSDForCausalLM, ssd_tiny_config,
                                         ssd_tiny_hybrid_config)
    from paddle_tpu_torch.serving import HybridCache, PagedKV, RecurrentState

    kw = dict(max_batch=2, num_blocks=8, block_size=16, prefill_buckets=(32,),
              prefill_chunk=16)
    for tcfg, jcfg, backend in ((ssd_tiny_config, jax_ssd_tiny, RecurrentState),
                                (ssd_tiny_hybrid_config, jax_ssd_hybrid, HybridCache)):
        eng = Engine(SSDForCausalLM(tcfg(), device="cpu"), device="cpu", **kw)
        j_eng = JaxEngine(JaxSSD(jcfg()), **kw)
        assert isinstance(eng.backend, backend)
        assert type(j_eng.backend).__name__ == backend.__name__
        assert not eng.prefix_cache and eng.prefill_chunk is None
        # one slot-state dict per SSD layer, max_batch rows
        assert len(eng._ssd_state) == eng.cfg.types.count("ssd")
        assert all(st["s"].shape[0] == 2 for st in eng._ssd_state)
    assert isinstance(Engine(pair[1], device="cpu", max_batch=2, num_blocks=8).backend,
                      PagedKV)
