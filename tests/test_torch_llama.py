"""paddle_tpu_torch Llama against paddle_tpu's on the same weights (CPU).

The narrow configuration: vocab 512, hidden 256, intermediate 512, 2 layers,
4 heads, 2 kv-heads (head_dim 64), 512 positions, fp32.  Weights go from the
JAX model to the port through ``models/convert.py``.  Logits are held to
fp32 ``atol = rtol = 1e-4`` (matmul sums in another order); tokens exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny
from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                     llama_tiny_config, load_paddle_tpu_params,
                                     to_paddle_tpu_params)

NARROW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(1, 512, size=shape).astype(np.int32)


def test_weight_exchange_round_trips_by_jax_names(pair):
    jm, tm = pair
    jax_params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    back = to_paddle_tpu_params(tm)
    assert sorted(back) == sorted(jax_params)
    for n in jax_params:
        np.testing.assert_array_equal(back[n], jax_params[n])
    # rope tables are recomputed buffers, not parameters
    assert "llama.rope_cos" not in back
    with pytest.raises(KeyError):
        load_paddle_tpu_params(tm, {k: v for k, v in jax_params.items() if k != "lm_head"})


def test_full_forward_logits_match(pair):
    jm, tm = pair
    ids = _ids((2, 40))
    ref = np.asarray(jm(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **LOGIT_TOL)


def test_dense_cache_prefill_and_decode_logits_match(pair):
    jm, tm = pair
    ids = _ids((2, 20), seed=1)
    nxt = _ids((2, 1), seed=2)
    jc = jm.init_cache(2, 64)
    jl, jc = jm(paddle.to_tensor(ids), cache=jc)
    jl2, _ = jm(paddle.to_tensor(nxt), cache=jc)
    with torch.no_grad():
        tc = tm.init_cache(2, 64)
        tl, tc = tm(torch.from_numpy(ids), cache=tc)
        tl2, tc = tm(torch.from_numpy(nxt), cache=tc)
    assert tc["offset"] == 21
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), **LOGIT_TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2._data), **LOGIT_TOL)


def test_generate_greedy_tokens_match(pair):
    jm, tm = pair
    ids = _ids((2, 24), seed=3)
    ref = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=12)._data)
    out = tm.generate(ids, max_new_tokens=12)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_eos_pads_like_jax(pair):
    jm, tm = pair
    ids = _ids((1, 16), seed=4)
    greedy = tm.generate(ids, max_new_tokens=10)[0, 16:].tolist()
    eos = greedy[3]
    ref = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                 eos_token_id=eos)._data)
    out = tm.generate(ids, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampling_top_k1_is_greedy_and_top_k_set_holds(pair):
    _, tm = pair
    ids = _ids((2, 24), seed=5)
    greedy = tm.generate(ids, max_new_tokens=8)
    g = torch.Generator().manual_seed(7)
    top1 = tm.generate(ids, max_new_tokens=8, do_sample=True, temperature=0.8,
                       top_k=1, generator=g)
    assert torch.equal(top1, greedy)
    # sampled tokens lie in the top-5 set of their own step's logits
    out = tm.generate(ids, max_new_tokens=6, do_sample=True, top_k=5, generator=g)
    with torch.no_grad():
        logits = tm(out[:, :-1])[:, 23:]
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == out[:, 24:, None].long()).any(-1).all())


def test_unported_options_raise():
    # recompute (tests/test_torch_train.py) and MoE (tests/test_torch_moe.py)
    # are ported; the rest comes later
    for bad in (dict(sequence_parallel=True), dict(context_parallel_axis="sep")):
        with pytest.raises(NotImplementedError):
            LlamaForCausalLM(llama_tiny_config(**bad), device="cpu")


def test_llama3_8b_config_matches_jax():
    from paddle_tpu.models.llama import llama3_8b_config as jax_8b

    assert llama3_8b_config().__dict__ == jax_8b().__dict__
