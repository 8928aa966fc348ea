"""paddle_tpu_torch serving.loadgen against paddle_tpu's (CPU).

``make_trace`` is numpy only, so the port's traces must be the JAX
package's array for array; ``run_trace`` over one replica of each package
(the narrow Llama, and the tiny SSD stack on its recurrent path, on the
same weights) must give the same outputs and the same deterministic
accounting (requests completed, prefix-cache hit rate, prefill tokens,
the metrics registry's counters).
The wall-clock metrics (goodput, latency, decode gaps) are checked for
shape only: they time this machine.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import SSDForCausalLM as JSSD
from paddle_tpu.models import llama_tiny_config as j_tiny
from paddle_tpu.models import ssd_tiny_config as j_ssd_tiny
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import loadgen as j_loadgen
from paddle_tpu.serving.router import Router as JRouter
from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_params, ssd_tiny_config)
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import loadgen as t_loadgen
from paddle_tpu_torch.serving.router import Router

NARROW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512)
EXACT = ("submitted", "completed", "hit_rate", "prefill_tokens", "outputs")


def _arrays(trace):
    return [(r.arrival_s, r.prompt_ids.dtype, r.prompt_ids.tolist(), r.max_new_tokens)
            for r in trace]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name, kw", [
    ("shared_prefix", {}),
    ("shared_prefix", dict(n_requests=16, shared_len=1024, tail_len=8, max_new_tokens=32)),
    ("long_prompt", {}),
    ("long_prompt", dict(n_requests=16, long_len=1024, short_len=16, max_new_tokens=32,
                         rate_rps=200.0)),
])
def test_make_trace_equals_jax(name, kw, seed):
    j = j_loadgen.make_trace(name, 32000, seed=seed, **kw)
    t = t_loadgen.make_trace(name, 32000, seed=seed, **kw)
    assert _arrays(t) == _arrays(j)
    assert all(isinstance(r, t_loadgen.TraceRequest) for r in t)


def test_make_trace_unknown_preset_raises():
    for mod in (j_loadgen, t_loadgen):
        with pytest.raises(ValueError, match="unknown trace preset"):
            mod.make_trace("poisson", 512)


def _run(router_cls, engine_cls, model, trace, **engine_kw):
    r = router_cls()
    r.add_replica(engine_cls(model, **engine_kw))
    m = (j_loadgen if router_cls is JRouter else t_loadgen).run_trace(r, trace)
    assert m["goodput_tps"] > 0 and m["wall_s"] > 0
    assert m["p99_ms"] >= m["p50_ms"] >= 0.0
    assert m["decode_gap_p99_ms"] >= m["decode_gap_p50_ms"] >= 0.0
    run = {k: m[k] for k in EXACT}
    # the registry's counters of the run (requests, prefill tokens, hits)
    run["counters"] = {k: v["value"] for k, v in m["metrics"].items()
                       if v["type"] == "counter"}
    assert run["counters"]["serve.requests{replica=0}"] == len(trace)
    return run


def test_run_trace_llama_replica_matches_jax():
    """shared_prefix over one Llama replica with the prefix cache: the
    same outputs, hit rate and prefill tokens in both packages."""
    jp.seed(0)
    jm = JLlama(j_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    trace = t_loadgen.make_trace("shared_prefix", 512, seed=0, n_requests=4, rate_rps=200.0,
                                 shared_len=130, tail_len=8, max_new_tokens=4)
    kw = dict(max_batch=2, num_blocks=16, block_size=128, prefill_buckets=(128,),
              decode_chunk=4)
    j = _run(JRouter, JEngine, jm, trace, **kw)
    t = _run(Router, Engine, tm, trace, device="cpu", **kw)
    assert t == j
    assert t["completed"] == t["submitted"] == 4 and t["hit_rate"] > 0


def test_run_trace_recurrent_replica_matches_jax():
    """long_prompt through a pure RecurrentState replica (tiny SSD): every
    request completes, nothing is ever looked up in a prefix cache, and
    both packages give the same outputs."""
    jp.seed(0)
    jm = JSSD(j_ssd_tiny())
    tm = SSDForCausalLM(ssd_tiny_config(), device="cpu", seed=5)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    trace = t_loadgen.make_trace("long_prompt", tm.config.vocab_size, seed=0, n_requests=6,
                                 rate_rps=200.0, long_len=48, short_len=8, max_new_tokens=4)
    kw = dict(max_batch=4, num_blocks=16, block_size=16, prefill_buckets=(32, 64))
    j = _run(JRouter, JEngine, jm, trace, **kw)
    t = _run(Router, Engine, tm, trace, device="cpu", **kw)
    assert t == j
    assert t["completed"] == t["submitted"] == 6 and t["hit_rate"] == 0.0
