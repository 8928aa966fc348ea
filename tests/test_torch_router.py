"""paddle_tpu_torch serving.Router against paddle_tpu's Router (CPU).

Each case of ``tests/test_router.py`` (and the router cases of
``test_ssd.py``, ``test_obs.py`` and ``test_store_replicated.py``) runs
through both packages on the same weights (narrow Llama: vocab 512, hidden
256, 2 layers, fp32; the JAX weights carried over by
``models.load_paddle_tpu_params``): the routing decisions (replica id per
request), ``replica_headroom_bytes``, ``stats`` and greedy outputs must be
equal, and the outputs equal to the JAX ``generate``'s.  JAX engines stay
small (one 128 bucket, ``decode_chunk`` 4) to bound compile time.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu import obs as j_obs
from paddle_tpu.distributed.fault_tolerance import injection as j_inj
from paddle_tpu.framework import flags as j_flags
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import SSDForCausalLM as JSSD
from paddle_tpu.models import llama_tiny_config as j_tiny
from paddle_tpu.models import ssd_tiny_config as j_ssd_tiny
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import GenRequest as JRequest
from paddle_tpu.serving.router import Router as JRouter
from paddle_tpu_torch import obs as t_obs
from paddle_tpu_torch.distributed.fault_tolerance import injection as t_inj
from paddle_tpu_torch.framework import flags as t_flags
from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama_tiny_config,
                                     load_paddle_tpu_params, ssd_tiny_config)
from paddle_tpu_torch.serving import Engine, GenRequest
from paddle_tpu_torch.serving.router import Router

NARROW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512)
JAX = SimpleNamespace(name="jax", Engine=JEngine, GenRequest=JRequest, Router=JRouter,
                      inj=j_inj, flags=j_flags, obs=j_obs, kw={})
PORT = SimpleNamespace(name="port", Engine=Engine, GenRequest=GenRequest, Router=Router,
                       inj=t_inj, flags=t_flags, obs=t_obs, kw={"device": "cpu"})


@pytest.fixture(scope="module")
def pair():
    jp.seed(0)
    jm = JLlama(j_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return {"jax": jm, "port": tm}


@pytest.fixture(autouse=True)
def _no_injector():
    """Each package's process-wide injector is installed by the case that
    needs it and never leaks into the next."""
    for side in (JAX, PORT):
        side.inj.set_injector(None)
    yield
    for side in (JAX, PORT):
        side.inj.set_injector(None)


def _engine(side, model, **kw):
    for k, v in dict(max_batch=2, num_blocks=16, block_size=128, prefill_buckets=(128,),
                     decode_chunk=4).items():
        kw.setdefault(k, v)
    return side.Engine(model, **kw, **side.kw)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=(p,)).astype(np.int32) for p in lengths]


def _shared_prefix_prompts(n, prefix_len=130, tail_len=8, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 512, size=prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 512, size=tail_len).astype(np.int32)])
            for _ in range(n)]


def _jax_generate(jm, prompts, max_new):
    return [np.asarray(jm.generate(jp.to_tensor(p[None, :]), max_new_tokens=max_new)._data)
            [0, len(p):].tolist() for p in prompts]


def _both(pair, scenario, **kw):
    j, t = scenario(JAX, pair["jax"], **kw), scenario(PORT, pair["port"], **kw)
    assert t == j
    return t


# -- the cases of tests/test_router.py ---------------------------------------

def _affinity_case(side, model):
    shared = _shared_prefix_prompts(3)
    fresh = _prompts((30,), seed=9)[0]
    r = side.Router()
    r.add_replica(_engine(side, model))
    r.add_replica(_engine(side, model))
    rids = [r.submit(side.GenRequest(prompt_ids=shared[0], max_new_tokens=4))]
    decisions = [r._tracked[rids[0]].replica]
    outs = {o.request_id: o.output_ids for o in r.run_to_completion()}
    for p in (shared[1], fresh):
        rids.append(r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=4)))
        decisions.append(r._tracked[rids[-1]].replica)
    outs.update({o.request_id: o.output_ids for o in r.run_to_completion()})
    return {"decisions": decisions, "outputs": [list(outs[x]) for x in rids],
            "stats": dict(r.stats), "rounds": r.rounds,
            "headroom": [r.replica_headroom_bytes(i) for i in r.replica_ids]}


def test_router_prefix_affinity_beats_load(pair):
    """A request sharing a cached prefix routes to the replica holding it
    despite an idle replica; a fresh one goes by headroom and load."""
    rec = _both(pair, _affinity_case)
    assert rec["decisions"] == [0, 0, 1]


def _headroom_case(side, model):
    r = side.Router()
    a = r.add_replica(_engine(side, model))
    b = r.add_replica(_engine(side, model))
    rec = {"h0": [r.replica_headroom_bytes(a), r.replica_headroom_bytes(b)]}
    rid = r.submit(side.GenRequest(prompt_ids=_prompts((200,), seed=2)[0], max_new_tokens=4))
    rec["replica"] = r._tracked[rid].replica
    r.step()    # blocks are claimed at admission, not at submit
    rec["h1"] = r.replica_headroom_bytes(a)
    rec["prefix_cache_bytes"] = r._replicas[a].memory_plan()["prefix_cache_bytes"]
    r.run_to_completion()
    rec["h2"] = r.replica_headroom_bytes(a)
    rec["stats"] = dict(r.stats)
    return rec


def test_router_headroom_tracks_occupancy(pair):
    rec = _both(pair, _headroom_case)
    assert rec["h0"][0] == rec["h0"][1] and rec["replica"] == 0
    assert rec["h1"] < rec["h0"][0] and rec["prefix_cache_bytes"] > 0


def _parking_case(side, model):
    prompts = _prompts((20, 40), seed=4)
    r = side.Router()
    rids = [r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=5)) for p in prompts]
    parked = [r._tracked[x].replica for x in rids]
    with pytest.raises(RuntimeError, match="parked"):
        r.run_to_completion()
    r.add_replica(_engine(side, model))
    outs = {o.request_id: o.output_ids for o in r.run_to_completion()}
    return {"parked": parked, "stats": dict(r.stats),
            "decisions": [r._tracked[x].replica for x in rids],
            "outputs": [list(outs[x]) for x in rids]}


def test_router_parks_until_replica_joins(pair):
    rec = _both(pair, _parking_case)
    assert rec["parked"] == [None, None] and rec["stats"]["parked_peak"] == 2
    assert rec["outputs"] == _jax_generate(pair["jax"], _prompts((20, 40), seed=4), 5)


def _removal_case(side, model):
    prompts = _prompts((20, 150, 60, 90), seed=6)
    r = side.Router()
    r.add_replica(_engine(side, model))
    r.add_replica(_engine(side, model))
    rids = [r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=8)) for p in prompts]
    decisions = [r._tracked[x].replica for x in rids]
    collected = r.step() + r.step()
    victim = next(r._tracked[x].replica for x in rids if r._tracked[x].replica is not None)
    moved = r.remove_replica(victim)
    while r.has_work():
        collected += r.step()
    return {"decisions": decisions, "victim": victim, "moved": moved,
            "emitted": sorted(o.request_id for o in collected),
            "outputs": [list({o.request_id: o.output_ids for o in collected}[x]) for x in rids],
            "stats": dict(r.stats), "rounds": r.rounds, "rids": rids}


def test_router_remove_replica_reroutes_exactly_once(pair):
    rec = _both(pair, _removal_case)
    assert rec["moved"] and rec["emitted"] == sorted(rec["rids"])
    assert rec["stats"]["rerouted"] == len(rec["moved"])
    assert rec["outputs"] == _jax_generate(pair["jax"], _prompts((20, 150, 60, 90), seed=6), 8)


def _chaos_case(side, model, tmp_path):
    prompts = _shared_prefix_prompts(2) + _prompts((25, 140, 70), seed=8)
    old = side.flags.get_flags(["ft_inject_serve_kill_round", "ft_inject_serve_kill_replica"])
    side.flags.set_flags({"ft_inject_serve_kill_round": 2, "ft_inject_serve_kill_replica": 0})
    side.obs.flight().clear()
    try:
        side.inj.set_injector(side.inj.FaultInjector.from_flags())
        r = side.Router()
        r.add_replica(_engine(side, model, max_batch=3))
        r.add_replica(_engine(side, model, max_batch=3))
        rids = [r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=8)) for p in prompts]
        decisions = [r._tracked[x].replica for x in rids]
        outs = r.run_to_completion()
    finally:
        side.flags.set_flags(old)
        side.inj.set_injector(None)
    path = side.obs.last_flight_dump()
    assert path is not None and path.startswith(str(tmp_path))
    with open(path) as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["events"]]
    return {"decisions": decisions,
            "emitted": sorted(o.request_id for o in outs), "rids": sorted(rids),
            "outputs": [list({o.request_id: o.output_ids for o in outs}[x]) for x in rids],
            "stats": dict(r.stats), "replicas": r.replica_ids,
            "dump": {k: doc[k] for k in ("reason", "victim", "rerouted", "round")},
            "order": [n for n in names if n in ("inject.serve-kill", "serve.kill",
                                                "serve.reroute")],
            "inject_victim": next(e for e in doc["events"]
                                  if e["name"] == "inject.serve-kill")["args"]["victim"]}


def test_chaos_replica_kill_flags_bit_identical(pair, tmp_path, monkeypatch):
    """FLAGS_ft_inject_serve_kill_* kill replica 0 at round 2 in both
    packages: the same re-routes, the outputs of JAX generate, and a flight
    dump naming the victim and the re-routed requests after the
    injection."""
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    rec = _both(pair, _chaos_case, tmp_path=tmp_path)
    prompts = _shared_prefix_prompts(2) + _prompts((25, 140, 70), seed=8)
    assert rec["outputs"] == _jax_generate(pair["jax"], prompts, 8)
    assert rec["stats"]["kills"] == 1 and rec["stats"]["rerouted"] >= 1
    assert rec["replicas"] == [1] and rec["emitted"] == rec["rids"]
    assert rec["dump"]["reason"] == "serve-kill" and rec["dump"]["victim"] == "replica 0"
    assert rec["dump"]["rerouted"] and rec["inject_victim"] == 0
    assert rec["order"][0] == "inject.serve-kill" and "serve.reroute" in rec["order"]


def test_serve_kill_due_is_one_shot():
    def case(side):
        inj = side.inj.FaultInjector(serve_kill_round=3, serve_kill_replica=7)
        inj2 = side.inj.FaultInjector(serve_kill_round=1, serve_kill_replica=9)
        return [inj.active(), inj.serve_kill_due(2, [0, 7]), inj.serve_kill_due(3, [0, 7]),
                inj.serve_kill_due(4, [0, 7]), inj2.serve_kill_due(5, [2, 3]),
                inj2.serve_kill_due(6, [2, 3])]

    assert case(PORT) == case(JAX) == [True, None, 7, None, 2, None]


# -- test_ssd.py: a recurrent replica beside a paged one --------------------

def _mixed_case(side, llama, ssd):
    r = side.Router()
    r.add_replica(_engine(side, llama))
    r.add_replica(_engine(side, ssd, block_size=16, prefill_buckets=(32,)))
    ssd_eng = r._replicas[1]
    prompts = _prompts((12, 9, 15, 11), seed=0)
    rec = {"affinity": side.Router._affinity(ssd_eng, prompts[0]),
           "headroom_is_backend": r.replica_headroom_bytes(1) == ssd_eng.backend.headroom_bytes(),
           "headroom": [r.replica_headroom_bytes(i) for i in r.replica_ids]}
    rids = [r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=4, temperature=0.0))
            for p in prompts]
    rec["decisions"] = [r._tracked[x].replica for x in rids]
    outs = {o.request_id: o.output_ids for o in r.run_to_completion()}
    rec.update(outputs=[list(outs[x]) for x in rids], stats=dict(r.stats),
               ledger_clean=ssd_eng._rstate._live == {})
    return rec


def test_router_degrades_to_headroom_load_for_recurrent(pair):
    """A recurrent replica scores affinity 0 and its headroom is its
    backend's; a Llama + SSD replica set completes every request once, the
    same way in both packages."""
    jp.seed(0)
    jssd = JSSD(j_ssd_tiny())
    tssd = SSDForCausalLM(ssd_tiny_config(), device="cpu", seed=5)
    load_paddle_tpu_params(tssd, {n: np.asarray(p._data) for n, p in jssd.named_parameters()})
    j = _mixed_case(JAX, pair["jax"], jssd)
    t = _mixed_case(PORT, pair["port"], tssd)
    assert t == j
    assert t["affinity"] == 0 and t["headroom_is_backend"] and t["ledger_clean"]
    assert set(t["decisions"]) <= {0, 1}


# -- test_obs.py: the lifecycle chain through a failover ---------------------

def _failover_chain_case(side, model):
    tr = side.obs.enable_tracing()
    side.inj.set_injector(side.inj.FaultInjector(serve_kill_round=2, serve_kill_replica=0))
    try:
        r = side.Router()
        r.add_replica(_engine(side, model))
        r.add_replica(_engine(side, model))
        rids = [r.submit(side.GenRequest(prompt_ids=p, max_new_tokens=6))
                for p in _prompts((30, 50, 25, 40), seed=3)]
        outs = r.run_to_completion()
    finally:
        side.inj.set_injector(None)
        side.obs.disable_tracing()
    evs = tr.events()
    snap = side.obs.registry().snapshot()
    return {"stats": dict(r.stats), "emitted": sorted(o.request_id for o in outs),
            "rids": sorted(rids),
            "chains": {x: [e["ph"] for e in evs if e.get("id") == x and e["ph"] in "be"]
                       for x in rids},
            "rerouted": sorted(e["id"] for e in evs
                               if e["ph"] == "n" and e["name"] == "rerouted"),
            "per_replica": sorted(k for k in snap if k.startswith("serve.requests{replica=")),
            "trace_errors": side.obs.validate_chrome_trace(tr.to_chrome_trace())}


def test_router_failover_chain_exactly_once(pair):
    """One begin (the router's submit) and one end (the survivor's emit) a
    request through the kill; the same re-route marks and per-replica
    registry families in both packages."""
    rec = _both(pair, _failover_chain_case)
    assert rec["stats"]["kills"] == 1 and rec["emitted"] == rec["rids"]
    assert all(c == ["b", "e"] for c in rec["chains"].values())
    assert rec["rerouted"] and rec["per_replica"] and rec["trace_errors"] == []


# -- test_store_replicated.py: membership in a replicated store --------------

def test_router_publishes_membership_to_replicated_store():
    """The port's Router publishes its membership into the port's
    replicated store through a leader's death; the JAX Router, publishing
    into the same store, writes the same document."""
    from paddle_tpu_torch.distributed.store_replicated import ReplicatedStore

    rs = ReplicatedStore(replicas=3, interval=0.05, timeout=30.0)
    try:
        docs = {}
        for side in (PORT, JAX):
            router = side.Router(store=rs, job_id=f"svc-{side.name}")
            router.add_replica(object())
            router.add_replica(object())
            first = json.loads(rs.get(f"serve/svc-{side.name}/replicas"))
            if side is PORT:
                rs.kill_replica(rs.leader_id())    # membership survives a leader death
            router.remove_replica(0, requeue=False)
            docs[side.name] = (first, json.loads(rs.get(f"serve/svc-{side.name}/replicas")))
    finally:
        rs.group.stop()
    first, last = docs["port"]
    assert first["replicas"] == [0, 1] and last["replicas"] == [1]
    assert last["stats"]["joins"] == 2
    assert docs["port"] == docs["jax"]
