"""Multi-replica serving front end: shared admission over data-parallel
:class:`~paddle_tpu_torch.serving.Engine` replicas (port of
``paddle_tpu/serving/router.py``; the same routing, failover and stats).

- **Prefix-affinity routing, not round-robin.**  A request is scored
  against every replica by (a) how many of its prompt's chain-hashed
  prefix blocks already live in that replica's prefix cache (the longest
  consecutive hit, ``PagedKV.lookup_chain`` over ``prefix_block_hashes``:
  the engine's own hashing, so the prediction is the hit the engine will
  take; a replica whose cache backend has no block chain -- a
  ``RecurrentState`` or hybrid stack -- scores 0), (b) the replica's HBM
  headroom (``memory_plan()`` slack under its budget plus the backend's
  claimable bytes), and (c) queue load as the tiebreak.
- **Elastic join/leave; cache state is disposable.**  ``add_replica`` can
  join mid-serve (parked requests drain onto it); ``remove_replica``
  (scale-down or a chaos kill) re-routes the dead replica's in-flight
  requests onto survivors from their ORIGINAL specs -- they re-prefill and
  complete exactly once.  The ``_done`` ledger is the exactly-once
  guarantee: a returned output is never returned again.
- **Deterministic chaos.**  ``step()`` consults the fault-injection
  framework (``FLAGS_ft_inject_serve_kill_round`` /
  ``FLAGS_ft_inject_serve_kill_replica``), so a replica kill lands on an
  exact serving round, reproducibly.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import Engine, GenRequest, RequestOutput, prefix_block_hashes
from .. import obs
from ..obs import dump_flight, flight_event

__all__ = ["Router"]


@dataclass
class _Tracked:
    """Router-side record of one submitted request: the immutable spec
    (everything needed to re-prefill from scratch after a replica dies)
    plus where it currently lives."""
    rid: str
    prompt_ids: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    eos_token_id: Optional[int]
    replica: Optional[int] = None          # None = parked (no replica)
    arrival: float = 0.0

    def to_request(self) -> GenRequest:
        return GenRequest(
            prompt_ids=np.asarray(self.prompt_ids, np.int32),
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            eos_token_id=self.eos_token_id, request_id=self.rid)


class Router:
    """Shared admission/routing layer over elastic engine replicas.

    ::

        r = Router()
        r.add_replica(Engine(model, device="cuda"))
        r.add_replica(Engine(model, device="cuda"))
        r.submit(GenRequest(prompt_ids, max_new_tokens=64))
        while r.has_work():
            for out in r.step():
                ...
    """

    def __init__(self, store=None, job_id: str = "default"):
        self._replicas: Dict[int, Engine] = {}
        self._next_replica = 0
        self._tracked: Dict[str, _Tracked] = {}
        self._done: Dict[str, RequestOutput] = {}
        self._parked: "collections.deque[str]" = collections.deque()
        self._rid_counter = 0
        self.rounds = 0
        self.stats = {"routed": 0, "rerouted": 0, "kills": 0, "joins": 0,
                      "parked_peak": 0}
        # optional control-plane store (TCPStore surface — plain, warm-
        # standby or replicated): the router publishes its replica
        # membership there so external schedulers/monitors see joins and
        # kills; all writes are short-bounded so a degraded store slows
        # membership visibility, never serving
        self._store = store
        self._job = job_id

    def _publish_membership(self) -> None:
        if self._store is None:
            return
        doc = json.dumps({"replicas": sorted(self._replicas),
                          "round": self.rounds,
                          "stats": dict(self.stats)})
        try:
            self._store.set(f"serve/{self._job}/replicas", doc, timeout=2.0)
        except (OSError, RuntimeError, TimeoutError) as e:
            print(f"[router] membership publish skipped: {e}",
                  file=sys.stderr)

    # -- replica lifecycle --------------------------------------------------

    def add_replica(self, engine: Engine, replica_id: Optional[int] = None) -> int:
        """Join a replica (mid-serve is fine); parked requests drain onto
        it immediately."""
        if replica_id is None:
            replica_id = self._next_replica
        self._next_replica = max(self._next_replica, replica_id) + 1
        self._replicas[replica_id] = engine
        try:
            engine.obs_replica = replica_id    # label its registry families
        except AttributeError:
            pass    # duck-typed stubs (bare object()) take no attributes
        self.stats["joins"] += 1
        flight_event("serve.join", replica=replica_id)
        self._drain_parked()
        self._publish_membership()
        return replica_id

    def remove_replica(self, replica_id: int, requeue: bool = True) -> List[str]:
        """Leave/kill a replica.  Its in-flight requests (submitted but not
        completed) re-route onto survivors from their original specs and
        re-prefill there — nothing is lost, nothing completes twice.
        Returns the re-routed request ids."""
        self._replicas.pop(replica_id, None)
        harvested = [t for t in self._tracked.values()
                     if t.replica == replica_id and t.rid not in self._done]
        for t in harvested:
            t.replica = None
        if requeue:
            # preserve submission order for determinism
            tr = obs.tracer()
            for t in sorted(harvested, key=lambda t: t.arrival):
                self._place(t)
                self.stats["rerouted"] += 1
                flight_event("serve.reroute", rid=t.rid,
                             from_replica=replica_id, to_replica=t.replica)
                if tr is not None:
                    tr.lifecycle_mark(t.rid, "rerouted",
                                      args={"from": replica_id,
                                            "to": t.replica})
        self._publish_membership()
        return [t.rid for t in harvested]

    @property
    def replica_ids(self) -> List[int]:
        return sorted(self._replicas)

    # -- admission ----------------------------------------------------------

    def submit(self, req: GenRequest) -> str:
        """Accept a request and route it to the best replica (or park it
        until one joins).  The router owns request ids: engines see fresh
        ``GenRequest`` clones, so an engine-side requeue/merge never
        corrupts the spec needed for failover re-prefill."""
        if req.request_id is None:
            self._rid_counter += 1
            req.request_id = f"rtr-{self._rid_counter}"
        t = _Tracked(
            rid=req.request_id,
            prompt_ids=np.asarray(req.prompt_ids, np.int32).copy(),
            max_new_tokens=req.max_new_tokens, temperature=req.temperature,
            top_k=req.top_k, top_p=req.top_p, eos_token_id=req.eos_token_id,
            arrival=time.perf_counter())
        self._tracked[t.rid] = t
        tr = obs.tracer()
        if tr is not None:
            # the router opens the chain; engine add_request's begin dedups
            tr.lifecycle_begin(t.rid)
            tr.lifecycle_mark(t.rid, "submitted")
        self._place(t)
        return t.rid

    def _place(self, t: _Tracked):
        rid = self._route(t)
        if rid is None:
            t.replica = None
            self._parked.append(t.rid)
            self.stats["parked_peak"] = max(self.stats["parked_peak"],
                                            len(self._parked))
            return
        t.replica = rid
        self._replicas[rid].add_request(t.to_request())
        self.stats["routed"] += 1

    def _drain_parked(self):
        parked, self._parked = self._parked, collections.deque()
        for rid in parked:
            if rid not in self._done:
                self._place(self._tracked[rid])

    def _route(self, t: _Tracked) -> Optional[int]:
        """Best replica by (prefix-affinity, HBM headroom, -load)."""
        if not self._replicas:
            return None
        best, best_score = None, None
        for rid in sorted(self._replicas):
            eng = self._replicas[rid]
            score = (self._affinity(eng, t.prompt_ids),
                     self.replica_headroom_bytes(rid),
                     -self._load(eng))
            if best_score is None or score > best_score:
                best, best_score = rid, score
        return best

    @staticmethod
    def _affinity(eng: Engine, prompt_ids) -> int:
        """Blocks of the prompt's cacheable prefix already resident in the
        replica's prefix cache (longest consecutive chain hit).  A replica
        whose cache backend has no block chain to hash (``RecurrentState``
        or a hybrid stack) scores 0 — routing degrades to headroom + load
        for it, instead of assuming paged-KV semantics."""
        backend = getattr(eng, "backend", None)
        if backend is not None and not backend.supports_prefix_cache:
            return 0
        if not eng.prefix_cache:
            return 0
        return eng._pages.lookup_chain(
            prefix_block_hashes(prompt_ids, eng.block_size))

    @staticmethod
    def _load(eng: Engine) -> int:
        return (len(eng._waiting)
                + sum(1 for s in eng._slots if s.req is not None))

    def replica_headroom_bytes(self, replica_id: int) -> int:
        """Admission headroom: static ``memory_plan()`` slack under the
        replica's HBM budget (0 when unbudgeted) plus the cache backend's
        claimable bytes — allocatable KV blocks (free pool + reclaimable
        ref-0 cache) for paged replicas, free state slots for recurrent
        ones, the sum for hybrids."""
        eng = self._replicas[replica_id]
        plan = eng.memory_plan()
        static = 0
        if eng.hbm_budget_bytes is not None:
            static = max(eng.hbm_budget_bytes - plan["total_bytes"], 0)
        return static + eng.backend.headroom_bytes()

    # -- serving loop -------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self._parked) or any(e.has_work()
                                         for e in self._replicas.values())

    def step(self) -> List[RequestOutput]:
        """One routing round: apply any due chaos kill, step every replica
        that has work, and return newly completed outputs (each request id
        exactly once, ever)."""
        self.rounds += 1
        self._maybe_inject_kill()
        if self._parked and self._replicas:
            self._drain_parked()
        outs: List[RequestOutput] = []
        for rid in list(self._replicas):
            eng = self._replicas.get(rid)
            if eng is None or not eng.has_work():
                continue
            for o in eng.step():
                if o.request_id in self._done:
                    continue               # exactly-once: never re-emit
                self._done[o.request_id] = o
                outs.append(o)
        return outs

    def run_to_completion(self) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        guard = 0
        while self.has_work():
            if not self._replicas:
                raise RuntimeError(
                    f"{len(self._parked)} request(s) parked with no replicas "
                    f"left; add_replica() to resume")
            outs.extend(self.step())
            guard += 1
            if guard > 100000:
                raise RuntimeError("router made no progress")
        return outs

    def _maybe_inject_kill(self):
        """Deterministic replica kill via the shared fault-injection flags
        (``FLAGS_ft_inject_serve_kill_round`` selects the round,
        ``FLAGS_ft_inject_serve_kill_replica`` the victim)."""
        from ..distributed.fault_tolerance.injection import get_injector

        inj = get_injector()
        if inj is None:
            return
        victim = inj.serve_kill_due(self.rounds, sorted(self._replicas))
        if victim is not None:
            flight_event("serve.kill", replica=victim, round=self.rounds)
            rerouted = self.remove_replica(victim)
            self.stats["kills"] += 1
            # dump AFTER re-routing so the postmortem holds the kill and
            # the recovery sequence
            dump_flight("serve-kill", victim=f"replica {victim}",
                        round=self.rounds, rerouted=rerouted)
