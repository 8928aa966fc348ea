"""Load generator for the serving tier: arrival-process traces with
latency/goodput metrics, not just steady-state tok/s (port of
``paddle_tpu/serving/loadgen.py``: numpy only, so a trace is the JAX
package's, array for array, for the same arguments).

Two trace presets mirror the traffic shapes the serving features target:

- ``shared_prefix`` — N requests share a long system-prompt prefix and
  differ only in a short tail (few-shot / RAG traffic).  With prefix
  caching the shared blocks prefill once; the preset's ``goodput_tps``
  ratio cache-on vs cache-off is the headline win.
- ``long_prompt`` — a decode-heavy base load with long prompts arriving
  mid-stream.  Without chunked prefill each long prompt stalls every
  decoding request for a whole monolithic prefill; ``decode_gap_p99_ms``
  (the p99 wall-time gap between rounds that produced decode tokens)
  exposes exactly that stall.

``run_trace`` drives a :class:`~paddle_tpu_torch.serving.router.Router` (single
replica is fine) with wall-clock arrival pacing and reports per-request
latency percentiles, goodput, decode-gap percentiles, and the engines'
prefix-cache hit rate.  Outputs are returned too, so bit-identity between
configurations is checkable in the same run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import GenRequest
from ..obs import registry, reset_metrics
from .router import Router

__all__ = ["TraceRequest", "make_trace", "run_trace"]


@dataclass
class TraceRequest:
    arrival_s: float
    prompt_ids: np.ndarray
    max_new_tokens: int


def make_trace(name: str, vocab_size: int, seed: int = 0,
               n_requests: int = 8, rate_rps: float = 50.0,
               shared_len: int = 96, tail_len: int = 8,
               long_len: int = 192, short_len: int = 16,
               max_new_tokens: int = 8) -> List[TraceRequest]:
    """Build a deterministic arrival trace.  Inter-arrivals are exponential
    (Poisson process) at ``rate_rps``; prompts are seeded-random tokens.

    - ``shared_prefix``: every request = shared ``shared_len`` prefix +
      a distinct ``tail_len`` tail.
    - ``long_prompt``: alternating short decode-heavy prompts and
      ``long_len`` prompts (the stall inducers), short ones first so
      decode is in flight when the long prompts land.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs: List[TraceRequest] = []
    if name == "shared_prefix":
        shared = rng.integers(1, vocab_size, size=shared_len).astype(np.int32)
        for _ in range(n_requests):
            tail = rng.integers(1, vocab_size, size=tail_len).astype(np.int32)
            reqs.append(TraceRequest(t, np.concatenate([shared, tail]),
                                     max_new_tokens))
            t += float(rng.exponential(1.0 / rate_rps))
        return reqs
    if name == "long_prompt":
        for i in range(n_requests):
            if i % 2 == 0:
                p = rng.integers(1, vocab_size, size=short_len).astype(np.int32)
                mn = max_new_tokens * 4       # decode-heavy base load
            else:
                p = rng.integers(1, vocab_size, size=long_len).astype(np.int32)
                mn = max_new_tokens
            reqs.append(TraceRequest(t, p, mn))
            t += float(rng.exponential(1.0 / rate_rps))
        return reqs
    raise ValueError(f"unknown trace preset {name!r} "
                     f"(expected shared_prefix|long_prompt)")


def run_trace(router: Router, trace: List[TraceRequest],
              temperature: float = 0.0) -> Dict[str, object]:
    """Replay ``trace`` against ``router`` with wall-clock arrival pacing
    and collect latency/goodput metrics.

    A round's wall time is attributed to decode when it advanced any
    replica's decode-call counter — ``decode_gap_*`` percentiles are over
    those rounds' durations, i.e. the time between consecutive decode-token
    deliveries that a long prefill can stretch.

    The ``"metrics"`` key is the obs-registry snapshot for the run (queue
    depth / batch occupancy gauges, decode-gap and TTFT histograms,
    per-replica counters) — the structured replacement for the ad-hoc
    stat keys, which stay for compatibility."""
    reset_metrics()                # isolate this run's registry families
    pending = sorted(trace, key=lambda r: r.arrival_s)
    arrivals: Dict[str, float] = {}
    done: Dict[str, tuple] = {}
    decode_gaps: List[float] = []
    submitted = 0
    i = 0
    t0 = time.perf_counter()
    while i < len(pending) or router.has_work():
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].arrival_s <= now:
            rid = router.submit(GenRequest(
                prompt_ids=pending[i].prompt_ids,
                max_new_tokens=pending[i].max_new_tokens,
                temperature=temperature))
            arrivals[rid] = max(now, pending[i].arrival_s)
            submitted += 1
            i += 1
        if not router.has_work():
            if i < len(pending):       # idle until the next arrival
                time.sleep(min(pending[i].arrival_s - now, 0.01))
                continue
            break
        dc0 = _decode_calls(router)
        r0 = time.perf_counter()
        outs = router.step()
        r1 = time.perf_counter()
        if _decode_calls(router) > dc0:
            decode_gaps.append(r1 - r0)
        for o in outs:
            done[o.request_id] = (o, r1 - t0)
    wall = time.perf_counter() - t0
    lat = [t_done - arrivals[rid] for rid, (_, t_done) in done.items()]
    out_tokens = sum(len(o.output_ids) for o, _ in done.values())
    lookups = sum(e.stats["prefix_lookup_blocks"]
                  for e in router._replicas.values())
    hits = sum(e.stats["prefix_hit_blocks"]
               for e in router._replicas.values())
    prefill_tokens = sum(e.stats["prefill_tokens"]
                         for e in router._replicas.values())
    return {
        "submitted": submitted,
        "completed": len(done),
        "wall_s": wall,
        "goodput_tps": out_tokens / max(wall, 1e-9),
        "p50_ms": 1e3 * float(np.percentile(lat, 50)) if lat else 0.0,
        "p99_ms": 1e3 * float(np.percentile(lat, 99)) if lat else 0.0,
        "decode_gap_p50_ms": (1e3 * float(np.percentile(decode_gaps, 50))
                              if decode_gaps else 0.0),
        "decode_gap_p99_ms": (1e3 * float(np.percentile(decode_gaps, 99))
                              if decode_gaps else 0.0),
        "hit_rate": hits / max(lookups, 1),
        "prefill_tokens": prefill_tokens,
        "outputs": {rid: list(o.output_ids) for rid, (o, _) in done.items()},
        "metrics": registry().snapshot(),
    }


def _decode_calls(router: Router) -> int:
    return sum(e.stats["decode_calls"] for e in router._replicas.values())
