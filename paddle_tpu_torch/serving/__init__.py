"""Continuous-batching LLM serving engine (port of
``paddle_tpu/serving/__init__.py``): the attention family over the paged KV
cache, and the SSD family over constant-size recurrent state.

The host scheduler is the original's, unchanged: admission, same-bucket
batched prefill on a 4/2/1 size ladder, block growth, recompute-style
eviction, the refcounted prefix cache, chunked prefill interleaved with
decode, eos handling and ``memory_plan``.  So are the ownership ledger and
the deferred token readback: every sampled token is written into a device
segment buffer, and tokens are read back only at a sync point (finish of an
eos-using request, an eviction that folds generated tokens into a prompt,
or drain end).  CUDA launches are asynchronous like XLA dispatch, so
``run_to_completion`` without eos reads tokens back once.

What changes with PyTorch: the compiled programs become eager functions on
device tensors — the decode "chunk" is a Python loop of ``k`` sub-steps —
and the pools are updated in place.  Every decode sub-step runs the paged
decode kernel once per layer and the RMSNorm kernel twice per layer plus
once at the end (on CUDA tensors; their plain versions on CPU tensors).

Recurrent (SSD) and hybrid stacks: the model's ``cache_spec`` selects the
backend (``RecurrentState`` for a pure SSD stack, ``HybridCache`` for a
mixed one).  Such an engine keeps one decode-state row per slot for every
SSD layer (``model.init_recurrent_slots``), prefills one request at a time
at its bucket with the padded tail masked (``n_valid``), scatters the
prefill's states into the slot's rows and, for hybrid attention layers, its
K/V into the paged pools, and threads the states through every decode
sub-step beside the pools.  Prefix caching and chunked prefill are off for
them: a pure SSD stack has no block chain to hash, and a hit would restore
only the attention half of a hybrid one.
"""

from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import default_device, make_generator, obs, to_dtype
from ..kernels.decode_attention import write_paged_prefill
from .cache_backend import CacheBackend, HybridCache, PagedKV, RecurrentState, make_backend

__all__ = ["Engine", "GenRequest", "RequestOutput", "prefix_block_hashes",
           "CacheBackend", "HybridCache", "PagedKV", "RecurrentState", "make_backend"]

NEG_INF = -1e30


def prefix_block_hashes(ids, block_size: int) -> List[bytes]:
    """Chain hashes of the FULL blocks of ``ids[:-1]`` — the cacheable
    prefix of a prompt.  Hash ``i`` commits to blocks ``0..i``, so an index
    hit on hash ``i`` means the whole prefix through block ``i`` is
    resident.  The last prompt token is never cached: at least one suffix
    token always prefills, producing the first output's logits."""
    ids = np.ascontiguousarray(np.asarray(ids, np.int32))
    n = max((len(ids) - 1) // block_size, 0)
    out: List[bytes] = []
    h = b""
    for i in range(n):
        h = hashlib.sha1(
            h + ids[i * block_size:(i + 1) * block_size].tobytes()).digest()
        out.append(h)
    return out


@dataclass
class GenRequest:
    """One generation request."""
    prompt_ids: np.ndarray                 # int32 [P]
    max_new_tokens: int = 64
    temperature: float = 0.0               # <= 0 -> greedy
    top_k: int = 0                         # 0 -> no top-k filter
    top_p: float = 1.0                     # 1.0 -> no nucleus filter
    eos_token_id: Optional[int] = None
    request_id: Optional[str] = None
    # eviction bookkeeping (internal): the user-visible prompt, and tokens
    # generated before a preemption folded them into ``prompt_ids``
    orig_prompt_ids: Optional[np.ndarray] = None
    prior_output: List[int] = field(default_factory=list)
    # deferred-sync bookkeeping (internal)
    _out_vals: List[int] = field(default_factory=list)
    _stopped: bool = field(default=False)
    _emitted: bool = field(default=False)
    _prefill_dt: float = field(default=0.0)
    _queued_t: float = field(default=0.0)


@dataclass
class RequestOutput:
    request_id: str
    prompt_ids: np.ndarray
    output_ids: List[int]
    finish_reason: str                     # "stop" | "length"
    prefill_time: float = 0.0
    finish_time: float = 0.0


@dataclass(eq=False)
class _Slot:
    idx: int = 0
    req: Optional[GenRequest] = None
    length: int = 0                        # tokens in cache (prompt + generated)
    blocks: List[int] = field(default_factory=list)
    out_count: int = 0                     # tokens emitted (incl. pending sync)
    admit_seq: int = 0                     # admission order (eviction priority)
    # chunked/suffix prefill: prompt tokens not yet written to the cache
    prefill_left: Optional[np.ndarray] = None
    hashes: List[bytes] = field(default_factory=list)


class Engine:
    """Continuous-batching generation over a paged KV cache.

    ::

        eng = Engine(model, max_batch=8, num_blocks=256)
        eng.add_request(GenRequest(prompt_ids, max_new_tokens=128))
        while eng.has_work():
            for out in eng.step():
                print(out.output_ids)

    ``device`` defaults to ``"cuda"`` and must be the model's device;
    sampling draws from a generator seeded with ``seed``.
    """

    def __init__(self, model, max_batch: int = 8, num_blocks: int = 256,
                 block_size: int = 128,
                 prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024),
                 max_prefill_overhead: float = 1.0, decode_chunk: int = 32,
                 hbm_budget_bytes: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 dispatch_staging: bool = True,
                 device=None, seed: int = 0):
        dev = default_device(device)
        if model.device.type != dev.type or dev.index not in (None, model.device.index):
            raise ValueError(f"model lives on {model.device}, engine asked for {dev}")
        self.device = model.device
        self.model = model
        self.cfg = model.config
        if hasattr(model, "cache_spec"):
            spec = model.cache_spec()
        else:
            from ..models.cache_spec import llama_cache_spec

            spec = llama_cache_spec(model)
        self._spec = spec
        self._recurrent = "ssd" in spec["kinds"]
        self._uses_pages = "attention" in spec["kinds"]
        if self._recurrent:
            # no block chain to hash (pure SSD), or a hit would restore only
            # the attention half (hybrid); chunked prefill rides the
            # block-aligned context offset, which the recurrent prefill
            # does not model
            prefix_cache = False
            prefill_chunk = None
        self.max_batch = max_batch
        self.block_size = block_size
        self.num_blocks = num_blocks
        if prefill_buckets == "auto":
            from ..framework.dim_expr import synthesize_buckets

            prefill_buckets, self.prefill_waste_bound = synthesize_buckets(
                1, block_size * 8, max_overhead=max_prefill_overhead,
                align=block_size)
        else:
            from ..framework.dim_expr import verify_buckets

            self.prefill_waste_bound = verify_buckets(
                prefill_buckets, 1, max(prefill_buckets))
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # longest admissible sequence (prompt + generated) per slot
        self.max_blocks_per_seq = max(
            (b // block_size for b in self.prefill_buckets)) * 2
        self.hbm_budget_bytes = hbm_budget_bytes
        if prefill_chunk is not None:
            # chunks are block-aligned so every chunk starts on a block
            # boundary (write_paged_chunk's precondition)
            prefill_chunk = max(1, -(-int(prefill_chunk) // block_size)) \
                * block_size
        self.prefill_chunk = prefill_chunk
        self.backend = make_backend(spec, num_blocks, block_size, max_batch,
                                    prefix_cache=prefix_cache)
        self.prefix_cache = self.backend.supports_prefix_cache
        # block verbs go to the paged side (a zero-block pool for a pure SSD
        # stack, so the _free/_ref/... surface stays uniform); slot state to
        # the recurrent ledger
        if isinstance(self.backend, PagedKV):
            self._pages, self._rstate = self.backend, None
        elif isinstance(self.backend, HybridCache):
            self._pages, self._rstate = self.backend.pages, self.backend.state
        else:
            self._pages = PagedKV(1, block_size, 0, prefix_cache=False)
            self._rstate = self.backend
        self._slots = [_Slot(idx=i) for i in range(max_batch)]
        self._tbl = np.zeros((max_batch, self.max_blocks_per_seq), np.int32)
        self._waiting: collections.deque = collections.deque()
        self._admit_counter = 0
        self._req_counter = 0
        self._tok_seg_rows = 1024
        self.decode_chunk = max(1, min(int(decode_chunk), self._tok_seg_rows))
        self.generator = make_generator(seed, self.device)
        dev = self.device
        # device-resident last-token vector, threaded chunk -> chunk
        self._last_dev = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        # device-side token segment buffers: every sampled token is written
        # here, so a sync reads back a handful of arrays, not one per call
        self._tok_buf = torch.zeros((self._tok_seg_rows, max_batch),
                                    dtype=torch.int32, device=dev)
        self._tok_row = 0
        self._first_seg = 512
        self._first_buf = torch.zeros(self._first_seg, dtype=torch.int32, device=dev)
        self._first_idx = 0
        if hbm_budget_bytes is not None:
            plan = self.memory_plan()
            if plan["total_bytes"] > hbm_budget_bytes:
                detail = ", ".join(f"{k}={v / 1e6:.1f}MB"
                                   for k, v in plan.items()
                                   if k != "total_bytes"
                                   and isinstance(v, (int, float)))
                raise ValueError(
                    f"serving memory plan {plan['total_bytes'] / 1e6:.1f}MB "
                    f"exceeds hbm_budget_bytes={hbm_budget_bytes / 1e6:.1f}MB"
                    f" ({detail}); reduce num_blocks (kv_pool_bytes scales "
                    f"linearly with it) or max_batch")
        self.k_pools, self.v_pools = model.init_paged_pools(num_blocks, block_size)
        # one decode-state dict per SSD layer, max_batch rows wide: written
        # by each prefill at its slot's row, advanced by every decode step
        self._ssd_state = model.init_recurrent_slots(max_batch) if self._recurrent else ()
        # dispatch staging: device copies of the decode inputs, reused while
        # the scheduler state they snapshot is unchanged (steady-state decode
        # uploads nothing; the lengths vector advances on the device)
        self.dispatch_staging = bool(dispatch_staging)
        self._sched_version = 0
        self._staged = None
        self._last_dispatch_t: Optional[float] = None
        self._decode_gaps: List[float] = []
        self._full_tok_bufs: List[torch.Tensor] = []
        self._full_first_bufs: List[torch.Tensor] = []
        self._pending: List[tuple] = []
        self._finish_order: List[GenRequest] = []
        self._ready: List[RequestOutput] = []
        self.stats = {"decode_steps": 0, "prefills": 0, "evictions": 0,
                      "generated_tokens": 0, "decode_time": 0.0,
                      "prefill_time": 0.0, "prefill_tokens": 0,
                      "decode_calls": 0, "syncs": 0, "sync_time": 0.0,
                      "prefix_lookup_blocks": 0, "prefix_hit_blocks": 0,
                      "prefix_hit_tokens": 0, "chunk_prefills": 0}
        self.obs_replica: Optional[int] = None

    # -- small helpers -----------------------------------------------------

    def _dev(self, arr, dtype=None) -> torch.Tensor:
        """A device COPY of a host value: the scheduler mutates its numpy
        tables while queued work may still read them."""
        return torch.tensor(np.asarray(arr), dtype=dtype, device=self.device)

    # -- observability -------------------------------------------------------

    def _obs_labels(self) -> dict:
        if self.obs_replica is None:
            return {}
        return {"replica": self.obs_replica}

    def _obs_mark(self, req: GenRequest, phase: str, **args) -> None:
        """Phase mark on the request's lifecycle chain (tracing only)."""
        tr = obs.tracer()
        if tr is None or req.request_id is None:
            return
        if self.obs_replica is not None:
            args.setdefault("replica", self.obs_replica)
        tr.lifecycle_begin(req.request_id)
        tr.lifecycle_mark(req.request_id, phase, args=args or None)

    # -- public API ---------------------------------------------------------

    def memory_plan(self) -> Dict[str, int]:
        """Static device-memory sizing of everything the engine keeps
        resident plus the transient workspace of its two program families
        — arithmetic over the config, safe before any allocation."""
        cfg = self.cfg
        itemsize = to_dtype(cfg.dtype).itemsize
        params_b = sum(p.numel() * p.element_size()
                       for p in self.model.parameters())
        buffers_b = sum(b.numel() * b.element_size()
                        for b in self.model.buffers())
        kv_pool_b = self.backend.pool_bytes()
        state_b = self.backend.state_bytes()
        table_b = (self.max_batch * self.max_blocks_per_seq * 4
                   + self._tok_seg_rows * self.max_batch * 4
                   + self._first_seg * 4 + self.max_batch * 4)
        decode_b = self.max_batch * (4 * cfg.hidden_size
                                     + cfg.vocab_size) * itemsize
        Pb = max(self.prefill_buckets)
        n_pf = min(4, self.max_batch)
        prefill_b = n_pf * (2 * Pb * cfg.hidden_size
                            + cfg.num_attention_heads * Pb * Pb
                            + Pb * cfg.vocab_size) * itemsize
        prefix_b = self.num_blocks * 64 if self.prefix_cache else 0
        chunk_b = 0
        if self.prefix_cache or self.prefill_chunk is not None:
            C = self.max_blocks_per_seq * self.block_size
            chunk_b = (2 * Pb * cfg.hidden_size * itemsize
                       + 2 * C * cfg.kv_heads * cfg.head_dim * itemsize
                       + cfg.num_attention_heads * Pb * C * 4
                       + Pb * cfg.vocab_size * itemsize)
        plan = {"params_bytes": params_b, "buffers_bytes": buffers_b,
                "kv_pool_bytes": kv_pool_b, "state_bytes": state_b,
                "table_bytes": table_b,
                "prefix_cache_bytes": prefix_b,
                "decode_workspace_bytes": decode_b,
                "prefill_workspace_bytes": prefill_b,
                "chunk_workspace_bytes": chunk_b}
        plan["total_bytes"] = (params_b + buffers_b + kv_pool_b + state_b
                               + table_b + prefix_b
                               + max(decode_b, prefill_b, chunk_b))
        plan["per_seq_cache_bytes"] = {
            ctx: self.backend.seq_bytes(ctx) for ctx in (4096, 16384, 65536)}
        return plan

    def add_request(self, req: GenRequest) -> str:
        if req.request_id is None:
            self._req_counter += 1
            req.request_id = f"req-{self._req_counter}"
        P = len(req.prompt_ids)
        # block capacity binds only where the cache pages (a pure SSD
        # sequence has no block chain)
        if self._uses_pages and (P + req.max_new_tokens) > \
                self.max_blocks_per_seq * self.block_size:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds the per-slot capacity "
                f"{self.max_blocks_per_seq * self.block_size}")
        if self._uses_pages and self._bucket(P) // self.block_size > self.num_blocks - 1:
            raise ValueError(
                f"prompt needs {self._bucket(P) // self.block_size} "
                f"blocks but the pool only has {self.num_blocks - 1} "
                f"usable; raise num_blocks")
        req._queued_t = time.perf_counter()
        self._obs_mark(req, "queued", prompt_len=P)
        self._waiting.append(req)
        return req.request_id

    def has_work(self) -> bool:
        return bool(self._waiting) or any(s.req is not None for s in self._slots)

    def step(self) -> List[RequestOutput]:
        """Admit + prefill new requests, run one decode chunk, sync, and
        return any requests that finished (streaming semantics)."""
        self._round()
        self._sync_pending()
        reg = obs.registry()
        lbl = self._obs_labels()
        reg.gauge("serve.queue_depth", **lbl).set(len(self._waiting))
        reg.gauge("serve.batch_occupancy", **lbl).set(
            sum(1 for s in self._slots if s.req is not None)
            / max(1, self.max_batch))
        return self._drain_ready()

    def run_to_completion(self) -> List[RequestOutput]:
        """Drain the queue.  While no ACTIVE request uses eos the schedule is
        host-deterministic, so rounds are dispatched back-to-back with no
        readback and one final sync materializes everything."""
        while self.has_work():
            self._round()
            if any(s.req is not None and s.req.eos_token_id is not None
                   for s in self._slots):
                self._sync_pending()
        self._sync_pending()
        return self._drain_ready()

    # -- scheduling ---------------------------------------------------------

    def _round(self):
        self._admit()
        self._advance_prefills()
        # slots mid-chunked-prefill don't decode this round
        active = [s for s in self._slots
                  if s.req is not None and s.prefill_left is None]
        if not active:
            return
        k = self._pick_chunk(active)
        self._ensure_decode_blocks(k)
        self._dispatch_chunk(k)

    # -- block pool (the CacheBackend's paged side) -------------------------

    @property
    def _free(self):
        return self._pages._free

    @property
    def _ref(self):
        return self._pages._ref

    @property
    def _index(self):
        return self._pages._index

    @property
    def _hash_of(self):
        return self._pages._hash_of

    @property
    def _lru(self):
        return self._pages._lru

    def _available(self) -> int:
        return self._pages.available()

    def _alloc_block(self) -> Optional[int]:
        return self._pages.alloc()

    def _free_block(self, b: int):
        self._pages.release(b)

    def _acquire_cached(self, h: bytes) -> Optional[int]:
        return self._pages.gather(h)

    def _register_prompt_blocks(self, slot: _Slot):
        """Publish a slot's cacheable prompt blocks in the hash index (dense
        prefill at admit time; chunked prefill at its final chunk)."""
        if not self.prefix_cache:
            return
        self._pages.register(slot.hashes, slot.blocks)

    def _pick_chunk(self, active) -> int:
        """Largest power-of-two chunk within the LONGEST remaining budget."""
        rem = max(s.req.max_new_tokens - s.out_count for s in active)
        k = min(max(rem, 1), self.decode_chunk)
        return 1 << (k.bit_length() - 1)

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if b >= n:
                return b
        return -(-n // self.block_size) * self.block_size

    def _admit(self):
        """Admit waiting requests into free slots, then prefill them in
        same-bucket batches (size ladder 4/2/1)."""
        bs = self.block_size
        admitted = []      # (slot, req, Pb, ids_row, blocks_row, P)
        for slot in self._slots:
            if not self._waiting:
                break
            if slot.req is not None:
                continue
            req = self._waiting[0]
            P = len(req.prompt_ids)
            hashes = (prefix_block_hashes(req.prompt_ids, bs)
                      if self.prefix_cache else [])
            n_hit = 0
            for h in hashes:
                if h not in self._index:
                    break
                n_hit += 1
            self.stats["prefix_lookup_blocks"] += len(hashes)
            chunked = (self.prefill_chunk is not None
                       and P - n_hit * bs > self.prefill_chunk)
            if n_hit == 0 and not chunked:
                # -- path A: dense batched prefill of the whole prompt
                Pb = self._bucket(P)
                n_blocks = Pb // bs if self._uses_pages else 0
                if n_blocks > self.num_blocks - 1:
                    raise RuntimeError(
                        f"request {req.request_id} needs {n_blocks} blocks "
                        f"but the pool only has {self.num_blocks - 1} usable")
                if self._available() < n_blocks:
                    break                  # pool pressure: stop admitting
                self._waiting.popleft()
                blocks = [self._alloc_block() for _ in range(n_blocks)]
                self._admit_counter += 1
                if self._rstate is not None:
                    self._rstate.acquire_slot(slot.idx)
                slot.req = req
                slot.length = P
                slot.blocks = blocks
                slot.out_count = 1
                slot.admit_seq = self._admit_counter
                slot.hashes = hashes
                # release bucket-padding blocks before snapshotting the
                # block row (the padded tail goes to trash block 0)
                needed = -(-slot.length // bs)
                while len(slot.blocks) > max(needed, 1):
                    self._free_block(slot.blocks.pop())
                self._write_tbl_row(slot)
                self._register_prompt_blocks(slot)
                ids_row = np.zeros((Pb,), np.int32)
                ids_row[:P] = req.prompt_ids
                blocks_row = np.zeros((n_blocks,), np.int32)
                blocks_row[:len(slot.blocks)] = slot.blocks
                admitted.append((slot, req, Pb, ids_row, blocks_row, P))
                self._obs_mark(req, "admitted", path="dense", bucket=Pb)
                continue
            # -- path B: prefix-hit suffix and/or chunked prefill
            hit_blocks = [self._acquire_cached(h) for h in hashes[:n_hit]]
            n_sblocks = -(-P // bs) - n_hit
            if self._available() < n_sblocks:
                for b in hit_blocks:
                    self._free_block(b)
                break
            self._waiting.popleft()
            suffix_blocks = [self._alloc_block() for _ in range(n_sblocks)]
            self._admit_counter += 1
            slot.req = req
            slot.length = n_hit * bs       # context already resident
            slot.blocks = hit_blocks + suffix_blocks
            slot.out_count = 0             # first token comes at final chunk
            slot.admit_seq = self._admit_counter
            slot.hashes = hashes
            slot.prefill_left = np.asarray(req.prompt_ids[n_hit * bs:], np.int32)
            self._write_tbl_row(slot)
            self.stats["prefix_hit_blocks"] += n_hit
            self.stats["prefix_hit_tokens"] += n_hit * bs
            if n_hit:
                obs.registry().counter(
                    "serve.prefix_hit_blocks", **self._obs_labels()).inc(n_hit)
            self._obs_mark(req, "admitted", path="chunked", hit_blocks=n_hit)
        by_bucket: Dict[int, list] = {}
        for entry in admitted:
            by_bucket.setdefault(entry[2], []).append(entry)
        for Pb, group in by_bucket.items():
            if self._recurrent:
                # one request a prefill: it scatters one slot's state rows
                for entry in group:
                    self._prefill_batch([entry], Pb)
                continue
            while group:
                n = 4 if len(group) >= 4 else (2 if len(group) >= 2 else 1)
                self._prefill_batch(group[:n], Pb)
                group = group[n:]
        for slot, req, *_ in admitted:
            if slot.req is req and slot.out_count >= req.max_new_tokens:
                self._finish_order.append(req)
                self._release(slot)

    def _write_tbl_row(self, slot: _Slot):
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        row[:len(slot.blocks)] = slot.blocks
        self._tbl[slot.idx] = row
        self._sched_version += 1

    def _advance_prefills(self):
        """Dispatch ONE prefill chunk per mid-prefill slot (admission order)."""
        for slot in sorted((s for s in self._slots
                            if s.req is not None and s.prefill_left is not None),
                           key=lambda s: s.admit_seq):
            self._prefill_chunk_step(slot)

    def _next_first_idx(self, n: int) -> int:
        if self._first_idx + n > self._first_seg:
            self._full_first_bufs.append(self._first_buf)
            self._first_buf = torch.zeros(self._first_seg, dtype=torch.int32,
                                          device=self.device)
            self._first_idx = 0
        fidx0 = self._first_idx
        self._first_idx += n
        return fidx0

    def _prefill_chunk_step(self, slot: _Slot):
        """One chunk of a path-B prefill at the slot's block-aligned context
        offset.  Non-final chunks are exactly ``prefill_chunk`` tokens; the
        final chunk samples the first output token and registers the
        prompt's cacheable blocks."""
        req = slot.req
        ids = slot.prefill_left
        total = len(ids)
        take = (total if self.prefill_chunk is None
                else min(total, self.prefill_chunk))
        final = take == total
        Cb = self._bucket(take)
        ids_row = np.zeros((Cb,), np.int32)
        ids_row[:take] = ids[:take]
        fidx0 = self._next_first_idx(1) if final else None
        t0 = time.perf_counter()
        with obs.span("serve.prefill-chunk", cat="serve",
                      args={"bucket": Cb, "final": final}):
            self._run_chunk_prefill(slot.idx, ids_row, self._tbl[slot.idx],
                                    slot.length, take, req, fidx0)
        dt = time.perf_counter() - t0
        req._prefill_dt += dt
        slot.length += take
        slot.prefill_left = None if final else ids[take:]
        self._sched_version += 1
        self.stats["prefill_time"] += dt
        self.stats["prefill_tokens"] += Cb
        self.stats["chunk_prefills"] += 1
        reg = obs.registry()
        lbl = self._obs_labels()
        reg.counter("serve.prefill_tokens", **lbl).inc(Cb)
        self._obs_mark(req, "prefill-chunk", take=take, final=final)
        if final:
            slot.out_count = 1
            self._pending.append(
                ("prefill", req, len(self._full_first_bufs), fidx0))
            self.stats["prefills"] += 1
            self.stats["generated_tokens"] += 1
            self._register_prompt_blocks(slot)
            if req._queued_t:
                reg.histogram("serve.ttft_ms", **lbl).observe(
                    (t0 + dt - req._queued_t) * 1e3)
            if slot.out_count >= req.max_new_tokens:
                self._finish_order.append(req)
                self._release(slot)

    def _ensure_decode_blocks(self, k: int = 1):
        """Allocate every block the next ``k`` decode steps write, per slot
        clipped to its remaining budget (evicting the youngest sequence on
        pressure)."""
        if not self._uses_pages:
            return                 # recurrent state never grows: no blocks
        for slot in sorted((s for s in self._slots if s.req is not None),
                           key=lambda s: s.admit_seq):
            if slot.req is None:
                continue           # evicted by an earlier slot's growth
            if slot.prefill_left is not None:
                continue           # mid-prefill: doesn't decode this round
            w = min(k, max(slot.req.max_new_tokens - slot.out_count, 1))
            need_idx = (slot.length + w - 1) // self.block_size
            while slot.req is not None and need_idx >= len(slot.blocks):
                b = self._alloc_block()
                if b is not None:
                    slot.blocks.append(b)
                    continue
                actives = [s for s in self._slots if s.req is not None]
                if len(actives) == 1 and actives[0] is slot:
                    raise RuntimeError(
                        "paged KV pool exhausted by a single sequence; "
                        "increase num_blocks")
                victim = max(actives, key=lambda s: s.admit_seq)
                self._evict(victim)
            if slot.req is not None:
                self._write_tbl_row(slot)

    def _evict(self, slot: _Slot):
        """Recompute-style preemption: requeue the request (its generated
        tokens prepended to the prompt) and free its blocks.  The merge needs
        token VALUES, so the deferred backlog materializes first."""
        free_before = self._available()
        self._sync_pending()
        req = slot.req
        if req is None:
            return
        if self._available() > free_before:
            # the sync released eos-finished slots: the pressure is gone
            return
        merged = np.concatenate(
            [np.asarray(req.prompt_ids, np.int32),
             np.asarray(req._out_vals, np.int32)]) if req._out_vals else \
            np.asarray(req.prompt_ids, np.int32)
        requeued = GenRequest(
            prompt_ids=merged,
            max_new_tokens=req.max_new_tokens - len(req._out_vals),
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            eos_token_id=req.eos_token_id,
            request_id=req.request_id,
            orig_prompt_ids=(req.orig_prompt_ids if req.orig_prompt_ids
                             is not None else req.prompt_ids),
            prior_output=req.prior_output + list(req._out_vals))
        self._waiting.appendleft(requeued)
        self._release(slot)
        self.stats["evictions"] += 1

    def _release(self, slot: _Slot):
        for b in slot.blocks:
            self._free_block(b)      # shared blocks just drop a ref
        if self._rstate is not None and slot.req is not None:
            self._rstate.release_slot(slot.idx)
        self._sched_version += 1
        slot.req = None
        slot.length = 0
        slot.blocks = []
        slot.out_count = 0
        slot.prefill_left = None
        slot.hashes = []
        self._tbl[slot.idx] = 0                  # point at the trash block

    # -- device work --------------------------------------------------------

    @torch.no_grad()
    def _run_chunk_prefill(self, sidx: int, ids_row, tbl_row, ctx: int,
                           n_valid: int, req: GenRequest, fidx0: Optional[int]):
        """B=1 chunk prefill over the paged pools: write the chunk at the
        slot's block-aligned context offset and attend context + chunk.  Only
        the final chunk (``fidx0`` given) samples, at position
        ``n_valid - 1``."""
        cache = {"k": self.k_pools, "v": self.v_pools,
                 "block_table": self._dev(tbl_row[None, :]),
                 "lengths": self._dev([ctx], torch.int32)}
        hidden, _ = self.model.decoder(self._dev(ids_row[None, :]), cache=cache)
        if fidx0 is None:
            return
        lg = self.model.head(hidden[:, n_valid - 1])
        nxt = _sample_batch(lg, self.generator,
                            self._dev([req.temperature], torch.float32),
                            self._dev([req.top_k], torch.int32),
                            self._dev([req.top_p], torch.float32),
                            req.temperature > 0)
        self._last_dev[sidx] = nxt[0]
        self._first_buf[fidx0] = nxt[0]

    def _prefill_batch(self, group, Pb: int):
        """Dense-causal prefill of ``n`` same-bucket requests in one forward;
        K/V scattered into the paged pools, first tokens sampled into the
        device last-token vector and the first-token segment buffer."""
        n = len(group)
        fidx0 = self._next_first_idx(n)
        t0 = time.perf_counter()
        run = self._run_ssd_prefill if self._recurrent else self._run_prefill
        with obs.span("serve.prefill", cat="serve", args={"bucket": Pb, "n": n}):
            run(group, Pb, fidx0)
        dt = time.perf_counter() - t0
        reg = obs.registry()
        lbl = self._obs_labels()
        ttft = reg.histogram("serve.ttft_ms", **lbl)
        for j, (slot, req, *_rest) in enumerate(group):
            req._prefill_dt = dt
            self._pending.append(
                ("prefill", req, len(self._full_first_bufs), fidx0 + j))
            if req._queued_t:
                ttft.observe((t0 + dt - req._queued_t) * 1e3)
            self._obs_mark(req, "prefill", bucket=Pb, batch=n)
        self.stats["prefills"] += n
        self.stats["prefill_time"] += dt
        self.stats["prefill_tokens"] += n * Pb
        self.stats["generated_tokens"] += n
        reg.counter("serve.prefill_tokens", **lbl).inc(n * Pb)

    @torch.no_grad()
    def _run_prefill(self, group, Pb: int, fidx0: int):
        n = len(group)
        ids = self._dev(np.stack([e[3] for e in group]))              # [n, Pb]
        blocks = self._dev(np.concatenate([e[4] for e in group]))     # [n*nb]
        last_pos = self._dev([e[5] - 1 for e in group], torch.long)   # [n]
        sidx = self._dev([e[0].idx for e in group], torch.long)
        temps = np.array([e[1].temperature for e in group], np.float32)
        cache = self.model.init_cache(n, Pb)
        hidden, new_cache = self.model.decoder(ids, cache=cache)
        for li, (k_c, v_c) in enumerate(new_cache["kv"]):
            hk, d = k_c.shape[2], k_c.shape[3]
            write_paged_prefill(self.k_pools[li], self.v_pools[li], blocks,
                                k_c[:, :Pb].reshape(n * Pb, hk, d),
                                v_c[:, :Pb].reshape(n * Pb, hk, d))
        # causality makes row j's hidden state at P[j]-1 independent of the
        # padded tail; only those rows reach the vocab projection
        lg = self.model.head(hidden[torch.arange(n, device=self.device), last_pos])
        nxt = _sample_batch(
            lg, self.generator, self._dev(temps),
            self._dev([e[1].top_k for e in group], torch.int32),
            self._dev([e[1].top_p for e in group], torch.float32),
            bool((temps > 0).any()))
        self._last_dev[sidx] = nxt
        self._first_buf[fidx0:fidx0 + n] = nxt

    @torch.no_grad()
    def _run_ssd_prefill(self, group, Pb: int, fidx0: int):
        """B=1 prefill of a model with SSD layers (``group`` holds one
        admission): dense forward over the bucket-padded prompt with the
        tail masked (``n_valid``: zeroed projections are exact no-ops on the
        scan), then the per-layer decode state into the slot's rows and, for
        hybrid attention layers, K/V into the paged pools."""
        (slot, req, _, ids_row, blocks_row, n_valid), = group
        sidx = slot.idx
        cache = self.model.init_cache(1, Pb)
        cache["n_valid"] = n_valid
        hidden, new_cache = self.model.decoder(self._dev(ids_row[None, :]), cache=cache)
        for slots, st in zip(self._ssd_state, new_cache["ssd"]):
            for key, rows in slots.items():
                rows[sidx] = st[key][0]
        if new_cache["kv"]:
            blocks = self._dev(blocks_row)
            for ai, (k_c, v_c) in enumerate(new_cache["kv"]):
                write_paged_prefill(self.k_pools[ai], self.v_pools[ai], blocks,
                                    k_c[0, :Pb], v_c[0, :Pb])
        lg = self.model.head(hidden[:, n_valid - 1])
        nxt = _sample_batch(lg, self.generator,
                            self._dev([req.temperature], torch.float32),
                            self._dev([req.top_k], torch.int32),
                            self._dev([req.top_p], torch.float32),
                            req.temperature > 0)
        self._last_dev[sidx] = nxt[0]
        self._first_buf[fidx0] = nxt[0]

    def _dispatch_chunk(self, k: int):
        """Run one k-sub-step decode chunk and account for it: ownership
        ledger, host length mirrors, dispatch-decided finishes (a finish
        frees its blocks now — the chunk's tail writes precede any later
        reuse, because the stream executes in issue order)."""
        def _dec(s):
            return s.req is not None and s.prefill_left is None

        staged = (self.dispatch_staging and self._staged is not None
                  and self._staged[0] == self._sched_version)
        if staged:
            _, tbl_dev, len_dev, temps_dev, topk_dev, topp_dev, any_sample = \
                self._staged
        else:
            lengths = np.array([s.length if _dec(s) else 0
                                for s in self._slots], np.int32)
            temps = np.array([s.req.temperature if _dec(s) else 0.0
                              for s in self._slots], np.float32)
            top_ks = np.array([s.req.top_k if _dec(s) else 0
                               for s in self._slots], np.int32)
            top_ps = np.array([s.req.top_p if _dec(s) else 1.0
                               for s in self._slots], np.float32)
            # mid-prefill slots are masked inactive and their table rows
            # zeroed in the snapshot, so a decode write can't reach their
            # real blocks
            tbl = self._tbl.copy()
            for s in self._slots:
                if s.req is not None and s.prefill_left is not None:
                    tbl[s.idx] = 0
            tbl_dev = self._dev(tbl)
            len_dev = self._dev(lengths)
            temps_dev = self._dev(temps)
            topk_dev = self._dev(top_ks)
            topp_dev = self._dev(top_ps)
            any_sample = bool((temps > 0).any())
        if self._tok_row + k > self._tok_seg_rows:
            self._full_tok_bufs.append(self._tok_buf)
            self._tok_buf = torch.zeros((self._tok_seg_rows, self.max_batch),
                                        dtype=torch.int32, device=self.device)
            self._tok_row = 0
        row0 = self._tok_row
        self._tok_row += k
        t0 = time.perf_counter()
        if self._last_dispatch_t is not None:
            gap = t0 - self._last_dispatch_t
            self._decode_gaps.append(gap)
            obs.registry().histogram(
                "serve.decode_gap_ms", **self._obs_labels()).observe(gap * 1e3)
        with obs.span("serve.decode-chunk", cat="serve",
                      args={"k": k, "staged": staged}):
            lens_out = self._run_decode(k, tbl_dev, len_dev, temps_dev,
                                        topk_dev, topp_dev, any_sample, row0)
        self._last_dispatch_t = time.perf_counter()
        if self.dispatch_staging:
            self._staged = (self._sched_version, tbl_dev, lens_out,
                            temps_dev, topk_dev, topp_dev, any_sample)
        self.stats["decode_time"] += time.perf_counter() - t0
        self.stats["decode_steps"] += k
        self.stats["decode_calls"] += 1
        recs = []
        for s in self._slots:
            if s.req is None or s.prefill_left is not None:
                continue
            take = min(k, s.req.max_new_tokens - s.out_count)
            recs.append((s.req, s.idx, take))
            s.out_count += take
            s.length += k
            self.stats["generated_tokens"] += take
            self._obs_mark(s.req, "decode-round", k=take)
            if s.out_count >= s.req.max_new_tokens:
                self._finish_order.append(s.req)
                self._release(s)
        self._pending.append(("chunk", len(self._full_tok_bufs), row0, k, recs))

    @torch.no_grad()
    def _run_decode(self, k: int, tbl, lengths, temps, top_ks, top_ps,
                    any_sample: bool, row0: int) -> torch.Tensor:
        """``k`` decode sub-steps over all ``max_batch`` slots; inactive
        slots (length 0) hold their last token and their SSD state, and
        write only to the trash block.  Returns the advanced lengths
        vector."""
        lst = self._last_dev
        for i in range(k):
            cache = {"k": self.k_pools, "v": self.v_pools,
                     "block_table": tbl, "lengths": lengths}
            if self._recurrent:
                cache["ssd"] = self._ssd_state
            hidden, new_cache = self.model.decoder(lst[:, None], cache=cache)
            if self._recurrent:
                self._ssd_state = new_cache["ssd"]
            nxt = _sample_batch(self.model.head(hidden[:, 0]), self.generator,
                                temps, top_ks, top_ps, any_sample)
            lst = torch.where(lengths > 0, nxt, lst)
            self._tok_buf[row0 + i] = lst
            lengths = new_cache["lengths"]
        self._last_dev = lst
        return lengths

    def warmup(self):
        """Build the kernels and run one decode step and one prefill per
        bucket on throwaway inputs (all slots inactive, writes to the trash
        block, SSD slot states unchanged), so neither the kernel build nor
        first-call library setup lands inside a serving window."""
        if self.device.type == "cuda":
            from ..kernels import _build

            _build.load_all()
        zeros = torch.zeros(self.max_batch, dtype=torch.int32, device=self.device)
        saved_last = self._last_dev.clone()
        with torch.no_grad():
            for Pb in self.prefill_buckets:
                cache = self.model.init_cache(1, Pb)
                self.model.decoder(torch.zeros((1, Pb), dtype=torch.int32,
                                               device=self.device), cache=cache)
            cache = {"k": self.k_pools, "v": self.v_pools,
                     "block_table": self._dev(np.zeros_like(self._tbl)),
                     "lengths": zeros}
            if self._recurrent:
                cache["ssd"] = self._ssd_state
            hidden, _ = self.model.decoder(zeros[:, None], cache=cache)
            self.model.head(hidden[:, 0])
        self._last_dev = saved_last
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- deferred-sync materialization --------------------------------------

    def _sync_pending(self):
        """Materialize every pending token in one readback per segment
        buffer, walk the ledger in dispatch order filling request values
        (honoring eos cuts), and emit finished outputs."""
        if self._pending:
            self.stats["syncs"] += 1
            t0 = time.perf_counter()
            tok_segs = [b.cpu().numpy()
                        for b in (*self._full_tok_bufs, self._tok_buf)]
            first_segs = [b.cpu().numpy()
                          for b in (*self._full_first_bufs, self._first_buf)]
            for e in self._pending:
                if e[0] == "prefill":
                    _, req, seg, fidx = e
                    self._absorb(req, [int(first_segs[seg][fidx])])
                else:
                    _, seg, row0, kk, recs = e
                    rows = tok_segs[seg][row0:row0 + kk]
                    for req, idx, take in recs:
                        self._absorb(req, rows[:take, idx].tolist())
            self._pending.clear()
            self._full_tok_bufs.clear()
            self._full_first_bufs.clear()
            self._tok_row = 0
            self._first_idx = 0
            self.stats["sync_time"] += time.perf_counter() - t0
        for req in self._finish_order:
            if not req._emitted:
                self._ready.append(self._emit(req, "length"))
        self._finish_order.clear()

    def _absorb(self, req: GenRequest, vals: List[int]):
        """Append materialized tokens to a request, cutting at eos; cells
        discarded here are un-counted from ``generated_tokens``."""
        for i, tok in enumerate(vals):
            if req._stopped or req._emitted:
                self.stats["generated_tokens"] -= len(vals) - i
                return
            if req.eos_token_id is not None and tok == req.eos_token_id:
                req._stopped = True
                self.stats["generated_tokens"] -= len(vals) - i
                for s in self._slots:
                    if s.req is req:
                        self._release(s)
                        break
                self._ready.append(self._emit(req, "stop"))
                return
            req._out_vals.append(tok)

    def _emit(self, req: GenRequest, reason: str) -> RequestOutput:
        req._emitted = True
        tr = obs.tracer()
        if tr is not None and req.request_id is not None:
            tr.lifecycle_end(
                req.request_id,
                args={"reason": reason,
                      "tokens": len(req.prior_output) + len(req._out_vals)})
        obs.registry().counter("serve.requests", **self._obs_labels()).inc()
        return RequestOutput(
            request_id=req.request_id,
            prompt_ids=np.asarray(
                req.orig_prompt_ids if req.orig_prompt_ids is not None
                else req.prompt_ids),
            output_ids=req.prior_output + list(req._out_vals),
            finish_reason=reason,
            prefill_time=req._prefill_dt,
            finish_time=time.time())

    def _drain_ready(self) -> List[RequestOutput]:
        out, self._ready = self._ready, []
        return out


def _sample_batch(logits, generator, temps, top_ks, top_ps, any_sample: bool):
    """Per-request sampling over a ``[B, V]`` logits batch: greedy rows
    (temp <= 0) take argmax; sampling rows apply temperature, then top-k,
    then nucleus top-p.  ``any_sample`` (known on the host) skips the two
    V-wide sorts for pure-greedy batches."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not any_sample:
        return greedy
    lg = logits / torch.clamp(temps, min=1e-6)[:, None]
    V = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, torch.clamp(top_ks.long() - 1, 0, V - 1)[:, None])
    lg = torch.where((top_ks[:, None] > 0) & (lg < kth), NEG_INF, lg)
    srt2 = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt2, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # the exclusive cumsum of the top token is exactly 0, so any positive p
    # keeps it; p <= 0 is floored so it never keeps nothing
    keep = (csum - probs) < torch.clamp(top_ps, min=1e-9)[:, None]
    thresh = torch.where(keep, srt2, torch.inf).amin(dim=-1, keepdim=True)
    lg = torch.where(lg < thresh, NEG_INF, lg)
    toks = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)
    return torch.where(temps > 0.0, toks, greedy)
