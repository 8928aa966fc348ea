"""Launcher rendezvous over the native TCPStore.

Counterpart of the reference's launch masters
(``launch/controllers/master.py:35,73`` — ``HTTPMaster`` KV sync /
``ETCDMaster`` registration): nodes join knowing only the master address and
job size; ranks are assigned by the store's atomic counter and every node
learns the full peer list before spawning trainers.

The node that successfully BINDS the master port hosts the store (the
reference's HTTPMaster works the same way: the process whose IP matches the
master address serves); everyone else connects as a client.  Generation
counting makes the same store reusable across elastic restarts.

Fault tolerance (v2): joins are BOUNDED — a generation that never fills
raises ``TimeoutError`` naming the missing ranks instead of hanging; and
when the failure detector declares a peer dead mid-training, survivors
:func:`invalidate_generation` and :func:`shrink_rendezvous` to re-form the
job at the reduced node count on the same store (graceful mesh shrink)
rather than waiting out the full join timeout.  Both paths presume the
store host survived; losing the store host is a whole-job restart (see
``fault_tolerance`` failure model).
"""

from __future__ import annotations

import json
import socket
import time
from typing import Dict, List, Optional

from ..store import TCPStore

__all__ = ["rendezvous", "RendezvousResult", "invalidate_generation",
           "shrink_rendezvous", "GenerationInvalidated",
           "request_join", "grow_rendezvous", "pending_joins"]


class GenerationInvalidated(RuntimeError):
    """The generation being joined (or trained on) was declared dead-peered
    and invalidated; survivors should re-rendezvous."""


class RendezvousResult:
    def __init__(self, rank: int, nnodes: int, peers: List[dict],
                 store: TCPStore, job_id: str = "default", gen: int = 0,
                 subgen: int = -1):
        self.rank = rank
        self.nnodes = nnodes
        self.peers = peers          # [{rank, host}, ...] in rank order
        self.store = store          # kept open: heartbeat/elastic use it
        self.job_id = job_id
        self.gen = gen              # join generation on this store
        self.subgen = subgen        # >= 0 after a mesh shrink

    def __repr__(self):
        tag = f", subgen={self.subgen}" if self.subgen >= 0 else ""
        return (f"RendezvousResult(rank={self.rank}, nnodes={self.nnodes}, "
                f"gen={self.gen}{tag})")


def _is_local(host: str) -> bool:
    """Does ``host`` name this machine?  (The store server binds 0.0.0.0, so
    'bind succeeded' would be true on EVERY machine — arbitration must be by
    address, like the reference HTTPMaster serving only when the master IP
    is local.)"""
    if host in ("127.0.0.1", "localhost", "0.0.0.0", socket.gethostname()):
        return True
    try:
        target = socket.gethostbyname(host)
    except OSError:
        return False
    if target.startswith("127."):
        return True
    try:
        local = socket.gethostbyname_ex(socket.gethostname())[2]
    except OSError:
        local = []
    return target in local


def _store_replicas() -> int:
    """``--store_replicas`` reaches rendezvous through the environment
    (launcher exports ``PADDLE_STORE_REPLICAS``) so no call site between
    the CLI and the store constructor needs a new parameter."""
    import os
    try:
        return max(1, int(os.environ.get("PADDLE_STORE_REPLICAS", "1")))
    except ValueError:
        return 1


def _try_host(host: str, port: int, nnodes: int, timeout: float):
    """Host the master store when the master address is THIS machine (falling
    back to client if another local process already bound it); pure client
    otherwise.  With ``PADDLE_STORE_REPLICAS >= 2`` the hosted store is the
    quorum-replicated one (ports ``port..port+n-1``) and clients follow
    leader redirects — same ``TCPStore`` surface either way."""
    n = _store_replicas()
    if _is_local(host):
        try:
            return TCPStore(host, port, world_size=nnodes, is_master=True,
                            timeout=timeout, replicas=n)
        except OSError:
            pass
    return TCPStore(host, port, world_size=nnodes, is_master=False,
                    timeout=timeout, replicas=n)


def _collect_peers(store: TCPStore, prefix: str, nnodes: int, timeout: float,
                   what: str, invalid_key: Optional[str] = None) -> List[dict]:
    """Gather all ``nnodes`` peer records under ``prefix`` within
    ``timeout`` seconds.  Bounded: on expiry raises ``TimeoutError`` naming
    exactly which ranks never registered; if ``invalid_key`` appears the
    generation was declared dead and ``GenerationInvalidated`` is raised."""
    deadline = time.monotonic() + timeout
    peers: Dict[int, dict] = {}
    while len(peers) < nnodes:
        for r in range(nnodes):
            if r in peers:
                continue
            raw = store.get(f"{prefix}/node/{r}", wait=False)
            if raw is not None:
                peers[r] = json.loads(raw)
        if len(peers) >= nnodes:
            break
        if invalid_key is not None and store.get(invalid_key, wait=False) is not None:
            raise GenerationInvalidated(
                f"{what}: generation invalidated while joining "
                f"(dead peers: {store.get(invalid_key, wait=False)})")
        if time.monotonic() > deadline:
            missing = sorted(set(range(nnodes)) - set(peers))
            raise TimeoutError(
                f"{what} incomplete after {timeout:.1f}s: missing ranks "
                f"{missing} of {nnodes} (joined: {sorted(peers)})")
        # wait on the FIRST missing rank's key so the poll blocks server-side
        # instead of spinning; short slices keep the deadline responsive
        first = min(set(range(nnodes)) - set(peers))
        slice_s = min(1.0, max(0.05, deadline - time.monotonic()))
        try:
            store.wait(f"{prefix}/node/{first}", timeout=slice_s)
        except TimeoutError:
            pass  # re-check all ranks + the deadline
    return [peers[r] for r in range(nnodes)]


def rendezvous(master: str, nnodes: int, job_id: str = "default",
               timeout: float = 300.0) -> RendezvousResult:
    """Join the job; blocks until all ``nnodes`` nodes registered.

    Returns the assigned node rank and the full peer list.  Rank 0 is NOT
    necessarily the store host — ranks come from arrival order (the
    reference's ETCDMaster also assigns by registration order).

    Failure semantics: a node that crashes AFTER joining but before its
    generation completes leaves that generation short — the remaining
    joiners raise ``TimeoutError`` after ``timeout`` naming the missing
    ranks (they never hang forever).  Recover by restarting the whole set
    of nodes (the next ``nnodes`` joins form a fresh generation), or — when
    the failure strikes mid-training — via :func:`invalidate_generation` +
    :func:`shrink_rendezvous` on the surviving nodes.
    """
    host, port_s = master.rsplit(":", 1)
    store = _try_host(host, int(port_s), nnodes, timeout)

    # ranks from the atomic join counter; a full round of nnodes joins forms
    # one GENERATION, so elastic restarts re-entering rendezvous on the same
    # store simply start the next generation (no state to reset)
    try:
        joined = store.add(f"rdzv/{job_id}/joined", 1) - 1
        gen, rank = divmod(joined, nnodes)
        info = {"rank": rank, "host": socket.gethostname()}
        store.set(f"rdzv/{job_id}/{gen}/node/{rank}", json.dumps(info))
        peers = _collect_peers(
            store, f"rdzv/{job_id}/{gen}", nnodes, timeout,
            what=f"rendezvous {job_id!r} generation {gen}",
            invalid_key=f"rdzv/{job_id}/{gen}/invalid")
        store.barrier(f"rdzv/{job_id}/{gen}/ready", timeout=timeout)
    except BaseException:
        store.close()  # a failed join must not leak the store (or its port)
        raise
    return RendezvousResult(rank, nnodes, peers, store, job_id=job_id, gen=gen)


def invalidate_generation(store: TCPStore, job_id: str, gen: int,
                          dead_ranks: List[int]) -> None:
    """Mark generation ``gen`` dead on the store (idempotent — every
    survivor may call it).  Late joiners and in-flight ``rendezvous`` polls
    observe the key and abort instead of waiting out their timeout."""
    from ...obs import flight_event
    flight_event("rdv.generation-invalidated", job_id=job_id, gen=gen,
                 dead_ranks=sorted(dead_ranks))
    store.set(f"rdzv/{job_id}/{gen}/invalid", json.dumps(sorted(dead_ranks)))


def shrink_rendezvous(prev: RendezvousResult, dead_ranks: List[int],
                      timeout: float = 60.0) -> RendezvousResult:
    """Re-form the job WITHOUT the dead peers: every survivor of
    ``prev.gen`` calls this once and receives a fresh contiguous rank in a
    mesh of ``prev.nnodes - len(dead_ranks)`` nodes, over the SAME store
    (the store host must be a survivor — a dead store host is the
    whole-job-restart path).

    Ranks are re-assigned by arrival order on a shrink counter scoped to
    the invalidated generation, so repeated shrinks (two failures in
    sequence) keep working: each invalidation starts the next sub-
    generation."""
    store, job_id, gen = prev.store, prev.job_id, prev.gen
    new_n = prev.nnodes - len(set(dead_ranks))
    if new_n < 1:
        raise ValueError(f"no survivors to shrink to (dead={dead_ranks})")
    joined = store.add(f"rdzv/{job_id}/{gen}/shrink/joined", 1) - 1
    subgen, rank = divmod(joined, new_n)
    prefix = f"rdzv/{job_id}/{gen}/shrink/{subgen}"
    info = {"rank": rank, "host": socket.gethostname(),
            "prev_rank": prev.rank, "prev_nnodes": prev.nnodes}
    store.set(f"{prefix}/node/{rank}", json.dumps(info))
    peers = _collect_peers(
        store, prefix, new_n, timeout,
        what=f"shrink rendezvous {job_id!r} gen {gen}.{subgen}")
    # subsequent barriers (including this ready barrier) are at the SHRUNK
    # world size; each survivor's client adjusts its own view
    store.world_size = new_n
    store.barrier(f"{prefix}/ready", timeout=timeout)
    return RendezvousResult(rank, new_n, peers, store, job_id=job_id,
                            gen=gen, subgen=subgen)


# ---------------------------------------------------------------------------
# scale UP: admit a (re)joining worker at the next generation bump


def _wait_json(store: TCPStore, key: str, timeout: float, what: str) -> dict:
    """Bounded sliced wait for ``key``, then decode it.  Short wait slices
    keep the deadline responsive (same pattern as :func:`_collect_peers`)."""
    deadline = time.monotonic() + timeout
    while True:
        raw = store.get(key, wait=False)
        if raw is not None:
            return json.loads(raw)
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: {key!r} not published "
                               f"within {timeout:.1f}s")
        slice_s = min(1.0, max(0.05, deadline - time.monotonic()))
        try:
            store.wait(key, timeout=slice_s)
        except TimeoutError:
            pass


def pending_joins(store: TCPStore, job_id: str = "default") -> int:
    """How many workers are parked in :func:`request_join` waiting to be
    admitted (requested minus already admitted).  Survivors poll this to
    decide when a :func:`grow_rendezvous` round is worth taking."""
    requested = store.add(f"rdzv/{job_id}/grow/pending", 0)
    admitted = store.add(f"rdzv/{job_id}/grow/admitted", 0)
    return max(0, requested - admitted)


def request_join(master: str, job_id: str = "default",
                 timeout: float = 300.0) -> RendezvousResult:
    """A NEW (or restarted) worker asks to join a running job.

    Unlike :func:`rendezvous`, this does not require a fresh generation:
    the request parks on the store until the survivors take a
    :func:`grow_rendezvous` round at the next generation bump, which
    admits every pending request at once and assigns the newcomer a rank
    past the current world.  Bounded: raises ``TimeoutError`` if no grow
    round admits us within ``timeout``."""
    host, port_s = master.rsplit(":", 1)
    store = TCPStore(host, int(port_s), world_size=1, is_master=False,
                     timeout=timeout, replicas=_store_replicas())
    try:
        k = store.add(f"rdzv/{job_id}/grow/pending", 1)  # my request id
        info = {"host": socket.gethostname()}
        store.set(f"rdzv/{job_id}/grow/req/{k}", json.dumps(info))
        admit = _wait_json(store, f"rdzv/{job_id}/grow/admit/{k}", timeout,
                           what=f"join request {k} for job {job_id!r}")
        prefix, rank, new_n = admit["prefix"], admit["rank"], admit["nnodes"]
        info["rank"] = rank
        store.set(f"{prefix}/node/{rank}", json.dumps(info))
        peers = _collect_peers(
            store, prefix, new_n, timeout,
            what=f"grow rendezvous {job_id!r} (admitted as rank {rank})")
        store.world_size = new_n
        store.barrier(f"{prefix}/ready", timeout=timeout)
    except BaseException:
        store.close()  # a failed join must not leak the client
        raise
    return RendezvousResult(rank, new_n, peers, store, job_id=job_id,
                            gen=admit.get("gen", -1))


def grow_rendezvous(prev: RendezvousResult,
                    timeout: float = 60.0) -> RendezvousResult:
    """Survivor side of scale-up: every member of the current world calls
    this once; pending :func:`request_join` workers are admitted at this
    generation bump and the job re-forms at the grown size.

    Survivors KEEP their ranks (no resharding of their state); newcomers
    are appended after them in request order.  The member with rank 0
    acts as admitter — it freezes the pending set, publishes the round
    meta, and writes each newcomer's admission ticket.  Repeated grows
    work: each round is scoped to an arrival-counter ``bump``."""
    store, job_id, gen = prev.store, prev.job_id, prev.gen
    # the arrival counter is scoped by the round's world size: nnodes is
    # non-decreasing across grows, so each size change starts a fresh
    # counter and repeated same-size rounds advance `bump` by divmod —
    # a single cumulative counter would tear once nnodes changes
    base = f"rdzv/{job_id}/grow/{gen}/n{prev.nnodes}"
    joined = store.add(f"{base}/joined", 1) - 1
    bump, _ = divmod(joined, prev.nnodes)
    prefix = f"{base}/{bump}"

    if prev.rank == 0:
        requested = store.add(f"rdzv/{job_id}/grow/pending", 0)
        admitted = store.add(f"rdzv/{job_id}/grow/admitted", 0)
        newcomers = max(0, requested - admitted)
        new_n = prev.nnodes + newcomers
        store.set(f"{prefix}/meta", json.dumps(
            {"nnodes": new_n, "admitted": newcomers, "base": prev.nnodes}))
        for i in range(newcomers):
            store.set(f"rdzv/{job_id}/grow/admit/{admitted + 1 + i}",
                      json.dumps({"prefix": prefix,
                                  "rank": prev.nnodes + i,
                                  "nnodes": new_n, "gen": gen}))
        store.add(f"rdzv/{job_id}/grow/admitted", newcomers)
    else:
        meta = _wait_json(store, f"{prefix}/meta", timeout,
                          what=f"grow rendezvous {job_id!r} bump {bump}")
        new_n = meta["nnodes"]

    info = {"rank": prev.rank, "host": socket.gethostname(),
            "prev_rank": prev.rank, "prev_nnodes": prev.nnodes}
    store.set(f"{prefix}/node/{prev.rank}", json.dumps(info))
    peers = _collect_peers(
        store, prefix, new_n, timeout,
        what=f"grow rendezvous {job_id!r} gen {gen} bump {bump}")
    # barriers from here on (including this ready barrier) are at the
    # GROWN world size; each client adjusts its own view
    store.world_size = new_n
    store.barrier(f"{prefix}/ready", timeout=timeout)
    return RendezvousResult(prev.rank, new_n, peers, store, job_id=job_id,
                            gen=gen)