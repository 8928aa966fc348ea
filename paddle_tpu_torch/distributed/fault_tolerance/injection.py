"""Deterministic fault injection — the harness the chaos tests drive.

Every simulated failure is derived from seeded RNG streams keyed by
``FLAGS_ft_inject_seed``, so a chaos run replays bit-for-bit: the same ops
get their connections dropped, the same shard gets the same bits flipped,
the same step crashes.  Faults are configured through ``framework.flags``
(env ``FLAGS_ft_inject_*``), so a training SUBPROCESS can be made faulty
without touching its code.

Supported faults (all off by default):

- **worker crash** at train step N (``ft_inject_crash_step`` /
  ``ft_inject_crash_rank``) — fail-stop via ``os._exit``, exactly what a
  preempted host looks like to its peers.  Fires only in the first
  incarnation (``PADDLE_RESTART_COUNT`` is exported by the launcher on
  relaunch) so the recovered process does not crash again at the same step.
- **dropped store connections** (``ft_inject_store_drop_rate``) — the
  client socket dies mid-op, exercising the reconnect/backoff path.
- **slow / partitioned store peer** (``ft_inject_store_delay_ms``) — fixed
  added latency per op, exercising timeout bounds.
- **bit-flipped checkpoint shard** (``ft_inject_corrupt_step`` +
  :meth:`FaultInjector.corrupt_file`) — silent storage corruption, caught
  by the CRC manifest on load.
- **serving replica kill** (``ft_inject_serve_kill_round`` /
  ``ft_inject_serve_kill_replica``) — the serving router drops a replica
  at an exact round; its in-flight requests must re-route and re-prefill
  on survivors (``serving.router``).
- **store leader kill** (``ft_inject_store_kill_leader``) — the replicated
  control-plane store's leader dies immediately after acking its N-th
  client write; the ack is already on the wire, so the chaos tests can
  assert a quorum-acked write survives failover
  (``distributed.store_replicated``).
- **store partition** (``ft_inject_store_partition``) — replica-to-replica
  links between the configured groups drop while client links stay up, so
  a minority leader stays reachable and can be asserted to never ack a
  write (no split brain).  Heal at runtime via
  :meth:`FaultInjector.set_store_partition`.
- **pipeline stage kill** (``ft_inject_stage_kill_tick`` /
  ``ft_inject_stage_kill_stage``) — the MPMD pipeline executor drops the
  device hosting a stage at an exact schedule tick; the runtime must
  re-plan the stage→device assignment onto survivors and restart the
  step (``distributed.parallel.mpmd``), not shrink the whole job.

The serving-kill and stage-kill knobs are read by the serving router and
the pipeline executor, which the port does not have yet: here they are
drawn and answered as in the JAX package, so those readers can come
without touching the injector.
"""

from __future__ import annotations

import os
import random
import sys
from typing import List, Optional, Tuple

from ...framework import flags

__all__ = ["FaultInjector", "get_injector", "set_injector"]


class FaultInjector:
    def __init__(self, seed: int = 0, crash_step: int = -1,
                 crash_rank: int = -1, store_drop_rate: float = 0.0,
                 store_delay_ms: int = 0, corrupt_step: int = -1,
                 crash_signal: int = 0, serve_kill_round: int = -1,
                 serve_kill_replica: int = -1, store_kill_leader: int = -1,
                 store_partition: str = "", stage_kill_tick: int = -1,
                 stage_kill_stage: int = -1):
        self.seed = int(seed)
        self.crash_step = int(crash_step)
        self.crash_rank = int(crash_rank)
        self.crash_signal = int(crash_signal)
        self.store_drop_rate = float(store_drop_rate)
        self.store_delay_ms = int(store_delay_ms)
        self.corrupt_step = int(corrupt_step)
        self.serve_kill_round = int(serve_kill_round)
        self.serve_kill_replica = int(serve_kill_replica)
        self._serve_kill_fired = False
        self.store_kill_leader = int(store_kill_leader)
        self._store_kill_fired = False
        self.stage_kill_tick = int(stage_kill_tick)
        self.stage_kill_stage = int(stage_kill_stage)
        self._stage_kill_fired = False
        self.set_store_partition(store_partition)
        # independent streams so enabling one fault cannot shift another's
        # decisions (replayability across configurations)
        self._drop_rng = random.Random(f"{self.seed}/store-drop")
        self._flip_rng = random.Random(f"{self.seed}/bit-flip")

    @classmethod
    def from_flags(cls) -> "FaultInjector":
        return cls(seed=flags.get_flag("ft_inject_seed"),
                   crash_step=flags.get_flag("ft_inject_crash_step"),
                   crash_rank=flags.get_flag("ft_inject_crash_rank"),
                   store_drop_rate=flags.get_flag("ft_inject_store_drop_rate"),
                   store_delay_ms=flags.get_flag("ft_inject_store_delay_ms"),
                   corrupt_step=flags.get_flag("ft_inject_corrupt_step"),
                   crash_signal=flags.get_flag("ft_inject_crash_signal"),
                   serve_kill_round=flags.get_flag("ft_inject_serve_kill_round"),
                   serve_kill_replica=flags.get_flag(
                       "ft_inject_serve_kill_replica"),
                   store_kill_leader=flags.get_flag(
                       "ft_inject_store_kill_leader"),
                   store_partition=flags.get_flag(
                       "ft_inject_store_partition"),
                   stage_kill_tick=flags.get_flag("ft_inject_stage_kill_tick"),
                   stage_kill_stage=flags.get_flag(
                       "ft_inject_stage_kill_stage"))

    def active(self) -> bool:
        return (self.crash_step >= 0 or self.store_drop_rate > 0.0
                or self.store_delay_ms > 0 or self.corrupt_step >= 0
                or self.serve_kill_round >= 0 or self.store_kill_leader >= 0
                or self.stage_kill_tick >= 0
                or bool(self._partition_groups))

    # -- fail-stop worker crash ---------------------------------------------

    def crash_point(self, step: int, rank: Optional[int] = None) -> None:
        """Call once per train step; fail-stops the process when the injected
        crash matches.  A relaunched incarnation (``PADDLE_RESTART_COUNT`` >
        0) never re-fires — the crash models a one-time preemption."""
        if self.crash_step < 0 or step != self.crash_step:
            return
        if self.crash_rank >= 0 and rank is not None and rank != self.crash_rank:
            return
        if int(os.environ.get("PADDLE_RESTART_COUNT", "0")) > 0:
            return
        if self.crash_signal > 0:
            # a real preemption/OOM kill delivers a signal with NO cleanup
            # (atexit, finally, buffered IO all skipped for SIGKILL) —
            # strictly harsher than os._exit
            print(f"[inject] signal {self.crash_signal} crash at step {step}",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), self.crash_signal)
            return
        print(f"[inject] fail-stop crash at step {step}", file=sys.stderr,
              flush=True)
        os._exit(1)

    # -- serving replica kill -----------------------------------------------

    def serve_kill_due(self, round_no: int,
                       alive: List[int]) -> Optional[int]:
        """One-shot replica kill for the serving router: returns the victim
        replica id when ``round_no`` reaches the injected round (the
        configured replica if alive, else the lowest alive id), ``None``
        otherwise.  Fires at most once per injector — the failover itself,
        not a crash loop, is what the chaos test exercises."""
        if (self.serve_kill_round < 0 or self._serve_kill_fired
                or round_no < self.serve_kill_round or not alive):
            return None
        self._serve_kill_fired = True
        victim = (self.serve_kill_replica
                  if self.serve_kill_replica in alive else min(alive))
        from ...obs import flight_event
        flight_event("inject.serve-kill", victim=victim, round=round_no)
        return victim

    # -- pipeline stage kill -------------------------------------------------

    def stage_kill_due(self, tick: int, alive: List[int]) -> Optional[int]:
        """One-shot stage kill for the MPMD pipeline executor: returns the
        victim stage when ``tick`` reaches the injected tick (the configured
        stage if alive, else the lowest alive stage), ``None`` otherwise.
        Fires at most once per injector — the re-plan onto survivors, not a
        crash loop, is what the chaos test exercises."""
        if (self.stage_kill_tick < 0 or self._stage_kill_fired
                or tick < self.stage_kill_tick or not alive):
            return None
        self._stage_kill_fired = True
        victim = (self.stage_kill_stage
                  if self.stage_kill_stage in alive else min(alive))
        from ...obs import flight_event
        flight_event("inject.stage-kill", victim=victim, tick=tick)
        return victim

    # -- store faults --------------------------------------------------------

    def store_kill_due(self, writes_acked: int) -> bool:
        """One-shot leader kill for the replicated store.  A leader calls
        this right after acking a client write with its own acked-write
        count; the first leader to reach the configured threshold dies.
        The ack is already on the wire when the kill fires — the write is
        quorum-committed, which is exactly what the chaos test asserts
        survives."""
        if self.store_kill_leader < 0 or self._store_kill_fired:
            return False
        if writes_acked < self.store_kill_leader:
            return False
        self._store_kill_fired = True
        from ...obs import flight_event
        flight_event("inject.store-kill", writes_acked=writes_acked)
        return True

    def set_store_partition(self, spec: str) -> None:
        """(Re)configure the replica partition at runtime: ``'0|1,2'``
        drops replica-to-replica links between group {0} and group {1,2};
        ``''`` heals.  Replica ids absent from the spec keep all links."""
        groups = []
        for part in str(spec or "").split("|"):
            ids = frozenset(int(tok) for tok in part.split(",") if tok.strip())
            if ids:
                groups.append(ids)
        self._partition_groups: List[frozenset] = groups

    def store_link_blocked(self, a: int, b: int) -> bool:
        """True when the replica-to-replica link a<->b is partitioned
        (checked sender-side in both directions, so one check per send
        cuts the link symmetrically)."""
        ga = gb = None
        for g in self._partition_groups:
            if a in g:
                ga = g
            if b in g:
                gb = g
        return ga is not None and gb is not None and ga is not gb

    def should_drop(self) -> bool:
        """One deterministic draw per store op."""
        if self.store_drop_rate <= 0.0:
            return False
        return self._drop_rng.random() < self.store_drop_rate

    def delay_seconds(self) -> float:
        return self.store_delay_ms / 1000.0

    # -- checkpoint corruption ----------------------------------------------

    def corrupt_file(self, path: str, nbits: int = 8) -> List[Tuple[int, int]]:
        """Flip ``nbits`` seeded-random bits in ``path`` in place.  Returns
        the ``(offset, bit)`` list — identical across runs with one seed."""
        size = os.path.getsize(path)
        if size == 0:
            return []
        flips = [(self._flip_rng.randrange(size), self._flip_rng.randrange(8))
                 for _ in range(nbits)]
        with open(path, "r+b") as f:
            for off, bit in flips:
                f.seek(off)
                b = f.read(1)[0]
                f.seek(off)
                f.write(bytes([b ^ (1 << bit)]))
        return flips


# process-wide injector consulted by the store client; ``None`` until
# installed, so the zero-fault fast path costs one attribute check
_INJECTOR: Optional[FaultInjector] = None
_LOADED_FROM_FLAGS = False


def set_injector(inj: Optional[FaultInjector]) -> None:
    global _INJECTOR, _LOADED_FROM_FLAGS
    _INJECTOR = inj
    _LOADED_FROM_FLAGS = True


def get_injector() -> Optional[FaultInjector]:
    """The process-wide injector; lazily built from flags on first use so
    subprocesses configured via ``FLAGS_ft_inject_*`` env need no code."""
    global _INJECTOR, _LOADED_FROM_FLAGS
    if not _LOADED_FROM_FLAGS:
        _LOADED_FROM_FLAGS = True
        inj = FaultInjector.from_flags()
        if inj.active():
            _INJECTOR = inj
    return _INJECTOR
