"""Retry / timeout / backoff policies for control-plane calls.

Every host-side control operation (store round-trips, rendezvous joins,
barriers) goes through a bounded policy so no call can hang unboundedly:
an exponential backoff with deterministic jitter caps the retry cadence,
and a :class:`Deadline` caps the total wall time.

Jitter is DETERMINISTIC (seeded ``random.Random``) so chaos runs replay
identically under a fixed ``FLAGS_ft_inject_seed`` — the same property the
injection framework relies on (see ``injection.py``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, NamedTuple, Optional, Tuple, Type

__all__ = ["RetryPolicy", "Deadline", "retry_call", "HeartbeatConfig",
           "heartbeat_config", "StoreConsensusConfig",
           "store_consensus_config"]


class HeartbeatConfig(NamedTuple):
    """Validated detection-latency knobs for the heartbeat failure
    detector — the documented surface of ``FLAGS_ft_heartbeat_interval``
    and ``FLAGS_ft_lease_ttl``.

    - ``interval``: seconds between lease renewals (bounds: 0.05..300).
    - ``ttl``: seconds a silent peer keeps its lease; must be at least
      ``2 * interval`` so one delayed beat cannot evict a live peer
      (flag value 0 means the 3x-interval default).
    - ``op_timeout``: per-store-op budget derived from the interval, so
      liveness probes stay bounded at heartbeat scale rather than the
      rendezvous-scale default.

    Worst-case detection latency is ``ttl + interval`` (a peer that died
    right after renewing, observed by a sampler that just missed it).
    """

    interval: float
    ttl: float
    op_timeout: float


#: validated bounds for FLAGS_ft_heartbeat_interval (seconds)
HEARTBEAT_INTERVAL_BOUNDS = (0.05, 300.0)


def heartbeat_config(interval: Optional[float] = None,
                     ttl: Optional[float] = None) -> HeartbeatConfig:
    """Resolve (and validate) the heartbeat knobs.

    Explicit arguments win; ``None`` falls back to the flags.  Raises
    ``ValueError`` on out-of-bounds values instead of letting a
    mis-tuned job silently evict live peers.
    """
    from ...framework.flags import get_flag

    if interval is None:
        interval = float(get_flag("ft_heartbeat_interval"))
    interval = float(interval)
    lo, hi = HEARTBEAT_INTERVAL_BOUNDS
    if not (lo <= interval <= hi):
        raise ValueError(
            f"FLAGS_ft_heartbeat_interval={interval} out of bounds "
            f"[{lo}, {hi}]")
    if ttl is None:
        ttl = float(get_flag("ft_lease_ttl"))
    ttl = float(ttl)
    if ttl == 0.0:
        ttl = 3.0 * interval
    if ttl < 2.0 * interval:
        raise ValueError(
            f"FLAGS_ft_lease_ttl={ttl} must be >= 2x the heartbeat "
            f"interval ({interval}) — one delayed beat would evict a "
            f"live peer")
    return HeartbeatConfig(interval=interval, ttl=ttl,
                           op_timeout=max(2.0, 2.0 * interval))


class StoreConsensusConfig(NamedTuple):
    """Validated timing knobs for the replicated control-plane store
    (``distributed.store_replicated``), all derived from the SAME
    heartbeat flag surface as the failure detector so one pair of knobs
    (``FLAGS_ft_heartbeat_interval`` / ``FLAGS_ft_lease_ttl``) tunes the
    whole control plane coherently:

    - ``heartbeat``: leader append/heartbeat cadence = the heartbeat
      interval.  Followers hear from a live leader at least this often.
    - ``lease_ttl``: the leader lease = the membership lease ttl.  The
      leader serves linearizable reads only while a quorum's latest
      acks are younger than this; past it, it steps down.
    - ``election_timeout``: base follower silence before standing for
      election; must be **>= 2 x lease_ttl** so a leader always loses
      its lease (stops serving reads) strictly before any follower can
      start a term that could elect a competing leader.  Actual
      timeouts are randomized per election in
      ``[election_timeout, 2 * election_timeout)``.
    - ``clock_skew``: safety margin subtracted from the lease before
      serving a read (0.25 x ttl): two replicas' monotonic clocks may
      advance at slightly different rates, so the old leader must
      consider its lease dead while the quorum still considers it live.
    - ``op_timeout``: per-peer-RPC budget (same derivation as the
      detector's store-op budget).
    """

    heartbeat: float
    lease_ttl: float
    election_timeout: float
    clock_skew: float
    op_timeout: float


def store_consensus_config(
        interval: Optional[float] = None, ttl: Optional[float] = None,
        election_timeout: Optional[float] = None) -> StoreConsensusConfig:
    """Derive replicated-store timings from ``heartbeat_config``.

    ``interval``/``ttl`` pass through :func:`heartbeat_config` (same
    bounds validation, same flag fallbacks); ``election_timeout``
    defaults to ``2 * ttl`` and is validated to stay >= that floor.
    Raises ``ValueError`` on a configuration that could elect a second
    leader while the first still serves reads.
    """
    hb = heartbeat_config(interval, ttl)
    if election_timeout is None:
        election_timeout = 2.0 * hb.ttl
    election_timeout = float(election_timeout)
    if election_timeout < 2.0 * hb.ttl:
        raise ValueError(
            f"store election timeout {election_timeout} must be >= 2x the "
            f"lease ttl ({hb.ttl}) — a follower could start an election "
            f"while the old leader still serves lease reads")
    return StoreConsensusConfig(heartbeat=hb.interval, lease_ttl=hb.ttl,
                                election_timeout=election_timeout,
                                clock_skew=0.25 * hb.ttl,
                                op_timeout=hb.op_timeout)


class Deadline:
    """Absolute wall-clock budget for one logical operation."""

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._end = None if seconds is None else time.monotonic() + seconds

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        return cls(seconds)

    def remaining(self) -> float:
        if self._end is None:
            return float("inf")
        return self._end - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str) -> None:
        if self.expired():
            raise TimeoutError(
                f"deadline of {self.seconds:.1f}s exceeded while {what}")

    def clamp(self, delay: float) -> float:
        """Never sleep past the deadline."""
        return max(0.0, min(delay, self.remaining()))


class RetryPolicy:
    """Exponential backoff with deterministic jitter and bounded attempts.

    >>> p = RetryPolicy(max_attempts=3, base_delay=0.1, seed=7)
    >>> list(p.delays()) == list(p.delays())   # replayable
    True
    """

    def __init__(self, max_attempts: int = 5, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.25, seed: int = 0):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delays(self) -> Iterator[float]:
        """The backoff schedule: one delay per retry (attempts - 1 entries).
        A fresh seeded RNG per call keeps the sequence replayable."""
        rng = random.Random(self.seed)
        d = self.base_delay
        for _ in range(self.max_attempts - 1):
            capped = min(d, self.max_delay)
            # symmetric jitter in [1-j, 1+j]; deterministic given the seed
            yield capped * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))
            d *= self.multiplier


def retry_call(fn: Callable, *, policy: RetryPolicy,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               deadline: Optional[Deadline] = None,
               describe: str = "operation",
               on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Call ``fn()`` under ``policy``: retry on ``retry_on`` exceptions with
    backoff, never exceeding ``deadline``.  The last failure is re-raised
    (wrapped in ``TimeoutError`` when the deadline, not the attempt budget,
    is what ran out)."""
    deadline = deadline or Deadline(None)
    last: Optional[BaseException] = None
    schedule = policy.delays()
    for attempt in range(policy.max_attempts):
        deadline.check(describe)
        try:
            return fn()
        except retry_on as e:
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            delay = next(schedule, None)
            if delay is None:
                break
            if deadline.expired():
                raise TimeoutError(
                    f"deadline of {deadline.seconds:.1f}s exceeded while "
                    f"{describe} (last error: {e})") from e
            time.sleep(deadline.clamp(delay))
    assert last is not None
    raise last
