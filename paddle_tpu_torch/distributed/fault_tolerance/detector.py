"""Heartbeat failure detector: lease counters over the control store.

Each member renews a LEASE by bumping a monotonic counter
(``ft/<job>/lease/<rank>``) every ``interval`` seconds.  Liveness is judged
purely by counter ADVANCE observed locally — never by comparing cross-host
timestamps (clocks are not trusted; same principle as
``fleet.ElasticManager``).  A rank whose counter stops advancing for
``ttl`` seconds has let its lease expire and is declared dead (fail-stop
model: a wedged process is indistinguishable from a crashed one, and both
need the same recovery).

The rank-0 **monitor** additionally publishes a MEMBERSHIP EPOCH: whenever
the alive set changes it bumps ``ft/<job>/epoch`` and records the new
membership under ``ft/<job>/members/<epoch>`` (and the dead set under
``ft/<job>/dead/<epoch>``).  Non-monitor ranks — and the rendezvous layer —
read the epoch to learn about failures without running their own detector
sweep, which keeps the store traffic O(nnodes), not O(nnodes^2).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...obs import flight_event

__all__ = ["HeartbeatFailureDetector"]

#: pseudo-rank reported when the store itself (the coordinator host) is
#: unreachable — membership is lost wholesale, peers cannot be judged
STORE_LOST = -1


class HeartbeatFailureDetector:
    def __init__(self, store, rank: int, nnodes: int, job_id: str = "default",
                 interval: Optional[float] = None, ttl: Optional[float] = None,
                 monitor: Optional[bool] = None):
        from .policy import heartbeat_config

        self.store = store
        self.rank = int(rank)
        self.nnodes = int(nnodes)
        self.job_id = job_id
        # interval/ttl default to the validated FLAGS_ft_heartbeat_interval
        # / FLAGS_ft_lease_ttl surface (policy.heartbeat_config)
        cfg = heartbeat_config(interval, ttl)
        self.interval = cfg.interval
        self.ttl = cfg.ttl
        self.monitor = (self.rank == 0) if monitor is None else bool(monitor)
        # liveness probes are bounded at heartbeat scale, NOT the store's
        # rendezvous-scale default timeout: once the master dies, a probe
        # that waits out a 300s op deadline (holding the client lock) makes
        # detection orders of magnitude slower than the ttl it enforces
        self.op_timeout = cfg.op_timeout
        self.STORE_LOST = STORE_LOST
        self._stop: Optional[threading.Event] = None
        self._threads: List[threading.Thread] = []
        self._dead_lock = threading.Lock()
        self._dead: List[int] = []

    # -- store keys ----------------------------------------------------------

    def _lease_key(self, rank: int) -> str:
        return f"ft/{self.job_id}/lease/{rank}"

    def _epoch_key(self) -> str:
        return f"ft/{self.job_id}/epoch"

    # -- lease renewal -------------------------------------------------------

    def beat_once(self) -> None:
        self.store.add(self._lease_key(self.rank), 1, timeout=self.op_timeout)
        flight_event("ft.lease-renew", rank=self.rank)

    def counters(self) -> Dict[int, int]:
        """Current lease counter per rank (0 = never renewed)."""
        return {r: self.store.add(self._lease_key(r), 0,  # add 0 = atomic read
                                  timeout=self.op_timeout)
                for r in range(self.nnodes)}

    def start(self) -> "HeartbeatFailureDetector":
        """Start the lease-renewal thread (and the monitor, on the monitor
        rank).  Both are daemons; call :meth:`stop` for a clean shutdown."""
        self._stop = threading.Event()

        def beat():
            failures = 0
            while not self._stop.is_set():
                try:
                    self.beat_once()
                    failures = 0
                except Exception as e:
                    # transient store errors must not kill the lease — peers
                    # would declare this healthy node dead; give up only
                    # after the ttl's worth of consecutive failures
                    failures += 1
                    if failures * self.interval > 2 * self.ttl:
                        import sys
                        print(f"[ft] lease renewal giving up after "
                              f"{failures} store failures: {e}",
                              file=sys.stderr)
                        return
                self._stop.wait(self.interval)

        t = threading.Thread(target=beat, name="ft-lease", daemon=True)
        t.start()
        self._threads = [t]
        if self.monitor:
            m = threading.Thread(target=self._monitor_loop, name="ft-monitor",
                                 daemon=True)
            m.start()
            self._threads.append(m)
        return self

    # -- monitor: lease expiry -> membership epoch ---------------------------

    def _monitor_loop(self) -> None:
        last_count: Dict[int, int] = {}
        last_advance: Dict[int, float] = {}
        declared: set = set()
        start = time.monotonic()
        while not self._stop.is_set():
            try:
                counts = self.counters()
            except Exception:
                self._stop.wait(self.interval)
                continue
            now = time.monotonic()
            for r, c in counts.items():
                if c != last_count.get(r):
                    last_count[r] = c
                    last_advance[r] = now
            expired = sorted(
                r for r in range(self.nnodes)
                if r not in declared
                # a rank that never renewed gets the full ttl from startup
                and now - last_advance.get(r, start) > self.ttl)
            if expired:
                declared.update(expired)
                flight_event("ft.heartbeat-miss", expired=expired,
                             dead=sorted(declared))
                with self._dead_lock:
                    self._dead = sorted(declared)
                try:
                    self._publish_epoch(sorted(set(range(self.nnodes)) - declared),
                                        sorted(declared))
                except Exception:
                    pass  # store gone: members find out via their own calls
            self._stop.wait(self.interval)

    def _publish_epoch(self, alive: List[int], dead: List[int]) -> int:
        t = self.op_timeout
        epoch = self.store.add(self._epoch_key(), 1, timeout=t)
        self.store.set(f"ft/{self.job_id}/members/{epoch}", json.dumps(alive),
                       timeout=t)
        self.store.set(f"ft/{self.job_id}/dead/{epoch}", json.dumps(dead),
                       timeout=t)
        flight_event("ft.epoch-bump", epoch=epoch, alive=alive, dead=dead)
        return epoch

    # -- consumers -----------------------------------------------------------

    def membership(self) -> Tuple[int, Optional[List[int]]]:
        """Latest published ``(epoch, alive_ranks)``; epoch 0 with full
        membership when the monitor has not declared anything yet."""
        epoch = self.store.add(self._epoch_key(), 0, timeout=self.op_timeout)
        if epoch == 0:
            return 0, list(range(self.nnodes))
        raw = self.store.get(f"ft/{self.job_id}/members/{epoch}",
                             timeout=self.op_timeout)
        return epoch, (json.loads(raw) if raw else None)

    def dead_from_epoch(self) -> List[int]:
        epoch = self.store.add(self._epoch_key(), 0, timeout=self.op_timeout)
        if epoch == 0:
            return []
        raw = self.store.get(f"ft/{self.job_id}/dead/{epoch}",
                             timeout=self.op_timeout)
        return json.loads(raw) if raw else []

    def wait_epoch(self, above: int = 0, timeout: float = 30.0) -> int:
        """Block until the membership epoch exceeds ``above``; returns it.
        Raises ``TimeoutError`` at the deadline — never hangs."""
        deadline = time.monotonic() + timeout
        while True:
            epoch = self.store.add(self._epoch_key(), 0,
                                   timeout=self.op_timeout)
            if epoch > above:
                return epoch
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"membership epoch stayed at {epoch} for {timeout}s "
                    f"(job {self.job_id!r})")
            time.sleep(min(0.05, self.interval))

    def sample_dead(self, wait_factor: float = 2.5, retries: int = 3) -> List[int]:
        """Double-sample lease counters across ``wait_factor * interval``
        seconds; peers whose lease did not advance are dead.  Blocking.
        ``[STORE_LOST]`` when the store itself is persistently unreachable."""
        for attempt in range(retries):
            try:
                before = self.counters()
                time.sleep(self.interval * wait_factor)
                after = self.counters()
            except Exception:
                if attempt == retries - 1:
                    return [STORE_LOST]
                time.sleep(self.interval)
                continue
            return [r for r in range(self.nnodes)
                    if r != self.rank and after[r] == before[r]]
        return [STORE_LOST]

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
