"""Fault tolerance for the host control plane: detect, bound, recover, inject.

Failure model (what this subsystem defends against)
---------------------------------------------------

**Fail-stop nodes.**  A worker host either works or is gone (preemption,
crash, kernel panic); Byzantine behavior is out of scope.  A *wedged*
process — alive but not making progress — is folded into fail-stop: its
heartbeat lease stops advancing and it is treated exactly like a crash
(the reference's ``fleet/elastic/manager.py`` makes the same reduction:
its etcd watcher only distinguishes "heartbeat present" from "absent").

**Detection latency.**  Failures are detected by lease expiry
(:class:`~paddle_tpu_torch.distributed.fault_tolerance.detector.HeartbeatFailureDetector`):
each node renews a monotonic lease counter on the control store every
``interval`` seconds, and the rank-0 monitor declares a node dead after
``ttl`` (default ``3 * interval``) seconds without an observed renewal,
then publishes a bumped *membership epoch*.  Worst-case detection latency
is therefore ``ttl + interval`` (one full monitor sweep after expiry);
with the reference-like defaults (5 s interval) that is ~20 s.  Liveness
judgments compare counter advances observed on one clock — cross-host
timestamps are never compared.

**Bounded control-plane calls.**  Every host-side control operation is
governed by a deadline + exponential-backoff-with-jitter policy
(:mod:`.policy`): store round-trips honor the socket timeout and
reconnect-on-drop, ``rendezvous()`` raises ``TimeoutError`` naming the
missing ranks instead of waiting forever on a short generation, and store
barriers report how many peers arrived when they fail.  Nothing in the
control plane can hang unboundedly.

Recovery paths
--------------

1. **Peer death, store alive** — survivable rendezvous: the current
   generation is invalidated on the store and survivors re-rendezvous at
   the reduced node count (graceful mesh shrink,
   :func:`~paddle_tpu_torch.distributed.launch.rendezvous.shrink_rendezvous`),
   resuming from the last complete checkpoint.  The reference instead
   restarts the whole job through its relauncher; shrink keeps the
   surviving capacity training.
2. **Store (coordinator host) death** — membership is lost wholesale; the
   detector reports ``STORE_LOST`` and the launcher exits with
   ``ELASTIC_EXIT_CODE`` (101) so an outer supervisor re-rendezvouses the
   job, exactly the reference's relaunch semantics.
3. **Checkpoint corruption** — every shard chunk carries a CRC32 in the
   manifest; a save commits atomically (temp dir, manifest written last,
   rename last); ``CheckpointManager.resume`` verifies on load, QUARANTINES
   a corrupt step directory and falls back to the newest intact step.

Determinism
-----------

Chaos testing is first-class: :mod:`.injection` simulates worker crashes
at a chosen step, dropped/slowed store connections, and bit-flipped
checkpoint shards — all driven by ``FLAGS_ft_inject_*`` flags and seeded
RNG streams so every chaos run replays identically.
"""

from .detector import STORE_LOST, HeartbeatFailureDetector  # noqa: F401
from .injection import FaultInjector, get_injector, set_injector  # noqa: F401
from .policy import (Deadline, HeartbeatConfig, RetryPolicy,  # noqa: F401
                     heartbeat_config, retry_call)

__all__ = [
    "Deadline", "FaultInjector", "HeartbeatConfig", "HeartbeatFailureDetector",
    "RetryPolicy", "STORE_LOST", "get_injector", "guard_host_collectives",
    "heartbeat_config", "retry_call", "set_injector",
]


def guard_host_collectives(timeout: float = 300.0) -> None:
    """Arm the collective watchdog for every host-level collective (barrier,
    allreduce-object, broadcast-object): a collective stuck past ``timeout``
    dumps where each rank is waiting instead of hanging silently.  One call
    wires the fault-tolerance deadline discipline into the communication
    layer."""
    from ..watchdog import set_default_timeout

    set_default_timeout(timeout)
