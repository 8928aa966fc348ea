"""Elastic training (port of ``paddle_tpu/distributed/fleet/elastic.py``):
checkpoint-based auto-resume and the store-backed node heartbeat.

Usage (the loop a relaunched process can re-enter at any point)::

    step_fn = paddle_tpu_torch.jit.TrainStep(model, loss_fn, opt)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start = mgr.resume(step_fn)            # 0 on a fresh start
    for i in range(start, total_steps):
        loss = step_fn(*batch(i))
        if (i + 1) % save_every == 0:
            mgr.save(i + 1, step_fn)

The launcher (``python -m paddle_tpu_torch.distributed.launch``) relaunches
a dead training process (reference ``fleet/elastic/manager.py:125``
watch->relaunch, ``ELASTIC_EXIT_CODE=101``) and this module makes the
relaunch RESUME instead of restart.  :class:`ElasticManager` is the
failure-detection half: a heartbeat on the control store and a watch over
the peers' leases.

``CheckpointManager`` saves and resumes one process's state: the JAX
module's rank checks and barriers, and the reshard-on-resume after an
elastic shrink (``peers``, ``prev_rank``), come with meshes and
resharding, as does ``migrate_to_mesh``, which raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
from typing import Optional

import torch

from ..checkpoint import CheckpointCorruptionError, load_state_dict, save_state_dict

__all__ = ["CheckpointManager", "ElasticManager", "ELASTIC_EXIT_CODE", "migrate_to_mesh"]

# reference fleet/elastic/__init__.py:33
ELASTIC_EXIT_CODE = 101

_STEP_DIR = re.compile(r"^step_(\d+)$")
_MANIFEST = "metadata.pkl"


class CheckpointManager:
    """Step-numbered checkpoints under one directory, newest-wins resume.

    Each save lands in ``<root>/step_<N>``; the checkpoint's own atomically-
    committed ``metadata.pkl`` is the completion marker, so a save killed
    mid-write is invisible to :meth:`resume`.  ``keep`` complete checkpoints
    are retained (older ones pruned after a successful save) so resume can
    fall back if the newest fails to read.
    """

    def __init__(self, root: str, keep: int = 2):
        self.root = root
        self.keep = max(1, int(keep))
        self._last_async = None
        self._async_step = None
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def complete_steps(self):
        """Step numbers with a committed manifest, ascending."""
        steps = []
        for fn in os.listdir(self.root):
            m = _STEP_DIR.match(fn)
            if m and os.path.exists(os.path.join(self.root, fn, _MANIFEST)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _state_of(target):
        """TrainStep -> its state dict; plain dicts pass through."""
        if hasattr(target, "state_dict") and not isinstance(target, dict):
            return target.state_dict()
        return target

    def save(self, step: int, target, async_save: bool = False):
        """Save ``target`` (a ``jit.TrainStep`` or a state dict) as step
        ``step``; with ``async_save`` the files are written in the
        background and the ``Future`` is returned (the next save settles
        it first)."""
        if self._last_async is not None:
            prev_fut = self._last_async
            self._last_async = None
            prev_fut.result()
            self._prune(self._async_step)
        fut = save_state_dict(self._state_of(target), self._dir(step), async_save=async_save)
        if async_save:
            self._last_async = fut
            self._async_step = step
        else:
            self._prune(step)
        return fut

    def _prune(self, new_step: int):
        """GC old checkpoints — but ONLY once the new step's manifest is
        fully committed: a save that crashed before commit must never
        trigger deletion of the checkpoints resume would fall back to."""
        steps = self.complete_steps()
        if new_step not in steps:
            return  # commit didn't land: keep everything loadable
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
        for fn in os.listdir(self.root):
            # orphaned staging dirs from saves that died pre-commit;
            # anything at or below the newest complete step is garbage
            if fn.endswith(".saving"):
                m = _STEP_DIR.match(fn[:-len(".saving")])
                if m and int(m.group(1)) <= steps[-1]:
                    shutil.rmtree(os.path.join(self.root, fn), ignore_errors=True)

    def _quarantine(self, step: int) -> None:
        """Move a CRC-corrupt step OUT of the resume scan, kept on disk as
        ``step_N.corrupt`` for post-mortem, never re-considered."""
        src = self._dir(step)
        try:
            os.rename(src, src + ".corrupt")
            print(f"[elastic] quarantined corrupt checkpoint {os.path.basename(src)} -> "
                  ".corrupt", file=sys.stderr)
        except OSError:
            pass  # another process already moved it

    @staticmethod
    def _scratch(d):
        """A host tensor for every leaf of ``d`` (its shape and dtype), the
        dict structure copied: a load lands here first, so one that dies
        midway leaves the target as it was."""
        return {k: CheckpointManager._scratch(v) if isinstance(v, dict) else
                torch.empty(tuple(v.shape), dtype=v.dtype) if isinstance(v, torch.Tensor) else v
                for k, v in d.items()}

    @staticmethod
    @torch.no_grad()
    def _write_back(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                CheckpointManager._write_back(dst[k], v)
            elif isinstance(dst.get(k), torch.Tensor):
                dst[k].copy_(v)
            else:
                dst[k] = v
        return dst

    def resume(self, target) -> int:
        """Load the newest readable checkpoint into ``target`` (a
        ``jit.TrainStep``, through its ``set_state_dict``, or a state dict,
        whose tensors are overwritten in place).

        Returns the step to continue from (0 if no checkpoint).  A checkpoint
        that fails to read falls back to the previous one, and a corrupt one
        (CRC) is quarantined.  The target is only written after a load fully
        succeeds."""
        for step in reversed(self.complete_steps()):
            work = self._scratch(self._state_of(target))
            try:
                load_state_dict(work, self._dir(step))
            except Exception as e:  # fall back to an older complete save
                print(f"[elastic] checkpoint step {step} unreadable ({e}); falling back",
                      file=sys.stderr)
                if isinstance(e, CheckpointCorruptionError):
                    self._quarantine(step)
                continue
            if isinstance(target, dict) or not hasattr(target, "set_state_dict"):
                self._write_back(target, work)
            else:
                target.set_state_dict(work)
            return step
        return 0


def migrate_to_mesh(target, dst_mesh):
    """Live-state migration onto another device mesh after a graceful
    shrink: needs the port's meshes and resharding, which it does not have
    yet."""
    raise NotImplementedError(
        "migrate_to_mesh needs device meshes and the resharding planner, which the "
        "port does not have yet; resume from a checkpoint instead")


class ElasticManager:
    """Store-backed node heartbeat + membership watch — the failure-DETECTION
    half of elastic training (reference ``fleet/elastic/manager.py:125``:
    etcd node registry + heartbeats + membership watch; here the native
    ``TCPStore`` plays etcd's role).

    Detection is delegated to the fault-tolerance
    :class:`~paddle_tpu_torch.distributed.fault_tolerance.HeartbeatFailureDetector`:
    lease counters are MONOTONIC, not timestamps — a counter that did not
    advance is a dead (or wedged) peer; no cross-host clock comparison
    anywhere.  On rank 0 the detector's monitor also publishes membership
    epochs that the rendezvous layer consumes for graceful mesh shrink.

    Usage on every node::

        mgr = ElasticManager(store, rank, nnodes)   # store from rendezvous
        mgr.start()
        ...
        if mgr.dead_peers():          # or mgr.watch(on_dead=...) in a thread
            sys.exit(ELASTIC_EXIT_CODE)   # relauncher re-rendezvous + resume
    """

    def __init__(self, store, rank: int, nnodes: int, job_id: str = "default",
                 interval: Optional[float] = None):
        from ..fault_tolerance.detector import HeartbeatFailureDetector

        self.store = store
        self.rank = int(rank)
        self.nnodes = int(nnodes)
        self.job_id = job_id
        # None defers to the validated FLAGS_ft_heartbeat_interval surface
        # (fault_tolerance.policy.heartbeat_config)
        self.detector = HeartbeatFailureDetector(
            store, self.rank, self.nnodes, job_id=job_id, interval=interval)
        self.interval = self.detector.interval
        self._stop = None

    #: pseudo-rank reported when the STORE itself (the coordinator node) is
    #: unreachable — also a membership loss, needing re-rendezvous
    STORE_LOST = -1

    def start(self):
        """Begin renewing this node's lease (daemon thread; rank 0 also runs
        the membership monitor)."""
        self._stop = self.detector.start()._stop
        return self

    def counters(self):
        """Current heartbeat counter per rank (0 = never beat)."""
        return self.detector.counters()

    def membership(self):
        """Latest published ``(epoch, alive_ranks)`` from the rank-0
        monitor (epoch 0 = nothing declared yet)."""
        return self.detector.membership()

    def dead_peers(self, wait_factor: float = 2.5, _retries: int = 3):
        """Ranks whose counter did not advance across ``wait_factor *
        interval`` seconds (a beat interval plus slack).  Blocking.
        ``[STORE_LOST]`` when the store itself is persistently unreachable
        (the coordinator node died — the membership is lost wholesale)."""
        return self.detector.sample_dead(wait_factor, retries=_retries)

    def watch(self, on_dead, poll_factor: float = 2.5):
        """Loop until dead peers appear (or the store is lost —
        ``[STORE_LOST]``), then call ``on_dead(ranks)`` and return them (run
        in a thread for background monitoring).  Never raises out of a
        monitoring thread."""
        while not (self._stop and self._stop.is_set()):
            try:
                dead = self.dead_peers(poll_factor)
            except Exception:
                dead = [self.STORE_LOST]
            if dead:
                on_dead(dead)
                return dead
        return []

    def stop(self):
        self.detector.stop()
        self._stop = self.detector._stop
