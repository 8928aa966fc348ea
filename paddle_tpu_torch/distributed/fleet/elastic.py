"""Checkpoint-based auto-resume (port of the single-process path of
``paddle_tpu/distributed/fleet/elastic.py``'s ``CheckpointManager``).

Usage (the loop a relaunched process can re-enter at any point)::

    step_fn = paddle_tpu_torch.jit.TrainStep(model, loss_fn, opt)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start = mgr.resume(step_fn)            # 0 on a fresh start
    for i in range(start, total_steps):
        loss = step_fn(*batch(i))
        if (i + 1) % save_every == 0:
            mgr.save(i + 1, step_fn)

One process: the JAX module's rank checks and barriers have nothing to
do here, and the reshard-on-resume after an elastic shrink (``peers``,
``prev_rank``), ``ElasticManager`` and ``migrate_to_mesh`` come with the
distributed slice.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
from typing import Optional

import torch

from ..checkpoint import CheckpointCorruptionError, load_state_dict, save_state_dict

__all__ = ["CheckpointManager"]

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
