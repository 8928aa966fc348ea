"""Datasets and hooks that the DataLoader tests hand to spawned worker
processes.  A worker imports this module to unpickle them, so it imports
neither ``jax`` nor ``paddle_tpu``: a worker pays only for the port's own
import."""

import contextlib
import os
import time

import numpy as np


@contextlib.contextmanager
def low_priority(step=10):
    """Lower this process's CPU priority (the workers it spawns inherit it)
    for the block: each worker's start is a torch import, seconds of CPU,
    which should not starve the timing-sensitive tests of a parallel run.
    Where the priority cannot be lowered the block runs as it is."""
    before = os.getpriority(os.PRIO_PROCESS, 0)
    try:
        os.setpriority(os.PRIO_PROCESS, 0, min(before + step, 19))
    except OSError:
        yield
        return
    try:
        yield
    finally:
        with contextlib.suppress(OSError):      # raising it back needs CAP_SYS_NICE
            os.setpriority(os.PRIO_PROCESS, 0, before)


class ArrayDS:
    """Sample i: an 8 x 8 float32 block of i and the label i."""

    def __init__(self, n=37):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((8, 8), i, np.float32), np.int64(i)


class DictDS:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.full((4,), i, np.float32), "meta": [np.int64(i), np.int64(2 * i)]}


class BoomDS:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros((2,), np.float32)


class SlowDS:
    """Every sample takes ``delay`` seconds."""

    def __init__(self, delay):
        self.delay = delay

    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(self.delay)
        return np.full((2,), i, np.float32)


class InfoDS:
    """Each sample records the worker that made it: (index, worker id,
    number of workers, worker seed, pid, whether the worker's init hook ran,
    whether CUDA was initialised)."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        import torch

        from paddle_tpu_torch.io import get_worker_info

        info = get_worker_info()
        return np.array([i, info.id, info.num_workers, info.seed, os.getpid(),
                         int(os.environ.get("TORCH_DATA_INIT_RAN", "-1")),
                         int(torch.cuda.is_initialized())], np.int64)


def mark_init(worker_id):
    """``worker_init_fn``: leaves its argument where ``InfoDS`` reads it."""
    os.environ["TORCH_DATA_INIT_RAN"] = str(worker_id)


def pid_collate(samples):
    """A custom collate: runs on the trainer, over the workers' samples, and
    says in which process it ran."""
    return os.getpid(), np.stack([s[0] for s in samples])


class Squares:
    """Sample i: ([i], [i * i]) in float32."""

    def __init__(self, n=20):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.float32([i]), np.float32([i * i])
