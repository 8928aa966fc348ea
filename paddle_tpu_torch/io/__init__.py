"""``paddle_tpu_torch.io``: datasets, samplers and the DataLoader (port of
``paddle_tpu/io/__init__.py``).

The samplers draw from numpy exactly as the JAX package's do (seeded from
the ``paddle_tpu_torch.seed`` value, and ``RandomSampler`` from the
sampler's identity as there), so a seeded ``DistributedBatchSampler`` or
``random_split`` gives the JAX package's order.  ``default_collate_fn``
stacks Tensor samples on their device and numpy ones on the host (then the
JAX conversion policy).  With ``num_workers > 0`` batches are made by a
background thread; the JAX package's shared-memory worker processes
(``io/shm_loader.py``) wait for a later slice, and the options that only
they honour (``worker_init_fn``, ``timeout``, ``shm_slot_bytes``) raise
``NotImplementedError`` with ``num_workers > 0``.
"""

from __future__ import annotations

import bisect
import itertools
import math
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..framework import random as rnd
from ..framework.tensor import Tensor

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset", "ChainDataset",
    "Subset", "ConcatDataset", "random_split", "BatchSampler", "Sampler", "SequenceSampler",
    "RandomSampler", "SubsetRandomSampler", "WeightedRandomSampler",
    "DistributedBatchSampler", "DataLoader", "default_collate_fn", "get_worker_info",
    "batch",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence[Tensor]):
        self.tensors = tensors
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list)) else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumsum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumsum, idx)
        prev = self.cumsum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(n, float) for n in lengths) and abs(sum(lengths) - 1.0) < 1e-6:
        n = len(dataset)
        sizes = [int(math.floor(n * f)) for f in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    total = sum(lengths)
    perm = np.random.RandomState(rnd.initial_seed()).permutation(total).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


def _sampler_rng(sampler) -> np.random.RandomState:
    return np.random.RandomState(abs(hash((rnd.initial_seed(), id(sampler)))) % (2 ** 31))


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _sampler_rng(self)
        if self.replacement:
            return iter(rng.randint(0, n, size=self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """The given indices in a random order, without replacement."""

    def __init__(self, indices):
        if len(indices) == 0:
            raise ValueError("indices of SubsetRandomSampler should not be empty")
        self.indices = list(indices)

    def __iter__(self):
        rng = _sampler_rng(self)
        return iter(np.asarray(self.indices, dtype=np.int64)[
            rng.permutation(len(self.indices))].tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(_sampler_rng(self).choice(len(self.weights), size=self.num_samples,
                                              replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the (optionally shuffled, per ``set_epoch``)
    indices, padded to equal shares; the world from ``torch.distributed``
    when it is initialised, else one rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.RandomState(self.epoch + rnd.initial_seed()).shuffle(indices)
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def get_worker_info():
    """None: the port makes every batch in this process (on one thread with
    ``num_workers > 0``), never in a worker process."""
    return None


def default_collate_fn(batch):
    """Stack a list of samples leaf by leaf: Tensors on their device, numpy
    arrays and numbers on the host and then into Tensors; dicts, lists and
    tuples by structure (a tuple comes back as a list, as the JAX
    package's), strings as lists."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([s._data for s in batch]))
    if isinstance(sample, torch.Tensor):
        return Tensor._wrap(torch.stack(list(batch)))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return Tensor(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([b[i] for b in batch]) for i in range(len(sample))]
    return batch


class DataLoader:
    """Batches of ``dataset`` through ``batch_sampler`` (else a
    ``BatchSampler`` of ``batch_size``, ``shuffle``, ``drop_last``) and
    ``collate_fn``; an ``IterableDataset`` is batched as it streams."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, shm_slot_bytes: Optional[int] = None):
        if num_workers > 0 and (worker_init_fn is not None or timeout
                                or shm_slot_bytes is not None):
            raise NotImplementedError(
                "DataLoader: worker processes are not ported (num_workers > 0 prefetches "
                "on one thread), so worker_init_fn, timeout and shm_slot_bytes are not "
                "taken")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def _iter_batches(self):
        if self._iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._iter_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor * max(self.num_workers, 1))
        sentinel = object()
        failure = []

        def producer():
            try:
                for b in self._iter_batches():
                    q.put(b)
            except BaseException as e:  # handed to the consumer, raised there
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if failure:
            raise failure[0]


def batch(reader, batch_size, drop_last=False):
    """Reader decorator (reference ``paddle.batch``): a zero-argument sample
    reader becomes a batch reader."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched
