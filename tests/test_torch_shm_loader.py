"""The port's DataLoader worker processes (``paddle_tpu_torch.io`` and
``io/shm_loader.py`` over ``core/csrc/shm_channel.cc``) against the JAX
package's: the shared-memory frame byte for byte, the channel, and the
batches of spawned workers against the JAX package's batches.

The datasets the workers unpickle live in ``torch_worker_data``, which
imports neither ``jax`` nor ``paddle_tpu``: a worker pays only for the
port's import.  Pools are few (each spawn costs a torch import), so the
persistent-worker tests share one loader."""

import os
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.io as jio
from paddle_tpu.io import shm_loader as jshm
import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.framework.tensor import Tensor
from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler, get_worker_info
from paddle_tpu_torch.io import shm_loader
from torch_worker_data import (ArrayDS, BoomDS, DictDS, InfoDS, SlowDS, low_priority,
                               mark_init, pid_collate)


@pytest.fixture(scope="module", autouse=True)
def _spawn_at_low_priority():
    with low_priority():
        yield


@pytest.fixture(autouse=True)
def _cpu():
    prev = tp_device._CURRENT
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _np(x):
    return np.asarray(x._data)


def _leaves(batch):
    if isinstance(batch, dict):
        return [v for k in sorted(batch) for v in _leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [v for b in batch for v in _leaves(b)]
    return [batch]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert isinstance(a, Tensor)
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


NESTED = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
          "b": [np.int64(7), "txt", np.arange(5, dtype=np.int32)[::2]],
          "c": (np.ones((2, 2), np.float16), b"raw")}


@pytest.mark.parametrize("prefix", [b"", b"\x03\x00\x00\x00"], ids=["plain", "epoch-tag"])
def test_frame_has_the_jax_bytes_and_each_decodes_the_other(prefix):
    mine, theirs = shm_loader._serialize(NESTED, prefix), jshm._serialize(NESTED, prefix)
    assert bytes(mine) == bytes(theirs)
    n = len(prefix)
    for frame, decode in ((mine, jshm._deserialize), (theirs, shm_loader._deserialize)):
        out = decode(memoryview(bytes(frame))[n:])
        np.testing.assert_array_equal(out["a"], NESTED["a"])
        assert out["b"][:2] == [7, "txt"]
        np.testing.assert_array_equal(out["b"][2], NESTED["b"][2])
        assert out["c"][1] == b"raw" and out["c"][0].dtype == np.float16


def test_channel_carries_a_record_to_the_jax_reader():
    ch = shm_loader._Channel(f"/pt_test_port_{os.getpid()}", slots=2, slot_bytes=1 << 16,
                             create=True)
    reader = jshm._Channel(ch.name)
    try:
        ch.send(shm_loader._serialize(NESTED))
        out = jshm._deserialize(memoryview(reader.recv(timeout_ms=1000)))
        np.testing.assert_array_equal(out["a"], NESTED["a"])
        assert ch.recv(timeout_ms=50) is None       # empty: a timeout
        ch.mark_closed()
        assert ch.recv(timeout_ms=50) == b""        # closed and drained
    finally:
        reader.close()
        ch.close()


def test_oversized_record_refused():
    ch = shm_loader._Channel(f"/pt_test_big_{os.getpid()}", slots=2, slot_bytes=64,
                             create=True)
    try:
        with pytest.raises(ValueError, match="shm_slot_bytes"):
            ch.send(b"x" * 1000)
    finally:
        ch.close()


@pytest.mark.parametrize("sampling", ["unshuffled", "distributed"])
def test_workers_give_the_jax_batches(sampling):
    paddle.seed(7)
    jpaddle.seed(7)
    ds = ArrayDS(37)
    if sampling == "unshuffled":
        mine = DataLoader(ds, batch_size=5, num_workers=2)
        ref = jio.DataLoader(ds, batch_size=5, num_workers=0)
    else:
        mine = DataLoader(ds, num_workers=2, batch_sampler=DistributedBatchSampler(
            ds, batch_size=4, num_replicas=2, rank=1, shuffle=True))
        ref = jio.DataLoader(ds, batch_sampler=jio.DistributedBatchSampler(
            ds, batch_size=4, num_replicas=2, rank=1, shuffle=True))
    got = list(mine)
    _assert_same_batches(got, list(ref))
    # the same batches as the port's own in-process path
    _assert_same_batches(got, list(DataLoader(ds, batch_sampler=mine.batch_sampler)))


def test_dict_batches():
    got = list(DataLoader(DictDS(), batch_size=4, num_workers=2))
    _assert_same_batches(got, list(jio.DataLoader(DictDS(), batch_size=4)))
    np.testing.assert_array_equal(_np(got[0]["meta"][1]), [0, 2, 4, 6])


def test_custom_collate_runs_on_the_trainer():
    got = list(DataLoader(ArrayDS(12), batch_size=4, num_workers=2, collate_fn=pid_collate))
    assert [pid for pid, _ in got] == [os.getpid()] * 3
    np.testing.assert_array_equal(np.concatenate([x[:, 0, 0] for _, x in got]), np.arange(12))


def test_worker_exception_surfaces():
    with pytest.raises(RuntimeError, match="worker 0 died"):
        list(DataLoader(BoomDS(), batch_size=2, num_workers=1))


def test_unpicklable_dataset_falls_back_to_the_thread_with_a_warning():
    class Local(ArrayDS):           # defined in a function: a worker cannot import it
        pass

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = list(DataLoader(Local(12), batch_size=4, num_workers=2))
    assert any("picklable" in str(x.message) for x in w)
    _assert_same_batches(got, list(jio.DataLoader(ArrayDS(12), batch_size=4)))


def test_timeout_names_the_stalled_worker():
    """Every sample takes 2 s; the 1 s limit (which runs from the first
    wait, so it covers the workers' start too) fires on batch 0 and the
    pool is torn down."""
    t0 = time.monotonic()
    dl = DataLoader(SlowDS(delay=2.0), batch_size=1, num_workers=1, timeout=1.0)
    with pytest.raises(TimeoutError, match="worker 0 stalled on batch 0"):
        list(dl)
    assert time.monotonic() - t0 < 30.0


@pytest.fixture(scope="module")
def info_loader():
    """One persistent pool over ``InfoDS`` (12 samples, batches of 3, two
    workers, an init hook), shared by the persistent-worker tests."""
    paddle.seed(5)
    dl = DataLoader(InfoDS(), batch_size=3, num_workers=2, worker_init_fn=mark_init,
                    persistent_workers=True)
    yield dl
    if dl._shm_pool is not None:
        dl._shm_pool.shutdown()


def _rows(dl):
    return np.concatenate([_np(b) for b in dl])


def test_worker_info_and_init_fn(info_loader):
    rows = _rows(info_loader)
    idx, wid, nw, seed, pid, init, cuda = rows.T
    np.testing.assert_array_equal(idx, np.arange(12))
    np.testing.assert_array_equal(wid, (np.arange(12) // 3) % 2)   # batch b from worker b % 2
    assert (nw == 2).all() and (seed == 5 + wid).all()
    assert (init == wid).all()                                     # the hook ran first
    assert not cuda.any()                                          # CUDA never initialised
    assert len(set(pid)) == 2 and os.getpid() not in set(pid)
    assert get_worker_info() is None                               # the trainer is no worker
    assert not torch.cuda.is_initialized()


def test_persistent_workers_keep_their_pool_over_epochs(info_loader):
    epochs = [_rows(info_loader) for _ in range(3)]
    pool = info_loader._shm_pool
    assert pool is not None and all(p.is_alive() for p in pool.procs)
    for rows in epochs:
        np.testing.assert_array_equal(rows, epochs[0])             # the same workers each epoch


def test_abandoned_epoch_does_not_bleed_into_the_next(info_loader):
    pool = info_loader._shm_pool
    it = iter(info_loader)
    next(it)                        # one batch, then the epoch is abandoned
    time.sleep(0.3)                 # the workers go on with the old plan meanwhile
    np.testing.assert_array_equal(_rows(info_loader)[:, 0], np.arange(12))
    del it                          # closing the abandoned epoch keeps the pool
    np.testing.assert_array_equal(_rows(info_loader)[:, 0], np.arange(12))
    assert info_loader._shm_pool is pool


def test_pool_error_resets_for_the_next_epoch():
    dl = DataLoader(BoomDS(), batch_size=2, num_workers=1, persistent_workers=True)
    with pytest.raises(RuntimeError, match="worker"):
        list(dl)
    assert dl._shm_pool is None     # the failed pool is dropped, not reused
