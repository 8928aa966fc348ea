"""DataLoader worker processes over the native shared-memory channel
(port of ``paddle_tpu/io/shm_loader.py``).

Counterpart of the reference's C++ dataloader core: its
``use_shared_memory=True`` path moves batch tensors between worker processes
and the trainer through shared-memory segments instead of pickling them over
multiprocessing pipes (``python/paddle/io/dataloader/dataloader_iter.py:368``
multi-process iterator + the fluid shared-memory allocator).

Here: ``num_workers`` spawned processes each own one ring channel
(``core/csrc/shm_channel.cc``).  Worker ``w`` produces batch indices
``w, w+W, ...``; the consumer reads channels round-robin, preserving batch
order.  Batches are serialized with pickle protocol 5 — array bodies travel
as out-of-band buffers, so the bulk bytes take exactly two memcpys (worker →
shm → trainer) and are never pickled.  The frame is byte for byte the JAX
package's, so either side decodes the other's.

Workers produce NUMPY and never initialise CUDA; the trainer-side iterator
wraps the leaves as Tensors on the default device.  Workers do not watch
for their trainer's death (as in the JAX package): a trainer killed without
cleanup leaves its workers and its ``/dev/shm/pt_dl*`` segments behind.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import threading
import time
from typing import List, Optional

from ..core import native

__all__ = ["ShmWorkerPool", "available"]


def available() -> bool:
    """True when the native library builds and loads."""
    return native.available()


def _serialize(obj, prefix: bytes = b"") -> bytearray:
    """Frame = [prefix] u32 body_len | pickle5 body | u32 nbufs |
    (u64 len | bytes)*.

    Array bodies travel as out-of-band PickleBuffers copied ONCE into the
    preallocated frame (the channel then copies frame -> shm -> trainer:
    three bulk copies total, vs pickle-over-pipe's pickle + chunked writes +
    reads).  ``prefix`` (e.g. the persistent-mode epoch tag) is packed into
    the same frame — no extra whole-frame copy."""
    bufs: List[pickle.PickleBuffer] = []
    body = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]  # contiguous by PEP 574 contract
    p = len(prefix)
    total = p + 4 + len(body) + 4 + sum(8 + r.nbytes for r in raws)
    frame = bytearray(total)
    mv = memoryview(frame)
    mv[0:p] = prefix
    struct.pack_into("<I", frame, p, len(body))
    mv[p + 4:p + 4 + len(body)] = body
    off = p + 4 + len(body)
    struct.pack_into("<I", frame, off, len(raws))
    off += 4
    for r in raws:
        struct.pack_into("<Q", frame, off, r.nbytes)
        off += 8
        mv[off:off + r.nbytes] = r.cast("B")
        off += r.nbytes
    return frame  # bytearray: _Channel.send passes it zero-copy via ctypes


def _deserialize(data: memoryview):
    (nbody,) = struct.unpack_from("<I", data, 0)
    body = data[4:4 + nbody]
    off = 4 + nbody
    (nbufs,) = struct.unpack_from("<I", data, off)
    off += 4
    bufs = []
    for _ in range(nbufs):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        bufs.append(data[off:off + blen])
        off += blen
    return pickle.loads(body, buffers=bufs)


class _Channel:
    """ctypes wrapper over one shm ring (owner = consumer side)."""

    def __init__(self, name: str, slots: int = 0, slot_bytes: int = 0,
                 create: bool = False):
        self._lib = native.load()
        if create:
            self._h = self._lib.ptc_create(name.encode(), slots, slot_bytes)
        else:
            self._h = self._lib.ptc_open(name.encode())
        if not self._h:
            raise OSError(f"shm channel {name} {'create' if create else 'open'} failed")
        self.name = name

    def send(self, payload, timeout_ms: int = 60000, retry_forever: bool = False) -> None:
        """``payload``: bytes or bytearray (bytearray passes zero-copy).

        ``retry_forever``: keep waiting through full-ring timeouts (worker
        side — a paused trainer, e.g. saving a checkpoint, must not kill its
        workers); channel closure still exits."""
        if isinstance(payload, bytearray):
            buf = (ctypes.c_char * len(payload)).from_buffer(payload)
        else:
            buf = payload
        while True:
            rc = self._lib.ptc_send(self._h, buf, len(payload), timeout_ms)
            if rc == 2:
                raise ValueError(
                    f"batch of {len(payload)} bytes exceeds the shm slot size "
                    f"({self._lib.ptc_slot_bytes(self._h)}); raise DataLoader's "
                    "shm_slot_bytes")
            if rc == 3:
                raise BrokenPipeError("channel closed")
            if rc == 0:
                return
            if not retry_forever:
                raise TimeoutError("shm send timed out (consumer stalled?)")

    def recv(self, timeout_ms: int = 100) -> Optional[bytes]:
        """One record; None on timeout; b'' means closed-and-drained.

        Waits via ptc_wait_nonempty first, so no receive buffer is allocated
        on empty polls."""
        rc = self._lib.ptc_wait_nonempty(self._h, timeout_ms)
        if rc == 1:
            return None
        if rc == 2:
            return b""
        n = self._lib.ptc_next_len(self._h)
        cap = n if n > 0 else self._lib.ptc_slot_bytes(self._h)
        buf = ctypes.create_string_buffer(int(cap) or 1)
        got = self._lib.ptc_recv(self._h, buf, cap, timeout_ms)
        if got == -1:
            return None
        if got == 0:
            return b""
        if got < 0:
            raise RuntimeError(f"shm recv error {got}")
        return buf.raw[:got]

    def mark_closed(self):
        self._lib.ptc_mark_closed(self._h)

    def close(self):
        if self._h:
            self._lib.ptc_close(self._h)
            self._h = None


def _ctrl_has_pending(ctrl) -> bool:
    """True when the control channel holds an unread record (a newer epoch
    plan): producers abandon the current epoch instead of finishing it."""
    return ctrl._lib.ptc_next_len(ctrl._h) > 0


def _worker_main(channel_name: str, spec_bytes: bytes, control_name=None):
    """Spawned worker entry (module-level so 'spawn' can import it: forking a
    parent that has initialised CUDA or runs threads risks deadlock on
    inherited locks, so workers are FRESH interpreters — the dataset must be
    picklable, the same contract as the reference's / torch's spawn workers).
    ``get_worker_info()`` answers inside the worker from its spec.

    With ``control_name`` (persistent_workers): instead of one baked batch
    plan, the worker LOOPS — each epoch's plan arrives as a pickled record
    on the control channel; closing the control channel shuts it down."""
    spec = pickle.loads(spec_bytes)
    ch = _Channel(channel_name)
    ctrl = _Channel(control_name) if control_name else None
    try:
        from . import _set_worker_info

        _set_worker_info(spec["worker_id"], spec["num_workers"], spec["seed"],
                         spec["dataset"])
        if spec["worker_init_fn"] is not None:
            spec["worker_init_fn"](spec["worker_id"])
        dataset = spec["dataset"]
        collate = spec["collate"]

        def produce(batches, n_batches, epoch_tag=b"", cancel_check=None):
            for b in range(spec["worker_id"], n_batches, spec["num_workers"]):
                if cancel_check is not None and cancel_check():
                    return  # a new plan is pending: abandon this epoch
                samples = [dataset[i] for i in batches[b]]
                obj = collate(samples) if collate is not None else samples
                # retry_forever: a trainer paused past the timeout (checkpoint
                # save, eval, long compile) must not kill its workers
                ch.send(_serialize(obj, prefix=epoch_tag), timeout_ms=60000,
                        retry_forever=True)

        def recv_plan():
            """Chunked plan protocol: each chunk is pickled
            (epoch, n_chunks, idx, bytes); returns (epoch, plan) or None on
            shutdown.  The EPOCH travels in the record, so worker and
            consumer can never disagree about numbering."""
            parts = {}
            want = None
            epoch = None
            while True:
                rec = ctrl.recv(timeout_ms=1000)
                if rec == b"":
                    return None
                if rec is None:
                    if want is None:
                        return ()   # nothing pending yet
                    continue        # mid-plan: keep collecting
                e, n, i, blob = pickle.loads(rec)
                if epoch is not None and e != epoch:
                    parts = {}
                epoch, want = e, n
                parts[i] = blob
                if len(parts) == want:
                    plan = pickle.loads(b"".join(parts[i] for i in range(want)))
                    return epoch, plan

        if ctrl is None:
            produce(spec["batches"], spec["n_batches"])
            ch.mark_closed()
        else:
            while True:
                got = recv_plan()
                if got is None:     # control closed: orderly shutdown
                    break
                if got == ():
                    continue
                epoch, plan = got
                produce(plan, len(plan), epoch_tag=struct.pack("<I", epoch),
                        cancel_check=lambda: _ctrl_has_pending(ctrl))
    except BrokenPipeError:
        pass  # consumer tore the pool down early
    finally:
        ch.close()


class ShmWorkerPool:
    """Spawn ``num_workers`` producer processes over a map-style dataset.

    Worker ``w`` produces batch indices ``w, w+W, ...`` with ``collate``
    (numpy-producing) applied in the worker; iterate with :meth:`__iter__`,
    order matches batch index order.
    """

    def __init__(self, dataset, batches: List, collate, num_workers: int,
                 slots: int = 4, slot_bytes: int = 8 << 20,
                 worker_init_fn=None, timeout: float = 120.0,
                 persistent: bool = False, seed: int = 0):
        import multiprocessing as mp

        self.n_batches = len(batches) if batches is not None else 0
        self.num_workers = num_workers
        self.timeout = timeout
        self.persistent = persistent
        self._epoch = 0   # bumped by submit_epoch; 0 = no plan submitted yet
        uid = f"{os.getpid()}_{id(self):x}"
        self.channels = []
        self.controls = []
        self.procs = []
        try:
            self.channels = [
                _Channel(f"/pt_dl_{uid}_{w}", slots=slots,
                         slot_bytes=slot_bytes, create=True)
                for w in range(num_workers)
            ]
            if persistent:
                # small control ring per worker: per-epoch batch plans
                self.controls = [
                    _Channel(f"/pt_dlc_{uid}_{w}", slots=2,
                             slot_bytes=4 << 20, create=True)
                    for w in range(num_workers)
                ]
            ctx = mp.get_context("spawn")
            procs = []
            for w in range(num_workers):
                spec = pickle.dumps({
                    "dataset": dataset,
                    "batches": batches if not persistent else None,
                    "collate": collate,
                    "worker_id": w, "num_workers": num_workers, "seed": seed + w,
                    "n_batches": self.n_batches,
                    "worker_init_fn": worker_init_fn, "timeout": timeout,
                })
                args = (self.channels[w].name, spec)
                if persistent:
                    args += (self.controls[w].name,)
                procs.append(ctx.Process(target=_worker_main, args=args, daemon=True))
            self._start(procs)
        except BaseException:
            # half-built pool: release shm segments + any started workers,
            # or every failed epoch would leak named /dev/shm segments
            self.shutdown()
            raise

    def _start(self, procs) -> None:
        """Start every worker at once.  A spawn ``start()`` returns only once
        the child has read its arguments past the pipe's buffer, which it
        does after importing this module (and torch): one at a time, the
        workers' starts would add up."""
        errors = []

        def start(p):
            try:
                p.start()
            except BaseException as e:  # raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=start, args=(p,), daemon=True) for p in procs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.procs = [p for p in procs if p.pid is not None]
        if errors:
            raise errors[0]

    def submit_epoch(self, batches: List) -> None:
        """Persistent mode: ship this epoch's batch plan to every worker.

        Any records left over from an ABANDONED previous epoch (consumer
        broke out of the iterator early) are drained first, so epochs can
        never bleed into each other."""
        if not self.persistent:
            raise RuntimeError("submit_epoch needs persistent=True")
        if not self.channels:
            raise RuntimeError(
                "persistent worker pool has been shut down (a previous epoch "
                "errored); create a fresh DataLoader/pool")
        for ch in self.channels:
            while ch.recv(timeout_ms=5) not in (None, b""):
                pass
        epoch = self._epoch + 1
        self.n_batches = len(batches)
        payload = pickle.dumps(batches)
        chunk_cap = (4 << 20) - 4096  # fits the control ring's slot
        chunks = [payload[i:i + chunk_cap]
                  for i in range(0, max(len(payload), 1), chunk_cap)]
        for ctrl in self.controls:
            for i, blob in enumerate(chunks):
                ctrl.send(pickle.dumps((epoch, len(chunks), i, blob)),
                          timeout_ms=int(self.timeout * 1000) or 60000)
        # bump only after every worker has the full plan: a partial-send
        # failure leaves _epoch unchanged, so a retry re-sends the SAME epoch
        self._epoch = epoch

    def __iter__(self):
        if self.persistent and self._epoch == 0:
            raise RuntimeError(
                "persistent worker pool: call submit_epoch(batches) before "
                "iterating (no epoch plan has been shipped to the workers)")
        for b in range(self.n_batches):
            ch = self.channels[b % self.num_workers]
            # timeout <= 0 means "no stall limit" (reference DataLoader
            # timeout=0 semantics); dead workers are still detected each poll
            deadline = (time.monotonic() + self.timeout) if self.timeout > 0 \
                else float("inf")
            while True:
                rec = ch.recv(timeout_ms=200)
                if rec is None:
                    if time.monotonic() > deadline:
                        self.shutdown()
                        raise TimeoutError(f"DataLoader worker {b % self.num_workers} "
                                           f"stalled on batch {b}")
                    p = self.procs[b % self.num_workers]
                    if not p.is_alive() and p.exitcode not in (0, None):
                        self.shutdown()
                        raise RuntimeError(
                            f"DataLoader worker {b % self.num_workers} died "
                            f"(exitcode {p.exitcode}); its traceback is on "
                            "stderr. Spawn workers must be able to import the "
                            "dataset/collate_fn from their defining modules "
                            "(no __main__-guarded or interactive definitions)")
                    continue
                if rec == b"":
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker channel closed before batch {b}")
                if self.persistent:
                    # skip any stragglers from an abandoned earlier epoch
                    (rec_epoch,) = struct.unpack_from("<I", rec, 0)
                    if rec_epoch != self._epoch:
                        continue
                    rec = memoryview(rec)[4:]
                yield _deserialize(memoryview(rec))
                break
        if not self.persistent:
            self.shutdown()

    def shutdown(self):
        for ch in self.controls:
            try:
                ch.mark_closed()
            except Exception:
                pass
        for ch in self.channels:
            try:
                ch.mark_closed()
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []
        for ch in self.channels + self.controls:
            ch.close()
        self.channels = []
        self.controls = []
