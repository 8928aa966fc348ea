"""Checkpoints of a state dict: the single-process path of
``paddle_tpu/distributed/checkpoint`` (the reference's
``python/paddle/distributed/checkpoint/``), in its on-disk format.

- the process writes one ``.npz`` (``0_0.distcp.npz``) holding every
  tensor as one chunk at offset 0 (the JAX package's chunk of a single
  process), bf16 stored as a same-width unsigned view (``_to_storage``);
- ``metadata.pkl`` records, per tensor, its global shape, dtype and every
  chunk's (offset, shape, file, key, CRC32);
- the commit is atomic: every file lands in ``<path>.saving``, the manifest
  is written last (tmp + rename), then the staging directory is renamed to
  ``path``, so a save killed at any point leaves the old checkpoint or no
  ``path`` at all;
- load checks every chunk's CRC32 (:class:`CheckpointCorruptionError`) and
  assembles each tensor from the chunks that cover it, so a directory
  written by the JAX package (one or several processes) loads here;
- ``async_save=True`` copies device tensors to the host now and writes the
  files on a background thread, returning a ``Future``.

The manifest is a pickle that names the JAX package's classes
(``paddle_tpu.distributed.checkpoint.Metadata``) or this module's.  It is
read with a restricted unpickler that maps exactly those two classes, of
either module, to this module's copies and refuses any other global: a
load never imports the JAX package and never runs an arbitrary pickle.
Multi-process saves, re-layout on write and reshard-on-load come with the
distributed slice.
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
import zipfile
import zlib
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "Metadata", "LocalTensorMetadata",
           "CheckpointCorruptionError"]

_METADATA_FILE = "metadata.pkl"
_STAGING_SUFFIX = ".saving"
_FILE_NAME = "0_0.distcp.npz"         # rank 0's file of the JAX layout

# path -> last async-save future; a new save into the same path waits for it
_INFLIGHT: Dict[str, Future] = {}


class CheckpointCorruptionError(ValueError):
    """A shard chunk's bytes do not match the CRC32 recorded in the manifest
    (silent storage corruption, a torn write, or a tampered file)."""


class LocalTensorMetadata:
    """One saved chunk (reference metadata.py:20): its global offset, shape,
    where the bytes live, and the CRC32 of those bytes (``None`` in
    manifests written before integrity checking existed)."""

    def __init__(self, global_offset, local_shape, file_name, key, crc32=None):
        self.global_offset = tuple(int(o) for o in global_offset)
        self.local_shape = tuple(int(s) for s in local_shape)
        self.file_name = file_name
        self.key = key
        self.crc32 = crc32

    def __repr__(self):
        return (f"LocalTensorMetadata(offset={self.global_offset}, shape={self.local_shape}, "
                f"file={self.file_name})")


class Metadata:
    """Global checkpoint manifest (reference metadata.py:41)."""

    def __init__(self):
        self.state_dict_metadata: Dict[str, dict] = {}

    def add(self, name, global_shape, dtype, chunks):
        self.state_dict_metadata[name] = {
            "global_shape": tuple(int(s) for s in global_shape),
            "dtype": str(dtype),
            "chunks": chunks,
        }


_MANIFEST_CLASSES = {
    (module, cls.__name__): cls
    for module in ("paddle_tpu.distributed.checkpoint", __name__)
    for cls in (Metadata, LocalTensorMetadata)}


class _ManifestUnpickler(pickle.Unpickler):
    """Reads a manifest: the two manifest classes of the JAX package or of
    this module become this module's; any other global is refused."""

    def find_class(self, module, name):
        cls = _MANIFEST_CLASSES.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"checkpoint manifest names {module}.{name}; only {sorted(_MANIFEST_CLASSES)} "
                "may appear there")
        return cls


def read_metadata(path: str) -> Metadata:
    """The manifest of the checkpoint directory ``path``."""
    with open(os.path.join(path, _METADATA_FILE), "rb") as f:
        return _ManifestUnpickler(f).load()


# dtypes numpy cannot hold: stored as a same-width unsigned view, their name
# in the manifest (the JAX package's ml_dtypes names are torch's)
_VIEW_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16}


def _to_storage(t: torch.Tensor):
    """``(array, dtype name)`` of a host tensor for the npz: numpy's own
    dtypes as they are, bf16 / fp8 as a same-width unsigned view."""
    name = str(t.dtype).replace("torch.", "")
    if name in _VIEW_DTYPES:
        raw = t.view(_INT_OF_WIDTH[t.element_size()]).numpy()
        return raw.view(np.dtype(f"u{t.element_size()}")), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storage(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_DTYPES:
        width = arr.dtype.itemsize
        return torch.from_numpy(arr.view(f"i{width}" if width == 2 else "u1")).view(
            _VIEW_DTYPES[dtype_name])
    dtype = np.dtype(dtype_name)
    return torch.from_numpy(arr if arr.dtype == dtype else arr.view(dtype))


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes (the JAX package's ``tobytes()``, without
    the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _flatten(state_dict, prefix="") -> Dict[str, object]:
    flat = {}
    for name, t in state_dict.items():
        if isinstance(t, dict):
            flat.update(_flatten(t, f"{prefix}{name}."))
        else:
            flat[f"{prefix}{name}"] = t
    return flat


def _host(t) -> torch.Tensor:
    """A value as a contiguous host tensor (copied off the device now)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=t.device.type == "cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(t)))


def save_state_dict(state_dict, path: str, process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False):
    """Save ``state_dict`` (name -> tensor, array or number; nested dicts
    flatten to ``outer.inner`` names) under directory ``path``, committed
    atomically (see the module docstring).  The device-to-host copies
    happen now; with ``async_save`` the files are written on a background
    thread and a ``Future`` (resolving to ``path``) is returned, else
    None."""
    staging = path + _STAGING_SUFFIX
    prev = _INFLIGHT.get(path)
    if prev is not None and not prev.done():
        prev.result()
    meta = Metadata()
    payload = {}
    for name, t in _flatten(state_dict).items():
        host = _host(t)
        stored, dtype_name = _to_storage(host)
        offset = (0,) * host.dim()
        key = f"{name}|{','.join(map(str, offset))}"
        payload[key] = stored
        meta.add(name, host.shape, dtype_name,
                 [LocalTensorMetadata(offset, host.shape, _FILE_NAME, key,
                                      crc32=_crc32(stored))])

    def write_and_commit():
        if os.path.isdir(staging):
            shutil.rmtree(staging)          # a save that died before its commit
        os.makedirs(staging)
        np.savez(os.path.join(staging, _FILE_NAME), **payload)
        # manifest written LAST within staging, atomically (tmp + rename)
        tmp = os.path.join(staging, _METADATA_FILE + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(meta, f)
        os.replace(tmp, os.path.join(staging, _METADATA_FILE))
        # ... and the whole checkpoint becomes visible in ONE rename: a crash
        # before this line leaves `path` untouched (old version or absent)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(staging, path)

    if not async_save:
        write_and_commit()
        return None
    fut: Future = Future()

    def runner():
        try:
            write_and_commit()
            fut.set_result(path)
        except BaseException as e:  # pragma: no cover - surfaced through the future
            fut.set_exception(e)

    threading.Thread(target=runner, name="distcp-save", daemon=True).start()
    _INFLIGHT[path] = fut
    return fut


def _region(chunks, shape, fetch) -> torch.Tensor:
    """The whole tensor of ``shape`` from the chunks that cover it."""
    if len(chunks) == 1 and tuple(chunks[0].local_shape) == tuple(shape):
        return fetch(chunks[0])
    out, covered = None, np.zeros(shape, dtype=bool)
    for c in chunks:
        part = fetch(c)
        out = torch.empty(shape, dtype=part.dtype) if out is None else out
        idx = tuple(slice(o, o + s) for o, s in zip(c.global_offset, c.local_shape))
        out[idx] = part
        covered[idx] = True
    if out is None or not covered.all():
        raise ValueError(f"checkpoint chunks do not cover the tensor (shape {shape})")
    return out


def load_state_dict(state_dict, path: str, process_group=None, coordinator_rank: int = 0,
                    prefer_files=(), stats=None):
    """Load the checkpoint at ``path`` into ``state_dict``: a tensor leaf is
    overwritten IN PLACE (cast to its dtype, on its device); any other leaf
    is replaced in its dict by a host tensor of the saved dtype.  Every
    name must be in the checkpoint with the same shape; a chunk whose bytes
    fail their CRC32, or that the npz cannot decode, raises
    :class:`CheckpointCorruptionError`.  ``stats`` (a dict) receives
    ``tensors``, ``reads`` and ``bytes``.  ``prefer_files`` (the JAX
    package's choice among overlapping shards of a multi-rank save) must be
    empty: multi-rank checkpoints wait for the distributed slice."""
    if prefer_files:
        raise NotImplementedError("paddle_tpu_torch: prefer_files (multi-rank checkpoints) "
                                  "comes with the distributed slice")
    meta = read_metadata(path)
    files: Dict[str, np.lib.npyio.NpzFile] = {}
    agg = {"tensors": 0, "reads": 0, "bytes": 0}

    def fetch(c, dtype_name):
        try:
            if c.file_name not in files:
                files[c.file_name] = np.load(os.path.join(path, c.file_name))
            raw = files[c.file_name][c.key]
        except (OSError, KeyError, ValueError, zlib.error, zipfile.BadZipFile) as e:
            raise CheckpointCorruptionError(
                f"shard {c.file_name} of checkpoint {path} is unreadable ({e}) — treating "
                "as corrupt") from e
        if c.crc32 is not None:
            got = _crc32(raw)
            if got != c.crc32:
                raise CheckpointCorruptionError(
                    f"chunk {c.key!r} in {c.file_name} failed CRC verification (manifest "
                    f"{c.crc32:#010x}, file {got:#010x}) — checkpoint {path} is corrupt")
        agg["reads"] += 1
        agg["bytes"] += raw.nbytes
        return _from_storage(raw, dtype_name)

    targets = []

    def collect(d, prefix=""):
        for name, t in d.items():
            if isinstance(t, dict):
                collect(t, f"{prefix}{name}.")
            else:
                targets.append((f"{prefix}{name}", d, name, t))

    collect(state_dict)
    for full, _, _, t in targets:       # every name and shape checked before any read
        if full not in meta.state_dict_metadata:
            raise KeyError(f"tensor {full!r} not present in checkpoint {path}")
        want = tuple(meta.state_dict_metadata[full]["global_shape"])
        have = tuple(np.shape(t)) if not isinstance(t, torch.Tensor) else tuple(t.shape)
        if have != want:
            raise ValueError(f"{full}: target shape {have} != saved {want}")
    try:
        with torch.no_grad():
            for full, container, key, t in targets:
                info = meta.state_dict_metadata[full]
                value = _region(info["chunks"], info["global_shape"],
                                lambda c, _d=info["dtype"]: fetch(c, _d))
                if isinstance(t, torch.Tensor):
                    t.copy_(value)
                else:
                    container[key] = value
                agg["tensors"] += 1
    finally:
        for f in files.values():
            f.close()
    if isinstance(stats, dict):
        stats.update(agg)
    return state_dict
