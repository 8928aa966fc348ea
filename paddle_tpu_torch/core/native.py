"""Build and load the native host runtime library (port of
``paddle_tpu/core/native.py``).

``csrc/`` holds the C++ host runtime: the shared-memory batch channel of
the DataLoader's worker processes (``shm_channel.cc``), the control-plane
key-value store (``tcp_store.cc``) and the host tracer
(``host_tracer.cc``).  They compile with the system ``g++`` into one
shared library with a C interface, loaded through ``ctypes``.

The build happens at first use, never at import (``python -m
paddle_tpu_torch.core.build`` forces it), into ``build/`` beside this file
(listed in ``.gitignore``), named by a hash of the sources and the flags:
an edited source is rebuilt and a stale library is never loaded.  The
compiler writes to a temporary name that is then renamed, and a file lock
lets one process build while the others wait, so concurrent processes
never load a half-written library.

A failed build raises with the compiler's message: no consumer falls back
to a slower path behind the caller's back (``TCPStore(use_native=False)``
still picks the pure-Python store on request).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["available", "build", "load", "lib_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cc"))


def lib_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_native-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cc`` into the shared library unless it is there
    already; returns its path.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # one process compiles; the rest wait
        if out.exists():
            return out
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *map(str, _sources())]
        if verbose:
            print(" ".join(cmd))
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _decorate(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    # tcp_store
    lib.pts_server_start.restype = c.c_void_p
    lib.pts_server_start.argtypes = [c.c_int]
    lib.pts_server_port.restype = c.c_int
    lib.pts_server_port.argtypes = [c.c_void_p]
    lib.pts_server_num_keys.restype = c.c_int
    lib.pts_server_num_keys.argtypes = [c.c_void_p]
    lib.pts_server_stop.argtypes = [c.c_void_p]
    lib.pts_client_connect.restype = c.c_void_p
    lib.pts_client_connect.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.pts_client_close.argtypes = [c.c_void_p]
    # keys are (ptr, len) pairs — binary-safe, embedded NULs preserved
    lib.pts_set.restype = c.c_int
    lib.pts_set.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_char_p, c.c_int]
    lib.pts_get.restype = c.c_int
    lib.pts_get.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int)]
    lib.pts_buf_free.argtypes = [c.POINTER(c.c_uint8)]
    lib.pts_add.restype = c.c_int
    lib.pts_add.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int64,
                            c.POINTER(c.c_int64)]
    lib.pts_wait.restype = c.c_int
    lib.pts_wait.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int]
    lib.pts_delete.restype = c.c_int
    lib.pts_delete.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    # shm_channel
    lib.ptc_create.restype = c.c_void_p
    lib.ptc_create.argtypes = [c.c_char_p, c.c_uint64, c.c_uint64]
    lib.ptc_open.restype = c.c_void_p
    lib.ptc_open.argtypes = [c.c_char_p]
    lib.ptc_send.restype = c.c_int
    lib.ptc_send.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64, c.c_int]
    lib.ptc_recv.restype = c.c_int64
    lib.ptc_recv.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64, c.c_int]
    lib.ptc_next_len.restype = c.c_int64
    lib.ptc_next_len.argtypes = [c.c_void_p]
    lib.ptc_wait_nonempty.restype = c.c_int
    lib.ptc_wait_nonempty.argtypes = [c.c_void_p, c.c_int]
    lib.ptc_mark_closed.argtypes = [c.c_void_p]
    lib.ptc_slot_bytes.restype = c.c_uint64
    lib.ptc_slot_bytes.argtypes = [c.c_void_p]
    lib.ptc_close.argtypes = [c.c_void_p]
    # host_tracer
    lib.ptt_begin.argtypes = [c.c_char_p]
    lib.ptt_counter.argtypes = [c.c_char_p, c.c_double]
    lib.ptt_span.argtypes = [c.c_char_p, c.c_uint64, c.c_uint64]
    lib.ptt_now_ns.restype = c.c_uint64
    lib.ptt_num_events.restype = c.c_int64
    lib.ptt_enabled.restype = c.c_int
    lib.ptt_export_chrome.restype = c.c_int
    lib.ptt_export_chrome.argtypes = [c.c_char_p, c.c_int64]
    return lib


def load() -> ctypes.CDLL:
    """The loaded native library, built first if needed.  Raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _decorate(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"native library {path} does not load: {e}") from e
    return _lib


def available() -> bool:
    """True when the library builds and loads (the error is swallowed:
    callers that need it call :func:`load`, which raises)."""
    try:
        load()
    except RuntimeError:
        return False
    return True
