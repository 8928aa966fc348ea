"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen at
first use, never at import; the libraries land in ``build/`` beside this file
(listed in ``.gitignore``), named by a hash of the source, its headers and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Several sources build in parallel (one ``nvcc`` each).  A failed
build raises; there is no fallback.

C entry points take every pointer and the stream as ``void*`` and return
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# ctypes signatures of the C entry points, per source
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "rms_norm": {
        # x, w, y, rows, d, eps, x_dtype, w_dtype, stream
        "rms_norm_launch": (P, P, P, I, I, F, I, I, P),
    },
    "decode_attention": {
        # q, k, v, lengths, table, ws, out, B, H, Hk, D, cap, maxb, paged,
        # nsplit, sm_scale, dtype, stream
        "decode_attention_launch": (P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                    I, F, I, P),
        "decode_attention_split_keys": (),
    },
    "flash_attention": {
        # q, k, v, o, lse, strides, B, H, Hk, Sq, Sk, D, causal, scale, dtype, stream
        "flash_attention_fwd_launch": (P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P),
        # q, k, v, dout, lse, delta, dq, dk, dv, strides, B, H, Hk, Sq, Sk, D,
        # causal, scale, dtype, stream
        "flash_attention_bwd_launch": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                       I, F, I, P),
    },
    "adamw": {
        # p, g, m, v, out, n, lr, c1, c2, decay, beta1, 1-beta1, beta2, 1-beta2,
        # eps, wd, coupled, out_dtype, vec, stream
        "adamw_launch": (P, P, P, P, P, L, F, F, F, F, F, F, F, F, F, F, I, I, I, P),
    },
    "ssd_scan": {
        # x, b, c, la, y, s, G, T, P, N, L, stream
        "ssd_scan_launch": (P, P, P, P, P, P, I, I, I, I, I, P),
    },
    "fused_gemm": {
        # a, b, c, c2, aux, rs, cs, M, N, K, lda, ldb, ldc, a_kcontig, b_ncontig,
        # pro_on_b, epi, dtype, b_dtype, c_dtype, stream
        "fused_gemm_launch": (P, P, P, P, P, P, P, I, I, I, L, L, L, I, I, I, I, I, I, I, P),
        # x, r, rows, d, eps, dtype, stream
        "row_rms_launch": (P, P, I, I, F, I, P),
    },
    "add_rms_norm": {
        # x, h, w, s, y, rows, d, eps, dtype, w_dtype, stream
        "add_rms_norm_fwd_launch": (P, P, P, P, P, I, I, F, I, I, P),
        # x, h, w, d_s, d_normed, dx, partial, dw, rows, d, eps, dtype, w_dtype, stream
        "add_rms_norm_bwd_launch": (P, P, P, P, P, P, P, P, I, I, F, I, I, P),
    },
}

# dtype codes shared with the C side (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"no CUDA kernel instantiation for dtype {dtype}")
    return DTYPE_CODES[name]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of paddle_tpu_torch are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all in
    parallel; return ``{name: library path}``.  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = []
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((n, proc, cmd, tmp, out))
    errors = []
    for n, proc, cmd, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every kernel source in parallel, then load each."""
    build(SIGNATURES)
    return {n: load(n) for n in SIGNATURES}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
