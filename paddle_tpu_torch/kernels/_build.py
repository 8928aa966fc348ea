"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen at
first use, never at import; the libraries land in ``build/`` beside this file
(listed in ``.gitignore``), named by a hash of the source, its headers, the
flags and any extra ``-D`` defines, so an edited source is rebuilt and a
stale library is never loaded.  A *build variant* is a source built with
extra defines into a library of its own (the kernel gate's seeded
``emit-race`` defect is ``fused_gemm.cu`` with ``KERNEL_GATE_EMIT_RACE``):
its hash differs, so it can never be loaded as the real library.  Several
sources build in parallel (one ``nvcc`` each).  A failed build raises;
there is no fallback.

C entry points take every pointer and the stream as ``void*`` and return
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
Every library also exports ``kernel_attributes(kernel, dtype, a, b, c, out)``:
the static shared memory, the dynamic shared memory its launch requests,
the registers and the local (spill) bytes of one kernel instantiation, read
with ``cudaFuncGetAttributes`` (:func:`kernel_attributes`).

The geometry constants of a source (tile sizes, split sizes, thread and
block counts) are defined once, in :data:`GEOMETRY`, and reach the source
as ``-D`` defines: the kernels compile with them and the verifier's specs
read them from here, also on a machine with no compiler (the static leg
runs on the CPU).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# ctypes signatures of the C entry points, per source
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "rms_norm": {
        # x, w, y, rows, d, eps, x_dtype, w_dtype, vectors a lane (0: a CTA a row), stream
        "rms_norm_launch": (P, P, P, I, I, F, I, I, I, P),
    },
    "decode_attention": {
        # q, k, v, lengths, table, ws, out, B, H, Hk, D, cap, maxb, lead (the
        # caches' first dim), paged, nsplit, sm_scale, dtype, stream
        "decode_attention_launch": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                    I, F, I, P),
        "decode_attention_split_keys": (),
    },
    "flash_attention": {
        # q, k, v, o, lse, strides, B, H, Hk, Sq, Sk, D, causal, scale, dtype, stream
        "flash_attention_fwd_launch": (P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P),
        # q, k, v, dout, lse, delta, dq, dk, dv, the fp32 dQ workspace, strides,
        # B, H, Hk, Sq, Sk, D, causal, scale, dtype, stream
        "flash_attention_bwd_launch": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                       I, I, F, I, P),
    },
    "adamw": {
        # leaves (a host array of the table's entries), count, chunks, lr,
        # c1, c2, decay, beta1, 1-beta1, beta2, 1-beta2, eps, wd, bf16
        # copies, stream (each entry's flags say its gradient's dtype)
        "adamw_multi_launch": (P, I, I, F, F, F, F, F, F, F, F, F, F, I, P),
        # int out[4]: the table's layout as compiled
        "adamw_layout": (P,),
    },
    "ssd_scan": {
        # x, b, c, la, y, s, states, tot, G, T, P, N, L, stream
        "ssd_scan_launch": (P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    },
    "ssd_scan_bwd": {
        # x, b, c, la, states, dy, ds, dx, db, dc, dla, states_grad, tot,
        # G, T, P, N, L, stream
        "ssd_scan_bwd_launch": (P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    },
    "fused_gemm": {
        # a, b, c, c2, aux, rs, cs, M, N, K, lda, ldb, ldc, a_kcontig, b_ncontig,
        # pro_on_b, epi, dtype, b_dtype, c_dtype, stream
        "fused_gemm_launch": (P, P, P, P, P, P, P, I, I, I, L, L, L, I, I, I, I, I, I, I, P),
        # x, r, rows, d, eps, dtype, stream
        "row_rms_launch": (P, P, I, I, F, I, P),
        # x, rs, cs, out, rows, cols, x_dtype, stream
        "prep_launch": (P, P, P, P, I, I, I, P),
    },
    "add_rms_norm": {
        # x, h, w, s, y, rows, d, eps, dtype, w_dtype, stream
        "add_rms_norm_fwd_launch": (P, P, P, P, P, I, I, F, I, I, P),
        # x, h, w, d_s, d_normed, dx, partial, dw, rows, d, eps, dtype, w_dtype, warps
        # a row (0: the wide kernel), teams, slots, ctas, stock, stream
        "add_rms_norm_bwd_launch": (P, P, P, P, P, P, P, P, I, I, F, I, I, I, I, I, I, I, P),
    },
    "injected": {
        # x, y, rows, stream
        "injected_write_race_launch": (P, P, I, P),
        # x, y, acc, groups, tiles, stream
        "injected_parallel_carry_launch": (P, P, P, I, I, P),
    },
}
# every library: kernel, dtype, a, b, c, int out[4]
ATTRIBUTES_SIGNATURE = (I, I, I, I, I, P)
# the geometry of each source, passed to nvcc as -D<name>=<value>: the one
# definition the kernels and the verifier's specs both read
GEOMETRY = {
    # the multi-tensor update: threads a CTA, elements a chunk (a CTA's work),
    # elements a slot of its TMA ring and the ring's slots (3 x 36 KB of
    # shared memory), leaves a launch (the table rides in the 32 KB parameter
    # space) and the resident CTAs an SM the registers are budgeted for
    # (chosen by a sweep on an H100; PERF.md)
    "adamw": {"ADAMW_THREADS": 256, "ADAMW_CHUNK": 8192, "ADAMW_STAGE": 2048,
              "ADAMW_STAGES": 3, "ADAMW_TABLE_CAP": 480, "ADAMW_MIN_CTAS_PER_SM": 2},
    # the backward's ring kernel: 16-byte vectors of a row a lane owns (a row
    # takes ceil(vectors / (32 x that)) warps), consumer warps a CTA (teams of
    # a row's warps), most row slots and bytes of its ring in shared memory,
    # CTAs an SM (the persistent grid); most row groups of the wide kernel
    "add_rms_norm": {"ARN_LANE_VECTORS": 4, "ARN_CONSUMER_WARPS": 8, "ARN_MAX_SLOTS": 8,
                     "ARN_RING_BYTES": 192 * 1024, "ARN_CTAS_PER_SM": 1,
                     "ADD_RMS_NORM_GROUPS": 512},
    "decode_attention": {"DECODE_TILE": 32,           # keys a tile = lanes of a warp
                         "DECODE_MAX_REP": 8,         # query rows a kv-head (H / Hk)
                         "DECODE_SPLIT_KEYS": 256,    # keys a CTA of pass 1 (DECODE_TILE x k)
                         "DECODE_WARPS": 8,           # warps a CTA of pass 1
                         # shared memory for the K/V tiles resident at once
                         # (the whole split up to D 128 in bf16)
                         "DECODE_RESIDENT_BYTES": 160 * 1024},
    # per head_dim, fp32 (CUDA cores, 8 warps a CTA): the forward's query
    # rows (BQ / 8 a warp) and keys of its k-tiles (the CTAs an SM its
    # registers are budgeted for follow from its shared memory); the keys of
    # a dK/dV CTA (4 a lane) and the query rows of its steps; the stages of a
    # cp.async ring and the steps of a product's loop each kernel unrolls;
    # each CTA within the 227 KB of shared memory it may use (chosen
    # by kernel_ab.py flash32 sweeps on an H100; PERF.md).  The k-tiles whose
    # dQ shares one workspace holds (a longer Sk runs the dK/dV and dQ
    # launches once for each group of that many) and the threads of a CTA of
    # the dQ sum (a float4 of dq each).  For bf16 the forward's query rows (64
    # a consumer warpgroup) and keys of its k-tiles, the keys of a dK/dV CTA
    # (64 a warpgroup, or 64 shared by two at D 256) and query rows of its
    # steps, the query rows of a dQ CTA and keys of its steps; stages of the
    # forward's and the backward's TMA rings
    "flash_attention": {
        **{f"FLASH32_FWD_Q_ROWS_D{d}": 128 if d <= 64 else 64 for d in (32, 64, 128, 256)},
        **{f"FLASH32_FWD_K_ROWS_D{d}": 64 if d == 128 else 32 for d in (32, 64, 128, 256)},
        **{f"FLASH32_DKDV_K_ROWS_D{d}": {32: 128, 64: 128, 128: 64, 256: 32}[d]
           for d in (32, 64, 128, 256)},
        **{f"FLASH32_DKDV_Q_ROWS_D{d}": 64 if d <= 64 else 32 for d in (32, 64, 128, 256)},
        "FLASH32_STAGES": 2, "FLASH32_FWD_UNROLL": 4, "FLASH32_DKDV_UNROLL": 8,
        "FLASH32_DQ_SLOTS": 8, "FLASH32_DQ_THREADS": 256,
        **{f"FLASH_FWD_Q_ROWS_D{d}": 128 for d in (32, 64, 128, 256)},
        **{f"FLASH_FWD_K_ROWS_D{d}": 32 if d == 256 else 64 for d in (32, 64, 128, 256)},
        **{f"FLASH_DKDV_K_ROWS_D{d}": 64 if d == 256 else 128 for d in (32, 64, 128, 256)},
        **{f"FLASH_DKDV_Q_ROWS_D{d}": 64 for d in (32, 64, 128, 256)},
        **{f"FLASH_DQ_Q_ROWS_D{d}": 128 for d in (32, 64, 128, 256)},
        **{f"FLASH_DQ_K_ROWS_D{d}": 32 if d == 256 else 64 for d in (32, 64, 128, 256)},
        "FLASH_FWD_STAGES": 2, "FLASH_BWD_STAGES": 2},
    # fp32 (CUDA cores): CTA tile and K step, the epilogue's fp32 staging
    # tile row stride; bf16 (wgmma): CTA tile (two consumer warpgroups of 64
    # rows; SwiGLU: half the columns each of gate and up), K step (one
    # 128-byte swizzle span) and the stages of the TMA ring; rows a CTA of
    # the preparation pass
    "fused_gemm": {"GEMM_BM": 128, "GEMM_BN": 128, "GEMM_BK": 32, "GEMM_LDC": 128 + 4,
                   "GEMM_TC_BM": 128, "GEMM_TC_BN": 256, "GEMM_TC_BK": 64, "GEMM_TC_STAGES": 4,
                   "GEMM_PREP_ROWS": 8},
    "injected": {"INJECTED_TILE_ROWS": 8, "INJECTED_TILE_COLS": 128},
    # state columns of an N block of the SSD backward's dCB kernel (its dC
    # and dB accumulators, a 32 x 16 unit a warp at chunk 128)
    "ssd_scan_bwd": {"SSD_BWD_NB": 32},
    # 16-byte vectors a lane of the row kernel (a row of G groups of 32
    # vectors takes G / that many warps)
    "rms_norm": {"RMS_LANE_VECTORS": 4},
}
# the build variants: name -> (source, extra defines)
VARIANTS = {"fused_gemm_emit_race": ("fused_gemm", ("-DKERNEL_GATE_EMIT_RACE",))}

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


def _source(name: str) -> Tuple[str, Tuple[str, ...]]:
    """(source file stem, its -D defines) of a library or build variant:
    the source's geometry, then the variant's own."""
    src, extra = VARIANTS.get(name, (name, ()))
    geometry = tuple(f"-D{k}={v}" for k, v in GEOMETRY.get(src, {}).items())
    return src, geometry + extra


def _lib_path(name: str) -> Path:
    src, defines = _source(name)
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    for f in [CSRC / f"{src}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source (or build variant) whose library is
    missing, all in parallel; return ``{name: library path}``.  Raises on
    any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = []
    for n, out in paths.items():
        if out.exists():
            continue
        src, defines = _source(n)
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((n, proc, cmd, tmp, out))
    errors = []
    for n, proc, cmd, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):"
                          f"\n{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the build variant
    ``name``), building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            sigs = dict(SIGNATURES[_source(name)[0]])
            sigs["kernel_attributes"] = ATTRIBUTES_SIGNATURE
            for fn, argtypes in sigs.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every kernel source and build variant in parallel, then load
    each."""
    names = [*SIGNATURES, *VARIANTS]
    build(names)
    return {n: load(n) for n in names}


def kernel_attributes(name: str, kernel: int, dtype: int = 0, a: int = 0,
                      b: int = 0, c: int = 0) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of one kernel instantiation of library
    ``name`` (which kernel and template arguments ``kernel, dtype, a, b, c``
    select is documented beside each source's ``kernel_attributes``)."""
    lib = load(name)
    out = (ctypes.c_int * 4)()
    check(lib, lib.kernel_attributes(kernel, dtype, a, b, c, ctypes.addressof(out)),
          f"{name} kernel_attributes({kernel}, {dtype}, {a}, {b}, {c})")
    return {"static_smem": out[0], "dynamic_smem": out[1], "registers": out[2],
            "local_bytes": out[3]}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
