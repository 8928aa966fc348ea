"""The kernel gate's seeded defects (``csrc/injected.cu``; port of the
``_build_injected_*`` kernels of ``paddle_tpu/kernels/registry.py``).

Kernels that are wrong on purpose, so the gate is proven able to fail:

- :func:`write_race`: every CTA doubles its tile of ``x`` and stores it to
  tile 0 — a write race, and tiles 1.. never written;
- :func:`parallel_carry`: each row's running sum over its tiles, carried
  across CTAs of an unordered grid axis through a global accumulator;
- ``emit-race``: the real ``fuse_swiglu_mlp`` forward launched from the
  build variant ``fused_gemm_emit_race`` of ``csrc/fused_gemm.cu``, whose
  epilogue stores every CTA's tile to tile (0, 0), under the site's honest
  (clean) spec: only the card's dynamic leg can see it.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version (what a correct kernel gives) on a CPU tensor.  The ``*_entry``
functions are the registry builders the ``KERNEL_GATE_INJECT`` legs of
:mod:`.registry` register; nothing registers them otherwise.
"""

from __future__ import annotations

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics
from . import _build, registry

__all__ = ["write_race", "write_race_reference", "parallel_carry",
           "parallel_carry_reference", "write_race_entry", "parallel_carry_entry",
           "emit_race_entry", "EMIT_RACE_LIB"]

TILE = (_build.GEOMETRY["injected"]["INJECTED_TILE_ROWS"],
        _build.GEOMETRY["injected"]["INJECTED_TILE_COLS"])
EMIT_RACE_LIB = "fused_gemm_emit_race"


def _check(x: torch.Tensor, dims: int) -> None:
    if (x.dtype != torch.float32 or x.dim() != dims or x.shape[-1] != TILE[1]
            or x.shape[-2] % TILE[0] or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"injected kernels take contiguous, 16-byte aligned fp32 "
                         f"[..., 8k, 128] tensors; got {x.dtype} {tuple(x.shape)}")


def write_race_reference(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * x


def write_race(x: torch.Tensor) -> torch.Tensor:
    """``2 x`` of ``x`` [rows, 128] fp32 — on the card, with the seeded
    write race (only tile 0 is stored, by every CTA)."""
    registry.ensure_admitted("injected_write_race", x.device)
    if x.device.type == "cpu":
        return write_race_reference(x)
    _check(x, 2)
    y = torch.empty_like(x)
    lib = _build.load("injected")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.injected_write_race_launch(x.data_ptr(), y.data_ptr(), x.shape[0], stream)
    _build.check(lib, err, "injected_write_race")
    write_race.launches += 1
    return y


def parallel_carry_reference(x: torch.Tensor) -> torch.Tensor:
    G, R, C = x.shape
    return x.reshape(G, R // TILE[0], TILE[0], C).cumsum(1).reshape(G, R, C)


def parallel_carry(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the 8-row tiles of each ``x[g]`` ([G, 8 tiles, 128]
    fp32) — on the card, carried across unordered CTAs (the seeded
    parallel carry): only each row's first tile is defined."""
    registry.ensure_admitted("injected_parallel_carry", x.device)
    if x.device.type == "cpu":
        return parallel_carry_reference(x)
    _check(x, 3)
    G, R, _ = x.shape
    y = torch.empty_like(x)
    acc = torch.empty((G, *TILE), dtype=torch.float32, device=x.device)
    lib = _build.load("injected")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.injected_parallel_carry_launch(x.data_ptr(), y.data_ptr(), acc.data_ptr(),
                                                 G, R // TILE[0], stream)
    _build.check(lib, err, "injected_parallel_carry")
    parallel_carry.launches += 1
    return y


write_race.launches = 0
parallel_carry.launches = 0


# ---------------------------------------------------------------------------
# the KERNEL_GATE_INJECT entries: honest specs of the defective kernels
# ---------------------------------------------------------------------------

def _randn(shape, device):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(device)


def write_race_spec(rows: int = 32) -> KernelSpec:
    f32 = torch.float32
    return KernelSpec(
        "injected_write_race_kernel", grid=(rows // TILE[0],),
        inputs=[BlockUse((rows, TILE[1]), f32, TILE, lambda i: (i, 0), name="x")],
        # every CTA writes block (0, 0): a race, and blocks 1.. never written
        outputs=[BlockUse((rows, TILE[1]), f32, TILE, lambda i: (0, 0), name="y")],
        dimension_semantics=cuda_semantics(1),
        cuda=("injected", 0, 0, 0, 0))


def parallel_carry_spec(groups: int = 2, tiles: int = 4) -> KernelSpec:
    f32 = torch.float32
    shape = (groups, tiles * TILE[0], TILE[1])
    return KernelSpec(
        "injected_parallel_carry_kernel", grid=(groups, tiles),
        inputs=[BlockUse(shape, f32, (1, *TILE), lambda g, i: (g, i, 0), name="x")],
        outputs=[BlockUse(shape, f32, (1, *TILE), lambda g, i: (g, i, 0), name="y")],
        scratch=[ScratchUse((groups, *TILE), f32, "global")],
        # the accumulator of row g is reset at i == 0 and read by i > 0: it
        # carries across axis 1, which a CUDA grid runs in no order
        dimension_semantics=cuda_semantics(2),
        carried_scratch=[(0, frozenset({1}))],
        cuda=("injected", 1, 0, 0, 0))


def write_race_entry():
    return ([write_race_spec()], write_race, write_race_reference,
            lambda device: (_randn((32, TILE[1]), device),))


def parallel_carry_entry():
    return ([parallel_carry_spec()], parallel_carry, parallel_carry_reference,
            lambda device: (_randn((2, 4 * TILE[0], TILE[1]), device),))


def emit_race_entry(dtype: str = "float32"):
    """``fuse_swiglu_mlp``'s forward entry with its GEMMs launched from the
    seeded build variant, at ``dtype`` (fp32: the CUDA-core kernel; bf16
    rows over fp32 weights: the tensor-core kernel); the specs are the
    site's own (they describe the correct kernel), so the defect is visible
    only on the card."""
    from . import emit

    site = emit.SITES["fuse_swiglu_mlp"]
    static = dict(site.example_static)
    _, _, plain, args = emit._fwd_builder(site)(dtype)
    specs = emit.site_specs(site.name, emit._example_shapes(site, dtype), static,
                            lib=EMIT_RACE_LIB)
    return (specs, lambda *a: emit.fuse_swiglu_mlp_fwd(*a, **static, lib=EMIT_RACE_LIB),
            plain, args)
