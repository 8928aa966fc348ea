"""The decode attention kernel's split plan and the gate's specs of the
serving path's launches, on the CPU.

``_issued`` mirrors the loops of ``decode_partial_kernel``
(``paddle_tpu_torch/kernels/csrc/decode_attention.cu``) in plain Python,
from the same geometry (``_build.GEOMETRY`` and ``resident_tiles``): which
key rows each CTA's copies fetch, round by round.  The tests hold it to
covering every live key of a sequence exactly once and never a key at or
past its length, so a paged row's block-table entry is read only for live
blocks.  The kernel runs on the card only; ``tests/test_torch_gpu.py`` holds
it to the plain version there.
"""

import pytest
import torch

from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.kernels import _build, registry
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import rms_norm as trms

GEO = _build.GEOMETRY["decode_attention"]
SPLIT, TILE = GEO["DECODE_SPLIT_KEYS"], GEO["DECODE_TILE"]


def _issued(L, capacity, D, dtype, bs=None):
    """{split: [(round, tile, first key, keys, by TMA, parity)]} of one
    (batch row, kv-head): the CTAs of grid z that find live keys, and the
    tiles their copies fetch each round, whether a tile goes by TMA (a whole
    tile, in one pool block of ``bs`` keys when paged) or by cp.async, and
    the phase parity its wait asks for, as ``parity_of`` computes it."""
    L = max(0, min(L, capacity))
    res = tda.resident_tiles(D, dtype)
    out = {}
    for split in range(-(-capacity // SPLIT)):
        begin, end = split * SPLIT, min(L, split * SPLIT + SPLIT)
        if begin >= end:
            continue                      # the CTA returns before any load
        ntiles = -(-(end - begin) // TILE)

        def keys(t):
            return min(TILE, end - (begin + t * TILE))

        def by_tma(t):
            return keys(t) == TILE and (bs is None or bs % TILE == 0)

        def parity_of(t):
            return sum(by_tma(u) == by_tma(t) for u in range(t % res, t, res)) & 1

        for t_lo in range(0, ntiles, res):
            for t in range(min(res, ntiles - t_lo)):
                out.setdefault(split, []).append(
                    (t_lo // res, t, begin + (t_lo + t) * TILE, keys(t_lo + t),
                     by_tma(t_lo + t), parity_of(t_lo + t)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("bs,maxb", [(128, 8), (48, 12), (16, 40)])
def test_split_plan_covers_each_live_key_once(bs, maxb, D, dtype):
    capacity = bs * maxb
    res = tda.resident_tiles(D, dtype)
    for L in sorted({0, 1, 15, 16, 17, bs - 1, bs, bs + 1, capacity}):
        plan = _issued(L, capacity, D, dtype, bs)
        keys = [t0 + j for tiles in plan.values() for _, _, t0, n, *_ in tiles
                for j in range(n)]
        assert sorted(keys) == list(range(L)), (L, plan)
        # the combine pass reads exactly the splits that wrote the workspace
        assert sorted(plan) == list(range(-(-L // SPLIT)))
        for tiles in plan.values():
            # a round's tiles fit the resident slots; a tile is at most a warp's keys
            assert all(t < res and 0 < n <= TILE for _, t, _, n, *_ in tiles)
        # a paged row's table entries are read for live blocks only
        assert {k // bs for k in keys} == set(range(-(-L // bs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("bs", [None, 128, 48, 16])
def test_each_tile_waits_for_its_own_copies(bs, D, dtype):
    """A slot's two mbarriers (TMA, cp.async) each complete one phase a tile
    that goes their way; a wait on parity P returns once the phase of that
    parity last completed, and a fresh barrier counts its phase before the
    first as completed with parity 1.  So the parity a tile's wait asks for
    must be that of the phase its own copies complete, or it reads the
    slot's earlier tile: this holds over rounds, where a split's last,
    partial tile goes by cp.async into a slot filled by TMA before."""
    capacity = 1024 if bs is None else bs * -(-1024 // bs)
    res = tda.resident_tiles(D, dtype)
    for L in sorted({0, 1, 15, 16, 17, 31, 33, 129, 200, 255, 257, 500, 1000, capacity}):
        for split, tiles in _issued(L, capacity, D, dtype, bs).items():
            completed = {}                # (slot, route) -> phases completed
            for _, t, _, _, tma, parity in tiles:
                done = completed.get((t, tma), 0)
                assert parity == done & 1, (L, split, t, tma, tiles)
                completed[(t, tma)] = done + 1
            if res < SPLIT // TILE and L % TILE and 128 < L - split * SPLIT < SPLIT and bs in (
                    None, 128):
                # the case that mixes routes in a slot is reached
                assert any(not tma and r for r, _, _, _, tma, _ in tiles), tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_resident_tiles_fit_shared_memory(D, dtype):
    """The whole split stays resident up to D 128 in bf16 (the serving
    path's), fewer tiles a round above; every layout fits a CTA."""
    res = tda.resident_tiles(D, dtype)
    assert SPLIT // TILE % res == 0
    if D * dtype.itemsize <= 256:
        assert res == SPLIT // TILE
    partial = tda.kernel_specs(8, 32, 8, D, 2048, dtype)[0]
    assert partial.grid[3] == SPLIT // TILE // res
    smem = sum(s.nbytes() for s in partial.scratch if s.memory_space == "smem")
    assert smem <= tlint.DEFAULT_SMEM_BUDGET
    assert partial.scratch[1].nbytes() == res * 2 * TILE * D * dtype.itemsize


@pytest.mark.parametrize("name", ["decode_mmha", "decode_mmha_fused", "paged_decode",
                                  "paged_decode_fused"])
def test_decode_entries_lint_clean_at_the_jax_examples_and_serving_shapes(name):
    entry = registry.entries()[name]
    assert entry.dtypes == ("float32", "bfloat16", "bfloat16@serve")
    rep = registry.check(name, device="cpu")
    assert not rep.findings, rep.report()
    assert rep.meta["legs"] == ["static"]
    assert {"decode_partial_kernel@bfloat16@serve",
            "decode_combine_kernel@bfloat16@serve"} <= set(rep.meta["kernel_names"])
    # Llama-3-8B's heads at the serving shape, the whole split resident
    spec = entry.build("bfloat16@serve")[0][0]
    assert tuple(spec.inputs[0].shape) == (8, 32, 128) and spec.grid[3] == 1
    assert rep.meta["smem_bytes_by_kernel"]["decode_partial_kernel@bfloat16@serve"] == (
        1024 + 8 * 2 * TILE * 128 * 2 + 8 * 128 * 2 + 4 * (8 * SPLIT + 3 * 8 * 8 + 2 * 8) + 2 * 8 * 8)


def test_serving_lengths_are_the_serve_phase_sizes():
    """The `@serve` examples' lengths are chip_smoke.py's `serve` requests'."""
    import chip_smoke

    assert tuple(chip_smoke._serve_lengths()) == tda.SERVE_LENGTHS
    assert tuple(registry.entries()["paged_decode"].build("bfloat16@serve")[3]("cpu")[4]
                 .tolist()) == tda.SERVE_LENGTHS


def test_rms_norm_entry_lints_clean_at_the_main_path_shapes():
    entry = registry.entries()["rms_norm"]
    assert {"bfloat16@serve", "bfloat16+float32@base"} <= set(entry.dtypes)
    rep = registry.check("rms_norm", device="cpu")
    assert not rep.findings, rep.report()
    names = set(rep.meta["kernel_names"])
    # the JAX example's 64 rows take a CTA a row; the main path's rows a warp each
    assert {"rms_norm_kernel@bfloat16", "rms_norm_rows_kernel@bfloat16@serve",
            "rms_norm_rows_kernel@bfloat16+float32@base"} <= names
    # a row of 16 groups: four warps and their 16 group sums
    assert rep.meta["smem_bytes_by_kernel"]["rms_norm_rows_kernel@bfloat16@serve"] == 16 * 4
    spec = entry.build("bfloat16+float32@base")[0][0]
    assert spec.grid == (3 * 2048,) and spec.cuda == ("rms_norm", 1, 1, 0, 8)
    assert trms.plan(4096, 4096, torch.bfloat16) == ("rows", 16)
