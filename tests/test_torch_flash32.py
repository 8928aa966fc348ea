"""The fp32 flash attention kernels' CPU-side contract.

Their tile sizes, stages and dQ workspace come from one definition,
``_build.GEOMETRY["flash_attention"]``, which both the CUDA source (as -D
defines) and the verifier's specs read; the backward's launch groups are a
function of the shape alone, and the verifier's specs follow them; the
kernel gate checks the launches ERNIE makes.  The kernels themselves run
only on the card (``tests/test_torch_gpu.py``); their plain versions are
held to the Pallas kernels in ``tests/test_torch_train.py``.
"""

import itertools

import pytest
import torch

from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.kernels import _build, registry
from paddle_tpu_torch.kernels import flash_attention as tfa

F32 = torch.float32


def _fwd_bytes(BQ, BK, D, stages):
    """Shared memory of the fp32 forward as ``Fwd32::kBytes`` lays it out,
    each row padded by 4 floats: Q, each stage's K and V, P."""
    return (BQ * (D + 4) + 2 * stages * BK * (D + 4) + BQ * (BK + 4)) * 4


def _dkdv_bytes(BK, BQ, D, stages):
    """... and of the dK/dV pass (``Bwd32::kBytes``): K and V, each stage's
    Q, dO, lse and delta, P and dS."""
    return (2 * BK * (D + 4) + stages * (2 * BQ * (D + 4) + 2 * BQ) + 2 * BQ * (BK + 4)) * 4


def _smem(spec):
    return sum(s.nbytes() for s in spec.scratch if s.memory_space == "smem")


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_fp32_specs_declare_the_kernels_layout(d):
    """Each fp32 spec declares the shared memory the kernel lays out, at
    every head dim, within the 227 KB a CTA may use, and lints clean."""
    geo = _build.GEOMETRY["flash_attention"]
    fwd, = tfa.kernel_specs(2, 300, 300, 4, 2, d, True, F32)
    bwd = tfa.kernel_specs(2, 300, 300, 4, 2, d, True, F32, backward=True)
    dkdv, dq = bwd[:2]          # at D 256, 10 k-tiles of 32 keys: two groups
    assert (fwd.name, dkdv.name, dq.name) == ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                                              "flash_bwd_dq_kernel")
    assert _smem(fwd) == _fwd_bytes(geo[f"FLASH32_FWD_Q_ROWS_D{d}"],
                                    geo[f"FLASH32_FWD_K_ROWS_D{d}"], d, geo["FLASH32_STAGES"])
    assert _smem(dkdv) == _dkdv_bytes(geo[f"FLASH32_DKDV_K_ROWS_D{d}"],
                                      geo[f"FLASH32_DKDV_Q_ROWS_D{d}"], d, geo["FLASH32_STAGES"])
    assert _smem(dq) == 0
    for spec in [fwd, *bwd]:
        assert _smem(spec) <= tlint.DEFAULT_SMEM_BUDGET
        assert not tlint.lint_kernel_spec(spec), spec.name


def test_fp32_specs_read_their_tiles_from_geometry(monkeypatch):
    """Changing ``_build.GEOMETRY`` changes the specs' tiles, grids, shared
    memory and dQ workspace with it: no tile size is written twice."""
    geo = dict(_build.GEOMETRY["flash_attention"])
    geo.update(FLASH32_FWD_Q_ROWS_D64=64, FLASH32_FWD_K_ROWS_D64=32,
               FLASH32_DKDV_K_ROWS_D64=64, FLASH32_DKDV_Q_ROWS_D64=32, FLASH32_STAGES=3,
               FLASH32_DQ_SLOTS=2, FLASH32_DQ_THREADS=128)
    monkeypatch.setitem(_build.GEOMETRY, "flash_attention", geo)
    B, S, H, D = 1, 200, 2, 64
    fwd, = tfa.kernel_specs(B, S, S, H, H, D, False, F32)
    assert fwd.grid == (-(-S // 64), B * H, -(-S // 32))
    assert fwd.inputs[0].block_shape == (1, 64, 1, D)
    assert fwd.inputs[1].block_shape == (1, 32, 1, D)
    assert _smem(fwd) == _fwd_bytes(64, 32, D, 3)
    assert tfa.dq_groups(S, D) == (2, 2)                   # 4 k-tiles, 2 slots
    dkdv, dq, dkdv2, dq2 = tfa.kernel_specs(B, S, S, H, H, D, False, F32, backward=True)
    assert dkdv.grid == (2, B * H, 1, -(-S // 32)) == dkdv2.grid
    assert dkdv.inputs[0].block_shape == (1, 64, 1, D)     # k
    assert dkdv.inputs[2].block_shape == (1, 32, 1, D)     # q
    assert _smem(dkdv) == _dkdv_bytes(64, 32, D, 3)
    assert dkdv.outputs[2].shape == (2, B, S, H, D)        # a dQ share a k-tile of the group
    assert dkdv2.inputs[0].shape == (B, S - 128, H, D)     # the second group's keys
    assert dq.grid == (-(-(B * S * H * D) // (4 * 128)),) == dq2.grid
    for spec in (fwd, dkdv, dq, dkdv2, dq2):
        assert not tlint.lint_kernel_spec(spec), spec.name


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_backward_specs_run_once_a_group(d, causal):
    """The fp32 backward declares its launches as ``launch_bwd_f32`` makes
    them: for each :func:`dq_groups` group of k-tiles, a dK/dV launch over
    that group's rows of k, v, dk and dv (together every row once) with a
    slot a k-tile, then a dQ sum over those slots; every sum after the
    first reads dq and adds to it.  Each spec lints clean."""
    geo = _build.GEOMETRY["flash_attention"]
    bk, cap = geo[f"FLASH32_DKDV_K_ROWS_D{d}"], geo["FLASH32_DQ_SLOTS"]
    Sq, Sk = 200, 2 * cap * bk + 40                         # 3 groups, the last ragged
    slots, groups = tfa.dq_groups(Sk, d)
    assert (slots, groups) == (cap, 3)
    specs = tfa.kernel_specs(1, Sq, Sk, 2, 1, d, causal, F32, backward=True)
    assert [s.name for s in specs] == ["flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"] * groups
    rows = []
    for g, (dkdv, dq) in enumerate(zip(specs[::2], specs[1::2])):
        n_kt = min(cap, -(-Sk // bk) - g * cap)
        assert dkdv.grid[0] == n_kt and dkdv.outputs[2].shape[0] == n_kt
        assert dkdv.inputs[0].shape == dkdv.outputs[0].shape     # k and dk: the group's rows
        rows.append(dkdv.outputs[0].shape[1])
        assert dq.inputs[0].shape[0] == n_kt
        assert [b.name for b in dq.inputs] == (["dq_shares", "dq"] if g else ["dq_shares"])
        assert dq.aliases == ({1: 0} if g else {})
        for spec in (dkdv, dq):
            assert not tlint.lint_kernel_spec(spec), (g, spec.name)
    assert rows == [cap * bk, cap * bk, 40]
    if causal:      # the causal start of a later group's walk follows its global k-tile
        last = specs[-2]
        q_at = last.inputs[2].index_map
        first = min(q_at(*pt)[1] for pt in itertools.product(*map(range, last.grid)))
        assert first == max(2 * cap * bk - (Sk - Sq), 0) // geo[f"FLASH32_DKDV_Q_ROWS_D{d}"]


def test_the_gate_checks_a_second_group():
    """The backward entry's ``float32@groups`` example (S 1152, D 64,
    causal) has one k-tile more than a dQ workspace holds: its specs are two
    groups' launches, the second sum adding to dq, and they lint clean."""
    e = registry.entries()["flash_bwd_stream"]
    assert "float32@groups" in e.dtypes
    specs = e.build("float32@groups")[0]
    assert [s.name for s in specs] == ["flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"] * 2
    assert specs[3].aliases == {1: 0}
    rep = registry.check("flash_bwd_stream", dtype="float32@groups")
    assert not rep, rep.report()


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_dq_groups_follow_the_shape(d):
    """One group of launches up to FLASH32_DQ_SLOTS k-tiles, one more for
    each further that many; the workspace never holds more slots."""
    geo = _build.GEOMETRY["flash_attention"]
    bk, cap = geo[f"FLASH32_DKDV_K_ROWS_D{d}"], geo["FLASH32_DQ_SLOTS"]
    assert tfa.dq_groups(1, d) == (1, 1)
    assert tfa.dq_groups(bk, d) == (1, 1)
    assert tfa.dq_groups(bk + 1, d) == (2, 1)
    assert tfa.dq_groups(cap * bk, d) == (cap, 1)
    assert tfa.dq_groups(cap * bk + 1, d) == (cap, 2)
    assert tfa.dq_groups(3 * cap * bk, d) == (cap, 3)
    assert tfa.dq_groups(0, d) == (0, 0)


def test_the_dq_shares_cover_every_skipped_q_tile():
    """Causal with Sq < Sk: a late k-tile's walk starts past q-tile 0, yet
    its slot of the workspace is written at every q-tile (zeros where the
    walk skipped), so the dQ sum reads no stale slot."""
    dkdv, dq = tfa.kernel_specs(1, 300, 700, 2, 1, 64, True, F32, backward=True)
    shares = dkdv.outputs[2]
    points = list(itertools.product(*map(range, dkdv.grid)))
    written = {shares.index_map(*pt) for pt in points}
    nblocks = shares.nblocks()
    assert written == set(itertools.product(*map(range, nblocks)))
    q_at = dkdv.inputs[2].index_map
    assert max(q_at(*pt)[1] for pt in points if pt[0] == nblocks[0] - 1) == nblocks[2] - 1
    assert min(q_at(*pt)[1] for pt in points if pt[0] == nblocks[0] - 1) > 0   # skips tiles
    assert dq.inputs[0].shape == (nblocks[0], 300 * 2 * 64)


@pytest.mark.parametrize("entry", ["flash_fwd_resident", "flash_bwd_stream"])
def test_the_gate_checks_ernies_launches(entry):
    """The forward and the backward entries carry an fp32 example at
    ERNIE-base's attention (S 512, 12 heads of 64, B cut to 1), non-causal
    as `ernie_train` launches it, and its specs lint clean."""
    e = registry.entries()[entry]
    assert "float32@ernie" in e.dtypes
    specs, _, _, make_args = e.build("float32@ernie")
    assert all(s.cuda[2] == _build.dtype_code(F32) and s.cuda[3] == 64 for s in specs)
    args = make_args("cpu")
    assert args[0].shape == (1, 512, 12, 64) and args[0].dtype == F32
    if entry == "flash_bwd_stream":
        q_at = specs[0].inputs[2].index_map
        firsts = [q_at[1][pt][1] if isinstance(q_at, tuple) else q_at(*pt)[1]
                  for pt in itertools.product(*map(range, specs[0].grid)) if pt[3] == 0]
        assert set(firsts) == {0}          # every k-tile walks from q-tile 0: not causal
    rep = registry.check(entry, dtype="float32@ernie")
    assert not rep, rep.report()
