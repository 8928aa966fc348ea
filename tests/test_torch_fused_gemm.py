"""The fused GEMM's launch geometry on the CPU (``kernels/fused_gemm.py``,
``csrc/fused_gemm.cu``, ``csrc/wgmma.cuh``): the wgmma wrappers' transpose
immediates, the tensor-core kernel's shared memory, its TMA boxes and its
rasterisation, as the specs and the launch describe them.  The kernels
themselves run only on the card (``tests/test_torch_gpu.py``)."""

import itertools

import pytest
import torch

from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.kernels import _build, _wgmma_gen, emit
from paddle_tpu_torch.kernels import fused_gemm as fg

GEO = _build.GEOMETRY["fused_gemm"]
EPIS = {"store": fg._EPI_STORE, "swiglu": fg._EPI_SWIGLU, "swiglu_bwd": fg._EPI_SWIGLU_BWD}
# (epilogue, a_t, b_t) of every instantiation: four layouts store, the
# SwiGLU epilogues NN
VARIANTS = [("store", False, False), ("store", False, True), ("store", True, False),
            ("store", True, True), ("swiglu", False, False), ("swiglu_bwd", False, False)]


@pytest.mark.parametrize("n", _wgmma_gen.SS_T_N)
@pytest.mark.parametrize("ta,tb", _wgmma_gen.TRANS)
def test_wgmma_variants_carry_their_transpose_immediates(n, ta, tb):
    """WgmmaSS<N, TA, TB> issues m64nNk16 with imm-trans-a = TA and
    imm-trans-b = TB (scale-a and scale-b 1), and the header holds it."""
    body = _wgmma_gen._ss(n, ta, tb)
    assert f"m64n{n}k16.f32.bf16.bf16" in body
    assert body.count(f"p, 1, 1, {ta}, {tb};") == 1
    assert f'"+f"(d[{n // 2 - 1}])' in body and f'"+f"(d[{n // 2}])' not in body
    header = _wgmma_gen.header()
    start = header.index(f"struct WgmmaSS<{n}, {ta}, {tb}> {{")
    assert header[start:].split("};", 1)[0].count("mma_async") == 1
    assert body in header


def test_flash_wrappers_keep_k_major_operands():
    """Wgmma<N>::ss, which flash attention issues, stays both K-major."""
    for n in _wgmma_gen.SS_N:
        assert "p, 1, 1, 0, 0;" in _wgmma_gen._ss(n)


def _tc_spec(M, N, K, epi, a_t=False, b_t=False):
    return fg.gemm_spec("t", M, N, K, torch.bfloat16, c_dtype=torch.bfloat16, a_t=a_t,
                        b_t=b_t, epi=epi)


@pytest.mark.parametrize("epi,a_t,b_t", VARIANTS)
def test_tc_shared_memory_is_the_ring(epi, a_t, b_t):
    """The declared shared memory is the ring the kernel lays out: 1024
    bytes of alignment slack, STAGES stages of an A tile [BM][BK] and a B
    tile [BN][BK] of bf16, a full and an empty mbarrier a stage; within the
    H100's 232,448 bytes a CTA."""
    BM, BN, BK, ST = (GEO[k] for k in ("GEMM_TC_BM", "GEMM_TC_BN", "GEMM_TC_BK",
                                       "GEMM_TC_STAGES"))
    spec = _tc_spec(300, 1000, 520, EPIS[epi], a_t, b_t)
    want = 1024 + ST * (BM * BK + BN * BK) * 2 + 2 * ST * 8
    assert tlint._smem_bytes(spec) == want <= tlint.DEFAULT_SMEM_BUDGET
    assert spec.cuda[1:3] == (2, _build.dtype_code(torch.bfloat16))
    assert spec.cuda[4] == int(a_t) | int(not b_t) << 1 | EPIS[epi] << 2
    assert not tlint.lint_kernel_spec(spec)


def _stored_columns(maps, name, origin):
    """Stored columns a box reads: its in-bounds part of the map, offset by
    the map's first column (TMA zero-fills the rest)."""
    first, (cols, rows), (bw, bh) = maps[name]
    c, r = origin
    if r >= rows:
        return set()
    return {first + j for j in range(c, min(c + bw, cols))}


@pytest.mark.parametrize("I", [8, 200, 264, 5632])
@pytest.mark.parametrize("epi", ["swiglu", "swiglu_bwd"])
def test_swiglu_boxes_never_cross_into_the_other_half(I, epi):
    """gate_up [H, 2I] is read through two maps, the gate half and the up
    half at column I, each I columns wide: a gate box never reads a column
    at or past I, an up box never one before I or at or past 2I, and
    together the tiles read each column once a K step."""
    M, H = 77, 136
    maps, boxes = fg.tc_boxes(M, I, H, epi=EPIS[epi])
    (gx, gy), m_fast, cols = fg.tc_grid(M, I, EPIS[epi])
    assert cols == GEO["GEMM_TC_BN"] // 2
    BK = GEO["GEMM_TC_BK"]
    for x, y, kt in itertools.product(range(gx), range(gy), range(-(-H // BK))):
        mt, nt = (x, y) if m_fast else (y, x)
        read = {"gate": set(), "up": set()}
        for name, origin in boxes(mt, nt, kt):
            if name in read:
                got = _stored_columns(maps, name, origin)
                assert not got & read[name]
                read[name] |= got
        assert read["gate"] <= set(range(I)) and read["up"] <= set(range(I, 2 * I))
        n0 = nt * cols
        assert read["gate"] == set(range(n0, min(n0 + cols, I)))
        assert {c - I for c in read["up"]} == read["gate"]


@pytest.mark.parametrize("epi,a_t,b_t", VARIANTS)
def test_each_k_step_expects_the_bytes_its_boxes_bring(epi, a_t, b_t):
    """The full barrier of a stage expects A's and B's tiles whole, clipped
    or not: the boxes a K step loads add up to exactly those bytes."""
    maps, boxes = fg.tc_boxes(77, 200, 136, a_t=a_t, b_t=b_t, epi=EPIS[epi])
    stage = (GEO["GEMM_TC_BM"] + GEO["GEMM_TC_BN"]) * GEO["GEMM_TC_BK"] * 2
    for step in itertools.product(range(2), range(2), range(3)):
        got = sum(maps[n][2][0] * maps[n][2][1] * 2 for n, _ in boxes(*step))
        assert got == stage


@pytest.mark.parametrize("M,N", [(1, 8), (77, 200), (129, 264), (300, 1000), (6144, 32000),
                                 (2048, 5632)])
@pytest.mark.parametrize("epi", list(EPIS))
def test_rasterisation_covers_each_output_tile_once(M, N, epi):
    """Every output tile is written by exactly one CTA, for ragged M and N:
    the grid's (x, y) points map one to one onto the output's blocks, and
    x walks the row tiles exactly when B is the larger operand."""
    spec = _tc_spec(M, N, 64, EPIS[epi])
    (gx, gy), m_fast, cols = fg.tc_grid(M, N, EPIS[epi])
    assert spec.grid[:2] == (gx, gy)
    c = spec.outputs[0]
    assert c.block_shape == (GEO["GEMM_TC_BM"], cols)
    kind, dims = c.index_map
    assert kind == "affine"

    def block(*pt):
        return tuple(pt[i] if k == "axis" else i for k, i in dims)

    blocks = [block(x, y, 0) for x, y in itertools.product(range(gx), range(gy))]
    assert sorted(blocks) == sorted(itertools.product(*map(range, c.nblocks())))
    assert m_fast == (N * (2 if EPIS[epi] else 1) > M)
    if gx > 1:                      # consecutive CTAs share the column tile when m_fast
        assert (block(0, 0, 0)[1] == block(1, 0, 0)[1]) == m_fast


@pytest.mark.parametrize("name", ["fuse_swiglu_mlp", "fuse_rms_norm_head"])
@pytest.mark.parametrize("backward", [False, True])
def test_site_specs_round_fp32_weights_once(name, backward):
    """bf16 rows over fp32 weights: each weight's rounding pass once a site
    call, every GEMM on the tensor cores over bf16 operands, the RMS
    prologue as its normed pass; bf16 weights: no rounding pass; fp32: the
    CUDA-core kernel alone, prologue in its loads."""
    site = emit.SITES[name]
    static = dict(site.example_static)
    by = {dt: emit.site_specs(name, emit._example_shapes(site, dt), static, backward)
          for dt in ("float32", "bfloat16+float32", "bfloat16")}
    rounds = [s.name for s in by["bfloat16+float32"] if s.name.startswith("prep_kernel[round")]
    want = (["prep_kernel[round w_gate_up]", "prep_kernel[round w_down]"]
            if name == "fuse_swiglu_mlp" else ["prep_kernel[round w_head]"])
    assert rounds == want
    assert not [s for s in by["bfloat16"] if s.name.startswith("prep_kernel[round")]
    gemms16 = [s for s in by["bfloat16+float32"] if s.name.startswith("gemm")]
    assert gemms16 and all(s.name.startswith("gemm_tc_kernel") for s in gemms16)
    assert all(b.dtype == torch.bfloat16 for s in gemms16 for b in s.inputs[:2])
    normed = [s for s in by["bfloat16+float32"] if s.name.startswith("prep_kernel[")
              and "normed" in s.name]
    assert len(normed) == (name == "fuse_rms_norm_head")
    assert not [s for s in by["float32"] if s.name.startswith(("prep", "gemm_tc"))]


@pytest.mark.parametrize("name", sorted(emit.SITES))
def test_base_examples_lint_clean(name):
    """The bf16 entries' `base`-shaped example: every spec clean on the
    static leg, grids past ENUM_CAP included (affine maps, or tables)."""
    for entry in (name, name + "_bwd"):
        specs = emit.registry.entries()[entry].build("bfloat16+float32@base")[0]
        for spec in specs:
            assert not tlint.lint_kernel_spec(spec), spec.name


def test_to_compute_on_the_cpu():
    w = torch.randn(16, 24, generator=torch.Generator().manual_seed(3))
    assert torch.equal(fg.to_compute(w, torch.bfloat16), w.to(torch.bfloat16))
    assert fg.to_compute(w, torch.float32) is w
    wb = w.to(torch.bfloat16)
    assert fg.to_compute(wb, torch.bfloat16) is wb and fg.to_compute(wb, torch.float32) is wb
