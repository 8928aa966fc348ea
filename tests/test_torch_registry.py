"""The port's kernel registry and verifier against the JAX package's.

``paddle_tpu_torch.kernels.registry`` must register the JAX registry's
entries (names, preset tags), and ``analysis.kernel_lint``'s static leg
must give the same codes, severities and counts as ``pallas_lint`` on the
same hand-built specs.  Admission is held to the JAX admission tests, on
CPU tensors (the static leg).  The dynamic leg's checks run here on torch
functions that carry each defect; on the CUDA kernels they need the card
(``tests/test_torch_gpu.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.analysis import pallas_lint as jlint
from paddle_tpu.kernels import registry as jregistry
from paddle_tpu_torch.analysis import kernel_lint as tlint
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.kernels import _build, emit, injected, registry
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.kernels import ssd_scan as tssd

REPO = Path(__file__).resolve().parents[1]

jregistry.load_all()
registry.load_all()


# the port's entries without a JAX counterpart: the SSD scan's backward
# kernels (the JAX package differentiates its plain scan instead) and the
# RMSNorm backward's (the JAX package's _rms_bwd_rule is XLA)
PORT_ONLY = {"ssd_scan_bwd", "rms_norm_bwd"}


def test_inventory_matches_the_jax_registry():
    assert sorted(set(registry.names()) - PORT_ONLY) == jregistry.names()
    assert set(registry.names()) >= PORT_ONLY
    assert len(registry.names()) == 20
    for name in jregistry.names():
        assert registry.entries()[name].presets == jregistry.entries()[name].presets, name
        assert registry.entries()[name].description == jregistry.entries()[name].description
    assert set(registry.check_all(presets="ssd")) == set(jregistry.check_all(presets="ssd")) \
        | {"ssd_scan_bwd"} == {"ssd_scan", "ssd_scan_bwd"}
    assert registry.entries()["rms_norm_bwd"].presets == registry.entries()["rms_norm"].presets


@pytest.mark.parametrize("name", sorted(registry.names()))
def test_every_entry_lints_clean_on_the_cpu(name):
    rep = registry.check(name)
    assert not rep, rep.report()
    assert rep.meta["legs"] == ["static"]
    assert rep.meta["kernel_smem_bytes"] <= tlint.DEFAULT_SMEM_BUDGET
    kernel_free = name in ("paged_chunk_attention", "write_paged_chunk")
    assert (rep.meta["kernels"] == 0) == kernel_free


# ---------------------------------------------------------------------------
# lint parity: the same hand-built specs through both verifiers
# ---------------------------------------------------------------------------

def _specs(case, mod, f32, bf16):
    """``case``'s KernelSpec built with module ``mod``'s classes (``jlint``
    with JAX dtypes, ``tlint`` with torch dtypes)."""
    B, S, K = mod.BlockUse, mod.ScratchUse, mod.KernelSpec
    if case == "write_race":         # registry.py:157's BlockSpecs
        return K(name="wr", grid=(4,),
                  inputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))],
                  outputs=[B((32, 128), f32, (8, 128), lambda i: (0, 0))],
                  dimension_semantics=("parallel",))
    if case == "parallel_carry":     # registry.py:182's, the carry as its jaxpr walk finds it
        return K(name="pc", grid=(2, 4),
                 inputs=[B((2, 32, 128), f32, (1, 8, 128), lambda g, i: (g, i, 0))],
                 outputs=[B((2, 32, 128), f32, (1, 8, 128), lambda g, i: (g, i, 0))],
                 scratch=[S((8, 128), f32)], dimension_semantics=("parallel", "parallel"),
                 carried_scratch=[(0, frozenset({1}))])
    if case == "oob_grid5":
        return K(name="oob", grid=(5,),
                 inputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))],
                 outputs=[B((40, 128), f32, (8, 128), lambda i: (i, 0))])
    if case == "ragged_overhang":
        return K(name="rag", grid=(4,),
                 inputs=[B((100, 128), f32, (32, 128), lambda i: (i, 0))],
                 outputs=[B((128, 128), f32, (32, 128), lambda i: (i, 0))])
    if case == "alias_mismatch":
        return K(name="gen", grid=(4,),
                 inputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))],
                 outputs=[B((32, 128), bf16, (8, 128), lambda i: (i, 0))], aliases={0: 0})
    if case == "alias_raw":
        return K(name="gen", grid=(4,),
                 inputs=[B((32, 128), f32, (8, 128), lambda i: ((i + 1) % 4, 0))],
                 outputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))], aliases={0: 0})
    assert case == "aligned_alias"
    return K(name="gen", grid=(4,),
             inputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))],
             outputs=[B((32, 128), f32, (8, 128), lambda i: (i, 0))], aliases={0: 0})


_EXPECTED = {
    "write_race": {("krn-coverage-hole", "high"), ("krn-write-race", "high")},
    "parallel_carry": {("krn-parallel-carry", "high")},
    "oob_grid5": {("krn-oob-read", "high")},
    "ragged_overhang": {("krn-oob-read", "medium")},
    "alias_mismatch": {("krn-alias-mismatch", "high")},
    "alias_raw": {("krn-alias-raw", "high")},
    "aligned_alias": set(),
}


def _summary(rep):
    return sorted((f.code, f.severity) for f in rep)


@pytest.mark.parametrize("case", sorted(_EXPECTED))
def test_static_leg_matches_pallas_lint(case):
    want = jlint.lint_kernel_spec(_specs(case, jlint, jnp.float32, jnp.bfloat16))
    got = tlint.lint_kernel_spec(_specs(case, tlint, torch.float32, torch.bfloat16))
    assert _summary(got) == _summary(want), (got.report(), want.report())
    assert set(_summary(got)) == _EXPECTED[case]
    if case == "parallel_carry":
        assert len(got.by_code("krn-parallel-carry")) == 1


def test_port_seeded_specs_give_the_jax_codes():
    """The seeded kernels' own specs (``kernels/injected.py``) report what
    the JAX registry's seeded kernels do."""
    race = tlint.lint_kernel_spec(injected.write_race_spec())
    assert race.by_code("krn-write-race") and race.by_code("krn-coverage-hole")
    carry = tlint.lint_kernel_spec(injected.parallel_carry_spec())
    assert len(carry.by_code("krn-parallel-carry")) == 1 and not carry.by_code("krn-write-race")


def test_shared_memory_over_budget_is_refused():
    rep = registry.check("flash_fwd_resident", smem_budget=64 * 1024)
    assert rep.by_code("krn-smem-over-budget"), rep.report()
    assert rep.meta["kernel_smem_bytes"] > 64 * 1024


def test_sentinel_outputs_fill_and_restore():
    det = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with pytest.raises(KeyError):
        with tlint.sentinel_outputs():
            assert bool(torch.isnan(torch.empty(8)).all())
            raise KeyError("leave the scope by an exception")
    assert torch.are_deterministic_algorithms_enabled() == det
    assert torch.utils.deterministic.fill_uninitialized_memory == fill


def _two_x(x):
    return 2.0 * x


def _hole(x):                    # writes half of its output
    y = torch.empty_like(x)
    y[:8] = 2.0 * x[:8]
    return y


def _oob(x):                     # reads one element past its input
    past = torch.as_strided(x, (x.numel() + 1,), (1,), x.storage_offset())
    y = 2.0 * x
    y[-1] = 2.0 * past[-1]
    return y


_CALLS = []


def _racy(x):                    # the second launch differs from the first
    _CALLS.append(1)
    return 2.0 * x + (1e-3 if len(_CALLS) % 3 == 2 else 0.0)


@pytest.mark.parametrize("launch,codes", [
    (_two_x, set()), (_hole, {"krn-coverage-hole"}),
    (_oob, {"krn-oob-read", "krn-plain-mismatch"}), (_racy, {"krn-write-race"}),
], ids=["clean", "hole", "oob", "race"])
def test_dynamic_leg_sees_each_defect(launch, codes):
    """The card's checks, driven on the CPU by torch functions that carry
    each defect: sentinels, guard bands, two launches, the plain version."""
    _CALLS.clear()
    rep = tlint.Report()
    tlint._dynamic_leg("toy", [], launch, _two_x,
                       lambda device: (torch.randn(16, generator=torch.Generator().manual_seed(0)),),
                       torch.device("cpu"), (0.0, 0.0, None), rep)
    assert set(rep.counts()) == codes, rep.report()


# ---------------------------------------------------------------------------
# carries: certified over in-CTA loop axes, refused across CTAs
# ---------------------------------------------------------------------------

def test_ssd_declares_sequential_chunk_axis():
    # the state pass carries the state; the chunks' kernels are all parallel
    for name in ("ssd_scan", "ssd_scan_bwd"):
        for dtype in ("float32", "float32@ssd_train"):
            specs = registry.entries()[name].build(dtype)[0]
            (spec,) = [s for s in specs if s.name.startswith("state_pass_kernel")]
            assert spec.dimension_semantics == ("parallel", "parallel", "arbitrary")
            assert spec.carried_scratch == [(0, frozenset({2}))]
            assert not tlint.lint_kernel_spec(spec)
            for other in specs:
                if other is not spec and other.name != "ssd_dcb_kernel":
                    assert set(other.dimension_semantics) == {"parallel"}, other.name


def test_ssd_parallel_chunk_axis_variant_refused():
    for reverse in (False, True):
        spec = tssd.state_pass_spec(2, 128, 32, 16, 16, reverse=reverse, chunk_axis="parallel")
        rep = tlint.lint_kernel_spec(spec)
        assert rep.by_code("krn-parallel-carry"), rep.report()
        assert rep.by_code("krn-write-race"), rep.report()


def test_flash_stream_carry_certified():
    (spec,) = registry.entries()["flash_fwd_stream"].build()[0]
    assert spec.carried_scratch, "expected the carried online-softmax state"
    for _, axes in spec.carried_scratch:
        assert axes == frozenset({2})
        assert not (axes & spec.parallel_axes())
    assert not tlint.lint_kernel_spec(spec)


# ---------------------------------------------------------------------------
# admission: a defective registered kernel is refused before its first launch
# ---------------------------------------------------------------------------

@pytest.fixture
def admission():
    orig = {n: registry.entries()[n] for n in ("ssd_scan", "fuse_add_rms_norm", "rms_norm")}
    registry.reset_admission_cache()
    try:
        yield
    finally:
        for e in orig.values():
            registry.register(e.name, e.build, presets=e.presets, description=e.description,
                              tol=e.tol, dtypes=e.dtypes)
        flags.set_flags({"kernel_admission": False})
        registry.reset_admission_cache()


def _ssd_args():
    g = torch.Generator().manual_seed(0)
    G, T, P, N = 2, 128, 8, 4
    return (torch.randn(G, T, P, generator=g), torch.randn(G, T, N, generator=g),
            torch.randn(G, T, N, generator=g), -0.1 * torch.ones(G, T))


def test_admission_refuses_defective_kernel_before_first_call(admission):
    flags.set_flags({"kernel_admission": True})
    registry.register("ssd_scan", registry._build_injected_write_race)
    before = tssd.ssd_scan.launches
    with pytest.raises(registry.KernelRejected, match="krn-write-race"):
        tssd.ssd_scan(*_ssd_args(), chunk=64)
    assert tssd.ssd_scan.launches == before


def test_admission_passes_clean_kernel_and_caches(admission):
    flags.set_flags({"kernel_admission": True})
    y, s = tssd.ssd_scan(*_ssd_args(), chunk=64)
    assert y.shape == (2, 128, 8) and s.shape == (2, 4, 8)
    tssd.ssd_scan(*_ssd_args(), chunk=64)          # the cache: admitted once
    assert registry.admissions() == {("ssd_scan", "cpu", "float32"): 1}


def test_admission_off_is_a_no_op(admission):
    registry.register("ssd_scan", registry._build_injected_write_race)
    y, _ = tssd.ssd_scan(*_ssd_args(), chunk=64)
    assert y.shape == (2, 128, 8)
    assert registry.admissions() == {}


def test_unregistered_name_passes_admission(admission):
    flags.set_flags({"kernel_admission": True})
    registry.ensure_admitted("not_a_registered_kernel", torch.device("cpu"))


def test_verified_activation_leaves_a_refused_site_out(admission):
    registry.register("fuse_add_rms_norm", registry._build_injected_write_race)
    with pytest.warns(RuntimeWarning, match="fuse_add_rms_norm was refused by kernel admission"):
        table = emit.verified_activation("cpu")
    assert sorted(table) == ["fuse_rms_norm_head", "fuse_swiglu_mlp"]


def test_admission_keys_on_the_dtype(admission):
    """Each dtype is admitted on its own instantiation's verdict: with the
    bf16 example's spec sabotaged, fp32 rows pass and bf16 rows are refused
    before the first call; a dtype with no example is refused."""
    clean = registry.entries()["rms_norm"]

    def build(dtype="bfloat16"):
        if dtype == "bfloat16":
            return registry._build_injected_write_race()
        return clean.build(dtype)

    registry.register("rms_norm", build, dtypes=clean.dtypes, tol=clean.tol)
    flags.set_flags({"kernel_admission": True})
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(0))
    trms.rms_norm(x, torch.ones(256))
    trms.rms_norm(x.to(torch.bfloat16), torch.ones(256))       # bf16 rows, fp32 weight
    with pytest.raises(registry.KernelRejected, match="krn-write-race"):
        trms.rms_norm(x.to(torch.bfloat16), torch.ones(256, dtype=torch.bfloat16))
    with pytest.raises(registry.KernelRejected, match="no example at dtype"):
        trms.rms_norm(x, torch.ones(256, dtype=torch.bfloat16))     # fp32 rows, bf16 weight
    assert registry.admissions() == {("rms_norm", "cpu", "float32"): 1,
                                     ("rms_norm", "cpu", "bfloat16+float32"): 1}


def test_verified_activation_admits_through_the_cache(admission):
    """verified_activation admits each site entry at each of its dtypes
    once; the fused callables it returns find them admitted."""
    flags.set_flags({"kernel_admission": True})
    table = emit.verified_activation("cpu")
    site = emit.SITES["fuse_add_rms_norm"]
    table[site.name](*emit._example_concrete(site, "cpu", 0), **site.example_static)
    want = {(n, "cpu", dt) for s in emit.SITES for n in (s, s + "_bwd")
            for dt in emit._SITE_DTYPES}
    assert registry.admissions() == dict.fromkeys(want, 1)


@pytest.mark.parametrize("name", ["flash_fwd_stream", "flash_bwd_stream", "fuse_swiglu_mlp"])
def test_bf16_examples_declare_the_bf16_kernels(name):
    """An entry's bf16 example declares the instantiations bf16 launches:
    flash's tensor-core kernels; the GEMM's tensor-core kernel with its
    bf16 code, after the passes that round the site's fp32 weights."""
    entry = registry.entries()[name]
    bf16 = [d for d in entry.dtypes if d.startswith("bfloat16")][0]
    specs32, specs16 = entry.build("float32")[0], entry.build(bf16)[0]
    if name == "fuse_swiglu_mlp":          # bf16 rows over fp32 weights
        rounds, specs16 = specs16[:2], specs16[2:]
        assert [s.name for s in rounds] == ["prep_kernel[round w_gate_up]",
                                            "prep_kernel[round w_down]"]
        assert all(s.cuda[1:4] == (3, _build.dtype_code(torch.float32), 0) for s in rounds)
    assert len(specs32) == len(specs16)
    for a, b in zip(specs32, specs16):
        assert a.cuda[2] == _build.dtype_code(torch.float32)
        assert b.cuda[2] == _build.dtype_code(torch.bfloat16)
        if name.startswith("flash"):
            assert b.name == a.name.replace("_kernel", "_tc_kernel")
        else:
            assert b.name == a.name.replace("gemm_kernel", "gemm_tc_kernel")


def test_geometry_reaches_its_sources():
    """Every geometry constant is a -D define its source reads, and the
    library's hash covers it."""
    for src, geometry in _build.GEOMETRY.items():
        text = (_build.CSRC / f"{src}.cu").read_text()
        for name, value in geometry.items():
            assert name in text, (src, name)
            assert f"-D{name}={value}" in _build._source(src)[1]
    assert _build._source("fused_gemm_emit_race")[1][-1] == "-DKERNEL_GATE_EMIT_RACE"


# ---------------------------------------------------------------------------
# the CLI and the seeded defects' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inject,rc,codes", [
    ("", 0, None),
    ("write-race", 1, {"krn-coverage-hole": 1, "krn-write-race": 1}),
    ("parallel-carry", 1, {"krn-parallel-carry": 1}),
])
def test_cli_on_the_cpu(inject, rc, codes):
    env = dict(os.environ, KERNEL_GATE_INJECT=inject)
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.kernels.registry",
                        "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == rc, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert out["kernel_count"] == 20 + bool(inject)
    for name, k in out["kernels"].items():
        assert k["legs"] == ["static"]
        if name.startswith("injected_"):
            assert k["codes"] == codes
        else:
            assert k["findings"] == 0, (name, k)
    assert out["total_findings"] == sum((codes or {}).values())


def test_cli_refuses_to_fall_back_to_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.kernels.registry"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert r.stdout == ""


def test_seeded_kernels_plain_versions():
    x = torch.randn(32, 128, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(injected.write_race(x), 2 * x, rtol=0, atol=0)
    x3 = torch.randn(2, 32, 128, generator=torch.Generator().manual_seed(1))
    want = torch.stack([sum(x3[:, 8 * j:8 * j + 8] for j in range(i + 1)) for i in range(4)], 1)
    torch.testing.assert_close(injected.parallel_carry(x3), want.reshape(2, 32, 128))


# ---------------------------------------------------------------------------
# operands a grid point does not touch (the multi-tensor AdamW's table)
# ---------------------------------------------------------------------------

def _adamw_table_spec():
    from paddle_tpu_torch.kernels import adamw

    (spec,) = adamw.kernel_spec([3 * adamw.CHUNK, 2 * adamw.CHUNK + 1, 5])
    return spec


def test_table_operands_map_other_leaves_to_no_block():
    """One operand a leaf and stream: each maps the CTAs of the other
    leaves' chunks to no block, as a sparse table or as a callable that
    returns None, and the spec is clean."""
    spec = _adamw_table_spec()
    assert spec.grid == (7,) and len(spec.inputs) == 12 and len(spec.outputs) == 9
    assert spec.inputs[4].index_map[1] == {(3,): (0,), (4,): (1,), (5,): (2,)}
    assert not tlint.lint_kernel_spec(spec)
    for bu in spec.inputs + spec.outputs:       # the same maps as callables
        table = bu.index_map[1]
        bu.index_map = lambda c, table=table: table.get((c,))
    assert not tlint.lint_kernel_spec(spec)
    assert not tlint.lint_kernel_spec(tlint.tabulated([spec])[0])


def test_table_operands_seeded_defects_are_refused():
    """The extension's seeded defects: two chunks mapped to one block of a
    leaf (a write race, and the block they leave unwritten), and a map that
    sends another leaf's chunk into its own blocks instead of to no block
    (out of bounds)."""
    spec = _adamw_table_spec()
    p_out = spec.outputs[0]                      # leaf 0's p, written
    images = dict(p_out.index_map[1])
    images[(1,)] = (0,)                          # chunks 0 and 1 both to block 0
    p_out.index_map = ("table", images)
    codes = {f.code for f in tlint.lint_kernel_spec(spec)}
    assert {"krn-write-race", "krn-coverage-hole", "krn-alias-raw"} <= codes
    spec = _adamw_table_spec()
    first = spec.inputs[4]                       # leaf 1's p, chunks 3 to 5
    first.index_map = lambda c: (c - 3,)         # forgets the other leaves
    assert ("krn-oob-read", "high") in _summary(tlint.lint_kernel_spec(spec))
