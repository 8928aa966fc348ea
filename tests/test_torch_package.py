"""paddle_tpu_torch stands alone: no JAX and no paddle_tpu behind it, no
silent CPU fallback, and chip_smoke.py refuses to run without a GPU or
outside a checkout."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "paddle_tpu_torch"


def _run(code, cwd=REPO, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models, paddle_tpu_torch.kernels, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.models.presets, paddle_tpu_torch.analysis.kernel_lint, "
            "paddle_tpu_torch.framework.flags, paddle_tpu_torch.kernels.registry, "
            "paddle_tpu_torch.kernels.injected, paddle_tpu_torch.ops, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.io, paddle_tpu_torch.autograd, paddle_tpu_torch.linalg, "
            "paddle_tpu_torch.framework.tensor, paddle_tpu_torch.framework.autograd, "
            "paddle_tpu_torch.framework.dispatch, paddle_tpu_torch.framework.io, "
            "paddle_tpu_torch.framework.device, paddle_tpu_torch.framework.dtype, "
            "paddle_tpu_torch.framework.random, paddle_tpu_torch.profiler, "
            "paddle_tpu_torch.device, paddle_tpu_torch.device.cuda, paddle_tpu_torch.version, "
            "paddle_tpu_torch.sysconfig, paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.serving.loadgen\n"
            "import paddle_tpu_torch as paddle\n"
            "paddle.set_device('cpu')\n"
            "x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)\n"
            "(paddle.matmul(x, x) * 2).backward()\n"
            "with paddle.amp.auto_cast():\n"
            "    paddle.nn.functional.linear(x[None], paddle.ones([2, 2]))\n"
            "list(paddle.io.DataLoader(paddle.io.TensorDataset([x]), batch_size=1))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "print(bad)")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_paddle_tpu(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "paddle_tpu"), f"{path}: imports {mod}"


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama_tiny_config,
                                         ssd_tiny_config)
    from paddle_tpu_torch.serving import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(llama_tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SSDForCausalLM(ssd_tiny_config())
    for model in (LlamaForCausalLM(llama_tiny_config(), device="cpu"),
                  SSDForCausalLM(ssd_tiny_config(), device="cpu")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(model)
    assert pt.default_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_reject_other_devices():
    from paddle_tpu_torch.kernels.decode_attention import paged_decode_attention
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.ssd_scan import ssd_scan

    with pytest.raises(ValueError):
        rms_norm(torch.ones(2, 64, device="meta"), torch.ones(64, device="meta"))
    x = torch.ones(1, 16, 32, device="meta")
    with pytest.raises(ValueError):
        ssd_scan(x, torch.ones(1, 16, 16, device="meta"), torch.ones(1, 16, 16, device="meta"),
                 torch.ones(1, 16, device="meta"), chunk=16)
    q = torch.ones(1, 1, 4, 64, device="meta")
    pool = torch.ones(2, 2, 128, 64, device="meta")
    tbl = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, tbl, torch.ones(1, dtype=torch.int32,
                                                             device="meta"))


def test_kernel_build_is_keyed_by_source_hash():
    from paddle_tpu_torch.kernels import _build

    a = _build._lib_path("rms_norm")
    b = _build._lib_path("decode_attention")
    assert a.parent == _build.BUILD_DIR and a != b
    assert a.name.startswith("librms_norm-") and a.suffix == ".so"
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "paddle_tpu_torch/kernels/build/" in ignored


def test_chip_smoke_exits_nonzero_without_a_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_obs_copies_keep_the_serving_names():
    from paddle_tpu_torch import obs

    obs.reset_metrics()
    tr = obs.enable_tracing()
    try:
        from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
        from paddle_tpu_torch.serving import Engine, GenRequest

        model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        eng = Engine(model, device="cpu", max_batch=2, num_blocks=8, prefill_buckets=(128,))
        ids = np.arange(1, 30, dtype=np.int32)
        eng.add_request(GenRequest(prompt_ids=ids, max_new_tokens=4))
        eng.run_to_completion()
        doc = tr.to_chrome_trace(metrics=obs.registry().snapshot())
    finally:
        obs.disable_tracing()
    assert obs.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"serve.prefill", "serve.decode-chunk"} <= names
    assert "serve.ttft_ms" in doc["metrics"] and "serve.requests" in doc["metrics"]
