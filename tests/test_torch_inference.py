"""``paddle_tpu_torch.inference`` (``Config`` / ``Predictor`` over
``jit.save`` artifacts) against ``paddle_tpu`` (CPU).

The Predictor cases of ``tests/test_inference.py`` on the tiny Llama: the
port's model takes the JAX model's weights (``models.convert``), is saved
with ``jit.save`` (the kernel entries as ``torch.export`` custom ops) and
run back through ``jit.load`` and the Predictor; the logits agree with the
JAX forward within fp32 tolerance (``TOL``: the JAX tests' own, the port's
flash and RMSNorm entries against the JAX plain attention) and with the
port's eager forward bit for bit, and the loaded program calls the kernel
entries as often as the eager forward does (on the card those calls are
the launches: ``tests/test_torch_gpu.py``).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny_config as j_tiny
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_paddle_tpu_params, to_paddle_tpu_params

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


@pytest.fixture(scope="module")
def tiny_pair():
    jp.seed(7)
    jm = JLlama(j_tiny(use_flash_attention=False))
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny_config(), device="cpu")
    load_paddle_tpu_params(tm, {n: np.array(t._data) for n, t in jm.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 16)).astype(np.int32)
    want = np.asarray(jp.jit.to_static(jm)(jp.to_tensor(ids)).numpy())
    return tm, ids, want


class _Calls:
    """Counts the calls of the kernel entries the Llama forward reaches: the
    eager forward's RMSNorm entry (the name the model imported), the one the
    custom op calls (the kernel module's) and the flash forward both reach;
    calls on meta tensors (a recording's shape inference) are not counted,
    as on the card they launch nothing."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.kernels import flash_attention as kflash
        from paddle_tpu_torch.kernels import rms_norm as krms

        self.n = {"rms_norm": 0, "flash_attention": 0}
        for mod, attr, name in ((tllama, "rms_norm", "rms_norm"), (krms, "rms_norm", "rms_norm"),
                                (kflash, "flash_attention_fwd", "flash_attention")):
            fn = getattr(mod, attr)

            def counted(*a, _fn=fn, _name=name, **k):
                # a recording's shape inference (meta tensors) launches nothing
                self.n[_name] += a[0].device.type != "meta"
                return _fn(*a, **k)

            monkeypatch.setattr(mod, attr, counted)

    def take(self):
        out, self.n = dict(self.n), dict.fromkeys(self.n, 0)
        return out


def test_save_load_forward_roundtrip(tiny_pair, tmp_path):
    tm, ids, want = tiny_pair
    path = str(tmp_path / "llama_fwd")
    tp.jit.save(tm, path, input_spec=[tp.static.InputSpec([2, 16], "int32")])
    loaded = tp.jit.load(path)
    got = loaded(tp.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, tm(tp.to_tensor(ids)).numpy())
    # the exported graph holds one custom op node a kernel entry call
    ep = torch.export.load(path + ".pt2")
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    L = tm.config.num_hidden_layers
    assert sum("paddle_tpu_torch.rms_norm" in t for t in targets) == 2 * L + 1
    assert sum("paddle_tpu_torch.flash_attention" in t for t in targets) == L


def test_predictor_runs_forward_artifact(tiny_pair, tmp_path, monkeypatch):
    tm, ids, want = tiny_pair
    path = str(tmp_path / "llama_pred")
    tp.jit.save(tm, path, input_spec=[tp.static.InputSpec([2, 16], "int32")])
    config = tp.inference.Config(path)
    assert config.use_gpu()          # the card unless asked otherwise
    config.disable_gpu()
    pred = tp.inference.create_predictor(config)
    calls = _Calls(monkeypatch)
    eager = tm(tp.to_tensor(ids)).numpy()
    eager_calls = calls.take()
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids)
    assert pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert calls.take() == eager_calls
    L = tm.config.num_hidden_layers
    assert eager_calls == {"rms_norm": 2 * L + 1, "flash_attention": L}
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_array_equal(out, eager)


def test_to_static_replay_calls_the_same_entries(tiny_pair, monkeypatch):
    tm, ids, want = tiny_pair
    calls = _Calls(monkeypatch)
    static = tp.jit.to_static(tm)
    with tp.no_grad():
        eager = tm(tp.to_tensor(ids)).numpy()
        eager_calls = calls.take()
        first = static(tp.to_tensor(ids)).numpy()       # recorded (on meta), then replayed
        first_calls = calls.take()
        again = static(tp.to_tensor(ids)).numpy()
    assert first_calls == eager_calls and calls.take() == eager_calls
    np.testing.assert_array_equal(first, eager)
    np.testing.assert_array_equal(again, eager)
    np.testing.assert_allclose(again, want, **TOL)


def test_predictor_pool_and_auxiliary_surface(tiny_pair, tmp_path):
    tm, ids, want = tiny_pair
    path = str(tmp_path / "llama_pool")
    tp.jit.save(tm, path, input_spec=[tp.static.InputSpec([2, 16], "int32")])
    config = tp.inference.Config(path + ".pdmodel.json")     # a suffix is taken off
    config.disable_gpu()
    pool = tp.inference.PredictorPool(config, size=2)
    assert len(pool) == 2
    p = pool.retrieve(1)
    p.get_input_handle("input_0").copy_from_cpu(ids)
    p.run()
    np.testing.assert_allclose(p.get_output_handle("output_0").copy_to_cpu(), want, **TOL)
    assert tp.inference.get_num_bytes_of_data_type("bfloat16") == 2
    assert tp.inference.get_num_bytes_of_data_type(tp.inference.DataType.INT64) == 8
    assert "torch" in tp.inference.get_version()
    # the mixed-precision copy: floating weights cast, the program copied
    out = tp.inference.convert_to_mixed_precision(
        path + ".pt2", path + ".pdiparams", str(tmp_path / "mixed.pt2"),
        str(tmp_path / "mixed.pdiparams"), mixed_precision="bfloat16")
    state = tp.load(out)
    assert all(v.dtype == torch.bfloat16 for v in state["params"].values())


def test_artifact_weights_carry_to_the_jax_names(tiny_pair, tmp_path):
    """The artifact's weights are the JAX parameter names: they load into
    the JAX model and give its forward."""
    tm, ids, want = tiny_pair
    path = str(tmp_path / "llama_names")
    tp.jit.save(tm, path, input_spec=[tp.static.InputSpec([2, 16], "int32")])
    params = tp.load(path + ".pdiparams", return_numpy=True)["params"]
    ref = to_paddle_tpu_params(tm)
    assert sorted(params) == sorted(ref)
    for n, a in params.items():
        np.testing.assert_array_equal(a, ref[n])


def test_inference_all_matches_jax():
    import paddle_tpu.inference as ji

    assert tp.inference.__all__ == ji.__all__


def test_jax_artifact_weights_load_into_the_port(tiny_pair, tmp_path):
    """A JAX ``jit.save`` artifact's weights file loads into a fresh port
    model by name; the port's own artifact of it gives the JAX logits."""
    from paddle_tpu_torch.models.convert import load_paddle_tpu_artifact

    tm, ids, want = tiny_pair
    jp.seed(7)
    jm = JLlama(j_tiny(use_flash_attention=False))
    jprefix = str(tmp_path / "jax_fwd")
    jp.jit.save(jm, jprefix, input_spec=[jp.static.InputSpec([2, 16], "int32")])
    fresh = tllama.LlamaForCausalLM(tllama.llama_tiny_config(), device="cpu", seed=3)
    load_paddle_tpu_artifact(fresh, jprefix)
    prefix = str(tmp_path / "port_fwd")
    tp.jit.save(fresh, prefix, input_spec=[tp.static.InputSpec([2, 16], "int32")])
    got = tp.jit.load(prefix)(tp.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_export_generate_predictor_matches_generate(tiny_pair, tmp_path, monkeypatch):
    """``export_generate`` (B 2, P 16, 8 new tokens) run by a Predictor:
    the ids of the port's ``generate`` and of the JAX ``generate`` on the
    same weights; the program holds one custom op node a kernel entry call
    (the dense decode entry L x 7, RMSNorm (2L + 1) x 8) and the loaded
    program makes those calls."""
    from paddle_tpu_torch.kernels import decode_attention as kdecode

    tm, ids, _ = tiny_pair
    jp.seed(7)
    jm = JLlama(j_tiny(use_flash_attention=False))
    want = np.asarray(jm.generate(jp.to_tensor(ids), max_new_tokens=8)._data)
    eager = tm.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(eager, want)
    path = str(tmp_path / "llama_gen")
    assert tm.export_generate(path, 2, 16, 8) > 0
    with open(path + ".pdmodel.json") as f:
        meta = json.load(f)
    assert meta["format"] == "torch.export" and meta["inputs"] == [
        {"shape": [2, 16], "dtype": "int32"}]
    assert meta["generate"] == {"max_new_tokens": 8, "eos_token_id": None}
    L = tm.config.num_hidden_layers
    targets = [str(n.target) for n in torch.export.load(path + ".pt2").graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.masked_multihead_attention" in t for t in targets) == 7 * L
    assert sum("paddle_tpu_torch.rms_norm" in t for t in targets) == 8 * (2 * L + 1)

    config = tp.inference.Config(path)
    config.disable_gpu()
    pred = tp.inference.create_predictor(config)
    calls = _Calls(monkeypatch)
    mmha = kdecode.masked_multihead_attention
    n_decode = []
    monkeypatch.setattr(kdecode, "masked_multihead_attention",
                        lambda *a, **k: (n_decode.append(1), mmha(*a, **k))[1])
    pred.get_input_handle("input_0").copy_from_cpu(ids)
    assert pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert out.dtype == np.int32 and out.shape == (2, 16 + 8)
    np.testing.assert_array_equal(out, want)
    assert calls.take() == {"rms_norm": 8 * (2 * L + 1), "flash_attention": 0}
    assert len(n_decode) == 7 * L
