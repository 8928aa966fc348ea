"""paddle_tpu_torch's checkpoints against paddle_tpu's on the CPU: the
single-process save / load of ``distributed.checkpoint`` (atomic commit,
CRC32, bf16 views, async save), ``fleet.CheckpointManager``, and a run
begun by the JAX TrainStep and continued by the port through the
checkpoint the JAX package wrote.  Small models, numpy seeds; each
tolerance is stated where it is used."""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import save_state_dict as jax_save
from paddle_tpu.distributed.fleet import CheckpointManager as JaxManager
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed.fleet import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.tensor(rng.standard_normal((16, 32)).astype(np.float32)),
            "b16": torch.tensor(rng.standard_normal((8, 4)).astype(np.float32)).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
            "opt": {"m": torch.tensor(rng.standard_normal(5).astype(np.float32))}}


def _zeros_like(d):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in d.items()}


def _equal(a, b):
    return all(_equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k])
               for k in a)


def test_round_trip_is_bitwise(tmp_path):
    """fp32, bf16 (stored as a u2 view), a 0-d int32 and a nested dict come
    back bit for bit, in place into the caller's tensors."""
    src = _state()
    tck.save_state_dict(src, str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck")) == ["0_0.distcp.npz", "metadata.pkl"]
    dst = _zeros_like(src)
    keep = dst["w"]
    stats = {}
    tck.load_state_dict(dst, str(tmp_path / "ck"), stats=stats)
    assert _equal(dst, src) and dst["w"] is keep
    assert stats["tensors"] == 4
    with pytest.raises(NotImplementedError, match="prefer_files"):
        tck.load_state_dict(dst, str(tmp_path / "ck"), prefer_files=("0_0.distcp.npz",))
    meta = tck.read_metadata(str(tmp_path / "ck"))
    assert meta.state_dict_metadata["b16"]["dtype"] == "bfloat16"
    assert meta.state_dict_metadata["opt.m"]["chunks"][0].key == "opt.m|0"
    with np.load(tmp_path / "ck" / "0_0.distcp.npz") as f:
        assert f["b16|0,0"].dtype == np.uint16


def test_missing_tensor_and_shape_mismatch_raise(tmp_path):
    tck.save_state_dict({"a": torch.ones(3)}, str(tmp_path / "ck"))
    with pytest.raises(KeyError, match="not present"):
        tck.load_state_dict({"a": torch.zeros(3), "b": torch.zeros(2)}, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state_dict({"a": torch.zeros(4)}, str(tmp_path / "ck"))


def _flip_a_byte(path):
    """Flip one byte of the npz member's payload (the zip's own CRC is not
    touched by writing past the header: np.load reads stored members)."""
    fn = os.path.join(path, "0_0.distcp.npz")
    data = bytearray(open(fn, "rb").read())
    data[len(data) // 3] ^= 0xFF
    open(fn, "wb").write(bytes(data))


def test_flipped_byte_raises_corruption(tmp_path):
    tck.save_state_dict({"w": torch.arange(4096, dtype=torch.float32)}, str(tmp_path / "ck"))
    _flip_a_byte(str(tmp_path / "ck"))
    with pytest.raises(tck.CheckpointCorruptionError):
        tck.load_state_dict({"w": torch.zeros(4096)}, str(tmp_path / "ck"))


def test_interrupted_save_leaves_no_path(tmp_path, monkeypatch):
    """A save that dies before its commit leaves the old checkpoint or no
    ``path`` at all, never a half-written one (the JAX package's contract):
    killed while writing, the old one stays; killed at the final rename, the
    old one is gone and the new one is not visible."""
    path = str(tmp_path / "ck")

    def dies(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez", dies)
    with pytest.raises(OSError):
        tck.save_state_dict({"w": torch.ones(3)}, path)
    assert not os.path.exists(path)
    monkeypatch.undo()
    tck.save_state_dict({"w": torch.ones(3)}, path)
    monkeypatch.setattr(tck.np, "savez", dies)
    with pytest.raises(OSError):
        tck.save_state_dict({"w": torch.full((3,), 2.0)}, path)
    monkeypatch.undo()
    out = {"w": torch.zeros(3)}
    tck.load_state_dict(out, path)
    assert torch.equal(out["w"], torch.ones(3))       # the old checkpoint, whole
    monkeypatch.setattr(tck.os, "rename", dies)
    with pytest.raises(OSError):
        tck.save_state_dict({"w": torch.full((3,), 2.0)}, path)
    monkeypatch.undo()
    assert not os.path.exists(path)
    assert CheckpointManager(str(tmp_path)).latest() is None


def test_async_save(tmp_path):
    src = _state(1)
    fut = tck.save_state_dict(src, str(tmp_path / "ck"), async_save=True)
    src["w"].zero_()                                   # the host copy was taken already
    assert fut.result(timeout=60) == str(tmp_path / "ck")
    dst = _zeros_like(src)
    tck.load_state_dict(dst, str(tmp_path / "ck"))
    assert torch.equal(dst["w"], _state(1)["w"])


def test_restricted_unpickler_refuses_other_globals(tmp_path):
    import collections

    os.makedirs(tmp_path / "ck")
    with open(tmp_path / "ck" / "metadata.pkl", "wb") as f:
        pickle.dump(collections.OrderedDict(a=1), f)
    with pytest.raises(pickle.UnpicklingError, match="collections.OrderedDict"):
        tck.read_metadata(str(tmp_path / "ck"))


def test_reads_a_checkpoint_the_jax_package_wrote(tmp_path):
    """A JAX-written directory (fp32, bf16, int32 scalar, nested names)
    loads bit for bit, in a process that never imports paddle_tpu or jax."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    h = rng.standard_normal((8, 4)).astype(np.float32)
    jax_save({"w": jnp.asarray(w), "h": jnp.asarray(h).astype(jnp.bfloat16),
              "step": jnp.asarray(9, jnp.int32), "opt": {"m": jnp.asarray(w[0])}},
             str(tmp_path / "ck"))
    code = f"""
import sys, torch, numpy as np
from paddle_tpu_torch.distributed.checkpoint import load_state_dict
d = {{"w": torch.zeros(16, 32), "h": torch.zeros(8, 4, dtype=torch.bfloat16),
      "step": torch.zeros((), dtype=torch.int32), "opt": {{"m": torch.zeros(32)}}}}
load_state_dict(d, {str(tmp_path / "ck")!r})
assert "paddle_tpu" not in sys.modules and "jax" not in sys.modules, "imported"
np.save({str(tmp_path / "w.npy")!r}, d["w"].numpy())
np.save({str(tmp_path / "h.npy")!r}, d["h"].float().numpy())
print(int(d["step"]), float(d["opt"]["m"][3]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    step, m3 = out.stdout.split()
    assert int(step) == 9 and float(m3) == float(w[0, 3])
    assert np.array_equal(np.load(tmp_path / "w.npy"), w)
    assert np.array_equal(np.load(tmp_path / "h.npy"),
                          np.asarray(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_manager_prunes_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 5):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    assert mgr.complete_steps() == [3, 4] and mgr.latest() == 4
    fut = mgr.save(5, {"w": torch.full((3,), 5.0)}, async_save=True)
    fut.result(timeout=60)
    mgr.save(6, {"w": torch.full((3,), 6.0)})
    assert mgr.complete_steps() == [5, 6]


def test_manager_falls_back_past_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2):
        mgr.save(s, {"w": torch.arange(4096, dtype=torch.float32) * s})
    _flip_a_byte(os.path.join(str(tmp_path), "step_00000002"))
    target = {"w": torch.zeros(4096)}
    keep = target["w"]
    assert mgr.resume(target) == 1
    assert torch.equal(target["w"], torch.arange(4096, dtype=torch.float32)) and target["w"] is keep
    assert "step_00000002.corrupt" in os.listdir(tmp_path)
    assert mgr.complete_steps() == [1]


def test_manager_restores_the_lr_scheduler(tmp_path):
    """A resume continues the LR schedule, not its warmup (the JAX test of
    the same name), and the TrainStep's step count."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import StepDecay

    def build():
        torch.manual_seed(3)
        model = torch.nn.Linear(4, 2)
        sched = StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
        opt = AdamW(learning_rate=sched, parameters=model.parameters())
        return TrainStep(model, lambda m, x: (m(x) ** 2).mean(), opt), sched, opt

    step_fn, sched, opt = build()
    x = torch.ones(2, 4)
    for _ in range(5):
        step_fn(x)
        sched.step()
    lr_after_5 = opt.get_lr()
    assert lr_after_5 < 0.1
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=1)
    mgr.save(5, step_fn)
    step2, sched2, opt2 = build()
    assert opt2.get_lr() == 0.1
    assert mgr.resume(step2) == 5
    assert opt2.get_lr() == lr_after_5 and sched2.last_epoch == sched.last_epoch
    assert step2._step == 5
    assert float(step2(x)) == float(step_fn(x))       # the same next step, to the bit


# ---------------------------------------------------------------------------
# a run begun by the JAX TrainStep, continued by the port
# ---------------------------------------------------------------------------

NARROW = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
LR = 1e-3


def test_port_resumes_a_jax_run_from_its_checkpoint(tmp_path):
    """The JAX TrainStep (tiny Llama, AdamW) takes two steps and saves them
    through its CheckpointManager; the port's TrainStep, built from other
    weights, resumes from that directory with its own code and takes step
    3, as the JAX one does."""
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import llama_tiny_config as jax_tiny
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         to_paddle_tpu_train_state)
    from paddle_tpu_torch.optimizer import AdamW

    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    js = paddle.jit.TrainStep(jm, lambda m, ids: m.compute_loss(m(ids), ids),
                              paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.1,
                                                     parameters=jm.parameters()))
    ids = np.random.default_rng(7).integers(0, 256, (2, 32)).astype(np.int32)
    for _ in range(2):
        js(paddle.to_tensor(ids))
    JaxManager(str(tmp_path), keep=1).save(2, js)

    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=5)
    ts = TrainStep(tm, lambda m, x: m.compute_loss(m(x), x),
                   AdamW(learning_rate=LR, weight_decay=0.1, parameters=tm.parameters()))
    assert CheckpointManager(str(tmp_path)).resume(ts) == 2 and ts._step == 2
    state = to_paddle_tpu_train_state(ts)
    for k, a in js.state_dict().items():
        np.testing.assert_array_equal(state[k], np.asarray(a), err_msg=k)   # loaded exactly
    lj = float(np.asarray(js(paddle.to_tensor(ids))._data))
    lt = float(ts(ids))
    # fp32 forward of the same weights: sums in another order
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    tsd = ts.state_dict()
    for k, b in js.state_dict().items():
        a, b = tsd[k].numpy(), np.asarray(b)
        if k.startswith("param."):
            # step 3 from equal state: 1.2e-7 apart at most, where the step
            # moved an element by up to 1.1e-3 (both read on the CPU); a
            # limit ~17x the reading, far below one step's update
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=k)
        elif k.startswith("opt"):
            # fp32 moments from gradients summed in another order
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_train_state_exchange_through_convert():
    """``load_paddle_tpu_train_state`` takes the JAX TrainStep's flat state
    (numpy) and refuses one whose keys differ."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         load_paddle_tpu_train_state, to_paddle_tpu_train_state)
    from paddle_tpu_torch.optimizer import AdamW

    def build(seed):
        m = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu", seed=seed)
        return TrainStep(m, lambda m, x: m.compute_loss(m(x), x),
                         AdamW(learning_rate=LR, parameters=m.parameters()))

    a, b = build(0), build(1)
    ids = np.random.default_rng(8).integers(0, 256, (2, 16)).astype(np.int32)
    a(ids)
    flat = to_paddle_tpu_train_state(a)
    load_paddle_tpu_train_state(b, flat)
    assert b._step == 1 and float(a(ids)) == float(b(ids))
    flat.pop("param.lm_head")
    with pytest.raises(KeyError, match="param.lm_head"):
        load_paddle_tpu_train_state(b, flat)
