"""The dygraph programs of the JAX package, run on paddle_tpu_torch with
``import paddle_tpu_torch as paddle`` and ``paddle.set_device("cpu")``
(CPU): the eager loop ``loss.backward(); opt.step(); opt.clear_grad()`` of
``tests/test_llama.py`` (against the JAX package's own eager loop, staged
through one ``jax.jit`` so that its ops compile once) and of
``tests/test_ernie.py``, in fp32 and under ``auto_cast`` O1 with a
GradScaler (against the JAX ``TrainStep``: the JAX eager tape cannot run
O1's backward, see ``_jax_ernie_steps``), on weights carried across by
``models.convert``.

Tolerances: fp32 losses within rtol 1e-5; after the steps every parameter
within 2 lr a step of the JAX one (Adam moves an element whose gradient is
rounding noise by up to lr, either way) and all but 0.1% of the elements
within 1e-5.  Under O1 the losses within 2^-5 of themselves (measured: step
1 0.16%, step 3 1.2%: XLA keeps a fusion's intermediates in fp32 where
torch rounds every op's output to bf16, and Adam amplifies the difference)
and all but 1% of the parameters' elements within 2e-3.  The port's eager
loop equals its own ``TrainStep`` bit for bit, and a ``state_dict`` the JAX
package saved loads into the port's model and gives the same logits.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as paddle
from paddle_tpu.models import ErnieForSequenceClassification as JErnie
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny_config as j_llama_tiny
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.models import (ErnieForSequenceClassification, LlamaForCausalLM,
                                     ernie_tiny_config, llama_tiny_config,
                                     load_paddle_tpu_params)

LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, share=1e-3)       # fp32: all but 0.1% within 1e-5
AMP_LOSS_RTOL = 2.0 ** -5
AMP_PARAM_TOL = dict(atol=2e-3, share=1e-2)   # O1: all but 1% within 2e-3
STEPS = 3


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _batch(vocab, bsz=2, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(bsz, seq)).astype(np.int32)


def _weights(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _llama_loop(P, model, ids_np, steps=STEPS):
    """``tests/test_llama.py``'s eager program, verbatim but the import."""
    opt = P.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids = P.to_tensor(ids_np)
    losses = []
    for _ in range(steps):
        loss = model.compute_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _params(model):
    out = {}
    for n, p in model.named_parameters():
        d = p._data if hasattr(p, "_data") else p
        out[n] = np.asarray(d.detach().float().cpu().numpy() if isinstance(d, torch.Tensor) else d,
                            np.float32)
    return out


def _assert_params(got, want, atol, lr, share):
    """Every parameter within ``2 lr STEPS`` of the JAX one (Adam moves an
    element by at most ~lr a step, in the direction of its gradient's sign,
    which rounding decides where the gradient is noise), and all but
    ``share`` of all the model's elements within ``atol``."""
    assert sorted(got) == sorted(want)
    far = total = 0
    for n in want:
        diff = np.abs(got[n] - want[n])
        assert diff.max() <= 2 * lr * STEPS, (n, diff.max())
        far += int((diff > atol).sum())
        total += diff.size
    assert far <= share * total, (far, total)


@pytest.fixture(scope="module")
def jax_llama_run():
    """The JAX package's eager program (its tape, its eager ``AdamW.step``),
    staged through one ``jax.jit`` so that its ops compile once instead of
    one by one: the parameters go in as arguments and come back updated."""
    import jax

    jp.seed(0)
    jm = JLlama(j_llama_tiny())
    start = _weights(jm)
    ids = _batch(jm.config.vocab_size)
    params = list(jm.parameters())

    def program(arrays):
        for p, a in zip(params, arrays):
            p._data = a
        logits = jm(jp.to_tensor(ids))._data
        opt = jp.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
        x = jp.to_tensor(ids)
        losses = []
        for _ in range(STEPS):
            loss = jm.compute_loss(jm(x), x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss._data)
        return logits, losses, [p._data for p in params]

    logits, losses, finals = jax.jit(program)([p._data for p in params])
    for p, a in zip(params, finals):
        p._data = a
    return start, ids, np.asarray(logits), [float(v) for v in losses], _params(jm)


def test_llama_eager_program_matches_jax(jax_llama_run):
    start, ids, j_logits, j_losses, j_params = jax_llama_run
    paddle.seed(0)
    model = LlamaForCausalLM(llama_tiny_config())     # the device set_device chose
    load_paddle_tpu_params(model, start)
    logits = model(paddle.to_tensor(ids))
    assert isinstance(logits, paddle.Tensor) and logits.shape == [2, 32, 512]
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=1e-5, atol=1e-5)
    loss = model.compute_loss(logits, paddle.to_tensor(ids))
    assert abs(loss.item() - math.log(512)) < 0.5
    loss.backward()
    assert model.llama.embed_tokens._grad is not None
    model.zero_grad(set_to_none=True)
    losses = _llama_loop(paddle, model, ids)
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    _assert_params(_params(model), j_params, lr=1e-3, **PARAM_TOL)


def test_eager_loop_equals_train_step_bit_for_bit():
    """The same weights, batch and AdamW through the eager loop and through
    ``jit.TrainStep``: the same autograd graph and the same update, so the
    same bits (losses and every parameter)."""
    ids = _batch(512)
    runs = []
    for eager in (True, False):
        model = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=3)
        if eager:
            losses = _llama_loop(paddle, model, ids)
        else:
            opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
            step = paddle.jit.TrainStep(model, lambda m, x: m.compute_loss(m(x), x), opt)
            t = torch.from_numpy(ids)
            losses = [float(step(t)) for _ in range(STEPS)]
        runs.append((losses, _params(model)))
    (el, ep), (tl, tparams) = runs
    assert el == tl
    for n in ep:
        np.testing.assert_array_equal(ep[n], tparams[n], err_msg=n)


def _ernie_task(n=16, seq=16, vocab=200):
    rng = np.random.default_rng(0)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    y = rng.integers(0, 2, size=(n,)).astype(np.int64)
    ids[:, 1] = y + 1
    return ids, y


ERNIE = dict(vocab_size=200, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=96, max_position_embeddings=32, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _ernie_loop(P, model, ids_np, y_np, amp):
    """``tests/test_ernie.py``'s eager program under ``auto_cast`` O1 bf16
    with a GradScaler."""
    opt = P.optimizer.Adam(learning_rate=2e-3, parameters=model.parameters())
    scaler = P.amp.GradScaler()
    ids_t, y_t = P.to_tensor(ids_np), P.to_tensor(y_np)
    losses = []
    for _ in range(STEPS):
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            loss = model.compute_loss(model(ids_t), y_t)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _jax_ernie_steps(jm, ids_np, y_np, amp):
    """The same steps in the JAX package through its ``TrainStep`` under
    ``auto_cast`` (its eager tape cannot backward from an fp32 op into the
    bf16 output of a white-listed one: the cotangent keeps the fp32 dtype,
    and ``jax.vjp`` refuses it).  No loss scaling there: the port's
    GradScaler scales by 2^16 and back, which is exact for the loss and the
    fp32 parameter gradients."""
    opt = jp.optimizer.Adam(learning_rate=2e-3, parameters=jm.parameters())
    step = jp.jit.TrainStep(jm, lambda m, i, y: m.compute_loss(m(i), y), opt)
    ids_t, y_t = jp.to_tensor(ids_np), jp.to_tensor(y_np)
    losses = []
    for _ in range(STEPS):
        with jp.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            losses.append(float(step(ids_t, y_t).numpy()))
    return losses


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "O1"])
def test_ernie_eager_program_matches_jax(amp):
    """``tests/test_ernie.py``'s program on the port (fp32, and under O1 with
    a GradScaler) against the JAX package's steps.  The key biases are left
    out of the parameter check: their gradient is zero but for rounding,
    which Adam normalises into a step of either sign."""
    import paddle_tpu.models.ernie as jax_ernie

    ids, y = _ernie_task()
    jp.seed(0)
    jm = JErnie(jax_ernie.ernie_tiny_config(**ERNIE))
    start = _weights(jm)
    j_losses = _jax_ernie_steps(jm, ids, y, amp)
    model = ErnieForSequenceClassification(ernie_tiny_config(**ERNIE))
    load_paddle_tpu_params(model, start)
    losses = _ernie_loop(paddle, model, ids, y, amp)
    assert all(math.isfinite(v) for v in losses)
    got, want = _params(model), _params(jm)
    for d in (got, want):
        for n in [n for n in d if n.endswith("k_proj.bias")]:
            del d[n]
    if amp:
        np.testing.assert_allclose(losses, j_losses, rtol=AMP_LOSS_RTOL)
        _assert_params(got, want, lr=2e-3, **AMP_PARAM_TOL)
    else:
        np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
        _assert_params(got, want, lr=2e-3, **PARAM_TOL)


def test_ernie_o1_runs_its_products_in_bf16_and_its_norms_in_fp32():
    """What O1 gives ERNIE's ops, as in the JAX package: the linears (and so
    attention's q, k, v) bf16, layer norms and the loss fp32."""
    model = ErnieForSequenceClassification(ernie_tiny_config(**ERNIE))
    seen = {}

    def spy(name):
        def hook(mod, args, out):
            seen.setdefault(name, str(out.dtype))
        return hook

    model.ernie.encoder.layers[0].linear1.register_forward_hook(spy("linear"))
    model.ernie.encoder.layers[0].norm1.register_forward_hook(spy("layer_norm"))
    ids, y = _ernie_task()
    with paddle.amp.auto_cast(level="O1"):
        loss = model.compute_loss(model(paddle.to_tensor(ids)), paddle.to_tensor(y))
    assert seen == {"linear": "torch.bfloat16", "layer_norm": "torch.float32"}
    assert loss.dtype == torch.float32


def test_state_dict_saved_by_paddle_tpu_loads_into_the_port(tmp_path, jax_llama_run):
    start, ids, j_logits, _, _ = jax_llama_run
    jp.seed(0)
    jm = JLlama(j_llama_tiny())
    path = str(tmp_path / "llama.pdparams")
    jp.save(jm.state_dict(), path)
    model = LlamaForCausalLM(llama_tiny_config(), seed=7)
    state = paddle.load(path)
    assert all(isinstance(v, paddle.Tensor) for v in state.values())
    load_paddle_tpu_params(model, state)
    np.testing.assert_allclose(model(paddle.to_tensor(ids)).numpy(), j_logits,
                               rtol=1e-5, atol=1e-5)


def _nan_case(P, case, start):
    """Run ``case`` on package ``P`` with a NaN planted in its input: an
    ``nn.functional`` op, or layer 0's MLP of the tiny Llama with a NaN in
    its ``down_proj`` (on the port through the whole model, whose first
    seam to see the NaN must be that MLP's)."""
    F = P.nn.functional
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    if case == "linear":
        w = rng.standard_normal((16, 3)).astype(np.float32)
        w[0, 0] = np.nan
        return F.linear(P.to_tensor(x), P.to_tensor(w))
    if case == "layer_norm":
        x[0, 0, 0, 0] = np.nan
        return F.layer_norm(P.to_tensor(x), 16)
    if case == "scaled_dot_product_attention":
        q = x.copy()
        q[0, 0, 0, 0] = np.nan
        return F.scaled_dot_product_attention(P.to_tensor(q), P.to_tensor(x), P.to_tensor(x))
    weights = dict(start)
    down = "llama.layers.0.mlp.down_proj"
    weights[down] = weights[down].copy()
    weights[down][0, 0] = np.nan
    if P is jp:
        # the layer alone: the JAX model's eager forward compiles op by op
        from paddle_tpu.models.llama import LlamaMLP as JMLP

        mlp = JMLP(j_llama_tiny(), None)
        mlp.set_state_dict({k.rsplit(".", 1)[1]: jp.to_tensor(v) for k, v in weights.items()
                            if k.startswith("llama.layers.0.mlp.")})
        h = rng.standard_normal((2, 32, j_llama_tiny().hidden_size)).astype(np.float32)
        return mlp(jp.to_tensor(h))
    model = LlamaForCausalLM(llama_tiny_config(), seed=0)
    load_paddle_tpu_params(model, weights)
    return model(P.to_tensor(_batch(512)))


@pytest.mark.parametrize("case", ["linear", "layer_norm", "scaled_dot_product_attention",
                                  "swiglu_mlp"])
def test_check_nan_inf_names_the_op_whose_output_holds_a_nan(case, jax_llama_run):
    """Under ``FLAGS_check_nan_inf`` a NaN coming out of an ``nn.functional``
    op or a model seam raises naming the same op as the JAX package; without
    the flag it passes through."""
    start = jax_llama_run[0]
    msgs = {}
    for P in (paddle, jp):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError) as err:
                _nan_case(P, case, start)
            msgs[P.__name__] = str(err.value)
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
    assert msgs["paddle_tpu_torch"] == msgs["paddle_tpu"] == \
        f"NaN or Inf found in output of op '{case}'"
    assert np.isnan(_nan_case(paddle, case, start).numpy()).any()
