"""paddle_tpu_torch's optimizer layer against paddle_tpu on the CPU: the 14
optimizers (eager ``step()`` and ``functional()``), the 18 LR schedulers,
the clips, AdamW's ``apply_decay_param_fun``, the multi-tensor AdamW table
and ``TrainStep.state_dict``.

The same numpy-seeded parameters and gradients go through the JAX
optimizer (its XLA update; the fused AdamW only under
``FLAGS_pallas_interpret``, used here for ``adamw_update``) and the port's.
fp32 throughout; each tolerance is stated where it is used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import adamw as jadamw
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.kernels import adamw as tadamw
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"w": (6, 5), "norm": (5,), "k": (3, 2, 4)}
# (constructor keywords, steps); RAdam takes 7 steps so that its rectified
# branch (rho_t > 5 from step 6 at beta2 0.999) runs too
CASES = {
    "SGD": (dict(learning_rate=0.1, weight_decay=0.01), 3),
    "Momentum": (dict(learning_rate=0.1, momentum=0.9, weight_decay=0.01), 3),
    "Momentum-nesterov": (dict(learning_rate=0.1, momentum=0.9, use_nesterov=True), 3),
    "Adam": (dict(learning_rate=0.01, weight_decay=0.01), 3),
    "AdamW": (dict(learning_rate=0.01, weight_decay=0.1), 3),
    "Adagrad": (dict(learning_rate=0.1, weight_decay=0.01, initial_accumulator_value=0.1), 3),
    "RMSProp": (dict(learning_rate=0.01, rho=0.9, momentum=0.5), 3),
    "RMSProp-centered": (dict(learning_rate=0.01, momentum=0.5, centered=True), 3),
    "Adadelta": (dict(learning_rate=1.0, weight_decay=0.01), 3),
    "Adamax": (dict(learning_rate=0.01, weight_decay=0.01), 3),
    "Lamb": (dict(learning_rate=0.01, lamb_weight_decay=0.01), 3),
    "NAdam": (dict(learning_rate=0.01, weight_decay=0.01), 3),
    "RAdam": (dict(learning_rate=0.01), 7),
    "ASGD": (dict(learning_rate=0.1, weight_decay=0.01), 3),
    "Rprop": (dict(learning_rate=0.01, learning_rate_range=(1e-4, 1.0), etas=(0.5, 1.2)), 3),
}
# fp32 elementwise updates in another order of fused operations (XLA's
# contraction, torch's CPU kernels, pow of beta ** t): a few ulps
TOL = dict(rtol=1e-5, atol=1e-6)


def _values(seed, steps):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def _cls(case):
    return case.split("-")[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_step_matches_jax(case):
    """Three eager steps (seven for RAdam) on fixed gradients, the `norm`
    leaf marked no_weight_decay: every parameter and slot."""
    kw, steps = CASES[case]
    params, grads = _values(1, steps)
    jp = {n: paddle.Parameter(a) for n, a in params.items()}
    tp = {n: torch.nn.Parameter(torch.tensor(a)) for n, a in params.items()}
    jp["norm"].no_weight_decay = tp["norm"].no_weight_decay = True
    jo = getattr(paddle.optimizer, _cls(case))(parameters=list(jp.values()), **kw)
    to = getattr(topt, _cls(case))(parameters=list(tp.values()), **kw)
    for g in grads:
        for n in SHAPES:
            jp[n]._grad = jnp.asarray(g[n])
            tp[n].grad = torch.tensor(g[n])
        jo.step()
        to.step()
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]._data), **TOL,
                                   err_msg=n)
    for js, ts in zip(jo._state, to._state):
        assert sorted(js) == sorted(ts)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL, err_msg=k)
    assert to._step_count == jo._step_count == steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_functional_update_matches_jax(case):
    """``functional()``'s update, the TrainStep path (every leaf decays),
    from step 5 on: parameters and every slot."""
    kw, steps = CASES[case]
    params, grads = _values(2, steps)
    jo = getattr(paddle.optimizer, _cls(case))(
        parameters=[paddle.Parameter(a) for a in params.values()], **kw)
    to = getattr(topt, _cls(case))(
        parameters=[torch.nn.Parameter(torch.tensor(a)) for a in params.values()], **kw)
    jinit, jupdate = jo.functional()
    tinit, tupdate = to.functional()
    jparams = {n: jnp.asarray(a) for n, a in params.items()}
    tparams = {n: torch.tensor(a) for n, a in params.items()}
    jstate, tstate = jinit(jparams), tinit(tparams)
    lr = kw["learning_rate"]
    for i, g in enumerate(grads):
        jparams, jstate = jupdate(jparams, {n: jnp.asarray(a) for n, a in g.items()}, jstate,
                                  jnp.asarray(lr, jnp.float32), jnp.asarray(5 + i, jnp.int32))
        out, _ = tupdate(tparams, {n: torch.tensor(a) for n, a in g.items()}, tstate, lr, 5 + i)
        assert out is tparams                      # in place
    for n in SHAPES:
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), **TOL,
                                   err_msg=n)
        assert sorted(tstate[n]) == sorted(jstate[n])
        for k in jstate[n]:
            np.testing.assert_allclose(tstate[n][k].numpy(), np.asarray(jstate[n][k]), **TOL,
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
def test_bf16_params_keep_fp32_masters(name):
    """bf16 parameters: an fp32 ``master`` slot carries the update (AdamW
    through the multi-tensor path with the parameter as its bf16 copy, SGD
    through its plain update), the parameter is the master rounded."""
    params, grads = _values(3, 3)
    jp = [paddle.Parameter(a) for a in params.values()]
    for p in jp:
        p._data = p._data.astype("bfloat16")
    tp = [torch.nn.Parameter(torch.tensor(a).to(torch.bfloat16)) for a in params.values()]
    kw = dict(learning_rate=0.01, weight_decay=0.1)
    jo = getattr(paddle.optimizer, name)(parameters=jp, **kw)
    to = getattr(topt, name)(parameters=tp, **kw)
    for g in grads:
        for j, t, a in zip(jp, tp, g.values()):      # bf16 gradients of bf16 params
            j._grad = jnp.asarray(a).astype(jnp.bfloat16)
            t.grad = torch.tensor(a).to(torch.bfloat16)
        jo.step()
        to.step()
    for j, t, js, ts in zip(jp, tp, jo._state, to._state):
        np.testing.assert_allclose(ts["master"].numpy(), np.asarray(js["master"]), **TOL)
        # the parameter is its master rounded to bf16 (both sides)
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.detach(), ts["master"].to(torch.bfloat16))


def test_lbfgs_matches_jax_on_a_quadratic():
    """LBFGS's host-driven closure loop (float64 numpy search over fp32
    parameters) on 0.5 x'Ax - b'x: the same iterates, and the solution."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    A = A @ A.T + 6 * np.eye(6, dtype=np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    jx = paddle.to_tensor(np.zeros(6, np.float32))
    jx.stop_gradient = False
    jA, jb = paddle.to_tensor(A), paddle.to_tensor(b)
    jo = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=25, parameters=[jx])
    tx = torch.nn.Parameter(torch.zeros(6))
    tA, tb = torch.tensor(A), torch.tensor(b)
    to = topt.LBFGS(learning_rate=1.0, max_iter=25, parameters=[tx])

    def jclosure():
        jo.clear_grad()
        loss = 0.5 * (jx @ (jA @ jx)) - jb @ jx
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = 0.5 * (tx @ (tA @ tx)) - tb @ tx
        loss.backward()
        return loss

    fj, ft = jo.step(jclosure), to.step(tclosure)
    # fp32 gradients of the same quadratic in another summation order feed
    # a float64 search: iterates agree to a few fp32 ulps of the solution
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx._data), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), np.linalg.solve(A, b), rtol=1e-2, atol=1e-2)


def test_optimizer_exports_match_jax():
    import paddle_tpu.optimizer as jopt

    public = {n for n in dir(jopt) if not n.startswith("_")}
    assert public - {"annotations"} <= set(dir(topt))
    assert sorted(topt.optimizer.__all__) == sorted(
        jopt.optimizer.__all__ + ["Rprop", "LBFGS"])


# ---------------------------------------------------------------------------
# AdamW options
# ---------------------------------------------------------------------------

def test_apply_decay_param_fun_marks_no_weight_decay():
    """``apply_decay_param_fun(name)`` False leaves the parameter undecayed
    in the eager step, as the JAX AdamW does for ``Parameter.name``; the
    port asks the ``named_parameters()`` name.  ``lr_ratio`` is accepted
    and, as in the JAX package, not applied."""
    params, grads = _values(4, 2)
    names = {"w": "layer.weight", "norm": "layer.norm.weight", "k": "conv.weight"}
    jp = {n: paddle.Parameter(a, name=names[n]) for n, a in params.items()}
    tp = {n: torch.nn.Parameter(torch.tensor(a)) for n, a in params.items()}

    def fun(name):
        return "norm" not in name

    jo = paddle.optimizer.AdamW(learning_rate=0.01, weight_decay=0.5,
                                parameters=list(jp.values()), apply_decay_param_fun=fun)
    to = topt.AdamW(learning_rate=0.01, weight_decay=0.5, lr_ratio=lambda p: 0.5,
                    parameters=[(names[n], p) for n, p in tp.items()],
                    apply_decay_param_fun=fun)
    assert tp["norm"].no_weight_decay and not hasattr(tp["w"], "no_weight_decay")
    for g in grads:
        for n in SHAPES:
            jp[n]._grad = jnp.asarray(g[n])
            tp[n].grad = torch.tensor(g[n])
        jo.step()
        to.step()
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]._data), **TOL)
    # the undecayed leaf moved as plain Adam would move it
    ref, m, v = torch.tensor(params["norm"]), torch.zeros(5), torch.zeros(5)
    for i, g in enumerate(grads):
        ref, m, v = tadamw.adamw_reference(ref, torch.tensor(g["norm"]), m, v, 0.01, i + 1,
                                           beta1=0.9, beta2=0.999, epsilon=1e-8)
    torch.testing.assert_close(tp["norm"].detach(), ref, rtol=0, atol=0)


def test_adam_coupled_decay_honours_no_weight_decay():
    """Adam's L2 (coupled) decay skips a no_weight_decay leaf in the eager
    step, as the JAX optimizer's XLA update does, through the kernel's
    table as through its plain version."""
    a = torch.nn.Parameter(torch.ones(4))
    b = torch.nn.Parameter(torch.ones(4))
    b.no_weight_decay = True
    opt = topt.Adam(learning_rate=0.1, weight_decay=0.5, parameters=[a, b])
    a.grad, b.grad = torch.zeros(4), torch.zeros(4)
    opt.step()
    assert float(a[0]) < 1.0 and torch.equal(b.detach(), torch.ones(4))


@pytest.mark.parametrize("multi_precision", [True, False])
def test_adam_family_sends_every_leaf_to_the_wrapper(monkeypatch, multi_precision):
    """Every Adam / AdamW leaf reaches ``adamw_update_leaves`` in one call
    a step, bf16 parameters too: over an fp32 master, or without one
    (``multi_precision=False``) over an fp32 working copy, the parameter
    the copy each time; the result is the plain version's bits."""
    from paddle_tpu_torch.optimizer import optimizer as toptimizer

    calls = []
    real = toptimizer.adamw_update_leaves

    def spy(params32, *a, **kw):
        calls.append(len(params32))
        return real(params32, *a, **kw)

    monkeypatch.setattr(toptimizer, "adamw_update_leaves", spy)
    rng = np.random.default_rng(12)
    ps = [torch.nn.Parameter(torch.tensor(0.02 * rng.standard_normal(n).astype(np.float32))
                             .to(torch.bfloat16)) for n in (3, 40, 7)]
    gs = [torch.tensor(1e-3 * rng.standard_normal(p.shape).astype(np.float32))
          .to(torch.bfloat16) for p in ps]
    start = [p.detach().float() for p in ps]
    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.1)
    opt = topt.AdamW(learning_rate=1e-3, parameters=ps, multi_precision=multi_precision,
                     **{k: v for k, v in hyper.items() if k != "epsilon"})
    for p, g in zip(ps, gs):
        p.grad = g
    opt.step()
    assert calls == [3]
    for p, g, p0, s in zip(ps, gs, start, opt._state):
        assert ("master" in s) == multi_precision
        z = torch.zeros_like(p0)
        want, m, v = tadamw.adamw_reference(p0, g.float(), z, z, 1e-3, 1, **hyper)
        assert p.dtype == torch.bfloat16 and torch.equal(p.detach(), want.to(torch.bfloat16))
        assert torch.equal(s["m"], m) and torch.equal(s["v"], v)


# ---------------------------------------------------------------------------
# the multi-tensor AdamW table
# ---------------------------------------------------------------------------

def _table(seed, sizes, g_dtype=torch.float32, offset=0):
    """p, g, m, v a leaf of ``sizes``; ``g_dtype`` "mixed": bf16 and fp32
    gradients leaf by leaf in turn."""
    rng = np.random.default_rng(seed)
    dtypes = ([torch.bfloat16, torch.float32] * len(sizes) if g_dtype == "mixed"
              else [g_dtype] * len(sizes))

    def leaf(n, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(n + offset).astype(np.float32))[offset:]

    p = [leaf(n) for n in sizes]
    g = [leaf(n).to(dt) for n, dt in zip(sizes, dtypes)]
    m = [leaf(n, 0.1) for n in sizes]
    v = [leaf(n).abs() * 0.01 for n in sizes]
    return p, g, m, v


RAGGED = [1, 3, 4097, 0, 2048, 3 * tadamw.CHUNK + 5]


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16, "mixed"])
@pytest.mark.parametrize("offset", [0, 1])
def test_adamw_update_leaves_ragged_table_is_the_reference_bitwise(g_dtype, offset):
    """A ragged table (sizes 1, 3, 4097, an empty leaf, 2048 and three
    chunks and a tail; views at offset 1; bf16 gradients, or bf16 and fp32
    ones in one table; bf16 copies; one leaf undecayed): every leaf bit for
    bit ``adamw_reference`` on the widened gradient."""
    p, g, m, v = _table(5, RAGGED, g_dtype, offset)
    apply = [True, False, True, True, True, True]
    outs = [torch.empty(n, dtype=torch.bfloat16) if i % 2 else None
            for i, n in enumerate(RAGGED)]
    hyper = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
    ref = [tadamw.adamw_reference(*x, 3e-4, 7, apply_decay=a, **hyper)
           for x, a in zip(zip(p, [x.float() for x in g], m, v), apply)]
    launches = tadamw.adamw_update_leaves.launches
    assert tadamw.adamw_update_leaves(p, g, m, v, outs, 3e-4, 7, apply_decay=apply,
                                      **hyper) is None
    assert tadamw.adamw_update_leaves.launches == launches       # the CPU runs no kernel
    for i, (got, want) in enumerate(zip(zip(p, m, v), ref)):
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        if outs[i] is not None:
            assert torch.equal(outs[i], want[0].to(torch.bfloat16))


@pytest.mark.parametrize("kw", [dict(weight_decay=0.1, decoupled=True),
                                dict(weight_decay=0.1, decoupled=True, apply_decay=[False] * 3),
                                dict(weight_decay=0.01, decoupled=False)])
def test_adamw_update_leaves_matches_jax_adamw_update(kw):
    """The table against the JAX ``adamw_update`` a leaf, its Pallas kernel
    in interpret mode (as tests/test_torch_train.py holds one leaf)."""
    sizes = [3000, 7, 130]
    p, g, m, v = _table(6, sizes)
    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
    jkw = dict(kw)
    jkw.pop("apply_decay", None)
    want = []
    for i in range(len(sizes)):
        apply = kw.get("apply_decay", [True] * 3)[i]
        want.append(jadamw.adamw_update(
            *(jnp.asarray(x[i].numpy()) for x in (p, g, m, v)), jnp.asarray(3e-4, jnp.float32),
            1000, interpret=True, apply_decay=apply, **hyper, **jkw)[:3])
    tadamw.adamw_update_leaves(p, g, m, v, [None] * 3, 3e-4, 1000, **hyper, **kw)
    for got, w in zip(zip(p, m, v), want):
        for a, b in zip(got, w):
            # fp32 pow of beta ** t and XLA's FMA contraction: a few ulps
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def _leaf_sizes(kind, c):
    """A model's leaf sizes in its parameters' order, from its config's
    widths."""
    if kind == "llama":
        qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * c.head_dim
        layer = [c.hidden_size, c.hidden_size * qkv,
                 c.num_attention_heads * c.head_dim * c.hidden_size, c.hidden_size,
                 c.hidden_size * 2 * c.intermediate_size, c.intermediate_size * c.hidden_size]
    else:
        H, nh, P, N = c.hidden_size, c.num_heads, c.head_dim, c.state_size
        layer = [H, H * (2 * nh * P + 2 * nh * N + nh), nh, nh, nh * P * H]
    head = [] if c.tie_word_embeddings else [c.hidden_size * c.vocab_size]
    return (head + [c.vocab_size * c.hidden_size] + layer * c.num_hidden_layers
            + [c.hidden_size])


def test_train_tables_are_the_models_leaves():
    """``adamw.TRAIN_TABLES`` (the registry's `@base` / `@ssd_train`
    examples and chip_smoke.py's timed tables) are the leaves of `base` and
    of `ssd_train`'s model: the widths' layout holds on the tiny models'
    own parameters, and gives the tables at those presets' widths."""
    from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama_tiny_config,
                                         ssd_8b_config, ssd_tiny_config)
    from paddle_tpu_torch.models.presets import build_config

    for kind, model in (("llama", LlamaForCausalLM(llama_tiny_config(tie_word_embeddings=False),
                                                   device="cpu")),
                        ("ssd", SSDForCausalLM(ssd_tiny_config(tie_word_embeddings=False),
                                               device="cpu"))):
        assert [p.numel() for p in model.parameters()] == _leaf_sizes(kind, model.config)
    assert tadamw.TRAIN_TABLES["base"] == _leaf_sizes("llama", build_config("base", "bfloat16"))
    assert tadamw.TRAIN_TABLES["ssd_train"] == _leaf_sizes(
        "ssd", ssd_8b_config(num_hidden_layers=8, param_dtype="float32"))
    assert [len(t) for t in tadamw.TRAIN_TABLES.values()] == [75, 43]


def test_leaf_table_geometry():
    """The launch table a card would get, built on the CPU from meta-free
    CPU tensors: chunk numbering (a leaf's chunks after its head), the
    empty leaf left out, ceil(leaves / TABLE_CAP) launch groups, the copy
    and decay flags."""
    sizes = [5] * (tadamw.TABLE_CAP + 3) + [2 * tadamw.CHUNK + 1]
    p, g, m, v = _table(7, sizes)
    outs = [None] * len(sizes)
    outs[-1] = torch.empty(sizes[-1], dtype=torch.bfloat16)
    decay, coupled = [True] * len(sizes), [False] * len(sizes)
    decay[1] = False
    t = tadamw.LeafTable(p, m, v, outs, decay, coupled)
    assert [len(arr) for arr, *_ in t.groups] == [tadamw.TABLE_CAP, 4] and t.cast
    first, second = t.groups
    assert first[3] == tadamw.TABLE_CAP                # one chunk a 5-value leaf
    head = tadamw._head(p[-1].data_ptr())
    assert second[3] == 3 + max(1, -(-(sizes[-1] - head) // tadamw.CHUNK))
    assert [e.chunk0 for e in second[0]] == [0, 1, 2, 3]
    assert not first[0][1].flags & tadamw._DECAY and first[0][0].flags & tadamw._DECAY
    assert second[0][3].out == outs[-1].data_ptr() and second[0][0].out == 0
    assert t.fill(g) == (torch.float32,)
    assert all(e.g == x.data_ptr() for e, x in zip(first[0], g))
    assert not any(e.flags & tadamw._BF16_GRAD for arr, *_ in t.groups for e in arr)
    # each leaf's gradient dtype is a flag of its own: one table takes both
    mixed = [x.to(torch.bfloat16) if i % 2 else x for i, x in enumerate(g)]
    assert t.fill(mixed) == (torch.float32, torch.bfloat16)
    entries = [e for arr, *_ in t.groups for e in arr]
    assert [bool(e.flags & tadamw._BF16_GRAD) for e in entries] == [
        bool(i % 2) for i in range(len(sizes))]
    assert all(e.g == x.data_ptr() for e, x in zip(entries, mixed))
    with pytest.raises(TypeError):
        t.fill([x.to(torch.float16) for x in g])
    t.fill(g)
    # the vector flag: set where the gradient shares p's 16-byte phase
    assert all(bool(e.flags & tadamw._VEC) == (tadamw._head(x.data_ptr()) == tadamw._head(e.p))
               for e, x in zip(first[0], g))
    shifted = torch.zeros(6)[1:]                       # leaf 0's gradient off p's phase
    t.fill([shifted] + g[1:])
    assert first[0][0].g == shifted.data_ptr() and not first[0][0].flags & tadamw._VEC
    assert t.fits(p, m, v, outs, decay, coupled)
    assert not t.fits(p, m, v, outs, [True] * len(sizes), coupled)
    with pytest.raises(ValueError):
        t.fill(g[:-1] + [g[-1][1:]])


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------

def _schedulers(mod):
    return {
        "NoamDecay": lambda: mod.NoamDecay(d_model=64, warmup_steps=5, learning_rate=2.0),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([4, 9, 20], [0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.1, gamma=0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.1, gamma=0.2),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.1, decay_steps=7, power=2.0,
                                                       cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(mod.StepDecay(0.1, step_size=4), 5, 0.0,
                                                 0.1),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.1, gamma=0.9),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.1, milestones=[3, 8, 15], gamma=0.5),
        "StepDecay": lambda: mod.StepDecay(0.1, step_size=6, gamma=0.3),
        "LambdaDecay": lambda: mod.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(0.1, patience=2, cooldown=1),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.1, T_max=12, eta_min=0.01),
        "CosineAnnealingWarmRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.1, T_0=4, T_mult=2, eta_min=0.001),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(0.1, lambda e: 0.9),
        "OneCycleLR": lambda: mod.OneCycleLR(0.1, total_steps=25),
        "CyclicLR": lambda: mod.CyclicLR(0.01, 0.1, step_size_up=4, step_size_down=6,
                                         mode="triangular2"),
        "LinearLR": lambda: mod.LinearLR(0.1, total_steps=20),
        "CosineWarmup": lambda: mod.CosineWarmup(0.1, warmup_steps=5, total_steps=25,
                                                 min_lr=0.001),
    }


def _advance(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(1.0 if i % 7 < 3 else 2.0 - 0.01 * i)    # plateaus, then improvements
    else:
        s.step()


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_matches_jax_and_round_trips(name):
    """30 steps of each schedule equal to the JAX one's (host doubles, the
    same expressions: 1e-12 relative); a fresh scheduler given the
    state_dict of step 12 continues with the same values."""
    t, j = _schedulers(tlr)[name](), _schedulers(jlr)[name]()
    assert set(t.state_dict()) == set(j.state_dict())
    lrs = []
    for i in range(30):
        assert t() == pytest.approx(j(), rel=1e-12, abs=1e-15), i
        lrs.append(t())
        if i == 12:
            saved = t.state_dict()
        _advance(t, i)
        _advance(j, i)
    again = _schedulers(tlr)[name]()
    again.set_state_dict(saved)
    for i in range(12, 30):
        assert again() == lrs[i], i
        _advance(again, i)


def test_scheduler_exports_match_jax():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)


# ---------------------------------------------------------------------------
# the clips
# ---------------------------------------------------------------------------

def _grads(seed, dtype="float32"):
    """fp32: normal values; bf16: multiples of 1/8 up to 3, exact in bf16,
    whose squares sum exactly in any order, so that the norms and factors
    are the same bits on both sides and the clipped values can be held
    bit for bit."""
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return [rng.integers(-24, 25, s).astype(np.float32) / 8 for s in SHAPES.values()]
    return [3 * rng.standard_normal(s).astype(np.float32) for s in SHAPES.values()]


def _assert_clipped(a, b, dtype):
    if dtype == "bfloat16":
        # each product rounded once from fp32, as JAX promotes bf16 x fp32
        # (torch alone would round the factor to bf16 first): the same bits
        assert torch.equal(a, torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16))
    else:
        # fp32 norms summed in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,args", [("ClipGradByValue", (0.5,)),
                                       ("ClipGradByValue", (0.5, -0.2)),
                                       ("ClipGradByNorm", (1.0,)),
                                       ("ClipGradByGlobalNorm", (2.0,))])
def test_clip_objects_match_jax(name, args, dtype):
    gs = _grads(8, dtype)
    jout = getattr(paddle.nn, name)(*args)([(None, jnp.asarray(g).astype(dtype)) for g in gs]
                                           + [(None, None)])
    tout = getattr(tnn, name)(*args)([(None, torch.tensor(g).to(getattr(torch, dtype)))
                                      for g in gs] + [(None, None)])
    assert tout[-1] == (None, None)
    for (_, a), (_, b) in zip(tout[:-1], jout[:-1]):
        assert str(a.dtype) == f"torch.{dtype}"
        _assert_clipped(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type, dtype):
    from paddle_tpu.nn.clip import clip_grad_norm_ as jnorm
    from paddle_tpu.nn.clip import clip_grad_value_ as jvalue

    gs = _grads(9, dtype)
    for jfn, tfn, arg in ((jnorm, tnn.clip_grad_norm_, 1.5), (jvalue, tnn.clip_grad_value_, 0.7)):
        jp = [paddle.Parameter(np.zeros_like(g)) for g in gs]
        tp = [torch.nn.Parameter(torch.zeros(g.shape, dtype=getattr(torch, dtype))) for g in gs]
        for j, t, g in zip(jp, tp, gs):
            j._grad = jnp.asarray(g).astype(dtype)
            t.grad = torch.tensor(g).to(getattr(torch, dtype))
        if jfn is jnorm:
            jt, tt = jfn(jp, arg, norm_type), tfn(tp, arg, norm_type)
            np.testing.assert_allclose(float(tt), float(np.asarray(jt._data)), rtol=1e-6)
        else:
            jfn(jp, arg)
            tfn(tp, arg)
        for j, t in zip(jp, tp):
            _assert_clipped(t.grad, j._grad, dtype)


# ---------------------------------------------------------------------------
# TrainStep.state_dict against the JAX TrainStep's
# ---------------------------------------------------------------------------

NARROW = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
LR = 1e-3


def test_train_step_state_dict_matches_jax_keys_and_values():
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import llama_tiny_config as jax_tiny
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config, load_paddle_tpu_params

    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**NARROW))
    tm = LlamaForCausalLM(llama_tiny_config(**NARROW), device="cpu")
    load_paddle_tpu_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    jopt = paddle.optimizer.AdamW(learning_rate=jlr.CosineAnnealingDecay(LR, T_max=10),
                                  weight_decay=0.1, parameters=jm.parameters())
    topt_ = topt.AdamW(learning_rate=tlr.CosineAnnealingDecay(LR, T_max=10), weight_decay=0.1,
                       parameters=tm.parameters())

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    js = paddle.jit.TrainStep(jm, loss_fn, jopt)
    ts = TrainStep(tm, loss_fn, topt_)
    ids = np.random.default_rng(6).integers(0, 256, (2, 32)).astype(np.int32)
    for _ in range(2):
        js(paddle.to_tensor(ids))
        ts(ids)
        jopt._lr.step()
        topt_._lr.step()
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert any(k.startswith("opt['llama.layers.1.") for k in tsd)
    for k, b in jsd.items():
        a = tsd[k]
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, k
        if k.startswith("param."):
            # fp32 updates of moments from gradients summed in another order:
            # 4.5e-6 apart at most, where the last step moved an element by
            # up to 1.07e-3 (both read on the CPU); a limit ~10x the reading,
            # a twentieth of one step's update
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-5, err_msg=k)
        elif k.startswith("opt"):
            # two steps of fp32 moments from gradients summed in another order
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=k)   # fp32 on JAX's side
    # set_state_dict writes in place: the kernel table's pointers stay valid
    ptrs = [p.data_ptr() for p in tm.parameters()]
    ts.set_state_dict({k: v.clone() for k, v in tsd.items()})
    assert ptrs == [p.data_ptr() for p in tm.parameters()]
