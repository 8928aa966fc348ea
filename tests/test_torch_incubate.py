"""paddle_tpu_torch.incubate (fused ops, fused layers, optimizer wrappers)
against paddle_tpu.incubate on the same inputs (CPU, fp32).

Outputs within rtol = atol = 1e-5 (fp32 sums in another order); the fused
layers on weights carried across by ``models/convert`` (their parameter
names are the JAX layers'), dropout at p = 0 or in eval.  Dropout's two
modes are held to Paddle's scaling.  The optimizer wrappers run
``tests/test_incubate_optimizer.py``'s cases through both packages.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu.incubate.optimizer as jopt_mod
import paddle_tpu_torch.incubate as inc
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.incubate import optimizer as topt_mod
from paddle_tpu_torch.models import load_paddle_tpu_params
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# functional ops that reach kernels, and the activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_fused_rms_norm(weighted):
    x, w = _rand((3, 5, 64)), _rand((64,), 1)
    jw, tw = (_j(w), _t(w)) if weighted else (None, None)
    _close(TF.fused_rms_norm(_t(x), tw, epsilon=1e-5), JF.fused_rms_norm(_j(x), jw, epsilon=1e-5))


def test_fused_layer_norm():
    x, w, b = _rand((4, 32)), _rand((32,), 1), _rand((32,), 2)
    _close(TF.fused_layer_norm(_t(x), _t(w), _t(b), 1e-5),
           JF.fused_layer_norm(_j(x), _j(w), _j(b), 1e-5))


def test_swiglu_one_and_two_inputs():
    x, y = _rand((2, 3, 16)), _rand((2, 3, 16), 1)
    _close(TF.swiglu(_t(x)), JF.swiglu(_j(x)))
    _close(TF.swiglu(_t(x), _t(y)), JF.swiglu(_j(x), _j(y)))


@pytest.mark.parametrize("tables", [False, True])
def test_fused_rotary_position_embedding(tables):
    q, k, v = _rand((2, 8, 4, 32)), _rand((2, 8, 4, 32), 1), _rand((2, 8, 4, 32), 2)
    kw_j, kw_t = {}, {}
    if tables:
        ang = _rand((1, 16, 1, 32), 3)
        cos, sin = np.cos(ang), np.sin(ang)
        pos = np.random.default_rng(4).integers(0, 16, size=(2, 8))
        kw_j = dict(cos=_j(cos), sin=_j(sin), position_ids=_j(pos))
        kw_t = dict(cos=_t(cos), sin=_t(sin), position_ids=_t(pos))
    jo = JF.fused_rotary_position_embedding(_j(q), _j(k), None, **kw_j)
    to = TF.fused_rotary_position_embedding(_t(q), _t(k), None, **kw_t)
    assert jo[2] is None and to[2] is None
    for a, b in zip(to[:2], jo[:2]):
        _close(a, b)
    jv = JF.fused_rotary_position_embedding(_j(q), None, _j(v), **kw_j)
    tv = TF.fused_rotary_position_embedding(_t(q), None, _t(v), **kw_t)
    assert jv[1] is None and tv[1] is None
    _close(tv[2], jv[2])


@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
def test_fused_bias_act(act):
    x, b = _rand((4, 16)), _rand((16,), 1)
    _close(TF.fused_bias_act(_t(x), _t(b), act_method=act),
           JF.fused_bias_act(_j(x), _j(b), act_method=act))


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_and_matmul_bias(transpose):
    x, b = _rand((3, 8)), _rand((6,), 2)
    w = _rand((6, 8) if transpose else (8, 6), 1)
    _close(TF.fused_linear(_t(x), _t(w), _t(b), transpose_weight=transpose),
           JF.fused_linear(_j(x), _j(w), _j(b), transpose_weight=transpose))
    y = _rand((5, 8), 3) if transpose else _rand((8, 5), 3)
    _close(TF.fused_matmul_bias(_t(x), _t(y), None, False, transpose),
           JF.fused_matmul_bias(_j(x), _j(y), None, False, transpose))
    _close(TF.fused_linear_activation(_t(x), _t(y), _t(b[:5]), trans_y=transpose),
           JF.fused_linear_activation(_j(x), _j(y), _j(b[:5]), trans_y=transpose))


def test_masked_multihead_attention():
    B, C, H, Hk, D = 3, 128, 8, 2, 64
    q, k, v = _rand((B, 1, H, D)), _rand((B, C, Hk, D), 1), _rand((B, C, Hk, D), 2)
    lengths = np.array([1, 77, 128], np.int32)
    _close(TF.masked_multihead_attention(_t(q), _t(k), _t(v), _t(lengths)),
           JF.masked_multihead_attention(_j(q), _j(k), _j(v), lengths))


def test_block_multihead_attention_takes_the_jax_pool_layout():
    NB, bs, B, H, Hk, D, MAXB = 16, 16, 3, 4, 2, 32, 4
    q = _rand((B, 1, H, D))
    kp, vp = _rand((NB, bs, Hk, D), 1), _rand((NB, bs, Hk, D), 2)
    table = np.random.default_rng(3).permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    lengths = np.array([5, 33, 64], np.int32)
    got = TF.block_multihead_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    _close(got, JF.block_multihead_attention(_j(q), _j(kp), _j(vp), table, lengths))
    # the same cache as a dense one gives the same rows
    dense_k = kp[table].reshape(B, -1, Hk, D)
    dense_v = vp[table].reshape(B, -1, Hk, D)
    _close(got, TF.masked_multihead_attention(_t(q), _t(dense_k), _t(dense_v), _t(lengths)))


# ---------------------------------------------------------------------------
# the fused transformer family
# ---------------------------------------------------------------------------

def test_fused_dropout_add_and_bias_dropout_residual_ln_at_p0_and_in_eval():
    x, y, b = _rand((2, 4, 16)), _rand((2, 4, 16), 1), _rand((16,), 2)
    s, lb = _rand((16,), 3), _rand((16,), 4)
    _close(TF.fused_dropout_add(_t(x), _t(y), p=0.0), JF.fused_dropout_add(_j(x), _j(y), p=0.0))
    _close(TF.fused_dropout_add(_t(x), _t(y), p=0.5, training=False),
           JF.fused_dropout_add(_j(x), _j(y), p=0.5, training=False))
    for kw in (dict(dropout_rate=0.0), dict(dropout_rate=0.3, training=False)):
        _close(TF.fused_bias_dropout_residual_layer_norm(_t(x), _t(y), _t(b), _t(s), _t(lb), **kw),
               JF.fused_bias_dropout_residual_layer_norm(_j(x), _j(y), _j(b), _j(s), _j(lb), **kw))


@pytest.mark.parametrize("pre", [False, True])
def test_fused_feedforward(pre):
    x = _rand((2, 4, 16))
    w1, w2 = _rand((16, 32), 1, 0.2), _rand((32, 16), 2, 0.2)
    b1, b2, s1, s2 = _rand((32,), 3), _rand((16,), 4), _rand((16,), 5), _rand((16,), 6)
    args = (x, w1, w2, b1, b2, s1, None, s2, None)
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu", pre_layer_norm=pre)
    _close(TF.fused_feedforward(*(None if a is None else _t(a) for a in args), **kw),
           JF.fused_feedforward(*(None if a is None else _j(a) for a in args), **kw))


@pytest.mark.parametrize("pre,transpose,residual", [(False, False, True), (True, False, True),
                                                    (False, True, True), (False, False, False)])
def test_fused_multi_head_attention(pre, transpose, residual):
    B, S, H, D = 2, 6, 4, 8
    E = H * D
    x = _rand((B, S, E))
    qkv_w = _rand((E, 3 * E) if transpose else (3, H, D, E), 1, 0.2)
    qkv_b = _rand((3 * E,) if transpose else (3, H, D), 2)
    lin_w, lin_b = _rand((E, E), 3, 0.2), _rand((E,), 4)
    mask = np.where(np.tril(np.ones((S, S))), 0.0, -1e9).astype(np.float32)[None, None]
    pieces = dict(pre_ln_scale=_rand((E,), 5), pre_ln_bias=_rand((E,), 6),
                  ln_scale=_rand((E,), 7), ln_bias=_rand((E,), 8), qkv_bias=qkv_b,
                  linear_bias=lin_b, attn_mask=mask)
    kw = dict(pre_layer_norm=pre, dropout_rate=0.0, attn_dropout_rate=0.0,
              add_residual=residual, num_heads=H, transpose_qkv_wb=transpose)
    got = TF.fused_multi_head_attention(_t(x), _t(qkv_w), _t(lin_w),
                                        **{k: _t(v) for k, v in pieces.items()}, **kw)
    want = JF.fused_multi_head_attention(_j(x), _j(qkv_w), _j(lin_w),
                                         **{k: _j(v) for k, v in pieces.items()}, **kw)
    _close(got, want)


def test_fused_multi_transformer():
    L, E, H, Fd = 2, 16, 2, 32
    names = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases", "linear_weights",
             "linear_biases", "ffn_ln_scales", "ffn_ln_biases", "ffn1_weights", "ffn1_biases",
             "ffn2_weights", "ffn2_biases")
    shapes = dict(ln_scales=(E,), ln_biases=(E,), qkv_weights=(3, H, E // H, E),
                  qkv_biases=(3, H, E // H), linear_weights=(E, E), linear_biases=(E,),
                  ffn_ln_scales=(E,), ffn_ln_biases=(E,), ffn1_weights=(E, Fd),
                  ffn1_biases=(Fd,), ffn2_weights=(Fd, E), ffn2_biases=(E,))
    ws = {n: [_rand(shapes[n], 10 * i + j, 0.3) for i in range(L)]
          for j, n in enumerate(names)}
    x = _rand((2, 5, E))
    got = TF.fused_multi_transformer(_t(x), *([_t(a) for a in ws[n]] for n in names))
    want = JF.fused_multi_transformer(_j(x), *([_j(a) for a in ws[n]] for n in names))
    _close(got, want)


@pytest.mark.parametrize("norm", [True, False])
def test_fused_moe(norm):
    X, E, Hd = 4, 16, 24
    x = _rand((2, 5, E))
    args = (x, _rand((E, X), 1), _rand((X, E, Hd), 2, 0.3), _rand((X, Hd), 3),
            _rand((X, Hd, E), 4, 0.3), _rand((X, E), 5))
    _close(TF.fused_moe(*map(_t, args), top_k=2, norm_topk_prob=norm),
           JF.fused_moe(*map(_j, args), top_k=2, norm_topk_prob=norm))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (False, True)])
def test_variable_length_memory_efficient_attention(causal, masked):
    B, H, S, D = 3, 2, 8, 16
    q, k, v = _rand((B, H, S, D)), _rand((B, H, S, D), 1), _rand((B, H, S, D), 2)
    sl, kl = np.array([8, 3, 5], np.int32), np.array([8, 6, 2], np.int32)
    mask = _rand((B, 1, S, S), 3) if masked else None
    got = TF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), _t(sl), _t(kl), None if mask is None else _t(mask), causal=causal)
    want = JF.variable_length_memory_efficient_attention(
        _j(q), _j(k), _j(v), _j(sl), _j(kl), None if mask is None else _j(mask), causal=causal)
    _close(got, want)
    mx = TF.blha_get_max_len(_t(sl), _t(kl), B)
    assert [int(a) for a in mx] == [int(_np(a)) for a in JF.blha_get_max_len(_j(sl), _j(kl), B)]


def test_top_level_masked_softmaxes_and_identity_loss():
    import paddle_tpu.incubate as jinc

    x, m = _rand((2, 4, 6)), _rand((2, 4, 6), 1)
    _close(inc.softmax_mask_fuse(_t(x), _t(m)), jinc.softmax_mask_fuse(_j(x), _j(m)))
    _close(inc.softmax_mask_fuse_upper_triangle(_t(x)), jinc.softmax_mask_fuse_upper_triangle(_j(x)))
    for red in ("none", "sum", "mean", 0, 1, 2):
        _close(inc.identity_loss(_t(x), red), jinc.identity_loss(_j(x), red))


# ---------------------------------------------------------------------------
# dropout: Paddle's two modes, an explicit generator
# ---------------------------------------------------------------------------

def test_dropout_modes_scale_as_paddle_and_draw_from_the_given_generator():
    x = torch.full((4096,), 2.0)
    g = torch.Generator().manual_seed(3)
    up = TF.dropout(x, 0.25, True, "upscale_in_train", g)
    assert set(up.unique().tolist()) == {0.0, float(torch.tensor(2.0) / 0.75)}
    assert abs(float((up > 0).float().mean()) - 0.75) < 0.03
    down = TF.dropout(x, 0.25, True, "downscale_in_infer", torch.Generator().manual_seed(3))
    assert set(down.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(down > 0, up > 0)                    # the same draws, the same mask
    assert torch.equal(TF.dropout(x, 0.25, False, "upscale_in_train"), x)
    assert torch.equal(TF.dropout(x, 0.25, False, "downscale_in_infer"), x * 0.75)
    with pytest.raises(ValueError):
        TF.dropout(x, 0.25, True, "scale_everything")
    with pytest.raises(ValueError, match="generator"):
        TF.fused_dropout_add(x, x, p=0.25)                  # no generator to draw from


def test_layers_draw_dropout_from_their_own_generator():
    from paddle_tpu_torch.incubate.nn import FusedDropoutAdd

    x, y = torch.ones(256), torch.zeros(256)
    a, b = (FusedDropoutAdd(p=0.5, device="cpu", seed=s) for s in (1, 1))
    assert torch.equal(a(x, y), b(x, y))
    a.eval()
    assert torch.equal(a(x, y), x)


# ---------------------------------------------------------------------------
# the fused layers on carried-across weights
# ---------------------------------------------------------------------------

def _layer_pair(jcls, tcls, *args, **kw):
    import paddle_tpu.incubate.nn as jnn

    paddle.seed(0)
    jl = getattr(jnn, jcls)(*args, **kw)
    tl = tcls(*args, device="cpu", **kw)
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(n for n, _ in jl.named_parameters())
    load_paddle_tpu_params(tl, {n: np.asarray(p._data) for n, p in jl.named_parameters()})
    jl.eval()
    tl.eval()
    return jl, tl


@pytest.mark.parametrize("case", ["linear", "linear_t", "bdrln", "mha_pre", "mha_post", "ffn",
                                  "encoder", "multi"])
def test_fused_layers_match_jax(case):
    from paddle_tpu_torch.incubate import nn as tnn

    x, y = _rand((2, 5, 16)), _rand((2, 5, 16), 1)
    make = {
        "linear": ("FusedLinear", tnn.FusedLinear, (16, 12), {}),
        "linear_t": ("FusedLinear", tnn.FusedLinear, (16, 12), dict(transpose_weight=True)),
        "bdrln": ("FusedBiasDropoutResidualLayerNorm", tnn.FusedBiasDropoutResidualLayerNorm,
                  (16,), {}),
        "mha_pre": ("FusedMultiHeadAttention", tnn.FusedMultiHeadAttention, (16, 4),
                    dict(normalize_before=True)),
        "mha_post": ("FusedMultiHeadAttention", tnn.FusedMultiHeadAttention, (16, 4), {}),
        "ffn": ("FusedFeedForward", tnn.FusedFeedForward, (16, 32), {}),
        "encoder": ("FusedTransformerEncoderLayer", tnn.FusedTransformerEncoderLayer,
                    (16, 4, 32), {}),
        "multi": ("FusedMultiTransformer", tnn.FusedMultiTransformer, (16, 4, 32),
                  dict(num_layers=2)),
    }[case]
    jl, tl = _layer_pair(make[0], make[1], *make[2], **make[3])
    if case == "bdrln":
        _close(tl(_t(x), _t(y)), jl(_j(x), _j(y)))
    else:
        _close(tl(_t(x)), jl(_j(x)))


# ---------------------------------------------------------------------------
# optimizer wrappers: tests/test_incubate_optimizer.py's cases, both packages
# ---------------------------------------------------------------------------

class _Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(np.array(w)))
        self.bias = torch.nn.Parameter(torch.from_numpy(np.array(b)))

    def forward(self, x):
        return x @ self.weight + self.bias


def _linear_pair(seed=0):
    import paddle_tpu.nn as jnn

    paddle.seed(seed)
    jnet = jnn.Linear(4, 2)
    return jnet, _Linear(np.asarray(jnet.weight._data), np.asarray(jnet.bias._data))


def _run_both(jnet, tnet, jstep, tstep, steps, x):
    for _ in range(steps):
        ((jnet(_j(x)) ** 2).mean()).backward()
        jstep()
        ((tnet(_t(x)) ** 2).mean()).backward()
        tstep()


@pytest.mark.parametrize("inner,alpha,k", [("SGD", 0.5, 2), ("SGD", 0.25, 1),
                                           ("AdamW", 0.5, 3)])
def test_lookahead_matches_jax(inner, alpha, k):
    jnet, tnet = _linear_pair()
    kw = dict(learning_rate=0.1) if inner == "SGD" else dict(learning_rate=0.05,
                                                             weight_decay=0.01)
    jla = jopt_mod.LookAhead(getattr(paddle.optimizer, inner)(parameters=jnet.parameters(), **kw),
                             alpha=alpha, k=k)
    tla = topt_mod.LookAhead({"SGD": SGD, "AdamW": AdamW}[inner](
        parameters=list(tnet.parameters()), **kw), alpha=alpha, k=k)
    x = np.ones((4, 4), np.float32)

    def jstep():
        jla.step()
        jla.clear_grad()

    def tstep():
        tla.step()
        tla.clear_grad()

    _run_both(jnet, tnet, jstep, tstep, 2 * k + 1, x)
    _close(tnet.weight, jnet.weight, rtol=1e-6, atol=1e-6)
    _close(tnet.bias, jnet.bias, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        topt_mod.LookAhead(tla.inner_optimizer, alpha=1.5)
    with pytest.raises(ValueError):
        topt_mod.LookAhead(tla.inner_optimizer, k=0)


def test_lookahead_syncs_the_master_of_a_bf16_parameter():
    p = torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))
    la = topt_mod.LookAhead(SGD(learning_rate=0.5, parameters=[p]), alpha=0.5, k=1)
    p.grad = torch.ones(8, dtype=torch.bfloat16)
    la.step()
    master = la.inner_optimizer._state[0]["master"]
    assert torch.equal(master, torch.full((8,), 0.75)) and torch.equal(p.float(), master)


def test_lookahead_minimize_and_state_round_trip():
    jnet, tnet = _linear_pair(1)
    x = np.ones((2, 4), np.float32)
    tla = topt_mod.LookAhead(SGD(learning_rate=0.1, parameters=list(tnet.parameters())),
                             alpha=0.5, k=2)
    tla.minimize((tnet(_t(x)) ** 2).mean())
    assert tla._step_count == 1
    state = tla.state_dict()
    _, tnet2 = _linear_pair(1)
    tla2 = topt_mod.LookAhead(SGD(learning_rate=0.1, parameters=list(tnet2.parameters())),
                              alpha=0.5, k=2)
    tla2.set_state_dict(state)
    assert tla2._step_count == 1 and "lookahead" in state
    for a, b in zip(tla._slow, tla2._slow):
        assert torch.equal(a, b)


def test_model_average_matches_jax_and_restores():
    jnet, tnet = _linear_pair()
    jo = paddle.optimizer.SGD(learning_rate=0.1, parameters=jnet.parameters())
    to = SGD(learning_rate=0.1, parameters=list(tnet.parameters()))
    jma = jopt_mod.ModelAverage(parameters=jnet.parameters(), min_average_window=2,
                                max_average_window=3)
    tma = topt_mod.ModelAverage(parameters=list(tnet.parameters()), min_average_window=2,
                                max_average_window=3)
    x = np.ones((2, 4), np.float32)

    def jstep():
        jo.step()
        jo.clear_grad()
        jma.step()

    def tstep():
        to.step()
        to.clear_grad()
        tma.step()

    _run_both(jnet, tnet, jstep, tstep, 5, x)
    current = tnet.weight.detach().clone()
    with jma.apply(), tma.apply():
        _close(tnet.weight, jnet.weight, rtol=1e-6, atol=1e-7)
    assert torch.equal(tnet.weight.detach(), current)
    empty = topt_mod.ModelAverage(parameters=list(_linear_pair()[1].parameters()))
    with empty.apply():
        pass


def _dgc_problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(n, n)) / np.sqrt(n)).astype(np.float32)
    x0 = rng.normal(size=(n,)).astype(np.float32)
    jx = paddle.to_tensor(x0)
    jx.stop_gradient = False
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    jA, tA = paddle.to_tensor(A), torch.from_numpy(A)
    return (jx, lambda: ((jA @ jx) * (jA @ jx)).sum()), (tx, lambda: ((tA @ tx) ** 2).sum())


@pytest.mark.parametrize("kw,steps", [
    (dict(learning_rate=1e-2, momentum=0.9, rampup_begin_step=100), 5),      # dense phase
    (dict(learning_rate=5e-3, momentum=0.9, rampup_begin_step=0, rampup_step=20,
          sparsity=(0.75, 0.9)), 30),                                        # rampup
    (dict(learning_rate=1e-2, momentum=0.5, rampup_begin_step=2, sparsity=(0.8,)), 8),
], ids=["dense", "rampup", "begin2"])
def test_dgc_momentum_matches_jax(kw, steps):
    (jx, jloss), (tx, tloss) = _dgc_problem(n=32, seed=3)
    jd = jopt_mod.DGCMomentum(parameters=[jx], **kw)
    td = topt_mod.DGCMomentum(parameters=[tx], **kw)
    for _ in range(steps):
        jloss().backward()
        jd.step()
        jd.clear_grad()
        tloss().backward()
        td.step()
        td.clear_grad()
    _close(tx, jx, rtol=1e-5, atol=1e-6)
    for slot in ("velocity", "residual"):
        _close(td._state[0][slot], jd._state[0][slot], rtol=1e-5, atol=1e-6)


def test_dgc_dense_phase_is_momentum_and_error_feedback_conserves_mass():
    (_, _), (x1, loss1) = _dgc_problem()
    (_, _), (x2, loss2) = _dgc_problem()
    m = Momentum(learning_rate=1e-2, momentum=0.9, parameters=[x1])
    d = topt_mod.DGCMomentum(learning_rate=1e-2, momentum=0.9, rampup_begin_step=100,
                             parameters=[x2])
    for _ in range(5):
        loss1().backward()
        m.step()
        m.clear_grad()
        loss2().backward()
        d.step()
        d.clear_grad()
    torch.testing.assert_close(x1, x2, rtol=1e-5, atol=1e-6)
    n = 256
    x = torch.nn.Parameter(torch.zeros(n))
    g = torch.linspace(1, 2, n)
    d = topt_mod.DGCMomentum(learning_rate=1.0, momentum=0.0, sparsity=(0.9,), parameters=[x])
    (x * g).sum().backward()
    d.step()
    k = int(np.ceil(0.1 * n))
    assert k <= int((x != 0).sum()) <= k + 4
    torch.testing.assert_close(d._state[0]["residual"] - x.detach(), g)
    with pytest.raises(ValueError, match="rampup_step"):
        topt_mod.DGCMomentum(sparsity=(0.75, 0.9, 0.99), rampup_step=1, parameters=[x])
    with pytest.raises(NotImplementedError):
        topt_mod.DGCMomentum(use_nesterov=True, parameters=[x])


def test_dgc_through_train_step_matches_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch.jit import TrainStep

    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))
    ws = [np.asarray(p._data) for p in jm.parameters()]
    tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    with torch.no_grad():
        for lin, (w, b) in zip((tm[0], tm[2]), (ws[0:2], ws[2:4])):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    kw = dict(learning_rate=5e-2, momentum=0.9, rampup_begin_step=0, sparsity=(0.8,))
    js = paddle.jit.TrainStep(jm, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                              jopt_mod.DGCMomentum(parameters=jm.parameters(), **kw))
    ts = TrainStep(tm, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                   topt_mod.DGCMomentum(parameters=tm.parameters(), **kw))
    rng = np.random.default_rng(0)
    a, b = _rand((32, 8), 5), _rand((32, 1), 6)
    for step in range(5):
        lj = float(np.asarray(js(_j(a), _j(b))._data))
        lt = float(ts(a, b))
        np.testing.assert_allclose(lt, lj, rtol=1e-5, err_msg=f"step {step + 1}")
    del rng


def test_lbfgs_is_the_ports_optimizer():
    from paddle_tpu_torch.optimizer import LBFGS

    assert topt_mod.LBFGS is LBFGS


def _quadratic(n=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("which", ["bfgs", "lbfgs"])
@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_minimize_bfgs_lbfgs_match_jax(which, problem):
    from paddle_tpu.incubate.optimizer import functional as jfn
    from paddle_tpu_torch.incubate.optimizer import functional as tfn

    if problem == "quadratic":
        A, b = _quadratic()
        x0 = np.zeros(6, np.float32)
        jA, jb, tA, tb = _j(A), _j(b), _t(A), _t(b)

        def jf(x):
            return 0.5 * (x @ (jA @ x)) - jb @ x

        def tf(x):
            return 0.5 * (x @ (tA @ x)) - tb @ x
    else:
        x0 = np.array([-1.2, 1.0], np.float32)

        def jf(x):
            return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

        tf = jf
    # fp32 rounding decides the last steps (a line search that finds no
    # descent), so the quadratic converges at a gradient of 1e-3; the
    # Rosenbrock valley runs in float64, the port alone (jax runs 32-bit here)
    kw = (dict(max_iters=100, dtype="float64") if problem == "rosenbrock"
          else dict(tolerance_grad=1e-3))
    fn = "minimize_bfgs" if which == "bfgs" else "minimize_lbfgs"
    jres = getattr(jfn, fn)(jf, _j(x0), **kw) if problem == "quadratic" else None
    tres = getattr(tfn, fn)(tf, _t(x0), **kw)
    assert bool(tres[0])
    if problem == "quadratic":
        assert bool(_np(jres[0]))
        _close(tres[3], jres[3], rtol=1e-5, atol=1e-6)
        _close(tres[2], jres[2], rtol=1e-3, atol=1e-4)
        _close(tres[2], np.linalg.solve(A, b), rtol=1e-3, atol=1e-4)
        if which == "bfgs":
            assert tuple(tres[5].shape) == (6, 6)
    else:
        np.testing.assert_allclose(_np(tres[2]), [1.0, 1.0], atol=1e-4)
