"""paddle_tpu_torch.nn's layers, initializers, ParamAttr, hooks and nn.utils
against paddle_tpu.nn's (CPU, fp32).

Every layer class this slice ports is built in both packages; the JAX
layer's parameters and persistent buffers are carried into the port's by
``models.convert.load_paddle_tpu_params`` (so every ``state_dict`` name must
be the JAX one), both run on the same seeded numpy inputs, and the port's
weights, perturbed, go back through ``to_paddle_tpu_params`` into the JAX
layer, which must then give the port's output.  The JAX forwards of the
table run as one jitted program.  Tolerances: ``RTOL`` (1e-6 relative,
an atol of 1e-6 of the largest |value|) for data movement and elementwise
math, ``ACCUM`` (1e-5) where sums run in another order (norms,
convolutions, pools, losses, recurrences), ``LOOSE`` (1e-4) for the
transposed and 3-D convolutions; integers exact.

Initializers: the deterministic ones (``Assign``, ``Dirac``, ``Bilinear``,
``Constant``) give the JAX values exactly; the random ones draw from torch
generators and are held to their shape, support and moments (mean within
5 standard errors, std within 5%); ``Orthogonal`` to ``W Wᵀ = gain² I``
within 1e-5.  Hooks, ``weight_norm`` (values and gradients) and
``spectral_norm`` (its ``u`` start is the JAX one's numpy draw, so its
values and updates match exactly in form, to ``ACCUM``) follow the JAX
package's call order and return rules.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.framework.tensor import wrap
from paddle_tpu_torch.models import load_paddle_tpu_params, to_paddle_tpu_params
from test_torch_ops import assert_same, jax_reference

RTOL = 1e-6
ACCUM = 1e-5
LOOSE = 1e-4
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


rng = np.random.default_rng(180)


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


V, V2, V3 = _f(4, 6), _f(4, 6), _f(4, 6)
X1, X, X4, X3 = _f(2, 3, 8), _f(2, 3, 6, 6), _f(2, 4, 5, 5), _f(2, 3, 4, 6, 6)
LG, P = _f(4, 5), _f(4, 5, lo=0.05, hi=0.95)
Y = np.array([0, 3, 1, 4], np.int32)
YB = rng.integers(0, 2, (4, 5)).astype(np.float32)
PM = np.array([1.0, -1.0, 1.0, -1.0], np.float32)
POS = _f(4, 5, lo=0.2, hi=2.0)
IDX2 = np.stack([rng.permutation(36)[:9] for _ in range(6)]).reshape(2, 3, 3, 3).astype(np.int32)
IDX1 = np.stack([rng.permutation(8)[:4] for _ in range(6)]).reshape(2, 3, 4).astype(np.int32)
IDX3 = np.stack([rng.permutation(64)[:8] for _ in range(6)]).reshape(2, 3, 2, 2, 2).astype(
    np.int32)


def _kw(P_, **kw):
    """``kw`` plus the port's ``device="cpu"`` for a layer with parameters."""
    return {**kw, **(CPU if P_ is tp else {})}


# name -> (ctor(P), inputs, call(layer, *tensors) or None, rtol)
LAYERS = {
    "Silu": (lambda P_: P_.nn.Silu(), (V,), None, RTOL),
    "Softmax": (lambda P_: P_.nn.Softmax(axis=0), (V,), None, RTOL),
    "LogSoftmax": (lambda P_: P_.nn.LogSoftmax(), (V,), None, RTOL),
    "LeakyReLU": (lambda P_: P_.nn.LeakyReLU(0.2), (V,), None, RTOL),
    "ELU": (lambda P_: P_.nn.ELU(0.5), (V,), None, RTOL),
    "SELU": (lambda P_: P_.nn.SELU(), (V,), None, RTOL),
    "CELU": (lambda P_: P_.nn.CELU(1.3), (V,), None, RTOL),
    "Mish": (lambda P_: P_.nn.Mish(), (V,), None, ACCUM),
    "Softplus": (lambda P_: P_.nn.Softplus(2.0, 3.0), (V,), None, RTOL),
    "Softsign": (lambda P_: P_.nn.Softsign(), (V,), None, RTOL),
    "GLU": (lambda P_: P_.nn.GLU(axis=0), (V,), None, RTOL),
    "Hardtanh": (lambda P_: P_.nn.Hardtanh(-0.5, 0.7), (V,), None, RTOL),
    "Tanhshrink": (lambda P_: P_.nn.Tanhshrink(), (V,), None, ACCUM),
    "Softshrink": (lambda P_: P_.nn.Softshrink(0.3), (V,), None, RTOL),
    "Hardshrink": (lambda P_: P_.nn.Hardshrink(0.3), (V,), None, RTOL),
    "PReLU": (lambda P_: P_.nn.PReLU(3, 0.1, **_kw(P_)), (X,), None, RTOL),
    "LogSigmoid": (lambda P_: P_.nn.LogSigmoid(), (V,), None, RTOL),
    "ThresholdedReLU": (lambda P_: P_.nn.ThresholdedReLU(0.3, -1.0), (V,), None, RTOL),
    "RReLU": (lambda P_: P_.nn.RReLU(0.1, 0.2), (V,), lambda m, x: m.eval()(x), RTOL),
    "Dropout2D": (lambda P_: P_.nn.Dropout2D(0.4), (X,), lambda m, x: m.eval()(x), RTOL),
    "Dropout3D": (lambda P_: P_.nn.Dropout3D(0.4), (X3,), lambda m, x: m.eval()(x), RTOL),
    "AlphaDropout": (lambda P_: P_.nn.AlphaDropout(0.4), (V,), lambda m, x: m.eval()(x), RTOL),
    "Pad1D": (lambda P_: P_.nn.Pad1D([1, 2], "reflect"), (X1,), None, RTOL),
    "Pad2D": (lambda P_: P_.nn.Pad2D([1, 0, 2, 1], value=0.5), (X,), None, RTOL),
    "Pad3D": (lambda P_: P_.nn.Pad3D([1, 0, 0, 1, 1, 1]), (X3,), None, RTOL),
    "ZeroPad2D": (lambda P_: P_.nn.ZeroPad2D([1, 0, 2, 1]), (X,), None, RTOL),
    "UpsamplingBilinear2D": (lambda P_: P_.nn.UpsamplingBilinear2D(size=[9, 8]), (X,), None,
                             ACCUM),
    "UpsamplingNearest2D": (lambda P_: P_.nn.UpsamplingNearest2D(scale_factor=2), (X,), None,
                            RTOL),
    "PixelShuffle": (lambda P_: P_.nn.PixelShuffle(2), (X4,), None, RTOL),
    "PixelUnshuffle": (lambda P_: P_.nn.PixelUnshuffle(2), (X,), None, RTOL),
    "CosineSimilarity": (lambda P_: P_.nn.CosineSimilarity(axis=1), (V, V2), None, ACCUM),
    "PairwiseDistance": (lambda P_: P_.nn.PairwiseDistance(3.0), (V, V2), None, ACCUM),
    "Unflatten": (lambda P_: P_.nn.Unflatten(1, [2, 3]), (V,), None, RTOL),
    "Bilinear": (lambda P_: P_.nn.Bilinear(6, 6, 5, **_kw(P_)), (V, V2), None, ACCUM),
    "Fold": (lambda P_: P_.nn.Fold([5, 5], 2), (_f(2, 12, 16),), None, RTOL),
    "Unfold": (lambda P_: P_.nn.Unfold(2, 2, 1), (X,), None, RTOL),
    "BatchNorm3D": (lambda P_: P_.nn.BatchNorm3D(3, **_kw(P_)), (X3,), None, ACCUM),
    "SyncBatchNorm": (lambda P_: P_.nn.SyncBatchNorm(3, **_kw(P_)), (X,),
                      lambda m, x: m.eval()(x), ACCUM),
    "RMSNorm": (lambda P_: P_.nn.RMSNorm(128, **_kw(P_)), (_f(3, 128),), None, ACCUM),
    "GroupNorm": (lambda P_: P_.nn.GroupNorm(2, 4, **_kw(P_)), (X4,), None, ACCUM),
    "InstanceNorm1D": (lambda P_: P_.nn.InstanceNorm1D(3, **_kw(P_)), (X1,), None, ACCUM),
    "InstanceNorm2D": (lambda P_: P_.nn.InstanceNorm2D(3, **_kw(P_)), (X,), None, ACCUM),
    "InstanceNorm3D": (lambda P_: P_.nn.InstanceNorm3D(3, **_kw(P_)), (X3,), None, ACCUM),
    "LocalResponseNorm": (lambda P_: P_.nn.LocalResponseNorm(3), (X4,), None, ACCUM),
    "SpectralNorm": (lambda P_: P_.nn.SpectralNorm([4, 3, 3], 1, 3, **_kw(P_)),
                     (_f(4, 3, 3),), None, ACCUM),
    "Conv3D": (lambda P_: P_.nn.Conv3D(3, 2, 3, padding=1, **_kw(P_)), (X3,), None, LOOSE),
    "Conv1DTranspose": (lambda P_: P_.nn.Conv1DTranspose(3, 2, 3, 2, 1, 1, **_kw(P_)), (X1,),
                        None, LOOSE),
    "Conv3DTranspose": (lambda P_: P_.nn.Conv3DTranspose(3, 2, 3, 2, 1, **_kw(P_)),
                        (_f(2, 3, 2, 3, 3),), None, LOOSE),
    "AvgPool1D": (lambda P_: P_.nn.AvgPool1D(3, 2, 1), (X1,), None, ACCUM),
    "AvgPool3D": (lambda P_: P_.nn.AvgPool3D(2, 2), (X3,), None, ACCUM),
    "MaxPool1D": (lambda P_: P_.nn.MaxPool1D(3, 2, 1), (X1,), None, RTOL),
    "MaxPool3D": (lambda P_: P_.nn.MaxPool3D(2), (X3,), None, RTOL),
    "AdaptiveAvgPool1D": (lambda P_: P_.nn.AdaptiveAvgPool1D(3), (X1,), None, ACCUM),
    "AdaptiveAvgPool3D": (lambda P_: P_.nn.AdaptiveAvgPool3D([2, 3, 3]), (X3,), None, ACCUM),
    "AdaptiveMaxPool1D": (lambda P_: P_.nn.AdaptiveMaxPool1D(3), (X1,), None, RTOL),
    "AdaptiveMaxPool2D": (lambda P_: P_.nn.AdaptiveMaxPool2D([4, 3]), (X,), None, RTOL),
    "BCEWithLogitsLoss": (lambda P_: P_.nn.BCEWithLogitsLoss(), (LG, YB), None, ACCUM),
    "L1Loss": (lambda P_: P_.nn.L1Loss("sum"), (LG, P), None, ACCUM),
    "SmoothL1Loss": (lambda P_: P_.nn.SmoothL1Loss(delta=0.5), (LG, P), None, ACCUM),
    "NLLLoss": (lambda P_: P_.nn.NLLLoss(), (LG, Y), None, ACCUM),
    "KLDivLoss": (lambda P_: P_.nn.KLDivLoss("batchmean"), (LG, P), None, ACCUM),
    "MarginRankingLoss": (lambda P_: P_.nn.MarginRankingLoss(0.2), (V[:, 0], V2[:, 0], PM),
                          None, ACCUM),
    "CosineEmbeddingLoss": (lambda P_: P_.nn.CosineEmbeddingLoss(0.1), (V, V2, PM), None,
                            ACCUM),
    "TripletMarginLoss": (lambda P_: P_.nn.TripletMarginLoss(swap=True), (V, V2, V3), None,
                          ACCUM),
    "HingeEmbeddingLoss": (lambda P_: P_.nn.HingeEmbeddingLoss(), (V[:, 0], PM), None, ACCUM),
    "PoissonNLLLoss": (lambda P_: P_.nn.PoissonNLLLoss(), (LG, POS), None, ACCUM),
    "GaussianNLLLoss": (lambda P_: P_.nn.GaussianNLLLoss(full=True), (LG, P, POS), None, ACCUM),
    "MultiLabelSoftMarginLoss": (lambda P_: P_.nn.MultiLabelSoftMarginLoss(), (LG, YB), None,
                                 ACCUM),
    "SoftMarginLoss": (lambda P_: P_.nn.SoftMarginLoss(), (V[:, 0], PM), None, ACCUM),
    "ZeroPad1D": (lambda P_: P_.nn.ZeroPad1D([2, 1]), (X1,), None, RTOL),
    "ZeroPad3D": (lambda P_: P_.nn.ZeroPad3D([1, 0, 0, 1, 1, 1]), (X3,), None, RTOL),
    "Maxout": (lambda P_: P_.nn.Maxout(2), (X4,), None, RTOL),
    "Softmax2D": (lambda P_: P_.nn.Softmax2D(), (X,), None, RTOL),
    "MaxUnPool1D": (lambda P_: P_.nn.MaxUnPool1D(2), (_f(2, 3, 4), IDX1), None, RTOL),
    "MaxUnPool2D": (lambda P_: P_.nn.MaxUnPool2D(2), (_f(2, 3, 3, 3), IDX2), None, RTOL),
    "MaxUnPool3D": (lambda P_: P_.nn.MaxUnPool3D(2), (_f(2, 3, 2, 2, 2), IDX3), None, RTOL),
    "LPPool1D": (lambda P_: P_.nn.LPPool1D(2, 3, 2), (X1,), None, ACCUM),
    "LPPool2D": (lambda P_: P_.nn.LPPool2D(3, 2), (X,), None, ACCUM),
    "FractionalMaxPool2D": (lambda P_: P_.nn.FractionalMaxPool2D(4, random_u=0.4), (X,), None,
                            RTOL),
    "FractionalMaxPool3D": (lambda P_: P_.nn.FractionalMaxPool3D([3, 4, 4]), (X3,), None, RTOL),
    "AdaptiveMaxPool3D": (lambda P_: P_.nn.AdaptiveMaxPool3D([2, 3, 4]), (X3,), None, RTOL),
    "FeatureAlphaDropout": (lambda P_: P_.nn.FeatureAlphaDropout(0.3), (X,),
                            lambda m, x: m.eval()(x), RTOL),
    "MultiMarginLoss": (lambda P_: P_.nn.MultiMarginLoss(2, 0.5), (LG, Y), None, ACCUM),
    "TripletMarginWithDistanceLoss": (lambda P_: P_.nn.TripletMarginWithDistanceLoss(
        margin=0.5), (V, V2, V3), None, ACCUM),
    "HSigmoidLoss": (lambda P_: P_.nn.HSigmoidLoss(6, 5, **_kw(P_)), (V, Y), None, ACCUM),
    "RNNTLoss": (lambda P_: P_.nn.RNNTLoss(), (_f(2, 4, 3, 5), rng.integers(1, 5, (2, 2)).astype(
        np.int32), np.array([4, 3], np.int32), np.array([2, 1], np.int32)), None, ACCUM),
    "AdaptiveLogSoftmaxWithLoss": (
        lambda P_: P_.nn.AdaptiveLogSoftmaxWithLoss(8, 10, [4, 7], head_bias=True, **_kw(P_)),
        (_f(4, 8), np.array([1, 5, 7, 9], np.int32)), None, ACCUM),
    "LayerDict": (lambda P_: P_.nn.LayerDict({"a": P_.nn.Linear(6, 3, **_kw(P_)),
                                              "b": P_.nn.Tanh()}),
                  (V,), lambda m, x: m["b"](m["a"](x)), ACCUM),
    "ParameterDict": (lambda P_: P_.nn.ParameterDict({"w": _layer_param(P_, [6]),
                                                      "v": _layer_param(P_, [1, 6])}),
                      (V,), lambda m, x: x * m["w"] + m["v"], RTOL),
    "RNNCellBase": (lambda P_: P_.nn.GRUCell(6, 5, **_kw(P_)), (V,), lambda m, x: m(x), ACCUM),
    "BiRNN": (lambda P_: P_.nn.BiRNN(P_.nn.GRUCell(6, 5, **_kw(P_)),
                                     P_.nn.LSTMCell(6, 5, **_kw(P_))),
              (_f(2, 3, 6),), None, ACCUM),
    "ParamAttr": (lambda P_: P_.nn.Linear(6, 3, weight_attr=P_.nn.ParamAttr(
        initializer=P_.nn.initializer.Constant(0.25)), **_kw(P_)), (V,), None, ACCUM),
    "Parameter": (lambda P_: P_.nn.ParameterList([P_.nn.Parameter(np.linspace(
        -1, 1, 6).astype(np.float32))]), (V,), lambda m, x: x * m[0], RTOL),
}


def _layer_param(P_, shape):
    """A parameter made by a layer of the package (normal draws)."""
    init = P_.nn.initializer.Normal()
    return P_.nn.Layer(**_kw(P_)).create_parameter(shape, default_initializer=init)


def _call(name, layer, P_, *arrays):
    _, _, call, _ = LAYERS[name]
    args = [P_.to_tensor(a) for a in arrays]
    return call(layer, *args) if call else layer(*args)


def _jax_state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _jax_layer(name, seed, ctor=None):
    """The case's JAX layer (or ``ctor()``'s), its parameters then set to
    seeded normal draws: built under a zero global initializer, since the
    JAX draws compile shape by shape (seconds a layer)."""
    init = jp.nn.initializer
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    try:
        layer = ctor() if ctor else LAYERS[name][0](jp)
    finally:
        init.set_global_initializer(None)
    draw = np.random.default_rng(seed)
    layer.set_state_dict({n: jp.to_tensor((0.5 * draw.standard_normal(tuple(p.shape)))
                                          .astype(np.float32))
                          for n, p in layer.named_parameters()})
    return layer


@pytest.fixture(scope="module")
def built():
    """name -> (JAX layer, port layer carrying its weights)."""
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    try:
        jp.seed(5)
        out = {}
        for i, (name, (ctor, *_rest)) in enumerate(LAYERS.items()):
            jl, tl = _jax_layer(name, i), ctor(tp)
            load_paddle_tpu_params(tl, _jax_state(jl))
            out[name] = (jl, tl)
        return out
    finally:
        tp.set_device(prev)


@pytest.fixture(scope="module")
def ref(built):
    cases = {n: (lambda P_, n=n: _call(n, built[n][0], P_, *LAYERS[n][1])) for n in LAYERS}
    return jax_reference(cases)


def test_layer_cases_cover_every_new_jax_layer():
    """Every capitalised name of ``paddle_tpu.nn`` is in the port; the ones
    this slice adds are in the table (the containers and the decoder have
    tests of their own)."""
    jax_names = {n for n in dir(jp.nn) if n[:1].isupper()}
    port_names = {n for n in dir(tp.nn) if n[:1].isupper()}
    assert jax_names <= port_names, sorted(jax_names - port_names)
    earlier = {
        "GELU", "ChannelShuffle", "Dropout", "Embedding", "Flatten", "Hardsigmoid", "Hardswish",
        "Identity", "Linear", "ReLU", "ReLU6", "Sigmoid", "Swish", "Tanh", "Upsample",
        "AdaptiveAvgPool2D", "AvgPool2D", "Conv1D", "Conv2D", "Conv2DTranspose", "MaxPool2D",
        "Layer", "LayerList", "ParameterList", "Sequential", "BCELoss", "CrossEntropyLoss",
        "CTCLoss", "MSELoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D", "LayerNorm", "GRU",
        "LSTM", "RNN", "GRUCell", "LSTMCell", "SimpleRNN", "SimpleRNNCell",
        "MultiHeadAttention", "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
        "TransformerEncoder", "TransformerEncoderLayer", "ClipGradByGlobalNorm",
        "ClipGradByNorm", "ClipGradByValue"}
    tested_apart = {"BeamSearchDecoder"}
    assert jax_names - earlier == set(LAYERS) | tested_apart


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax_on_its_weights(name, built, ref):
    jl, tl = built[name]
    assert list(tl.state_dict()) == list(jl.state_dict()), name
    tp.seed(0)
    assert_same(_call(name, tl, tp, *LAYERS[name][1]), ref[name], rtol=LAYERS[name][3],
                what=name)


CARRIED = sorted(n for n in LAYERS if n not in ("SpectralNorm", "BatchNorm3D"))


@pytest.fixture(scope="module")
def carried_back():
    """name -> (port layer, the JAX output after its weights came back):
    fresh pairs, the port's weights perturbed and carried into the JAX
    layer by ``to_paddle_tpu_params``; the JAX forwards as one program."""
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    try:
        jp.seed(7)
        pairs = {}
        for i, name in enumerate(CARRIED):
            jl, tl = _jax_layer(name, 100 + i), LAYERS[name][0](tp)
            with torch.no_grad():
                for p in tl.parameters():
                    p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(len(name)))
            back = to_paddle_tpu_params(tl)
            assert set(back) == set(jl.state_dict()), name
            jl.set_state_dict({k: jp.to_tensor(v) for k, v in back.items()})
            pairs[name] = jl, tl
        ref = jax_reference({n: (lambda P_, n=n: _call(n, pairs[n][0], P_, *LAYERS[n][1]))
                             for n in CARRIED})
        return {n: (pairs[n][1], ref[n]) for n in CARRIED}
    finally:
        tp.set_device(prev)


@pytest.mark.parametrize("name", CARRIED)
def test_port_weights_carry_back_into_the_jax_layer(name, carried_back):
    """The port's weights, perturbed, through ``to_paddle_tpu_params`` into
    the JAX layer: its output becomes the port's."""
    tl, want = carried_back[name]
    assert_same(_call(name, tl, tp, *LAYERS[name][1]), want, rtol=LAYERS[name][3], what=name)


def test_batch_norm_3d_and_spectral_norm_state_carries_both_ways():
    jp.seed(6)
    pairs = {}
    for name in ("BatchNorm3D", "SpectralNorm"):
        jl, tl = LAYERS[name][0](jp), LAYERS[name][0](tp)
        load_paddle_tpu_params(tl, _jax_state(jl))
        back = to_paddle_tpu_params(tl)
        for k, v in _jax_state(jl).items():
            np.testing.assert_array_equal(back[k], v, err_msg=f"{name}.{k}")
        pairs[name] = jl, tl
    jl, tl = pairs["BatchNorm3D"]
    for P_, m in ((jp, jl), (tp, tl)):
        m.train()
        m(P_.to_tensor(X3))
    assert_same([tp.to_tensor(to_paddle_tpu_params(tl)[k]) for k in ("_mean", "_variance")],
                [jl._mean, jl._variance], rtol=ACCUM, what="BatchNorm3D statistics")


def test_sync_batch_norm_converts_every_batch_norm():
    for P_ in (tp, jp):
        net = P_.nn.Sequential(P_.nn.Conv2D(3, 4, 3, **_kw(P_)), P_.nn.BatchNorm2D(4, **_kw(P_)),
                               P_.nn.ReLU())
        w = np.asarray(_np_of(net[1].weight))
        conv = P_.nn.SyncBatchNorm.convert_sync_batchnorm(net)
        assert type(conv[1]).__name__ == "SyncBatchNorm" and type(conv[0]).__name__ == "Conv2D"
        np.testing.assert_array_equal(_np_of(conv[1].weight), w)


def _np_of(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


# ---------------------------------------------------------------------------
# initializers, ParamAttr, create_parameter
# ---------------------------------------------------------------------------

def _draw(P_, init, shape):
    """A parameter of ``shape`` drawn by ``init`` in package ``P_``."""
    layer = P_.nn.Layer(**_kw(P_))
    return _np_of(layer.create_parameter(shape, default_initializer=init))


@pytest.mark.parametrize("name,args,shape", [
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), [3, 4]),
    ("Dirac", (2,), [4, 3, 3, 3]),
    ("Bilinear", (), [2, 3, 4, 4]),
    ("Constant", (0.3,), [5]),
])
def test_deterministic_initializers_match_jax_exactly(name, args, shape):
    got = _draw(tp, getattr(tp.nn.initializer, name)(*args), shape)
    want = _draw(jp, getattr(jp.nn.initializer, name)(*args), shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args,shape,mean,std,support", [
    ("TruncatedNormal", (0.5, 2.0, -1.0, 1.5), [200, 100], None, None, (-1.5, 3.5)),
    ("XavierNormal", (), [300, 200], 0.0, (2.0 / 500) ** 0.5, None),
    ("KaimingNormal", (), [64, 32, 3, 3], 0.0, (2.0 / (32 * 9)) ** 0.5, None),
    ("Normal", (1.0, 0.5), [200, 100], 1.0, 0.5, None),
])
def test_random_initializers_match_jax_in_distribution(name, args, shape, mean, std, support):
    tp.seed(2)
    jp.seed(2)
    got = _draw(tp, getattr(tp.nn.initializer, name)(*args), shape)
    want = _draw(jp, getattr(jp.nn.initializer, name)(*args), shape)
    assert got.shape == want.shape and got.dtype == want.dtype
    se = float(want.std()) / np.sqrt(got.size)
    assert abs(float(got.mean()) - float(want.mean())) < 7 * se
    assert abs(float(got.std()) / float(want.std()) - 1) < 0.05
    if mean is not None:
        assert abs(float(got.mean()) - mean) < 5 * std / np.sqrt(got.size)
        assert abs(float(got.std()) / std - 1) < 0.05
    if support is not None:
        assert got.min() >= support[0] and got.max() <= support[1]


@pytest.mark.parametrize("shape,gain", [([6, 10], 1.0), ([10, 4], 2.0), ([4, 2, 3], 0.5)])
def test_orthogonal_initializer_is_orthogonal_as_jax(shape, gain):
    for P_ in (tp, jp):
        w = _draw(P_, P_.nn.initializer.Orthogonal(gain), shape).reshape(shape[0], -1)
        small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(small, gain ** 2 * np.eye(len(small)), atol=1e-5)


def test_global_initializer_sits_between_the_attr_and_the_default():
    C = "initializer"
    try:
        for P_ in (tp, jp):
            init = getattr(P_.nn, C)
            init.set_global_initializer(init.Constant(2.0), init.Constant(3.0))
            layer = P_.nn.Linear(2, 2, bias_attr=P_.ParamAttr(initializer=init.Constant(4.0)),
                                 **_kw(P_))
            assert (_np_of(layer.weight) == 2.0).all() and (_np_of(layer.bias) == 4.0).all()
            conv = P_.nn.Conv2D(1, 1, 1, **_kw(P_))          # its own defaults lose too
            assert (_np_of(conv.weight) == 2.0).all() and (_np_of(conv.bias) == 3.0).all()
            init.set_global_initializer(None)
            assert not (_np_of(P_.nn.Linear(2, 2, **_kw(P_)).weight) == 2.0).all()
    finally:
        tp.nn.initializer.set_global_initializer(None)
        jp.nn.initializer.set_global_initializer(None)


def test_param_attr_records_trainable_learning_rate_and_regularizer():
    reg = tp.regularizer.L2Decay(0.01)
    layer = tp.nn.Linear(3, 2, weight_attr=tp.ParamAttr(learning_rate=0.5, regularizer=reg,
                                                        trainable=False), **CPU)
    assert not layer.weight.requires_grad and layer.bias.requires_grad
    assert layer.weight.optimize_attr == {"learning_rate": 0.5} and layer.weight.regularizer is reg
    jl = jp.nn.Linear(3, 2, weight_attr=jp.ParamAttr(learning_rate=0.5, trainable=False))
    assert jl.weight.stop_gradient and jl.weight.optimize_attr["learning_rate"] == 0.5
    assert tp.nn.ParamAttr is tp.ParamAttr
    for P_ in (tp, jp):
        from importlib import import_module

        wn = import_module(f"{P_.__name__}.framework.param_attr").WeightNormParamAttr(dim=0)
        with pytest.raises(RuntimeError, match="static mode"):
            P_.nn.Linear(3, 2, weight_attr=wn, **_kw(P_))


def test_create_parameter_takes_its_default_initializer_first():
    for P_ in (tp, jp):
        init = P_.nn.initializer
        p = P_.create_parameter([3], "float32", attr=P_.ParamAttr(
            name="w", initializer=init.Constant(1.0), learning_rate=0.2),
            default_initializer=init.Constant(5.0))
        assert (p.numpy() == 5.0).all() and p.optimize_attr["learning_rate"] == 0.2
        assert P_.create_parameter([2], "float32", attr="named").name == "named"
        assert (P_.create_parameter([2], "float32", is_bias=True).numpy() == 0).all()
        with pytest.raises(ValueError):
            P_.create_parameter([2], "float32", attr=False)


# ---------------------------------------------------------------------------
# hooks, nn.utils
# ---------------------------------------------------------------------------

def test_forward_hooks_follow_the_jax_order_and_return_rules():
    """Pre-hooks in order (a tuple or a bare value replaces the inputs),
    post-hooks in order (a value replaces the output), ``remove``."""
    logs, outs, weights = {}, {}, None
    for P_ in (jp, tp):
        log = []
        layer = P_.nn.Linear(6, 3, **_kw(P_))
        if weights is None:
            weights = _jax_state(layer)
        else:
            load_paddle_tpu_params(layer, weights)
        h1 = layer.register_forward_pre_hook(lambda m, inp, log=log: log.append("pre1"))
        h2 = layer.register_forward_pre_hook(lambda m, inp: (inp[0] * 2,))
        h3 = layer.register_forward_pre_hook(lambda m, inp: inp[0] + 1)
        h4 = layer.register_forward_post_hook(lambda m, inp, out: out * 10)
        h5 = layer.register_forward_post_hook(lambda m, inp, out, log=log: log.append("post2"))
        x = P_.to_tensor(V)
        got = [layer(x)]
        h2.remove()
        h4.remove()
        got.append(layer(x))
        for h in (h1, h3, h5):
            h.remove()
        got.append(layer(x))
        logs[P_.__name__], outs[P_.__name__] = log, got
    assert logs["paddle_tpu_torch"] == logs["paddle_tpu"] == ["pre1", "post2", "pre1", "post2"]
    assert_same(outs["paddle_tpu_torch"], outs["paddle_tpu"], rtol=ACCUM, what="hooks")


def test_weight_norm_matches_jax_in_values_names_and_gradients():
    jl = _jax_layer(None, 1, lambda: jp.nn.Linear(8, 4))
    tl = tp.nn.Linear(8, 4, **CPU)
    load_paddle_tpu_params(tl, _jax_state(jl))
    jp.nn.utils.weight_norm(jl, dim=0)
    tp.nn.utils.weight_norm(tl, dim=0)
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["bias", "weight_v", "weight_g"]
    assert tuple(tl.weight_g.shape) == (8,)
    assert_same(wrap([tl.weight_g, tl.weight_v]), [jl.weight_g, jl.weight_v], rtol=ACCUM,
                what="g, v")
    jx, tx = jp.to_tensor(X1[0]), tp.to_tensor(X1[0])
    jo, to = jl(jx), tl(tx)
    assert_same(to, jo, rtol=ACCUM, what="forward")
    c = np.cos(np.arange(jo.size, dtype=np.float32)).reshape(jo.shape)
    (jo * jp.to_tensor(c)).sum().backward()
    (to * tp.to_tensor(c)).sum().backward()
    np.testing.assert_allclose(tl.weight_g.grad.numpy(), jl.weight_g.grad.numpy(), rtol=ACCUM,
                               atol=ACCUM)
    np.testing.assert_allclose(tl.weight_v.grad.numpy(), jl.weight_v.grad.numpy(), rtol=ACCUM,
                               atol=ACCUM)
    jp.nn.utils.remove_weight_norm(jl)
    tp.nn.utils.remove_weight_norm(tl)
    assert list(tl.state_dict()) == ["bias", "weight"] and set(jl.state_dict()) == {"bias",
                                                                                    "weight"}
    assert_same(tl(tx), jl(jx), rtol=ACCUM, what="after remove")


def test_spectral_norm_matches_jax_and_updates_u():
    jl = _jax_layer(None, 2, lambda: jp.nn.Linear(5, 4))
    tl = tp.nn.Linear(5, 4, **CPU)
    load_paddle_tpu_params(tl, _jax_state(jl))
    jp.nn.utils.spectral_norm(jl, n_power_iterations=2)
    tp.nn.utils.spectral_norm(tl, n_power_iterations=2)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == ["bias", "weight_orig",
                                                                  "weight_u"]
    assert_same(wrap([tl.weight, tl.weight_u]), [jl.weight, jl.weight_u], rtol=ACCUM,
                what="init")
    for _ in range(2):
        assert_same(tl(tp.to_tensor(V[:, :5])), jl(jp.to_tensor(V[:, :5])), rtol=ACCUM,
                    what="forward")
    assert_same(wrap(tl.weight_u), jl.weight_u, rtol=ACCUM, what="u after two forwards")


def test_parameter_vector_roundtrip_and_the_clip_reexports():
    layer = tp.nn.Linear(3, 2, **CPU)
    vec = tp.nn.utils.parameters_to_vector(list(layer.parameters()))
    assert tuple(vec.shape) == (8,)
    tp.nn.utils.vector_to_parameters(torch.arange(8.0), list(layer.parameters()))
    np.testing.assert_array_equal(layer.weight.detach().numpy().reshape(-1), np.arange(6.0))
    tv = tp.nn.utils.parameters_to_vector([tp.to_tensor(V), tp.to_tensor(V2)])
    jv = jp.nn.utils.parameters_to_vector([jp.to_tensor(V), jp.to_tensor(V2)])
    assert_same(tv, jv, rtol=RTOL, what="parameters_to_vector")
    with pytest.raises(ValueError):
        tp.nn.utils.vector_to_parameters(torch.zeros(9), list(layer.parameters()))
    assert tp.nn.utils.clip_grad_norm_ is tp.nn.clip.clip_grad_norm_
    assert tp.nn.utils.clip_grad_value_ is tp.nn.clip.clip_grad_value_
    assert set(tp.nn.utils.__all__) == set(jp.nn.utils.__all__)


# ---------------------------------------------------------------------------
# containers, beam search
# ---------------------------------------------------------------------------

def test_layer_and_parameter_dicts_behave_as_jax():
    for P_ in (tp, jp):
        d = P_.nn.LayerDict({"a": P_.nn.ReLU()})
        d["b"] = P_.nn.Linear(2, 2, **_kw(P_))
        d.update([("c", P_.nn.Tanh())])
        assert list(d.keys()) == ["a", "b", "c"] and len(d) == 3 and "b" in d
        assert type(d.pop("a")).__name__ == "ReLU" and list(d) == ["b", "c"]
        assert list(d.state_dict()) == ["b.weight", "b.bias"]
        pd = P_.nn.ParameterDict({"w": _layer_param(P_, [2])})
        pd["v"] = _layer_param(P_, [3])
        assert list(pd.keys()) == ["w", "v"] and list(pd.state_dict()) == ["w", "v"]
        d.clear()
        assert len(d) == 0


def test_beam_search_decodes_the_jax_beams():
    V_, H_, B_ = 7, 8, 2
    j_cell, j_emb, j_out = (_jax_layer(None, i, c) for i, c in enumerate((
        lambda: jp.nn.GRUCell(5, H_), lambda: jp.nn.Embedding(V_, 5),
        lambda: jp.nn.Linear(H_, V_))))
    t_cell, t_emb, t_out = (tp.nn.GRUCell(5, H_, **CPU), tp.nn.Embedding(V_, 5, **CPU),
                            tp.nn.Linear(H_, V_, **CPU))
    for j, t in ((j_cell, t_cell), (j_emb, t_emb), (j_out, t_out)):
        load_paddle_tpu_params(t, _jax_state(j))
    init = _f(B_, H_)
    outs = {}
    for P_, cell, emb, out in ((jp, j_cell, j_emb, j_out), (tp, t_cell, t_emb, t_out)):
        dec = P_.nn.BeamSearchDecoder(cell, 1, 0, 3, embedding_fn=emb, output_fn=out)
        outs[P_.__name__] = P_.nn.dynamic_decode(dec, P_.to_tensor(init), max_step_num=6)
    (gi, gs), (wi, ws) = outs["paddle_tpu_torch"], outs["paddle_tpu"]
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=ACCUM, atol=ACCUM)
    assert gi.numpy().dtype == wi.numpy().dtype and gs.numpy().dtype == ws.numpy().dtype
