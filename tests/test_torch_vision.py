"""``vision.models`` of paddle_tpu_torch (the models and the zoo) against
paddle_tpu's (CPU); the transforms, datasets and activations are
``test_torch_vision_data.py``'s.

- Parameter counts: every factory of ``vision.models`` equals the JAX
  package's count and, where there is one, the canonical published count.
  Counting needs no random draws, so neither side makes them: the JAX
  side's parameters come from a zero initializer set with
  ``set_global_initializer`` (the JAX package compiles its draws shape by
  shape), the port's from ``Uniform`` and ``Normal`` patched to allocate
  without filling.
- Forwards after carrying the JAX weights and BatchNorm statistics across
  (random statistics, eval mode, 1 x 3 x 64 x 64): within 1e-4 absolute;
  GoogLeNet's three outputs; ``with_pool=False`` (MobileNetV2's feature
  map, within 1e-4 of its largest value).  The JAX forwards run compiled
  (``jit.to_static``).
- One ``Model.fit`` step of ``resnet18`` at 32 x 32, 10 classes, under
  Momentum: the loss within 1e-4 relative of the JAX step's, the updated
  parameters within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.models.convert import load_paddle_tpu_params
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.vision import models as TM

FWD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data)


# ---------------------------------------------------------------------------
# models: parameter counts
# ---------------------------------------------------------------------------

# canonical parameter counts at num_classes=1000 (GoogLeNet with its two aux
# heads, InceptionV3 with none), as tests/test_vision_zoo.py
CANONICAL_COUNTS = {
    "alexnet": 61_100_840, "squeezenet1_0": 1_248_424, "squeezenet1_1": 1_235_496,
    "densenet121": 7_978_856, "mobilenet_v1": 4_231_976, "mobilenet_v2": 3_504_872,
    "shufflenet_v2_x1_0": 2_278_604, "resnext50_32x4d": 25_028_904,
    "wide_resnet50_2": 68_883_240, "googlenet": 13_378_280, "inception_v3": 23_834_568,
    "vgg11": 132_863_336, "vgg19": 143_667_240, "resnet18": 11_689_512,
    "resnet50": 25_557_032, "vgg16": 138_357_544,
}
FACTORIES = sorted(n for n in JM.__all__ if n[0].islower())


class _Zeros(jinit.Initializer):
    def __call__(self, shape, dtype):
        return np.zeros(tuple(int(s) for s in shape), np.float32)


def _count(m):
    return sum(int(np.prod(tuple(p.shape))) for p in m.parameters())


def _unfilled(self, shape, dtype, generator):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype)


@pytest.mark.parametrize("name", FACTORIES)
def test_param_count_is_jax_and_canonical(name, monkeypatch):
    assert name in TM.__all__
    jinit.set_global_initializer(_Zeros(), _Zeros())
    try:
        want = _count(getattr(JM, name)())
    finally:
        jinit.set_global_initializer(None, None)
    monkeypatch.setattr(tinit.Uniform, "__call__", _unfilled)
    monkeypatch.setattr(tinit.Normal, "__call__", _unfilled)
    got = _count(getattr(TM, name)())
    assert got == want
    if name in CANONICAL_COUNTS:
        assert got == CANONICAL_COUNTS[name]


def test_zoo_exports_the_jax_names():
    assert sorted(TM.__all__) == sorted(JM.__all__)


def test_densenet161_channel_algebra_and_rejections():
    assert TM.densenet161(num_classes=0, with_pool=True).feat_channels == 2208
    with pytest.raises(ValueError, match="1.0"):
        TM.SqueezeNet("2.0")
    with pytest.raises(ValueError, match="scales"):
        TM.ShuffleNetV2(scale=0.75)
    with pytest.raises(ValueError, match="no network access"):
        TM.resnet18(pretrained=True)


# ---------------------------------------------------------------------------
# models: forwards and a fit step against the JAX package
# ---------------------------------------------------------------------------

def _state_with_random_stats(jm, seed):
    """The JAX model's state dict with random BatchNorm statistics (loaded
    back into it), as numpy."""
    rng = np.random.default_rng(seed)
    state = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    for n, v in state.items():
        if n.endswith("_mean"):
            state[n] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        elif n.endswith("_variance"):
            state[n] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    jm.set_state_dict({n: jp.to_tensor(v) for n, v in state.items()})
    return state


def _pair(name, seed=0, **kw):
    jp.seed(seed)
    jm = getattr(JM, name)(**kw)
    tm = getattr(TM, name)(**kw)
    load_paddle_tpu_params(tm, _state_with_random_stats(jm, seed))
    jm.eval()
    tm.eval()
    return jm, tm


def _forwards(jm, tm, x):
    want = jp.jit.to_static(jm)(jp.to_tensor(x))
    got = tm(torch.from_numpy(x))
    as_tuple = lambda o: o if isinstance(o, (tuple, list)) else (o,)   # noqa: E731
    return [_np(o) for o in as_tuple(got)], [_np(o) for o in as_tuple(want)]


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v3_small", "shufflenet_v2_x0_25",
                                  "squeezenet1_1", "densenet121", "googlenet"])
def test_eval_forward_matches_jax(name):
    jm, tm = _pair(name, num_classes=10)
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(np.float32)
    got, want = _forwards(jm, tm, x)
    assert len(got) == len(want) == (3 if name == "googlenet" else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 10)
        np.testing.assert_allclose(g, w, atol=FWD_ATOL, rtol=0)


def test_with_pool_false_keeps_the_feature_map():
    jm, tm = _pair("mobilenet_v2", num_classes=0, with_pool=False)
    x = np.random.default_rng(2).normal(size=(1, 3, 64, 64)).astype(np.float32)
    (got,), (want,) = _forwards(jm, tm, x)
    assert got.shape == want.shape == (1, tm.feat_channels, 2, 2)
    # the map is not normalised by a classifier: its values reach ~5 (the
    # reading, 1.6e-4, is 3.3e-5 of that), so the limit scales with them
    np.testing.assert_allclose(got, want, atol=FWD_ATOL * max(1.0, np.abs(want).max()), rtol=0)


def test_resnet18_fit_step_matches_jax():
    """One ``Model.fit`` step (``num_iters=1``) under Momentum."""
    jp.seed(0)
    jm = JM.resnet18(num_classes=10)
    tm = TM.resnet18(num_classes=10)
    load_paddle_tpu_params(tm, {n: np.asarray(t._data) for n, t in jm.state_dict().items()})
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int64)
    hist, params = {}, {}
    for P, net in ((jp, jm), (tp, tm)):
        model = P.Model(net)
        model.prepare(P.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                           parameters=net.parameters()),
                      P.nn.CrossEntropyLoss())
        ds = P.io.TensorDataset([P.to_tensor(x), P.to_tensor(y)])
        hist[P] = model.fit(ds, batch_size=8, epochs=1, shuffle=False, verbose=0,
                            num_iters=1)["loss"]
        params[P] = {n: _np(p) for n, p in net.named_parameters()}
    np.testing.assert_allclose(hist[tp], hist[jp], rtol=1e-4)
    assert sorted(params[tp]) == sorted(params[jp])
    for n, w in params[jp].items():
        np.testing.assert_allclose(params[tp][n], w, atol=1e-5, rtol=0, err_msg=n)


def test_pretrained_local_path_roundtrip(tmp_path):
    p = str(tmp_path / "sq.pdparams")
    jp.seed(0)
    jm = JM.squeezenet1_1(num_classes=5)
    jp.save(jm.state_dict(), p)                          # a JAX-written checkpoint
    tm = TM.squeezenet1_1(pretrained=p, num_classes=5)
    for n, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jm.state_dict()[n]._data))
    with pytest.raises(FileNotFoundError):
        TM.squeezenet1_1(pretrained=str(tmp_path / "missing.pdparams"))


def test_models_refuse_the_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp.set_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.resnet18()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.vision.transforms.to_tensor(np.zeros((2, 2, 3), np.float32))
