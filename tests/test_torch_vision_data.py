"""``vision``'s transforms, datasets and image backend of paddle_tpu_torch,
and the ``nn`` activations its models need, against paddle_tpu's (CPU).

- ``relu6``, ``hardswish``, ``hardsigmoid`` (Paddle's slope 0.1666667),
  ``swish`` and ``channel_shuffle``: the JAX package's bits.
- Transforms: the deterministic ones give the JAX package's bits; the
  random ones too under the same ``random.seed`` / ``np.random.seed``.
  Bilinear resizing (``resize``, ``Resize``, ``RandomResizedCrop``) on
  [0, 1] images is held within 1e-5 absolute where an axis grows and 1e-6
  where both shrink.  The readings: upscaling 37 x 50 -> 224 read 1.7e-6
  and 200 x 181 -> 224 7.3e-6, the larger being the JAX side's own float32
  error (7.0e-6 against a float64 resample with the same weights, where
  the port's reads 1.1e-7); downscaling 256 -> 224 read 2.4e-7, 64 -> 12
  1.2e-7 and ``RandomResizedCrop(12)`` of 24 x 24 crops 1.2e-7 (a few
  float32 ulps of values up to 1: the limit is 4x the largest).
- Datasets read the same items as the JAX package's from files the tests
  write: MNIST IDX gz, a Cifar10 tar, a DatasetFolder / ImageFolder tree,
  Flowers and VOC2012 (the fixtures of ``test_vision_datasets_extra.py``).
"""

import gzip
import io as _io
import os
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.framework import device as tp_device
from paddle_tpu_torch.vision import transforms as TT

RESIZE_ATOL = 1e-5          # an axis grows
RESIZE_DOWN_ATOL = 1e-6     # both axes shrink


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tp_device._CURRENT
    tp.set_device("cpu")
    yield
    tp.set_device(prev)


def _np(x):
    if isinstance(x, tp.Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, jp.Tensor):
        return np.asarray(x._data)
    return np.asarray(x)


# ---------------------------------------------------------------------------
# nn activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("relu6", {}), ("hardswish", {}), ("hardsigmoid", {}),
                                     ("swish", {}), ("channel_shuffle", {"groups": 4})])
def test_activations_give_the_jax_bits(name, kw):
    x = np.random.default_rng(0).normal(scale=4.0, size=(2, 8, 5, 6)).astype(np.float32)
    x.ravel()[:9] = [-3.0, 3.0, 0.0, 6.0, -6.0, 2.9999998, -3.0000002, 1e-8, -1e-8]
    want = _np(getattr(jp.nn.functional, name)(jp.to_tensor(x), **kw))
    np.testing.assert_array_equal(_np(getattr(tp.nn.functional, name)(torch.from_numpy(x),
                                                                      **kw)), want)
    layer = {"relu6": "ReLU6", "hardswish": "Hardswish", "hardsigmoid": "Hardsigmoid",
             "swish": "Swish", "channel_shuffle": "ChannelShuffle"}[name]
    args = (kw["groups"],) if kw else ()
    np.testing.assert_array_equal(_np(getattr(tp.nn, layer)(*args)(tp.to_tensor(x))), want)


def test_hardsigmoid_is_paddles_not_torchs():
    x = torch.tensor([-1.0, 0.5, 2.0])
    assert not torch.equal(tp.nn.functional.hardsigmoid(x), torch.nn.functional.hardsigmoid(x))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _u8(h=16, w=16, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)


def _f32(h=16, w=16, seed=0):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


DETERMINISTIC = [
    ("to_tensor", lambda T, a: T.to_tensor(a)),
    ("to_tensor_hwc", lambda T, a: T.to_tensor(a, data_format="HWC")),
    ("normalize_chw", lambda T, a: T.normalize(a.transpose(2, 0, 1).astype(np.float32),
                                               [10.0, 20.0, 30.0], [2.0, 3.0, 4.0])),
    ("normalize_hwc", lambda T, a: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3],
                                               data_format="HWC")(a)),
    ("center_crop", lambda T, a: T.CenterCrop((9, 7))(a)),
    ("crop", lambda T, a: T.crop(a, 2, 3, 5, 6)),
    ("hflip", lambda T, a: T.hflip(a)),
    ("vflip", lambda T, a: T.vflip(a)),
    ("transpose", lambda T, a: T.Transpose()(a)),
    ("pad_class", lambda T, a: T.Pad([1, 2, 3, 4], fill=7)(a)),
    ("pad_reflect", lambda T, a: T.pad(a, (2, 1), padding_mode="reflect")),
    ("pad_edge", lambda T, a: T.pad(a, 3, padding_mode="edge")),
    ("erase", lambda T, a: T.erase(a, 2, 3, 4, 2, v=0)),
    ("brightness", lambda T, a: T.adjust_brightness(a, 1.5)),
    ("contrast", lambda T, a: T.adjust_contrast(a, 0.6)),
    ("hue", lambda T, a: T.adjust_hue(a, 0.25)),
    ("grayscale", lambda T, a: T.to_grayscale(a, 3)),
    ("affine_nearest", lambda T, a: T.affine(a, 30.0, (2, -1), 1.1, (5.0, 3.0))),
    ("affine_bilinear", lambda T, a: T.affine(a, -20.0, (1, 1), 0.9, (0.0, 0.0),
                                              interpolation="bilinear")),
    ("rotate", lambda T, a: T.rotate(a, 90.0)),
    ("perspective", lambda T, a: T.perspective(a, [(0, 0), (15, 0), (15, 15), (0, 15)],
                                               [(1, 2), (14, 0), (13, 15), (2, 12)])),
    ("perspective_bilinear", lambda T, a: T.perspective(
        a, [(0, 0), (15, 0), (15, 15), (0, 15)], [(1, 2), (14, 0), (13, 15), (2, 12)],
        interpolation="bilinear")),
]


@pytest.mark.parametrize("name,fn", DETERMINISTIC, ids=[d[0] for d in DETERMINISTIC])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_deterministic_transforms_give_the_jax_bits(name, fn, kind):
    a = _u8() if kind == "uint8" else _f32()
    want = _np(fn(JT, a))
    got = _np(fn(TT, a))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((16, 16), (24, 24)), ((37, 50), (224, 224)),
                                     ((200, 181), (224, 224)), ((256, 256), (224, 224)),
                                     ((64, 64), (12, 12)), ((100, 60), (33, 97))],
                         ids=["up", "up_wide", "up_crop", "down_imagenet", "down_5x", "mixed"])
def test_resize_matches_jax_image_resize(src, dst):
    a = _f32(*src)
    atol = RESIZE_DOWN_ATOL if dst[0] < src[0] and dst[1] < src[1] else RESIZE_ATOL
    want = JT.resize(a, dst)
    got = TT.resize(a, dst)
    assert got.dtype == np.float32 and got.shape == want.shape == dst + (3,)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(TT.Resize(dst)(a), want, atol=atol, rtol=0)
    gray = a[..., 0]
    np.testing.assert_allclose(TT.resize(gray, dst), JT.resize(gray, dst), atol=atol, rtol=0)


def _seeded(T, make, img, n=4, seed=7):
    random.seed(seed)
    np.random.seed(seed)
    t = make(T)
    return [_np(t(img)) for _ in range(n)]


RANDOM = [
    ("random_crop", lambda T: T.RandomCrop(10, padding=2)),
    ("hflip", lambda T: T.RandomHorizontalFlip()),
    ("vflip", lambda T: T.RandomVerticalFlip()),
    ("rotation", lambda T: T.RandomRotation(30)),
    ("brightness", lambda T: T.BrightnessTransform(0.4)),
    ("contrast", lambda T: T.ContrastTransform(0.4)),
    ("saturation", lambda T: T.SaturationTransform(0.4)),
    ("hue", lambda T: T.HueTransform(0.2)),
    ("color_jitter", lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.2)),
    ("affine", lambda T: T.RandomAffine(15, translate=(0.1, 0.1), scale=(0.9, 1.1),
                                        shear=(-5, 5, -3, 3))),
    ("perspective", lambda T: T.RandomPerspective(prob=1.0)),
    ("erasing", lambda T: T.RandomErasing(prob=1.0, value=0)),
    ("grayscale", lambda T: T.Grayscale(3)),
]


@pytest.mark.parametrize("name,make", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_transforms_match_jax_under_the_same_seeds(name, make):
    img = _u8(24, 24)
    got = _seeded(TT, make, img)
    want = _seeded(JT, make, img)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size,atol", [(12, RESIZE_DOWN_ATOL), ((40, 36), RESIZE_ATOL)],
                         ids=["down", "up"])
def test_random_resized_crop_matches_jax(size, atol):
    img = _f32(24, 24)
    got = _seeded(TT, lambda T: T.RandomResizedCrop(size), img, n=6)
    want = _seeded(JT, lambda T: T.RandomResizedCrop(size), img, n=6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_compose_and_base_transform_keys():
    img, label = _u8(), 3
    for T in (TT, JT):
        out = T.Grayscale(1, keys=("image", "label"))((img, label))
        assert out[1] == label and out[0].shape == (16, 16, 1)
    comp = lambda T: T.Compose([T.CenterCrop(12), T.Normalize(  # noqa: E731
        [0.5] * 3, [0.25] * 3, data_format="HWC"), T.Transpose()])
    np.testing.assert_array_equal(comp(TT)(_f32()), comp(JT)(_f32()))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _same_items(tds, jds, n=None):
    assert len(tds) == len(jds)
    for i in range(n or len(tds)):
        ti, ji = tds[i], jds[i]
        assert len(ti) == len(ji)
        for t, j in zip(ti, ji):
            tv, jv = _np(t), _np(j)
            assert tv.dtype == jv.dtype and tv.shape == jv.shape
            np.testing.assert_array_equal(tv, jv)


def test_fake_data_matches_jax():
    kw = dict(num_samples=5, image_shape=(3, 8, 8), num_classes=4, seed=2)
    _same_items(tp.vision.datasets.FakeData(**kw), jp.vision.datasets.FakeData(**kw))


def test_mnist_idx_gz(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=5, dtype=np.uint8)
    ip, lp = tmp_path / "train-images-idx3-ubyte.gz", tmp_path / "train-labels-idx1-ubyte.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    for cls in ("MNIST", "FashionMNIST"):
        tds = getattr(tp.vision.datasets, cls)(root=str(tmp_path),
                                               transform=lambda a: a / 255.0)
        jds = getattr(jp.vision.datasets, cls)(root=str(tmp_path),
                                               transform=lambda a: a / 255.0)
        _same_items(tds, jds)
    with pytest.raises(FileNotFoundError, match="no network access"):
        tp.vision.datasets.MNIST(root=str(tmp_path / "none"))


def _add_bytes(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, _io.BytesIO(data))


def test_cifar10_tar(tmp_path):
    import pickle

    rng = np.random.default_rng(1)
    path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for name, n in (("data_batch_1", 3), ("data_batch_2", 2), ("test_batch", 2)):
            d = {b"data": rng.integers(0, 256, size=(n, 3 * 32 * 32), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, size=n).tolist()}
            _add_bytes(tar, f"cifar-10-batches-py/{name}", pickle.dumps(d))
    for mode in ("train", "test"):
        _same_items(tp.vision.datasets.Cifar10(str(path), mode=mode),
                    jp.vision.datasets.Cifar10(str(path), mode=mode))
        _same_items(tp.vision.datasets.Cifar100(str(path), mode=mode),
                    jp.vision.datasets.Cifar100(str(path), mode=mode))


def test_dataset_folder_and_image_folder(tmp_path):
    rng = np.random.default_rng(2)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(2):
            np.save(tmp_path / c / f"{i}.npy", rng.random((4, 4, 3)).astype(np.float32))
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    tds = tp.vision.datasets.DatasetFolder(str(tmp_path))
    jds = jp.vision.datasets.DatasetFolder(str(tmp_path))
    assert tds.class_to_idx == jds.class_to_idx == {"cat": 0, "dog": 1}
    assert tds.samples == jds.samples
    _same_items(tds, jds)
    _same_items(tp.vision.datasets.ImageFolder(str(tmp_path)),
                jp.vision.datasets.ImageFolder(str(tmp_path)))


def _jpg_bytes(w=8, h=8, color=(255, 0, 0)):
    from PIL import Image

    buf = _io.BytesIO()
    Image.new("RGB", (w, h), color).save(buf, format="JPEG")
    return buf.getvalue()


def _png_bytes(w=8, h=8, value=3):
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.full((h, w), value, np.uint8), mode="L").save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def flowers_files(tmp_path):
    import scipy.io

    data_file = tmp_path / "102flowers.tgz"
    with tarfile.open(data_file, "w:gz") as tar:
        for i in range(1, 7):
            _add_bytes(tar, f"jpg/image_{i:05d}.jpg", _jpg_bytes(color=(i * 30, 0, 0)))
    label_file = tmp_path / "imagelabels.mat"
    scipy.io.savemat(label_file, {"labels": np.arange(1, 7)[None]})
    setid_file = tmp_path / "setid.mat"
    scipy.io.savemat(setid_file, {"tstid": np.array([[1, 2, 3, 4]]),
                                  "trnid": np.array([[5]]),
                                  "valid": np.array([[6]])})
    return str(data_file), str(label_file), str(setid_file)


@pytest.mark.parametrize("mode", ["train", "test", "valid"])
def test_flowers_matches_jax(flowers_files, mode):
    tds = tp.vision.datasets.Flowers(*flowers_files, mode=mode, backend="cv2")
    jds = jp.vision.datasets.Flowers(*flowers_files, mode=mode, backend="cv2")
    _same_items(tds, jds)
    with pytest.raises(FileNotFoundError, match="no network access"):
        tp.vision.datasets.Flowers(flowers_files[0] + ".missing")


@pytest.fixture
def voc_archive(tmp_path):
    path = tmp_path / "VOCtrainval_11-May-2012.tar"
    base = "VOCdevkit/VOC2012"
    with tarfile.open(path, "w") as tar:
        names = ["2007_000001", "2007_000002", "2007_000003"]
        _add_bytes(tar, f"{base}/ImageSets/Segmentation/trainval.txt",
                   "\n".join(names).encode())
        _add_bytes(tar, f"{base}/ImageSets/Segmentation/train.txt", names[0].encode())
        _add_bytes(tar, f"{base}/ImageSets/Segmentation/val.txt", "\n".join(names[1:]).encode())
        for k, n in enumerate(names):
            _add_bytes(tar, f"{base}/JPEGImages/{n}.jpg", _jpg_bytes(color=(0, 40 * k, 0)))
            _add_bytes(tar, f"{base}/SegmentationClass/{n}.png", _png_bytes(value=k + 1))
    return str(path)


@pytest.mark.parametrize("mode", ["train", "test", "valid"])
def test_voc2012_matches_jax(voc_archive, mode):
    _same_items(tp.vision.datasets.VOC2012(voc_archive, mode=mode, backend="cv2"),
                jp.vision.datasets.VOC2012(voc_archive, mode=mode, backend="cv2"))


def test_image_backend_trio(tmp_path):
    from paddle_tpu_torch.vision import get_image_backend, image_load, set_image_backend

    p = str(tmp_path / "img.jpg")
    with open(p, "wb") as f:
        f.write(_jpg_bytes(w=5, h=4))
    assert get_image_backend() == "pil"
    assert image_load(p).size == (5, 4)
    t = image_load(p, backend="tensor")
    assert isinstance(t, tp.Tensor) and tuple(t.shape) == (4, 5, 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jp.vision.image_load(
        p, backend="tensor")._data))
    with pytest.raises(ValueError, match="Expected backend"):
        set_image_backend("turbojpeg")
    set_image_backend("tensor")
    try:
        assert get_image_backend() == "tensor"
    finally:
        set_image_backend("pil")
