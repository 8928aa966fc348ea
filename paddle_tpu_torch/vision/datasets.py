"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``).

They read local files in the standard formats (no download); ``FakeData``
makes synthetic samples from a seed.  PIL and ``scipy.io`` are imported
only by the datasets that decode images or read ``.mat`` files, when they
do.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData", "ImageFolder", "DatasetFolder"]


class FakeData(Dataset):
    def __init__(self, num_samples=1000, image_shape=(3, 32, 32), num_classes=10, transform=None, seed=0):
        rng = np.random.RandomState(seed)
        self.images = rng.rand(num_samples, *image_shape).astype(np.float32)
        self.labels = rng.randint(0, num_classes, size=(num_samples,)).astype(np.int32)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class MNIST(Dataset):
    """Reads the classic IDX-format files from ``root``."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=False, backend=None, root=None):
        root = root or os.path.expanduser("~/.cache/paddle_tpu/mnist")
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
        if not os.path.exists(image_path):
            raise FileNotFoundError(
                f"MNIST files not found at {image_path}; no network access — place files locally")
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)
        self.transform = transform

    @staticmethod
    def _read_images(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        return data

    @staticmethod
    def _read_labels(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), dtype=np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None, :, :]
        if self.transform:
            img = self.transform(img)
        return img, int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=False, backend=None):
        if data_file is None or not os.path.exists(data_file):
            raise FileNotFoundError("Cifar10 archive not found; no network access — place file locally")
        self.transform = transform
        self.data = []
        with tarfile.open(data_file) as tf:
            names = [n for n in tf.getnames() if ("data_batch" in n if mode == "train" else "test_batch" in n)]
            for name in sorted(names):
                d = pickle.load(tf.extractfile(name), encoding="bytes")
                imgs = d[b"data"].reshape(-1, 3, 32, 32)
                for img, lbl in zip(imgs, d[b"labels"]):
                    self.data.append((img, lbl))

    def __getitem__(self, idx):
        img, lbl = self.data[idx]
        img = img.astype(np.float32)
        if self.transform:
            img = self.transform(img)
        return img, int(lbl)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    pass


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=IMG_EXTENSIONS, transform=None, is_valid_file=None):
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for fname in sorted(os.listdir(os.path.join(root, c))):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(root, c, fname), self.class_to_idx[c]))
        self.transform = transform
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    def __init__(self, root, loader=None, extensions=IMG_EXTENSIONS, transform=None, is_valid_file=None):
        self.samples = []
        for dirpath, _, files in os.walk(root):
            for fname in sorted(files):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(dirpath, fname), 0))
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader

    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return (img,)


class Flowers(Dataset):
    """Flowers102 (reference: ``python/paddle/vision/datasets/flowers.py``).

    Reads the standard distribution files locally (no network): the image
    tarball (``102flowers.tgz`` — jpg members), ``imagelabels.mat`` and
    ``setid.mat``.  Keeps the reference's historical split quirk:
    ``mode='train'`` reads the ``tstid`` subset (6149 images) and
    ``mode='test'`` reads ``trnid`` (1020), matching its MODE_FLAG_MAP.
    """

    _MODE_FLAG = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if mode.lower() not in self._MODE_FLAG:
            raise ValueError(f"mode should be 'train', 'test' or 'valid', got {mode}")
        root = os.path.expanduser("~/.cache/paddle_tpu/flowers")
        data_file = data_file or os.path.join(root, "102flowers.tgz")
        label_file = label_file or os.path.join(root, "imagelabels.mat")
        setid_file = setid_file or os.path.join(root, "setid.mat")
        for p in (data_file, label_file, setid_file):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"Flowers file not found at {p}; no network access — place files locally")
        import scipy.io

        self.transform = transform
        self.backend = backend
        labels = scipy.io.loadmat(label_file)["labels"][0]
        indexes = scipy.io.loadmat(setid_file)[self._MODE_FLAG[mode.lower()]][0]
        self._tar = tarfile.open(data_file)
        self._members = {os.path.basename(m.name): m
                         for m in self._tar.getmembers() if m.name.endswith(".jpg")}
        self.samples = [(f"image_{idx:05d}.jpg", int(labels[idx - 1]))
                        for idx in indexes]

    def __getitem__(self, idx):
        name, label = self.samples[idx]
        from PIL import Image

        img = Image.open(self._tar.extractfile(self._members[name])).convert("RGB")
        if self.backend != "pil":
            img = np.asarray(img)
        if self.transform:
            img = self.transform(img)
        return img, np.array([label], dtype=np.int64)

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference:
    ``python/paddle/vision/datasets/voc2012.py``).

    Reads the standard ``VOCtrainval_11-May-2012.tar`` locally.  Split map
    matches the reference: ``mode='train'`` → ``trainval.txt``,
    ``'test'`` → ``train.txt``, ``'valid'`` → ``val.txt``; each item is an
    (image, segmentation-mask) pair.
    """

    _MODE_FLAG = {"train": "trainval", "test": "train", "valid": "val"}
    _SET = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    _IMG = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    _LBL = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if mode.lower() not in self._MODE_FLAG:
            raise ValueError(f"mode should be 'train', 'test' or 'valid', got {mode}")
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle_tpu/voc2012/VOCtrainval_11-May-2012.tar")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"VOC2012 archive not found at {data_file}; no network access — place file locally")
        self.transform = transform
        self.backend = backend
        self._tar = tarfile.open(data_file)
        names = self._tar.extractfile(
            self._SET.format(self._MODE_FLAG[mode.lower()])).read().split()
        self.samples = [n.decode() for n in names]

    def __getitem__(self, idx):
        from PIL import Image

        name = self.samples[idx]
        img = Image.open(self._tar.extractfile(self._IMG.format(name))).convert("RGB")
        lbl = Image.open(self._tar.extractfile(self._LBL.format(name)))
        if self.backend != "pil":
            img, lbl = np.asarray(img), np.asarray(lbl)
        if self.transform:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return len(self.samples)


__all__ += ["Flowers", "VOC2012"]
