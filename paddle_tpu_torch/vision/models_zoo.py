"""The rest of the classification zoo (port of
``paddle_tpu/vision/models_zoo.py``): AlexNet, VGG 11/13/19, SqueezeNet,
DenseNet, GoogLeNet (with its two aux heads), InceptionV3, MobileNet
V1/V2 and the V3 classes, ShuffleNetV2 (and its swish variant), ResNeXt
and wide ResNet, layer for layer the JAX package's (the same parameter
names and counts).  ``pretrained=`` given a local checkpoint path loads it
through ``paddle_tpu_torch.load``; ``pretrained=True`` raises, as there is
no weight download.
"""

from __future__ import annotations

import os

import torch

from .. import nn
from .models import (MobileNetV3, ResNet, VGG, BottleneckBlock,
                     _MOBILENETV3_LARGE, _MOBILENETV3_SMALL, _make_divisible,
                     _vgg_layers)

__all__ = [
    "AlexNet", "alexnet",
    "vgg11", "vgg13", "vgg19",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
    "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3",
    "MobileNetV1", "mobilenet_v1",
    "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2",
]


def _maybe_load_pretrained(model, pretrained):
    """``pretrained`` as a local checkpoint path (a ``.pdparams`` either
    package wrote, or a numpy ``.npz``) loads the weights; ``True`` has no
    download to run and says so."""
    if not pretrained:
        return model
    if pretrained is True:
        raise ValueError(
            "pretrained=True needs a weight download; no network access — "
            "pass pretrained='/path/to/ckpt.pdparams' (or convert an HF "
            "checkpoint via models.hf_compat)")
    model.set_state_dict(_load_local(pretrained))
    return model


def _load_local(path):
    """A state dict from a local file (the JAX ``hub.load_state_dict_from_path``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found at {path}; no network access — "
                                "place the file locally")
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    from ..framework.io import load

    return load(path)


def _conv_bn(in_c, out_c, k, stride=1, padding=0, groups=1, act=nn.ReLU):
    return nn.Sequential(
        nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                  groups=groups, bias_attr=False),
        nn.BatchNorm2D(out_c), act())


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------

class AlexNet(nn.Layer):
    """Reference: ``python/paddle/vision/models/alexnet.py``."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes))
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(self.flatten(x))
        return x


def alexnet(pretrained=False, **kwargs):
    return _maybe_load_pretrained(AlexNet(**kwargs), pretrained)


# ---------------------------------------------------------------------------
# VGG variants (VGG class + vgg16 live in models.py)
# ---------------------------------------------------------------------------

_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _maybe_load_pretrained(VGG(_vgg_layers(_VGG_CFGS[11], batch_norm), **kwargs), pretrained)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _maybe_load_pretrained(VGG(_vgg_layers(_VGG_CFGS[13], batch_norm), **kwargs), pretrained)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _maybe_load_pretrained(VGG(_vgg_layers(_VGG_CFGS[19], batch_norm), **kwargs), pretrained)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------

class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, expand1, expand3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_c, squeeze, 1), nn.ReLU())
        self.e1 = nn.Sequential(nn.Conv2D(squeeze, expand1, 1), nn.ReLU())
        self.e3 = nn.Sequential(nn.Conv2D(squeeze, expand3, 3, padding=1), nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.e1(s), self.e3(s)], dim=1)


class SqueezeNet(nn.Layer):
    """Reference: ``python/paddle/vision/models/squeezenet.py``."""

    def __init__(self, version, num_classes=1000, with_pool=True):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"supported versions are '1.0'/'1.1', got {version!r}")
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        fire = _Fire
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(), nn.MaxPool2D(3, 2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), nn.MaxPool2D(3, 2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2), fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2D(3, 2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256))
        if num_classes > 0:
            self.classifier_conv = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier_conv(x)
        if self.with_pool:
            x = self.flatten(self.avgpool(x))
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    return _maybe_load_pretrained(SqueezeNet("1.0", **kwargs), pretrained)


def squeezenet1_1(pretrained=False, **kwargs):
    return _maybe_load_pretrained(SqueezeNet("1.1", **kwargs), pretrained)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------

_DENSENET_CFGS = {
    # layers -> (init_features, growth_rate, block repeats)
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size, dropout):
        super().__init__()
        self.fn = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False),
            *([nn.Dropout(dropout)] if dropout else []))

    def forward(self, x):
        return torch.cat([x, self.fn(x)], dim=1)


class DenseNet(nn.Layer):
    """Reference: ``python/paddle/vision/models/densenet.py``."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        if layers not in _DENSENET_CFGS:
            raise ValueError(f"supported layers are {sorted(_DENSENET_CFGS)}, "
                             f"got {layers}")
        init_c, growth, repeats = _DENSENET_CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(init_c), nn.ReLU(), nn.MaxPool2D(3, 2, padding=1))
        blocks = []
        c = init_c
        for bi, n in enumerate(repeats):
            for _ in range(n):
                blocks.append(_DenseLayer(c, growth, bn_size, dropout))
                c += growth
            if bi != len(repeats) - 1:   # transition halves channels + spatial
                blocks.append(nn.Sequential(
                    nn.BatchNorm2D(c), nn.ReLU(),
                    nn.Conv2D(c, c // 2, 1, bias_attr=False),
                    nn.AvgPool2D(2, 2)))
                c = c // 2
        blocks.append(nn.Sequential(nn.BatchNorm2D(c), nn.ReLU()))
        self.blocks = nn.Sequential(*blocks)
        self.feat_channels = c
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c, num_classes)
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def densenet121(pretrained=False, **kwargs):
    return _maybe_load_pretrained(DenseNet(layers=121, **kwargs), pretrained)


def densenet161(pretrained=False, **kwargs):
    return _maybe_load_pretrained(DenseNet(layers=161, **kwargs), pretrained)


def densenet169(pretrained=False, **kwargs):
    return _maybe_load_pretrained(DenseNet(layers=169, **kwargs), pretrained)


def densenet201(pretrained=False, **kwargs):
    return _maybe_load_pretrained(DenseNet(layers=201, **kwargs), pretrained)


def densenet264(pretrained=False, **kwargs):
    return _maybe_load_pretrained(DenseNet(layers=264, **kwargs), pretrained)


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1)
# ---------------------------------------------------------------------------

class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_c, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_c, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_c, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                nn.Conv2D(in_c, proj, 1), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], dim=1)


class _GoogLeNetAux(nn.Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = nn.Sequential(nn.Conv2D(in_c, 128, 1), nn.ReLU())
        self.fc = nn.Sequential(
            nn.Flatten(1), nn.Linear(128 * 4 * 4, 1024), nn.ReLU(),
            nn.Dropout(0.7), nn.Linear(1024, num_classes))

    def forward(self, x):
        return self.fc(self.conv(self.pool(x)))


class GoogLeNet(nn.Layer):
    """Reference: ``python/paddle/vision/models/googlenet.py`` — forward
    returns ``(out, aux1, aux2)`` like the reference (the two auxiliary
    heads regularize training; ignore them at inference)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _GoogLeNetAux(512, num_classes)
            self.aux2 = _GoogLeNetAux(528, num_classes)
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(self.flatten(x)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    return _maybe_load_pretrained(GoogLeNet(**kwargs), pretrained)


# ---------------------------------------------------------------------------
# Inception v3
# ---------------------------------------------------------------------------

class _IncA(nn.Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = _conv_bn(in_c, 64, 1)
        self.b5 = nn.Sequential(_conv_bn(in_c, 48, 1), _conv_bn(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_conv_bn(in_c, 64, 1), _conv_bn(64, 96, 3, padding=1),
                                _conv_bn(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, pool_features, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], dim=1)


class _IncB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _conv_bn(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_conv_bn(in_c, 64, 1), _conv_bn(64, 96, 3, padding=1),
                                 _conv_bn(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class _IncC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _conv_bn(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1), _conv_bn(in_c, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], dim=1)


class _IncD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_conv_bn(in_c, 192, 1), _conv_bn(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _conv_bn(in_c, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class _IncE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _conv_bn(in_c, 320, 1)
        self.b3_stem = _conv_bn(in_c, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_conv_bn(in_c, 448, 1),
                                      _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1), _conv_bn(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return torch.cat([self.b1(x),
                       self.b3_a(s), self.b3_b(s),
                       self.b3d_a(d), self.b3d_b(d),
                       self.bp(x)], dim=1)


class InceptionV3(nn.Layer):
    """Reference: ``python/paddle/vision/models/inceptionv3.py``."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, 32, 3, stride=2), _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _conv_bn(64, 80, 1), _conv_bn(80, 192, 3), nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _IncB(288),
            _IncC(768, 128), _IncC(768, 160), _IncC(768, 160), _IncC(768, 192),
            _IncD(768),
            _IncE(1280), _IncE(2048))
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(self.flatten(x)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return _maybe_load_pretrained(InceptionV3(**kwargs), pretrained)


# ---------------------------------------------------------------------------
# MobileNet v1 / v2 (+ the v3 class aliases the reference exports)
# ---------------------------------------------------------------------------

_MOBILENETV1_CFG = [  # (out_c, stride) of each depthwise-separable block
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]


class MobileNetV1(nn.Layer):
    """Reference: ``python/paddle/vision/models/mobilenetv1.py``."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = _make_divisible(32 * scale)
        layers = [_conv_bn(3, c, 3, stride=2, padding=1)]
        for out, s in _MOBILENETV1_CFG:
            out_c = _make_divisible(out * scale)
            layers.append(_conv_bn(c, c, 3, stride=s, padding=1, groups=c))
            layers.append(_conv_bn(c, out_c, 1))
            c = out_c
        self.features = nn.Sequential(*layers)
        self.feat_channels = c
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c, num_classes)
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return _maybe_load_pretrained(MobileNetV1(scale=scale, **kwargs), pretrained)


_MOBILENETV2_CFG = [  # (expansion t, out_c, repeats n, first stride s)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class _InvertedResidualV2(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self._residual = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(in_c, hidden, 1, act=nn.ReLU6))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, act=nn.ReLU6),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        self.fn = nn.Sequential(*layers)

    def forward(self, x):
        out = self.fn(x)
        return x + out if self._residual else out


class MobileNetV2(nn.Layer):
    """Reference: ``python/paddle/vision/models/mobilenetv2.py``."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        layers = [_conv_bn(3, c, 3, stride=2, padding=1, act=nn.ReLU6)]
        for t, out, n, s in _MOBILENETV2_CFG:
            out_c = _make_divisible(out * scale)
            for i in range(n):
                layers.append(_InvertedResidualV2(c, out_c, s if i == 0 else 1, t))
                c = out_c
        layers.append(_conv_bn(c, last_c, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*layers)
        self.feat_channels = last_c
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last_c, num_classes))
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(self.flatten(x))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return _maybe_load_pretrained(MobileNetV2(scale=scale, **kwargs), pretrained)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MOBILENETV3_SMALL, last_channel=1024, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MOBILENETV3_LARGE, last_channel=1280, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


# ---------------------------------------------------------------------------
# ShuffleNet v2
# ---------------------------------------------------------------------------

_SHUFFLENET_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}
_SHUFFLENET_REPEATS = [4, 8, 4]


class _ShuffleUnit(nn.Layer):
    """Stride-1 unit: split halves, transform one, concat, shuffle.
    Stride-2 unit: transform both halves (no split), concat, shuffle."""

    def __init__(self, in_c, out_c, stride, act):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            main_in = in_c // 2
        else:
            main_in = in_c
            self.short = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=2, padding=1, groups=in_c,
                          bias_attr=False),
                nn.BatchNorm2D(in_c),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act())
        self.main = nn.Sequential(
            nn.Conv2D(main_in, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), act(),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False),
            nn.BatchNorm2D(branch_c),
            nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), act())
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        if self.stride == 1:
            short, main = torch.chunk(x, 2, dim=1)
        else:
            short, main = self.short(x), x
        return self.shuffle(torch.cat([short, self.main(main)], dim=1))


class ShuffleNetV2(nn.Layer):
    """Reference: ``python/paddle/vision/models/shufflenetv2.py``."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000, with_pool=True):
        super().__init__()
        if scale not in _SHUFFLENET_STAGE_OUT:
            raise ValueError(f"supported scales are "
                             f"{sorted(_SHUFFLENET_STAGE_OUT)}, got {scale}")
        act_layer = {"relu": nn.ReLU, "swish": nn.Swish}[act]
        self.num_classes = num_classes
        self.with_pool = with_pool
        chans = _SHUFFLENET_STAGE_OUT[scale]
        self.stem = nn.Sequential(
            nn.Conv2D(3, chans[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(chans[0]), act_layer(),
            nn.MaxPool2D(3, 2, padding=1))
        c = chans[0]
        stages = []
        for si, n in enumerate(_SHUFFLENET_REPEATS):
            out_c = chans[si + 1]
            stages.append(_ShuffleUnit(c, out_c, 2, act_layer))
            for _ in range(n - 1):
                stages.append(_ShuffleUnit(out_c, out_c, 1, act_layer))
            c = out_c
        self.stages = nn.Sequential(*stages)
        self.head = nn.Sequential(
            nn.Conv2D(c, chans[-1], 1, bias_attr=False),
            nn.BatchNorm2D(chans[-1]), act_layer())
        self.feat_channels = chans[-1]
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(chans[-1], num_classes)
        self.flatten = nn.Flatten(1)

    def forward(self, x):
        x = self.head(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=0.25, **kwargs), pretrained)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=0.33, **kwargs), pretrained)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=0.5, **kwargs), pretrained)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=1.0, **kwargs), pretrained)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=1.5, **kwargs), pretrained)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=2.0, **kwargs), pretrained)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ShuffleNetV2(scale=1.0, act="swish", **kwargs), pretrained)


# ---------------------------------------------------------------------------
# ResNeXt / wide ResNet (grouped-bottleneck ResNet variants)
# ---------------------------------------------------------------------------

def resnext50_32x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 50, groups=32, width_per_group=4, **kwargs), pretrained)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 50, groups=64, width_per_group=4, **kwargs), pretrained)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 101, groups=32, width_per_group=4, **kwargs), pretrained)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 101, groups=64, width_per_group=4, **kwargs), pretrained)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 152, groups=32, width_per_group=4, **kwargs), pretrained)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 152, groups=64, width_per_group=4, **kwargs), pretrained)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 50, width_per_group=128, **kwargs), pretrained)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _maybe_load_pretrained(ResNet(BottleneckBlock, 101, width_per_group=128, **kwargs), pretrained)
