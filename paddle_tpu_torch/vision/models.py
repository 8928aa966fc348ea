"""Vision models (port of ``paddle_tpu/vision/models.py``): ``LeNet``,
``ResNet`` and ``resnet18`` ... ``resnet152``, ``VGG`` / ``vgg16`` and
``MobileNetV3``.  Parameter and buffer names are the JAX layers', so
``models.convert`` carries weights (and BatchNorm's running statistics)
across.  Parameters are drawn on the device ``set_device`` chose (the card
by default) from its ``default_generator``."""

from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg16",
           "MobileNetV3", "mobilenet_v3_small", "mobilenet_v3_large"]

# the rest of the zoo (AlexNet/DenseNet/GoogLeNet/InceptionV3/MobileNetV1-V2/
# ShuffleNetV2/SqueezeNet/ResNeXt/wide-ResNet) lives in models_zoo.py; its
# names are re-exported here at the bottom of this module so
# ``paddle.vision.models.<name>`` matches the reference surface.


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.Linear(120, 84), nn.Linear(84, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        return self.fc(torch.flatten(x, 1))


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, norm_layer=None,
                 groups=1, base_width=64):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """Reference: ``python/paddle/vision/models/resnet.py``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, in_channels=3,
                 groups=1, width_per_group=64):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width_per_group
        self.inplanes = 64
        self.conv1 = nn.Conv2D(in_channels, self.inplanes, 7, stride=2, padding=3, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.num_classes = num_classes

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion),
            )
        extra = ({"groups": self.groups, "base_width": self.base_width}
                 if block is BottleneckBlock else {})
        layers = [block(self.inplanes, planes, stride, downsample, **extra)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **extra))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def resnet18(pretrained=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(ResNet(BasicBlock, 18, **kwargs), pretrained)


def resnet34(pretrained=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(ResNet(BasicBlock, 34, **kwargs), pretrained)


def resnet50(pretrained=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(ResNet(BottleneckBlock, 50, **kwargs), pretrained)


def resnet101(pretrained=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(ResNet(BottleneckBlock, 101, **kwargs), pretrained)


def resnet152(pretrained=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(ResNet(BottleneckBlock, 152, **kwargs), pretrained)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(torch.flatten(x, 1))


def _vgg_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
    return _maybe_load_pretrained(VGG(_vgg_layers(cfg, batch_norm), **kwargs), pretrained)


# ---------------------------------------------------------------------------
# MobileNetV3 (reference ``python/paddle/vision/models/mobilenetv3.py`` — the
# PP-OCR backbone family: depthwise-separable convs, SE blocks, hardswish)
# ---------------------------------------------------------------------------

def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(nn.Layer):
    def __init__(self, channels, reduced):
        super().__init__()
        self.fc1 = nn.Conv2D(channels, reduced, 1)
        self.fc2 = nn.Conv2D(reduced, channels, 1)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        s = F.relu(self.fc1(s))
        s = F.hardsigmoid(self.fc2(s))
        return x * s


class InvertedResidual(nn.Layer):
    """expand (1x1) -> depthwise (kxk) -> [SE] -> project (1x1), residual when
    stride 1 and channels match."""

    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, act):
        super().__init__()
        self._residual = stride == 1 and in_c == out_c
        self._act = F.hardswish if act == "hardswish" else F.relu
        layers = []
        if exp_c != in_c:
            layers += [nn.Conv2D(in_c, exp_c, 1, bias_attr=False), nn.BatchNorm2D(exp_c)]
        self.expand = nn.Sequential(*layers) if layers else None
        self.dw = nn.Conv2D(exp_c, exp_c, kernel, stride=stride,
                            padding=kernel // 2, groups=exp_c, bias_attr=False)
        self.dw_bn = nn.BatchNorm2D(exp_c)
        self.se = SqueezeExcitation(exp_c, _make_divisible(exp_c // 4)) if use_se else None
        self.project = nn.Conv2D(exp_c, out_c, 1, bias_attr=False)
        self.project_bn = nn.BatchNorm2D(out_c)

    def forward(self, x):
        out = x
        if self.expand is not None:
            out = self._act(self.expand(out))
        out = self._act(self.dw_bn(self.dw(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.project_bn(self.project(out))
        return x + out if self._residual else out


# (kernel, exp, out, SE, act, stride) rows from the paper / reference config
_MOBILENETV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]

_MOBILENETV3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        in_c = _make_divisible(16 * scale)
        self.stem = nn.Sequential(
            nn.Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(in_c), nn.Hardswish())
        blocks = []
        for k, exp, out, se, act, s in config:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(InvertedResidual(in_c, exp_c, out_c, k, s, se, act))
            in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        last_exp = _make_divisible(config[-1][1] * scale)
        self.head_conv = nn.Sequential(
            nn.Conv2D(in_c, last_exp, 1, bias_attr=False),
            nn.BatchNorm2D(last_exp), nn.Hardswish())
        self.with_pool = with_pool
        self.num_classes = num_classes
        self.feat_channels = last_exp
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_exp, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.head_conv(self.blocks(self.stem(x)))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(MobileNetV3(_MOBILENETV3_SMALL, last_channel=1024, scale=scale, **kwargs), pretrained)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    from .models_zoo import _maybe_load_pretrained

    return _maybe_load_pretrained(MobileNetV3(_MOBILENETV3_LARGE, last_channel=1280, scale=scale, **kwargs), pretrained)


from .models_zoo import *  # noqa: E402,F401,F403
from .models_zoo import __all__ as _zoo_all  # noqa: E402

__all__ = __all__ + _zoo_all
