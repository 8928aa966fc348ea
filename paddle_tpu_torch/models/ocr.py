"""PP-OCR-style text detection and recognition (port of
``paddle_tpu/models/ocr.py``; BASELINE configs[3]).

- :class:`DBNet`: the DB text detector -- a conv-bn-relu backbone with
  strides 4/8/16/32, a top-down FPN neck (1x1 laterals, nearest upsampling
  to each lateral's exact size, concat at stride 4) and a shrink-map head
  (conv, two 2x transposed convs, sigmoid); :func:`db_loss` is BCE + dice.
- :class:`CRNN`: the CTC recognizer -- conv stages that collapse the height
  by 16, a bidirectional GRU over the width, a per-column classifier;
  ``compute_loss`` is CTC with blank 0 over every column.

NCHW throughout; the same parameter and buffer names as the JAX models
(BatchNorm's ``_mean`` / ``_variance`` included), so ``models.convert``
carries a model's whole state across.  ``device`` defaults to CUDA (raising
without a card); weights come from one generator seeded with ``seed``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import default_device, make_generator
from .. import nn
from ..nn import functional as F

__all__ = ["DBNet", "CRNN", "db_loss", "ocr_det_tiny", "ocr_det_base", "ocr_rec_tiny",
           "ocr_rec_base"]


class ConvBNLayer(nn.Layer):
    """conv (no bias, "same" padding) + BatchNorm + optional relu."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1, act=True, *, generator):
        super().__init__(generator=generator)
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                              groups=groups, bias_attr=False, generator=generator)
        self.bn = nn.BatchNorm2D(out_ch, generator=generator)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class _Stage(nn.Layer):
    def __init__(self, in_ch, out_ch, n_blocks, stride, *, generator):
        super().__init__(generator=generator)
        blocks = [ConvBNLayer(in_ch, out_ch, stride=stride, generator=generator)]
        blocks += [ConvBNLayer(out_ch, out_ch, generator=generator) for _ in range(n_blocks - 1)]
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        return self.blocks(x)


class DBBackbone(nn.Layer):
    """A stride-2 stem and four stride-2 stages: features at strides 4-32."""

    def __init__(self, in_ch=3, base=16, blocks=(2, 2, 2, 2), *, generator):
        super().__init__(generator=generator)
        self.stem = ConvBNLayer(in_ch, base, stride=2, generator=generator)
        chs = [base, base * 2, base * 4, base * 8]
        self.stages = nn.LayerList([
            _Stage(base if i == 0 else chs[i - 1], chs[i], blocks[i], stride=2,
                   generator=generator) for i in range(4)])
        self.out_channels = chs

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


class DBFPN(nn.Layer):
    """Top-down FPN: lateral 1x1 + upsample-add, concat at stride 4."""

    def __init__(self, in_channels: Sequence[int], out_ch=64, *, generator):
        super().__init__(generator=generator)
        self.lateral = nn.LayerList([ConvBNLayer(c, out_ch, kernel=1, act=False,
                                                 generator=generator) for c in in_channels])
        self.smooth = nn.LayerList([ConvBNLayer(out_ch, out_ch // 4, generator=generator)
                                    for _ in in_channels])
        self.out_channels = out_ch

    def forward(self, feats):
        laterals = [lat(f) for lat, f in zip(self.lateral, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            # to the lateral's exact size (a 2x scale overshoots after odd sizes)
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        target = laterals[0].shape[2:]
        outs = []
        for sm, lat in zip(self.smooth, laterals):
            o = sm(lat)
            if o.shape[2:] != target:
                o = F.interpolate(o, size=target, mode="nearest")
            outs.append(o)
        return torch.cat(outs, dim=1)


class DBHead(nn.Layer):
    """Shrink-probability head: conv -> deconv x2 -> sigmoid at input resolution."""

    def __init__(self, in_ch, *, generator):
        super().__init__(generator=generator)
        self.conv1 = ConvBNLayer(in_ch, in_ch // 4, generator=generator)
        self.up1 = nn.Conv2DTranspose(in_ch // 4, in_ch // 4, 2, stride=2, generator=generator)
        self.bn1 = nn.BatchNorm2D(in_ch // 4, generator=generator)
        self.up2 = nn.Conv2DTranspose(in_ch // 4, 1, 2, stride=2, generator=generator)

    def forward(self, x):
        x = F.relu(self.bn1(self.up1(self.conv1(x))))
        return F.sigmoid(self.up2(x))


class DBNet(nn.Layer):
    """DB text detector: the shrink probability map ``[B, 1, H, W]``."""

    def __init__(self, in_ch=3, base=16, fpn_ch=64, blocks=(2, 2, 2, 2), device=None,
                 seed: int = 0):
        gen = make_generator(seed, default_device(device))
        super().__init__(generator=gen)
        self.backbone = DBBackbone(in_ch, base, blocks, generator=gen)
        self.neck = DBFPN(self.backbone.out_channels, fpn_ch, generator=gen)
        self.head = DBHead(fpn_ch, generator=gen)

    def forward(self, images):
        h, w = images.shape[2], images.shape[3]
        if h % 4 or w % 4:
            # the head's two 2x deconvs rebuild exactly 4x the stride-4 map
            raise ValueError(f"DBNet input H/W must be multiples of 4, got {h}x{w}")
        return self.head(self.neck(self.backbone(images)))


def db_loss(pred, gt, eps: float = 1e-6):
    """DB shrink-map loss in fp32: BCE + dice (the paper's loss without the
    border maps)."""
    p = pred.to(torch.float32).clamp(eps, 1.0 - eps)
    g = gt.to(torch.float32)
    bce = -(g * torch.log(p) + (1 - g) * torch.log(1 - p)).mean()
    dice = 1.0 - 2.0 * (p * g).sum() / (p.sum() + g.sum() + eps)
    return bce + dice


class CRNN(nn.Layer):
    """CTC recognizer: per-column class logits ``[B, W / 4, num_classes]``
    (blank 0)."""

    def __init__(self, num_classes, in_ch=3, base=16, hidden=48, img_h=32, device=None,
                 seed: int = 0):
        gen = make_generator(seed, default_device(device))
        super().__init__(generator=gen)
        kw = dict(generator=gen)
        self.convs = nn.Sequential(
            ConvBNLayer(in_ch, base, **kw), nn.MaxPool2D(2, 2),                  # H/2, W/2
            ConvBNLayer(base, base * 2, **kw), nn.MaxPool2D(2, 2),               # H/4, W/4
            ConvBNLayer(base * 2, base * 4, **kw),
            nn.MaxPool2D(kernel_size=(2, 1), stride=(2, 1)),                     # H/8
            ConvBNLayer(base * 4, base * 4, **kw),
            nn.MaxPool2D(kernel_size=(2, 1), stride=(2, 1)),                     # H/16
        )
        self.rnn = nn.GRU(base * 4 * (img_h // 16), hidden, direction="bidirect", **kw)
        self.fc = nn.Linear(2 * hidden, num_classes, **kw)

    def forward(self, images):
        x = self.convs(images)                            # [B, C, h, W']
        B, C, h, W = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B, W, C * h)   # [B, W', C h]
        x, _ = self.rnn(x)
        return self.fc(x)

    def compute_loss(self, logits, labels, label_lengths):
        B, T = logits.shape[0], logits.shape[1]
        input_lengths = torch.full((B,), T, dtype=torch.long, device=logits.device)
        return F.ctc_loss(logits.transpose(0, 1), labels, input_lengths, label_lengths, blank=0)


def ocr_det_tiny(**kw) -> DBNet:
    """CPU/CI scale."""
    cfg = dict(base=8, fpn_ch=16, blocks=(1, 1, 1, 1))
    cfg.update(kw)
    return DBNet(**cfg)


def ocr_det_base(**kw) -> DBNet:
    """Bench scale (``bench.py``'s ``ocr`` preset)."""
    cfg = dict(base=24, fpn_ch=96, blocks=(2, 2, 2, 2))
    cfg.update(kw)
    return DBNet(**cfg)


def ocr_rec_tiny(num_classes=64, **kw) -> CRNN:
    cfg = dict(base=8, hidden=32)
    cfg.update(kw)
    return CRNN(num_classes, **cfg)


def ocr_rec_base(num_classes=6625, **kw) -> CRNN:
    """The PP-OCRv4 rec head's width: the 6625-class Chinese charset."""
    cfg = dict(base=32, hidden=96)
    cfg.update(kw)
    return CRNN(num_classes, **cfg)
