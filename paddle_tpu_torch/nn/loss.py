"""Loss layers (port of the part of ``paddle_tpu/nn/loss.py`` the recipes
use), each a holder of its options over :mod:`.functional`."""

from __future__ import annotations

from . import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "BCELoss", "MSELoss", "CTCLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = weight, ignore_index, reduction
        self.soft_label, self.axis, self.use_softmax = soft_label, axis, use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, ignore_index=self.ignore_index,
                               reduction=self.reduction, soft_label=self.soft_label,
                               axis=self.axis, use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)
