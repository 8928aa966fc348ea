"""Loss layers (port of ``paddle_tpu/nn/loss.py``), each a holder of its
options over :mod:`.functional`."""

from __future__ import annotations

from . import functional as F
from .layers import Layer, option_layer

__all__ = [
    "CrossEntropyLoss", "BCELoss", "BCEWithLogitsLoss", "MSELoss", "L1Loss",
    "SmoothL1Loss", "NLLLoss", "KLDivLoss", "MarginRankingLoss", "CTCLoss",
    "CosineEmbeddingLoss", "TripletMarginLoss", "HingeEmbeddingLoss",
    "PoissonNLLLoss", "GaussianNLLLoss", "MultiLabelSoftMarginLoss", "SoftMarginLoss",
]


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


BCEWithLogitsLoss = option_layer("BCEWithLogitsLoss", F.binary_cross_entropy_with_logits,
                                ("weight", None), ("reduction", "mean"), ("pos_weight", None))
L1Loss = option_layer("L1Loss", F.l1_loss, ("reduction", "mean"))
SmoothL1Loss = option_layer("SmoothL1Loss", F.smooth_l1_loss, ("reduction", "mean"),
                           ("delta", 1.0))
NLLLoss = option_layer("NLLLoss", F.nll_loss, ("weight", None), ("ignore_index", -100),
                      ("reduction", "mean"))
KLDivLoss = option_layer("KLDivLoss", F.kl_div, ("reduction", "mean"), ("log_target", False))
MarginRankingLoss = option_layer("MarginRankingLoss", F.margin_ranking_loss, ("margin", 0.0),
                                ("reduction", "mean"))
CosineEmbeddingLoss = option_layer("CosineEmbeddingLoss", F.cosine_embedding_loss,
                                  ("margin", 0.0), ("reduction", "mean"))
TripletMarginLoss = option_layer("TripletMarginLoss", F.triplet_margin_loss, ("margin", 1.0),
                                ("p", 2.0), ("epsilon", 1e-06), ("swap", False),
                                ("reduction", "mean"))
HingeEmbeddingLoss = option_layer("HingeEmbeddingLoss", F.hinge_embedding_loss, ("margin", 1.0),
                                 ("reduction", "mean"))
PoissonNLLLoss = option_layer("PoissonNLLLoss", F.poisson_nll_loss, ("log_input", True),
                             ("full", False), ("epsilon", 1e-8), ("reduction", "mean"))
GaussianNLLLoss = option_layer("GaussianNLLLoss", F.gaussian_nll_loss, ("full", False),
                              ("epsilon", 1e-6), ("reduction", "mean"))
MultiLabelSoftMarginLoss = option_layer("MultiLabelSoftMarginLoss",
                                       F.multi_label_soft_margin_loss, ("weight", None),
                                       ("reduction", "mean"))
SoftMarginLoss = option_layer("SoftMarginLoss", F.soft_margin_loss, ("reduction", "mean"))
