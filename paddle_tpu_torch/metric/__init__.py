"""``paddle_tpu_torch.metric`` (port of ``paddle_tpu/metric/__init__.py``).

``Accuracy.compute`` and :func:`accuracy` take the top k on the scores'
device (``torch.topk``, as Paddle does), where the JAX package pulls the
scores to the host and argsorts them with numpy: only the ``[batch, k]``
hit matrix crosses to the host.  Where scores tie, the two may rank the
tied classes in other orders; on tie-free scores they agree exactly.
``Precision``, ``Recall`` and ``Auc`` count on the host in numpy, as the
JAX package, so their counts and areas are its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _torch(x, device=None) -> torch.Tensor:
    """A Tensor, torch tensor or array as a torch tensor (on ``device``)."""
    if isinstance(x, Tensor):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x if device is None else x.to(device)


def _np(x) -> np.ndarray:
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _topk_hits(pred, label, k) -> torch.Tensor:
    """``[rows, k]`` float32: whether the j-th highest score is the label
    (a one-hot label is taken by its argmax)."""
    p = _torch(pred)
    lab = _torch(label, p.device)
    if lab.dim() == p.dim() and lab.shape[-1] > 1:
        lab = lab.argmax(-1)
    idx = torch.topk(p.reshape(-1, p.shape[-1]), k, dim=-1).indices
    return (idx == lab.reshape(-1, 1).to(idx.dtype)).to(torch.float32)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        return Tensor._wrap(_topk_hits(pred, label, self.maxk))

    def update(self, correct, *args):
        c = _np(correct)
        res = []
        for i, k in enumerate(self.topk):
            num = c[:, :k].sum()
            self.total[i] += num
            self.count[i] += c.shape[0]
            res.append(num / c.shape[0])
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        lab = _np(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(np.int32)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        lab = _np(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(np.int32)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` + 1 score bins."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, -1]
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0, self.num_thresholds)
        pos = lab.astype(bool)
        n = self.num_thresholds + 1
        self._stat_pos += np.bincount(bins[pos], minlength=n)
        self._stat_neg += np.bincount(bins[~pos], minlength=n)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            area += self._stat_pos[i] * (neg + self._stat_neg[i] / 2.0)
            pos += self._stat_pos[i]
            neg += self._stat_neg[i]
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Share of rows whose label is among the top ``k`` scores, a float32
    0-d Tensor."""
    hits = _topk_hits(input, label, k).amax(dim=1)
    return Tensor(np.float32(_np(hits).astype(bool).mean()))
