"""Metrics (counterpart of ``paddle_tpu/metric``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and ``accuracy``,
computed on the host in numpy as there (the same arithmetic, so the same
values from the same inputs); torch tensors are read to the host."""
from __future__ import annotations

import abc

import numpy as np

import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base class: reset/update/accumulate/name contract
    (reference `python/paddle/metric/metrics.py:79`)."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        """Optional pre-processing on device tensors; default passthrough."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference `metrics.py:184`)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _to_np(pred)
        label = _to_np(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        # (N,1) integer labels are class ids, not one-hot — only argmax
        # genuine one-hot/soft labels (reference metrics.py compute)
        if label.ndim == pred.ndim and label.shape[-1] != 1:
            label = np.argmax(label, axis=-1)
        elif label.ndim == pred.ndim:
            label = label[..., 0]
        label = label.reshape(label.shape + (1,) * (idx.ndim - label.ndim))
        return (idx == label).astype(np.float32)

    def update(self, correct, *args):
        correct = _to_np(correct)
        num_samples = correct.shape[0] if correct.ndim else 1
        accs = []
        for k in self.topk:
            num_corrects = correct[..., :k].sum()
            self.total[self.topk.index(k)] += num_corrects
            self.count[self.topk.index(k)] += num_samples
            accs.append(float(num_corrects) / max(num_samples, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (reference `metrics.py:332`)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).flatten()
        labels = _to_np(labels).flatten()
        pred_pos = np.rint(preds).astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels != 1)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (reference `metrics.py:421`)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).flatten()
        labels = _to_np(labels).flatten()
        pred_pos = np.rint(preds).astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC-AUC via histogram buckets (reference `metrics.py:510`)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).flatten()
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.flatten()
        bins = np.clip(
            (pos_prob * self.num_thresholds).astype(np.int64),
            0,
            self.num_thresholds,
        )
        for b, l in zip(bins, labels):
            if l == 1:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):  # noqa: A002
    """Functional top-k accuracy (``paddle.metric.accuracy``): the share
    of rows whose label is among the ``k`` largest scores, as a 0-dim
    fp32 tensor on input's device."""
    idx = torch.argsort(-input, dim=-1)[..., :k]
    lab = label.reshape(label.shape[0], 1)
    return (idx == lab).any(dim=-1).to(torch.float32).mean()
