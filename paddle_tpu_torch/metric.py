"""Metrics (port of ``paddle_tpu/metric.py``): ``Metric``, ``Accuracy``,
``Precision``, ``Recall`` and ``Auc``, with the 2.0 protocol:
``compute`` (optional per-batch prep), ``update`` (numpy accumulation on
the host), ``accumulate``, ``reset``, ``name``. Used alone or through
hapi ``Model.prepare(metrics=...)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _np(x) -> np.ndarray:
    """A VarBase, tensor (on any device) or array-like on the host."""
    import torch

    if isinstance(x, torch.Tensor):
        from .core.executor import _to_numpy

        return _to_numpy(x)
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name: Optional[str] = None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self) -> Union[str, List[str]]:
        return self._name

    def compute(self, pred, label, *args):
        """Per-batch hook run in the graph/dygraph context; default
        passthrough. Subclasses may return derived tensors that `update`
        then consumes as numpy."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy (reference: metric/metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = tuple(topk) if isinstance(topk, (list, tuple)) else (topk,)
        super().__init__(name or "acc")
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        return pred, label

    def update(self, pred, label, *args):
        pred, label = _np(pred), _np(label)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        maxk = max(self.topk)
        top = np.argsort(-pred, axis=-1)[..., :maxk]
        correct = top == label[..., None]
        n = label.size
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(-1).sum()
            self.count[i] += n
        return self.accumulate()

    def accumulate(self):
        acc = [t / max(c, 1.0) for t, c in zip(self.total, self.count)]
        return acc[0] if len(acc) == 1 else acc

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: TP / (TP + FP); pred is P(y=1) (reference:
    metric/metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, pred, label, *args):
        pred, label = _np(pred).reshape(-1), _np(label).reshape(-1)
        hard = (pred > 0.5).astype(np.int64)
        self.tp += int(((hard == 1) & (label == 1)).sum())
        self.fp += int(((hard == 1) & (label == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    """Binary recall: TP / (TP + FN)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, pred, label, *args):
        pred, label = _np(pred).reshape(-1), _np(label).reshape(-1)
        hard = (pred > 0.5).astype(np.int64)
        self.tp += int(((hard == 1) & (label == 1)).sum())
        self.fn += int(((hard == 0) & (label == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    """ROC AUC via threshold bucketing (reference: metric/metrics.py Auc /
    operators/metrics/auc_op — same bucketed estimator)."""

    def __init__(self, curve: str = "ROC", num_thresholds: int = 4095,
                 name=None):
        self.num_thresholds = num_thresholds
        super().__init__(name)
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels, *args):
        preds, labels = _np(preds), _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        idx = np.clip((pos_prob * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        pos = labels != 0
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            # trapezoid over the (fp, tp) staircase
            auc += n * (tot_pos + tot_pos + p) / 2.0
            tot_pos += p
            tot_neg += n
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)
