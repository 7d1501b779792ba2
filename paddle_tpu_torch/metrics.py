"""Host-side streaming metrics (the JAX package's metrics.py, a copy: it is
numpy only): MetricBase, CompositeMetric, Precision, Recall, Accuracy, Auc,
EditDistance, after the reference's python/paddle/fluid/metrics.py.

They accumulate numpy values fetched from executor runs; the in-program
metric ops are in ops/ (the accuracy op, layers.accuracy) and evaluator.py.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
           "Auc", "EditDistance"]


def _to_np(x):
    return np.asarray(x)


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}


class CompositeMetric(MetricBase):
    """Evaluate several metrics over the same feed (metrics.py:214)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics: list[MetricBase] = []

    def add_metric(self, metric: MetricBase):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision over thresholded predictions (metrics.py:262)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_to_np(preds)).astype(np.int64).reshape(-1)
        labels = _to_np(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels != 1)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_to_np(preds)).astype(np.int64).reshape(-1)
        labels = _to_np(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds != 1) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Accuracy(MetricBase):
    """Weighted running mean of per-batch accuracy values (metrics.py:354)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        if weight < 0:
            raise ValueError("weight must be nonnegative")
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated — call update() first")
        return self.value / self.weight


class Auc(MetricBase):
    """Streaming ROC-AUC via threshold buckets (metrics.py:407)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n, np.int64)
        self._stat_neg = np.zeros(n, np.int64)

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        # preds: [N, 2] class probs (reference contract) or [N] positive prob
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_prob * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels != 1], 1)

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc) / denom if denom else 0.0


class EditDistance(MetricBase):
    """Mean edit distance + instance error rate (metrics.py:310)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _to_np(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data accumulated — call update() first")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)
