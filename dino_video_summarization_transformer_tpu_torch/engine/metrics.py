"""Accuracy metrics (ref: utils/metrics.py:8-94, utils/utils.py:472-479),
copied from the JAX package's ``engine/metrics.py``. ``get_map``'s average
precision is written here in numpy (the JAX package calls
``sklearn.metrics.average_precision_score``, which the card's machine does
not have): the same step-function integral over the same curve."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def topks_correct(preds: np.ndarray, labels: np.ndarray, ks: Sequence[int]) -> List[float]:
    """Number of top-k correct predictions per k (ref: utils/metrics.py:8-34)."""
    assert preds.shape[0] == labels.shape[0]
    max_k = max(ks)
    order = np.argsort(-preds, axis=1)[:, :max_k]  # (N, max_k)
    correct = order == labels[:, None]
    return [float(correct[:, :k].sum()) for k in ks]


def topk_errors(preds, labels, ks):
    """(ref: utils/metrics.py:37-47)."""
    num_correct = topks_correct(preds, labels, ks)
    return [(1.0 - x / preds.shape[0]) * 100.0 for x in num_correct]


def topk_accuracies(preds, labels, ks):
    """(ref: utils/metrics.py:50-60)."""
    num_correct = topks_correct(preds, labels, ks)
    return [(x / preds.shape[0]) * 100.0 for x in num_correct]


def accuracy(output: np.ndarray, target: np.ndarray, topk=(1,)):
    """(ref: utils/utils.py:472-479) — percentage top-k accuracy."""
    return topk_accuracies(output, target, topk)


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Uninterpolated average precision of one binary column, as
    ``sklearn.metrics.average_precision_score`` computes it: scores sorted
    descending (stable), one precision-recall point per distinct score,
    then sum over the points of (R_n - R_{n-1}) * P_n. A column with no
    positive has recall 1 everywhere, so its AP is 0 (sklearn warns)."""
    y_true = np.asarray(y_true)
    if not np.all((y_true == 0) | (y_true == 1)):
        raise ValueError("average precision needs binary (0/1) labels")
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order].astype(np.float64)
    distinct = np.where(np.diff(y_score))[0]
    thresholds = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[thresholds]
    fps = 1 + thresholds - tps
    precision = tps / (tps + fps)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.hstack((precision[::-1], 1.0))
    recall = np.hstack((recall[::-1], 0.0))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def get_map(preds: np.ndarray, labels: np.ndarray) -> float:
    """Multi-label mAP (ref: utils/meters.py:195-216): the mean of each
    class's average precision over the classes with a positive."""
    preds = preds[:, ~(np.all(labels == 0, axis=0))]
    labels = labels[:, ~(np.all(labels == 0, axis=0))]
    aps = [0.0]
    try:
        aps = [average_precision(labels[:, c], preds[:, c])
               for c in range(labels.shape[1])]
    except ValueError:
        print("Average precision requires a sufficient number of samples")
    return float(np.mean(aps))
