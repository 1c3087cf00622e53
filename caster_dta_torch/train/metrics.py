"""Evaluation metrics: MSE/RMSE/MAE/Pearson + Concordance Index.

A numpy copy of caster_dta_tpu/train/metrics.py (the reference's
train_model.py:752-802). The reference's CI is an
O(n²) Python double loop (:773-790); this is an O(n log n) Fenwick-tree
implementation with identical tie semantics: pairs with equal y_true are
excluded; equal y_pred counts 0.5.
"""
from __future__ import annotations

import numpy as np


def mse(pred, target):
    return float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))


def rmse(pred, target):
    return float(np.sqrt(mse(pred, target)))


def mae(pred, target):
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(target))))


def pearson(pred, target):
    p, t = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    return float(np.corrcoef(p, t)[0, 1])


class _Fenwick:
    def __init__(self, n):
        self.t = np.zeros(n + 1, np.int64)

    def add(self, i, v=1):
        i += 1
        while i < len(self.t):
            self.t[i] += v
            i += i & (-i)

    def query(self, i):  # sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += self.t[i]
            i -= i & (-i)
        return int(s)


def concordance_index(y_true, y_pred) -> float:
    """CI = (concordant + 0.5 * pred-ties) / pairs-with-distinct-y_true,
    matching reference train_model.py:773-790 exactly on all tie cases."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    n = len(y_true)
    if n < 2:
        return 0.0
    order = np.lexsort((y_pred, y_true))
    yt, yp = y_true[order], y_pred[order]
    # compress predictions to ranks
    ranks = np.searchsorted(np.unique(yp), yp)
    n_ranks = int(ranks.max()) + 1

    bit = _Fenwick(n_ranks)
    concordant = 0
    half = 0
    pairs = 0
    processed = 0
    i = 0
    while i < n:
        j = i
        while j < n and yt[j] == yt[i]:
            j += 1
        group = ranks[i:j]
        for r in group:
            below = bit.query(r - 1) if r > 0 else 0
            at = bit.query(r) - below
            concordant += below
            half += at
            pairs += processed
        for r in group:
            bit.add(r)
        processed += j - i
        i = j
    if pairs == 0:
        return 0.0
    return (concordant + 0.5 * half) / pairs


def regression_report(pred, target) -> dict:
    """The reference's full test metric set (train_model.py:752-802)."""
    return {
        "mse": mse(pred, target),
        "rmse": rmse(pred, target),
        "mae": mae(pred, target),
        "pearson": pearson(pred, target),
        "concordance_index": concordance_index(target, pred),
    }
