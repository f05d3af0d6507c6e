"""Exact frame-level ROC AUC without an sklearn dependency.

Rank-based (Mann-Whitney U) implementation with average ranks for ties —
bitwise-identical to sklearn.metrics.roc_auc_score on binary labels, which is
what the reference uses everywhere (reference eval_COSKAD.py:223,252,
models/euclidean_encoder_staticCenter.py:307).
"""

from __future__ import annotations

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties assigned the average rank (scipy 'average'),
    fully vectorized (a Python loop over tie groups dominated large AUCs)."""
    n = len(x)
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    starts = np.concatenate(([0], np.nonzero(np.diff(sx))[0] + 1))
    sizes = np.diff(np.append(starts, n))
    # average of ranks (start+1) .. (start+size), 1-based
    group_rank = starts + (sizes + 1) / 2.0
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = np.repeat(group_rank, sizes)
    return ranks


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUC-ROC of binary `y_true` under continuous `y_score`."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = int(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score requires both classes present")
    ranks = _average_ranks(y_score)
    u = ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """ROC curve (fpr, tpr, thresholds); mirrors sklearn's drop-none variant.

    Returned thresholds are the distinct scores in decreasing order; the
    first element is +inf like sklearn >= 1.3 (the reference's best-threshold
    pick only relies on relative shape, utils/eval_utils.py:216-230).
    """
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    desc = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[desc]
    y_score = y_score[desc]
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [len(y_true) - 1]])
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    tpr = np.concatenate([[0.0], tps / tps[-1]])
    fpr = np.concatenate([[0.0], fps / fps[-1]])
    thresholds = np.concatenate([[np.inf], y_score[idx]])
    return fpr, tpr, thresholds


def best_threshold(y_true: np.ndarray, y_score: np.ndarray):
    """Threshold where TPR crosses 1 - FPR, as the reference's ROC() picks
    (utils/eval_utils.py:219: sign change of tpr - (1 - fpr))."""
    fpr, tpr, thr = roc_curve(y_true, y_score)
    idx = np.argwhere(np.diff(np.sign(tpr - (1 - fpr)))).flatten()
    return thr[idx], roc_auc_score(y_true, y_score)
