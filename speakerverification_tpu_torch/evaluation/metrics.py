"""Verification metrics: ROC/EER, minDCF, G-mean, precision/recall F-score.

The port's own copy of ``speakerverification_tpu/evaluation/metrics.py``
(numpy only; the training-only top-k ``accuracy`` comes with the training
slice). The ROC and PR curves replicate sklearn's algorithm
(descending-score thresholds, drop-intermediate collinear points), with
behavioral parity to the reference's ``tuneThresholdfromScore``,
``ComputeErrorRates`` and ``ComputeMinDcf``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "roc_curve",
    "precision_recall_curve",
    "tune_threshold_from_score",
    "compute_error_rates",
    "compute_min_dcf",
    "auc",
]


def _binary_clf_curve(labels: np.ndarray, scores: np.ndarray):
    """Cumulative TP/FP counts at each distinct score threshold (descending)."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    desc = np.argsort(scores, kind="mergesort")[::-1]
    scores = scores[desc]
    labels = labels[desc]

    distinct_idx = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct_idx, labels.size - 1]

    tps = np.cumsum(labels)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, scores[threshold_idxs]


def roc_curve(labels, scores, drop_intermediate: bool = True):
    """sklearn-compatible ROC curve: returns (fpr, tpr, thresholds)."""
    fps, tps, thresholds = _binary_clf_curve(labels, scores)

    if drop_intermediate and fps.size > 2:
        optimal_idxs = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thresholds = fps[optimal_idxs], tps[optimal_idxs], thresholds[optimal_idxs]

    # Prepend the (0, 0) point with an out-of-range threshold, like sklearn.
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]

    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan, dtype=float)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan, dtype=float)
    return fpr, tpr, thresholds


def precision_recall_curve(labels, scores):
    """sklearn-compatible PR curve: returns (precision, recall, thresholds)."""
    fps, tps, thresholds = _binary_clf_curve(labels, scores)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps, dtype=float), where=ps != 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps, dtype=float)
    else:
        recall = tps / tps[-1]
    # Reverse and stop at full recall, append the (1, 0) endpoint.
    sl = slice(None, None, -1)
    return (np.r_[precision[sl], 1], np.r_[recall[sl], 0], thresholds[sl])


def auc(x, y) -> float:
    """Trapezoidal area under a curve (sklearn.metrics.auc semantics)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    trapezoid = getattr(np, "trapezoid", np.trapz)
    return float(direction * trapezoid(y, x))


def tune_threshold_from_score(scores, labels, target_fa: Sequence[float],
                              target_fr: Sequence[float] | None = None) -> dict:
    """Threshold tuning + EER/AUC/G-mean/F-score.

    Behavioral parity with ``tuneThresholdfromScore`` (src/utils.py:74-121):

    * ``results['gmean']  = [idx, gmean, threshold]``
    * ``results['roc']    = [tuned_thresholds, eer_percent, auc, opt_threshold]``
      where each tuned threshold row is ``[threshold, fpr%, fnr%]`` and EER
      is ``(fpr% + fnr%) / 2`` at the argmin of ``|fnr - fpr|``.
    * ``results['prec_recall'] = [precision, recall, best_f, best_f_threshold]``

    Note the reference computes ``auc`` on percentage-scaled fpr/tpr
    (``fpr*100`` vs ``tpr``); we keep AUC on the standard [0, 1] curve and
    additionally return it scaled identically under ``results['roc'][2]``
    computed from the 0-100 fpr axis against 0-1 tpr — matching the exact
    call ``metrics.auc(fpr, tpr)`` after ``fpr = fpr*100`` in the reference.
    """
    labels = np.nan_to_num(np.asarray(labels, dtype=np.float64))
    scores = np.nan_to_num(np.asarray(scores, dtype=np.float64))

    fpr, tpr, thresholds = roc_curve(labels, scores)

    gmean = np.sqrt(tpr * (1 - fpr))
    idx_g = int(np.argmax(gmean))
    gmean_result = [idx_g, float(gmean[idx_g]), float(thresholds[idx_g])]

    fnr = (1 - tpr) * 100.0
    fpr_pct = fpr * 100.0

    tuned = []
    if target_fr:
        for tfr in target_fr:
            idx = int(np.nanargmin(np.absolute(tfr - fnr)))
            tuned.append([float(thresholds[idx]), float(fpr_pct[idx]), float(fnr[idx])])
    for tfa in target_fa:
        idx = int(np.nanargmin(np.absolute(tfa - fpr_pct)))
        tuned.append([float(thresholds[idx]), float(fpr_pct[idx]), float(fnr[idx])])

    idx_e = int(np.nanargmin(np.absolute(fnr - fpr_pct)))
    eer = float(np.mean([fpr_pct[idx_e], fnr[idx_e]]))
    optimal_threshold = float(thresholds[idx_e])

    # Reference calls metrics.auc(fpr*100, tpr) — reproduce exactly.
    auc_value = auc(fpr_pct, tpr)

    precision, recall, pr_thresholds = precision_recall_curve(labels, scores)
    with np.errstate(invalid="ignore", divide="ignore"):
        fscore = (2 * precision * recall) / (precision + recall)
    ix_pr = int(np.nanargmax(np.nan_to_num(fscore, nan=-1.0)))

    return {
        "gmean": gmean_result,
        "roc": [tuned, eer, auc_value, optimal_threshold],
        "prec_recall": [precision, recall, float(fscore[ix_pr]),
                        float(pr_thresholds[min(ix_pr, len(pr_thresholds) - 1)])],
    }


def compute_error_rates(scores, labels):
    """FNR/FPR lists at each sorted-score threshold.

    Vectorized parity with ``ComputeErrorRates`` (src/utils.py:221-256):
    scores sorted ascending act as thresholds; ``fnrs[i]`` counts positives
    at-or-below threshold i (misses), ``fprs[i]`` the share of negatives
    above it (false accepts).
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    order = np.argsort(scores, kind="stable")
    thresholds = scores[order]
    sorted_labels = labels[order]

    fnrs = np.cumsum(sorted_labels)
    fprs = np.cumsum(1.0 - sorted_labels)

    n_pos = fnrs[-1] if len(fnrs) else 0.0
    n_neg = fprs[-1] if len(fprs) else 0.0
    fnrs = fnrs / float(n_pos) if n_pos > 0 else fnrs
    fprs = 1.0 - (fprs / float(n_neg) if n_neg > 0 else fprs)
    return fnrs.tolist(), fprs.tolist(), thresholds.tolist()


def compute_min_dcf(fnrs, fprs, thresholds, p_target: float = 0.05,
                    c_miss: float = 1.0, c_fa: float = 1.0):
    """NIST SRE minimum detection cost (parity: src/utils.py:262-275)."""
    fnrs = np.asarray(fnrs, dtype=np.float64)
    fprs = np.asarray(fprs, dtype=np.float64)
    c_det = c_miss * fnrs * p_target + c_fa * fprs * (1 - p_target)
    i = int(np.argmin(c_det))
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    return float(c_det[i] / c_def), float(thresholds[i])
