"""The classification and ranking metrics the eval harness reports, in
numpy, with scikit-learn's definitions and edge cases (the port does not
depend on scikit-learn). Correlations (spearmanr, pearsonr) come from scipy.

  accuracy_score           share of equal labels
  matthews_corrcoef        multiclass MCC; 0 where a denominator is 0
  f1_score                 per-class F1 averaged ('weighted' by true
                           support, 'macro', or 'binary' for label 1); a
                           class never predicted scores 0
  precision_score          binary precision of label 1, zero_division
  roc_curve / auc /        binary ROC with the collinear intermediate
  roc_auc_score            points dropped, the trapezoid area; one class
                           present gives nan with a warning
  precision_recall_curve   binary, thresholds at each distinct score
"""
from __future__ import annotations

import warnings

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A metric is ill-defined on its input and got a stand-in value."""


def _labels(y_true, y_pred):
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    if y_true.shape != y_pred.shape:
        raise ValueError(f"inconsistent lengths {y_true.shape[0]} and {y_pred.shape[0]}")
    return y_true, y_pred


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = _labels(y_true, y_pred)
    return float(np.mean(y_true == y_pred))


def _confusion(y_true, y_pred):
    """(confusion matrix over the sorted union of labels, those labels)."""
    classes, inv = np.unique(np.concatenate([y_true, y_pred]), return_inverse=True)
    t, p = inv[:len(y_true)], inv[len(y_true):]
    C = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(C, (t, p), 1)
    return C, classes


def matthews_corrcoef(y_true, y_pred) -> float:
    y_true, y_pred = _labels(y_true, y_pred)
    C, _ = _confusion(y_true, y_pred)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    denom = cov_ypyp * cov_ytyt
    if denom == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(denom))


def _divide(num, den, zero_division):
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = num / np.where(den == 0, 1.0, den)
    out[den == 0] = 0.0 if zero_division == "warn" else float(zero_division)
    return out


def _binary_labels(y):
    y = np.asarray(y).ravel()
    if not set(np.unique(y).tolist()) <= {0, 1, -1}:
        raise ValueError(f"labels {np.unique(y)} are not binary (0/1 or -1/1)")
    return y == 1


def f1_score(y_true, y_pred, *, average: str = "binary",
             zero_division="warn") -> float:
    y_true, y_pred = _labels(y_true, y_pred)
    if average == "binary":
        t, p = _binary_labels(y_true), _binary_labels(y_pred)
        tp = np.sum(t & p)
        return float(_divide([2.0 * tp], [t.sum() + p.sum()], zero_division)[0])
    if average not in ("weighted", "macro"):
        raise ValueError(f"average must be 'binary', 'weighted' or 'macro', got {average!r}")
    C, _ = _confusion(y_true, y_pred)
    tp = np.diag(C).astype(np.float64)
    true_sum, pred_sum = C.sum(axis=1), C.sum(axis=0)
    f = _divide(2.0 * tp, true_sum + pred_sum, zero_division)
    if average == "macro" or true_sum.sum() == 0:
        return float(np.mean(f))
    return float(np.average(f, weights=true_sum))


def precision_score(y_true, y_pred, *, zero_division="warn") -> float:
    """Precision of label 1 in binary labels (scikit-learn's default
    average='binary')."""
    y_true, y_pred = _labels(y_true, y_pred)
    t, p = _binary_labels(y_true), _binary_labels(y_pred)
    return float(_divide([np.sum(t & p)], [p.sum()], zero_division)[0])


def _thresholds(y_true, y_score):
    """(false positives, true positives, score) at each distinct score,
    scores descending (scikit-learn's confusion_matrix_at_thresholds)."""
    pos = _binary_labels(y_true)
    y_score = np.asarray(y_score, np.float64).ravel()
    if pos.shape != y_score.shape:
        raise ValueError(f"inconsistent lengths {pos.shape[0]} and {y_score.shape[0]}")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("y_score holds a non-finite value")
    order = np.argsort(-y_score, kind="stable")
    y_score, pos = y_score[order], pos[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [pos.size - 1]])
    tps = np.cumsum(pos)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, *, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) of a binary problem, label 1 positive."""
    fps, tps, thr = _thresholds(y_true, y_score)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thr = np.concatenate([[np.inf], thr])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless", UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless", UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thr


def auc(x, y) -> float:
    """Trapezoid area under y(x), x monotonic (either direction)."""
    x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    if x.shape[0] < 2:
        raise ValueError(f"at least 2 points are needed to compute the area "
                         f"under a curve, got {x.shape[0]}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    # numpy's trapezoid rule, written out: np.trapezoid is numpy >= 2.0 only
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of a binary problem; nan with a warning
    when y_true holds one class."""
    y = np.asarray(y_true).ravel()
    classes = np.unique(y)
    if len(classes) > 2:
        raise ValueError("roc_auc_score here takes binary labels only")
    if len(classes) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is "
                      "not defined in that case.", UndefinedMetricWarning)
        return float("nan")
    fpr, tpr, _ = roc_curve(y == classes[1], y_score)
    return auc(fpr, tpr)


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) of a binary problem, label 1
    positive, thresholds ascending; the last point is (1, 0)."""
    fps, tps, thr = _thresholds(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.", UndefinedMetricWarning)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thr[::-1])
