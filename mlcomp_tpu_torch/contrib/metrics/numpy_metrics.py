"""Host-side evaluation metrics — a copy of
``mlcomp_tpu/contrib/metrics/numpy_metrics.py`` (the port imports nothing
of the JAX package). Pure numpy: they run on predictions already on the
host (``Valid`` executors, report builders).
"""

import numpy as np


def dice_numpy(y_true: np.ndarray, y_pred: np.ndarray,
               empty_score: float = 1.0) -> float:
    """Binary dice over boolean/0-1 masks (reference
    contrib/metrics/dice.py:4-24 returns ``empty_score`` when both masks
    are empty)."""
    t = np.asarray(y_true, bool).reshape(-1)
    p = np.asarray(y_pred, bool).reshape(-1)
    denom = t.sum() + p.sum()
    if denom == 0:
        return float(empty_score)
    return float(2.0 * np.logical_and(t, p).sum() / denom)


def iou_numpy(y_true: np.ndarray, y_pred: np.ndarray,
              empty_score: float = 1.0) -> float:
    t = np.asarray(y_true, bool).reshape(-1)
    p = np.asarray(y_pred, bool).reshape(-1)
    union = np.logical_or(t, p).sum()
    if union == 0:
        return float(empty_score)
    return float(np.logical_and(t, p).sum() / union)


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int = None) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64).reshape(-1)
    y_pred = np.asarray(y_pred, np.int64).reshape(-1)
    n = num_classes or int(max(y_true.max(initial=0),
                               y_pred.max(initial=0))) + 1
    out = np.zeros((n, n), np.int64)
    np.add.at(out, (y_true, y_pred), 1)
    return out


def per_class_prf(y_true: np.ndarray, y_pred: np.ndarray,
                 num_classes: int = None):
    """(precision, recall, f1) arrays, one entry per class."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    precision = tp / np.maximum(cm.sum(0), 1)
    recall = tp / np.maximum(cm.sum(1), 1)
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    return precision, recall, f1


def f1_macro(y_true: np.ndarray, y_pred: np.ndarray,
             num_classes: int = None) -> float:
    return float(per_class_prf(y_true, y_pred, num_classes)[2].mean())


__all__ = ['dice_numpy', 'iou_numpy', 'accuracy', 'f1_macro',
           'per_class_prf', 'confusion_matrix']
