"""Classification metrics (weighted precision/recall/F1, confusion matrix,
per-class report, balanced class weights) in NumPy: a copy of
polyp_tpu/eval/metrics.py, which is sklearn's `average='weighted'`,
`zero_division=0` in NumPy (the card's machine has no sklearn). Labels
default to the sorted unique true labels, as the reference's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _as_label_array(y) -> np.ndarray:
    return np.asarray(list(y))


def _label_order(y_true, labels: Sequence | None) -> np.ndarray:
    if labels is not None:
        return np.asarray(list(labels))
    # Reference convention: sorted unique *true* labels
    return np.unique(_as_label_array(y_true))


def confusion_matrix(y_true, y_pred, labels: Sequence | None = None) -> np.ndarray:
    """Rows = true label, cols = predicted label (sklearn convention)."""
    y_true = _as_label_array(y_true)
    y_pred = _as_label_array(y_pred)
    order = _label_order(y_true, labels)
    index = {l: i for i, l in enumerate(order.tolist())}
    n = len(order)
    cm = np.zeros((n, n), dtype=np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def accuracy_score(y_true, y_pred) -> float:
    y_true = _as_label_array(y_true)
    y_pred = _as_label_array(y_pred)
    if len(y_true) == 0:
        return 0.0
    return float(np.mean(y_true == y_pred))


def _per_class_prf(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)  # zero_division=0
        recall = np.where(true_pos > 0, tp / true_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, true_pos


def precision_recall_f1(y_true, y_pred, average: str = "weighted",
                        labels: Sequence | None = None):
    """Returns (precision, recall, f1) under 'weighted' | 'macro' | None.

    'weighted' weights per-class scores by true-label support — the
    reference's scoring metric (classifier.py:253-256)."""
    cm = confusion_matrix(y_true, y_pred, labels)
    precision, recall, f1, support = _per_class_prf(cm)
    if average is None:
        return precision, recall, f1
    if average == "macro":
        return float(precision.mean()), float(recall.mean()), float(f1.mean())
    if average == "weighted":
        total = support.sum()
        if total == 0:
            return 0.0, 0.0, 0.0
        w = support / total
        return float(precision @ w), float(recall @ w), float(f1 @ w)
    raise ValueError(f"unknown average: {average}")


def classification_report(y_true, y_pred, labels: Sequence | None = None) -> dict:
    """Dict-shaped report mirroring sklearn's output_dict=True layout
    (consumed as a CSV artifact at classifier.py:262-266)."""
    order = _label_order(_as_label_array(y_true), labels)
    cm = confusion_matrix(y_true, y_pred, order)
    precision, recall, f1, support = _per_class_prf(cm)
    report: dict = {}
    for i, lab in enumerate(order.tolist()):
        report[str(lab)] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": float(support[i]),
        }
    acc = accuracy_score(y_true, y_pred)
    p_m, r_m, f_m = precision_recall_f1(y_true, y_pred, "macro", order)
    p_w, r_w, f_w = precision_recall_f1(y_true, y_pred, "weighted", order)
    n = float(len(_as_label_array(y_true)))
    report["accuracy"] = acc
    report["macro avg"] = {"precision": p_m, "recall": r_m, "f1-score": f_m, "support": n}
    report["weighted avg"] = {"precision": p_w, "recall": r_w, "f1-score": f_w, "support": n}
    return report


def balanced_class_weights(labels) -> dict:
    """sklearn `compute_class_weight('balanced')` parity:
    weight_c = n_samples / (n_classes * count_c) (classifier.py:108-117)."""
    labels = _as_label_array(labels)
    classes, counts = np.unique(labels, return_counts=True)
    n = len(labels)
    weights = n / (len(classes) * counts.astype(np.float64))
    return dict(zip(classes.tolist(), weights.tolist()))
