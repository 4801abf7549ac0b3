"""Classification metric battery for the MES classifier and judge, in numpy.

The port's copy of `psd_tpu/metrics/classification.py` (numpy, no JAX):
accuracy (macro, micro, per class), precision / recall / F1 (macro,
weighted, per class), specificity, Cohen's kappa with quadratic (QWK) and
linear weights, one-vs-rest AUROC by the rank statistic, the expected
calibration error, the confusion matrix; the regressor's RMSE, MAE, rounded
accuracy and QWK.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    for t, p in zip(np.asarray(y_true, int), np.asarray(y_pred, int)):
        cm[t, p] += 1
    return cm


def accuracy_metrics(cm: np.ndarray) -> Dict[str, float]:
    total = cm.sum()
    per_class = np.divide(
        np.diag(cm), cm.sum(1), out=np.zeros(len(cm)), where=cm.sum(1) > 0
    )
    return {
        "acc_micro": float(np.trace(cm) / max(total, 1)),
        "acc_macro": float(per_class.mean()),
        **{f"acc_class_{i}": float(v) for i, v in enumerate(per_class)},
    }


def precision_recall_f1(cm: np.ndarray) -> Dict[str, float]:
    K = len(cm)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = cm.sum() - tp - fp - fn
    prec = np.divide(tp, tp + fp, out=np.zeros(K), where=(tp + fp) > 0)
    rec = np.divide(tp, tp + fn, out=np.zeros(K), where=(tp + fn) > 0)
    f1 = np.divide(2 * prec * rec, prec + rec, out=np.zeros(K),
                   where=(prec + rec) > 0)
    spec = np.divide(tn, tn + fp, out=np.zeros(K), where=(tn + fp) > 0)
    support = cm.sum(1)
    w = support / max(support.sum(), 1)
    out = {
        "precision_macro": float(prec.mean()),
        "recall_macro": float(rec.mean()),
        "f1_macro": float(f1.mean()),
        "precision_weighted": float((prec * w).sum()),
        "recall_weighted": float((rec * w).sum()),
        "f1_weighted": float((f1 * w).sum()),
        "specificity_macro": float(spec.mean()),
    }
    for i in range(K):
        out[f"f1_class_{i}"] = float(f1[i])
        out[f"precision_class_{i}"] = float(prec[i])
        out[f"recall_class_{i}"] = float(rec[i])
    return out


def cohen_kappa(cm: np.ndarray, weights: Optional[str] = None) -> float:
    """weights: None | "linear" | "quadratic" (QWK)."""
    cm = cm.astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    K = len(cm)
    idx = np.arange(K)
    if weights == "quadratic":
        w = (idx[:, None] - idx[None, :]) ** 2 / (K - 1) ** 2
    elif weights == "linear":
        w = np.abs(idx[:, None] - idx[None, :]) / (K - 1)
    else:
        w = 1.0 - np.eye(K)
    obs = cm / n
    expected = np.outer(cm.sum(1), cm.sum(0)) / n**2
    denom = (w * expected).sum()
    if denom == 0:
        return 0.0
    return float(1.0 - (w * obs).sum() / denom)


def auroc_ovr(y_true: np.ndarray, probs: np.ndarray) -> float:
    """Macro one-vs-rest AUROC via rank statistic (no sklearn)."""
    y_true = np.asarray(y_true, int)
    K = probs.shape[1]
    aucs = []
    for c in range(K):
        pos = probs[y_true == c, c]
        neg = probs[y_true != c, c]
        if len(pos) == 0 or len(neg) == 0:
            continue
        ranks = np.argsort(np.argsort(np.concatenate([pos, neg]))) + 1
        r_pos = ranks[: len(pos)].sum()
        auc = (r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.0


def expected_calibration_error(
    y_true: np.ndarray, probs: np.ndarray, n_bins: int = 15
) -> float:
    conf = probs.max(1)
    pred = probs.argmax(1)
    correct = (pred == np.asarray(y_true, int)).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(bins[:-1], bins[1:]):
        mask = (conf > lo) & (conf <= hi)
        if mask.sum() == 0:
            continue
        ece += mask.mean() * abs(correct[mask].mean() - conf[mask].mean())
    return float(ece)


def classification_report(
    y_true, y_pred, probs: Optional[np.ndarray] = None, num_classes: int = 4
) -> Dict[str, float]:
    cm = confusion_matrix(y_true, y_pred, num_classes)
    out = {}
    out.update(accuracy_metrics(cm))
    out.update(precision_recall_f1(cm))
    out["qwk"] = cohen_kappa(cm, "quadratic")
    out["kappa_linear"] = cohen_kappa(cm, "linear")
    out["kappa"] = cohen_kappa(cm)
    if probs is not None:
        out["auroc"] = auroc_ovr(y_true, probs)
        out["ece"] = expected_calibration_error(y_true, probs)
    return out


def regression_report(y_true, y_pred, num_classes: int = 4) -> Dict[str, float]:
    """Judge regressor metrics (model_regression.py:141-216)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    rounded = np.clip(np.round(y_pred), 0, num_classes - 1).astype(int)
    cm = confusion_matrix(y_true.astype(int), rounded, num_classes)
    return {
        "rmse": float(np.sqrt(np.mean((y_true - y_pred) ** 2))),
        "mae": float(np.mean(np.abs(y_true - y_pred))),
        "rounded_acc": float((rounded == y_true.astype(int)).mean()),
        "qwk": cohen_kappa(cm, "quadratic"),
    }
