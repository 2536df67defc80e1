"""Segmentation and classifier metrics (counterpart of
:mod:`ich_tpu.ops.metrics`).

The classifier metrics are scikit-learn's (the JAX package calls it; the
port runs without it), in numpy and scipy: accuracy, recall, precision
and F1 with ``zero_division=0`` (an undefined score is 0), and the ROC AUC
as the Mann-Whitney statistic on average ranks (``scipy.stats.rankdata``),
so that tied scores count a half as scikit-learn's trapezoids do. A
``y_true`` with one class has no AUC (NaN); in the macro AUC one such
label column makes the whole value NaN, as scikit-learn raises there and
the JAX package catches it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def batch_binary_confusion_matrix(
    pred: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-batch-element TN, FP, FN, TP of binary (B, ...) tensors, reduced
    over all non-batch axes, as float32 (exact for counts below 2^24)."""
    if pred.shape != target.shape:
        raise ValueError(f"Shapes do not match! {tuple(pred.shape)} != {tuple(target.shape)}")
    if pred.dim() < 2:
        raise ValueError(f"Need a batch dimension; got ndim={pred.dim()}")
    p = pred.reshape(pred.shape[0], -1).to(torch.float32)
    t = target.reshape(target.shape[0], -1).to(torch.float32)
    tp = torch.sum(p * t, dim=1)
    tn = torch.sum((1.0 - p) * (1.0 - t), dim=1)
    fp = torch.sum(p * (1.0 - t), dim=1)
    fn = torch.sum((1.0 - p) * t, dim=1)
    return tn, fp, fn, tp


def dice_from_counts(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, smooth: float = 1.0
) -> torch.Tensor:
    """Smoothed Dice ``(2TP+s)/(2TP+FP+FN+s)``."""
    return (2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth)


def iou_from_counts(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, eps: float = 1.0
) -> torch.Tensor:
    """Smoothed IoU ``(TP+eps)/(TP+FP+FN+eps)``."""
    return (tp + eps) / (tp + fp + fn + eps)


def volume_counts(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    volume_ids: torch.Tensor,
    num_volumes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum per-slice confusion counts into per-volume counts on the device;
    ``volume_ids`` maps each slice to a dense index in ``[0, num_volumes)``
    (the JAX package's ``segment_sum``)."""
    vids = volume_ids.to(device=tp.device, dtype=torch.long)

    def seg(x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(num_volumes, dtype=x.dtype, device=x.device).index_add_(0, vids, x)

    return seg(tp), seg(fp), seg(fn)


def volume_dice(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    volume_ids: torch.Tensor,
    num_volumes: int,
    smooth: float = 1.0,
) -> torch.Tensor:
    """Per-volume Dice from per-slice counts."""
    vtp, vfp, vfn = volume_counts(tp, fp, fn, volume_ids, num_volumes)
    return dice_from_counts(vtp, vfp, vfn, smooth)


def dice_all_and_positive(
    vol_dice: torch.Tensor, vol_has_ich: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean volumetric Dice over all volumes and over the ICH-positive ones
    (``vol_has_ich``: a boolean mask of volumes with a positive voxel); the
    positive mean is 0 where there is no positive volume."""
    d_all = torch.mean(vol_dice)
    pos = vol_has_ich.to(torch.float32)
    n_pos = torch.clamp(torch.sum(pos), min=1.0)
    d_pos = torch.sum(vol_dice * pos) / n_pos
    return d_all, d_pos


def fold_aggregate(values: np.ndarray) -> Tuple[float, float]:
    """Mean ± 1.96σ across folds (reference
    ``scripts/unet-2D/UNet2D_scripts.py:203-207``)."""
    v = np.asarray(values, dtype=np.float64)
    return float(v.mean()), float(1.96 * v.std())


def _auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC of binary ``y_true`` against ``y_score`` (1-D), NaN when
    ``y_true`` has one class."""
    from scipy.stats import rankdata

    pos = np.asarray(y_true).ravel() > 0
    n_pos = int(pos.sum())
    n_neg = pos.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(y_score, dtype=np.float64).ravel())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _prf(t: np.ndarray, p: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column recall, precision and F1 of binary (N, K) arrays, 0 where
    undefined."""
    tp = np.sum(t & p, axis=0).astype(np.float64)
    true_sum = np.sum(t, axis=0).astype(np.float64)
    pred_sum = np.sum(p, axis=0).astype(np.float64)

    def div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

    return div(tp, true_sum), div(tp, pred_sum), div(2.0 * tp, true_sum + pred_sum)


def classification_metrics(y_true: np.ndarray, y_score: np.ndarray,
                           threshold: float = 0.5) -> Dict[str, float]:
    """Binary classifier metrics: accuracy, recall, precision, F1 of the
    scores thresholded at ``threshold``, and the AUC (NaN for one class)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    y_pred = (y_score >= threshold).astype(np.int64)
    t, p = (y_true == 1)[:, None], (y_pred == 1)[:, None]
    recall, precision, f1 = _prf(t, p)
    return {"accuracy": float(np.mean(y_true == y_pred)), "recall": float(recall[0]),
            "precision": float(precision[0]), "f1": float(f1[0]),
            "auc": _auc(y_true == 1, y_score)}


def multilabel_metrics(y_true: np.ndarray, y_score: np.ndarray,
                       threshold: float = 0.5) -> Dict[str, float]:
    """Multilabel metrics: subset accuracy, and recall, precision, F1 and
    AUC averaged over the label columns (the AUC NaN if a column has one
    class)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    y_pred = (y_score >= threshold).astype(np.int64)
    recall, precision, f1 = _prf(y_true == 1, y_pred == 1)
    aucs = [_auc(y_true[:, j] == 1, y_score[:, j]) for j in range(y_true.shape[1])]
    return {"subset_accuracy": float(np.mean(np.all(y_true == y_pred, axis=1))),
            "recall_macro": float(np.mean(recall)), "precision_macro": float(np.mean(precision)),
            "f1_macro": float(np.mean(f1)), "auc_macro": float(np.mean(aucs))}


def pixel_auc(heatmap: np.ndarray, mask: np.ndarray) -> float:
    """Pixel-level AUC of an anomaly heatmap against a binary mask; NaN
    when the mask has one class."""
    return _auc(np.asarray(mask).ravel().astype(np.int64) > 0, np.asarray(heatmap).ravel())
