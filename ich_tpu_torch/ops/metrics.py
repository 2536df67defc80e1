"""Segmentation metrics (counterpart of :mod:`ich_tpu.ops.metrics`)."""

from __future__ import annotations

from typing import Tuple

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
