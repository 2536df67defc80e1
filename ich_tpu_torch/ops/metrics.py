"""Segmentation metrics (counterpart of :mod:`ich_tpu.ops.metrics`)."""

from __future__ import annotations

from typing import Tuple

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
