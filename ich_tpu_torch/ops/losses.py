"""Objective functions (counterpart of :mod:`ich_tpu.ops.losses`).

Ported: the segmentation losses (``binary_dice_loss``, ``tversky_loss``,
``combo_loss``) and DiscountedL1, the caller of the EDT kernel. Layout is
NHWC, as in the JAX package, and every loss computes in float32. The
``LOSSES`` registry carries them under the reference's class names.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from ich_tpu_torch.ops.distance import distance_to_set
from ich_tpu_torch.utils.config import LOSSES


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"Unsupported reduction {reduction!r}")


def _batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes."""
    return torch.sum(x.reshape(x.shape[0], -1), dim=1)


def binary_dice_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    reduction: str = "mean",
    p: int = 2,
    alpha: float = 1.0,
    eps: float = 1.0,
) -> torch.Tensor:
    """1 - (2*sum(pred*mask)+eps)/(sum(pred^p)+sum(mask^p)+eps) per sample,
    multiplied by ``alpha`` where the mask is empty (reference
    ``LossFunctions.py:14-63``; alpha applied at ``:56``)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    inter = _batch_sum(pred * mask)
    union = _batch_sum(pred**p) + _batch_sum(mask**p)
    dl = 1.0 - (2.0 * inter + eps) / (union + eps)
    dl = torch.where(_batch_sum(mask) > 0, dl, alpha * dl)
    return _reduce(dl, reduction)


def tversky_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 0.5,
    reduction: str = "mean",
    eps: float = 1.0,
) -> torch.Tensor:
    """1 - (TP+eps)/(TP + beta*FN + gamma*FP + eps), with the empty-mask
    alpha (reference ``LossFunctions.py:65-114``)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    tp = _batch_sum(pred * mask)
    fp = _batch_sum(pred * (1.0 - mask))
    fn = _batch_sum((1.0 - pred) * mask)
    tl = 1.0 - (tp + eps) / (tp + beta * fn + gamma * fp + eps)
    tl = torch.where(_batch_sum(mask) > 0, tl, alpha * tl)
    return _reduce(tl, reduction)


def combo_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    reduction: str = "mean",
    p: int = 1,
) -> torch.Tensor:
    """alpha * beta-weighted BCE (summed per sample) + (1-alpha) * Dice
    (Asgari et al.; reference ``LossFunctions.py:116-166``). ``pred`` is a
    probability (post-sigmoid)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    dice = binary_dice_loss(pred, mask, reduction="none", p=p)
    bce = -_batch_sum(
        beta * mask * torch.log(pred + 1e-14)
        + (1.0 - beta) * (1.0 - mask) * torch.log(1.0 - pred + 1e-14)
    )
    return _reduce(alpha * bce + (1.0 - alpha) * dice, reduction)


def discounted_l1_loss(
    rec: torch.Tensor,
    im: torch.Tensor,
    mask: torch.Tensor,
    gamma: float = 0.99,
    reduction: str = "mean",
) -> torch.Tensor:
    """Discounted L1 (Yu et al. 2018): L1 on the masked region, weighted
    ``gamma**dist`` where dist is the euclidean distance of each masked pixel
    to the nearest border pixel (border = 3x3 dilation of the mask minus the
    mask); weight 0 outside the mask. ``rec``/``im`` (B, H, W, C), ``mask``
    (B, H, W, 1)."""
    rec = rec.to(torch.float32)
    im = im.to(torch.float32)
    m2d = mask.to(torch.float32)[..., 0]  # (B, H, W)
    # max_pool2d pads with -inf, as reduce_window "SAME" does in JAX
    dil = F.max_pool2d(m2d[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    border = dil - m2d
    dist = distance_to_set(border)  # (B, H, W)
    weight = torch.pow(gamma, dist) * m2d
    l1 = torch.abs(rec - im) * weight[..., None]
    return _reduce(l1, reduction)


def _factory(fn: Callable, **defaults) -> Callable:
    def make(**kwargs):
        cfg = {**defaults, **kwargs}
        cfg.pop("device", None)  # reference configs carry torch device strings
        return functools.partial(fn, **cfg)

    return make


LOSSES.add("BinaryDiceLoss", _factory(binary_dice_loss))
LOSSES.add("TverskyLoss", _factory(tversky_loss))
LOSSES.add("ComboLoss", _factory(combo_loss))
LOSSES.add("DiscountedL1", _factory(discounted_l1_loss))
