"""Objective functions (counterpart of :mod:`ich_tpu.ops.losses`).

Only the DiscountedL1 loss is ported so far; it is the caller of the EDT
kernel. Layout is NHWC, as in the JAX package, and the loss is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ich_tpu_torch.ops.distance import distance_to_set


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"Unsupported reduction {reduction!r}")


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
