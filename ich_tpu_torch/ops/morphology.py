"""Binary morphology and hysteresis thresholding on the device (counterpart
of :mod:`ich_tpu.ops.morphology`).

``dilation`` / ``erosion`` are a size x size max / min over the last two
axes with stride 1 and ``SAME`` padding (``(size - 1) // 2`` before, the
rest after, padded with -inf / +inf as ``reduce_window`` pads); opening and
closing compose them. ``hysteresis_threshold`` seeds from the pixels above
``high`` (strict ``>``) and grows them into the pixels above ``low`` by
repeated masked 3x3 dilation until nothing changes, at most 256 steps; the
host checks for the fixpoint every few steps (extra steps after it change
nothing, and the cap counts steps, not checks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CHECK_EVERY = 8  # hysteresis steps between two fixpoint checks on the host


def _max_window(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sliding size x size max over the last two axes of a float tensor,
    ``SAME`` padding with -inf; any leading axes."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    lo = (size - 1) // 2
    hi = size - 1 - lo
    y = F.pad(x.reshape(-1, 1, h, w), (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(y, size, stride=1).reshape(*lead, h, w)


def dilation(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return _max_window(mask.to(torch.float32), size)


def erosion(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return -_max_window(-mask.to(torch.float32), size)


def opening(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return dilation(erosion(mask, size), size)


def closing(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    return erosion(dilation(mask, size), size)


def hysteresis_threshold(x: torch.Tensor, low, high, max_iter: int = 256) -> torch.Tensor:
    """Pixels above ``high`` seed regions grown into the pixels above
    ``low`` (skimage ``apply_hysteresis_threshold``'s strict ``>``), float32
    {0, 1}. ``x`` (..., H, W); ``low`` and ``high`` scalars or tensors that
    broadcast."""
    weak = (x > low).to(torch.float32)
    strong = (x > high).to(torch.float32)
    cur = torch.minimum(dilation(strong), weak)
    prev = strong
    steps = 0
    while steps < max_iter:
        if not bool((cur != prev).any()):
            break
        for _ in range(min(_CHECK_EVERY, max_iter - steps)):
            prev, cur = cur, torch.minimum(dilation(cur), weak)
            steps += 1
    return cur


def quantile_iqr_thresholds(x: torch.Tensor, alpha: float = 1.5):
    """(low, high) = (q75, q75 + alpha * IQR) over the whole tensor, linear
    interpolation between order statistics (``jnp.percentile``'s)."""
    q = torch.quantile(x.reshape(-1).to(torch.float32),
                       torch.tensor([0.25, 0.75], dtype=torch.float32, device=x.device))
    q25, q75 = q[0], q[1]
    return q75, q75 + alpha * (q75 - q25)
