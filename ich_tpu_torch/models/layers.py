"""Building blocks of the U-Net (counterpart of :mod:`ich_tpu.models.layers`).

Modules take channels-first tensors (NCHW / NCDHW), PyTorch's layout; the
JAX package's are channels-last. ``PConv``'s lane packing is a TPU trick
and is not ported: a conv here is ``nn.Conv2d`` / ``nn.Conv3d``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONVT = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


def normalize_p_dropout(p_dropout: Union[float, Sequence[float]], depth: int) -> Tuple[float, ...]:
    """Float -> repeated per level; list -> validated."""
    if isinstance(p_dropout, (float, int)):
        return (float(p_dropout),) * depth
    p = tuple(float(x) for x in p_dropout)
    if len(p) != depth:
        raise ValueError(f"p_dropout list length {len(p)} != depth {depth}")
    return p


def make_norm(kind: str, channels: int, ndim: int) -> nn.Module:
    """The JAX package's ``Norm``: BatchNorm (eps 1e-5; flax momentum 0.9 is
    torch momentum 0.1) or GroupNorm as ``FlatGroupNorm`` (eps 1e-6,
    ``max(1, C // 16)`` groups)."""
    if kind == "batch":
        return _BN[ndim](channels, eps=1e-5, momentum=0.1)
    if kind == "group":
        return nn.GroupNorm(max(1, channels // 16), channels, eps=1e-6)
    raise ValueError(f"unknown norm {kind!r}")


class ConvBlock(nn.Module):
    """Double [3x3 conv -> norm -> ReLU] with SAME padding and stride 1, and
    dropout at the end (off in eval). Submodule names ``conv1``, ``bn1``,
    ``conv2``, ``bn2`` follow the reference's torch ``ConvBlock``."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 ndim: int = 2, p_dropout: float = 0.0, norm: str = "batch"):
        super().__init__()
        mid = mid_channels or out_channels
        self.conv1 = _CONV[ndim](in_channels, mid, 3, padding=1)
        self.bn1 = make_norm(norm, mid, ndim)
        self.conv2 = _CONV[ndim](mid, out_channels, 3, padding=1)
        self.bn2 = make_norm(norm, out_channels, ndim)
        self.dropout = nn.Dropout(p_dropout) if p_dropout > 0.0 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.dropout(x)


def max_pool(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """2x (or 2x2x2) max pooling, stride 2."""
    return F.max_pool2d(x, 2) if ndim == 2 else F.max_pool3d(x, 2)


def upsample_linear(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """x2 bi/trilinear upsampling with the corner-aligned grid
    (``align_corners=True``)."""
    mode = "bilinear" if ndim == 2 else "trilinear"
    return F.interpolate(x, scale_factor=2, mode=mode, align_corners=True)


def up_conv(in_channels: int, out_channels: int, ndim: int) -> nn.Module:
    """The JAX package's ``UpConv``: a transposed conv, kernel 2, stride 2."""
    return _CONVT[ndim](in_channels, out_channels, kernel_size=2, stride=2)
