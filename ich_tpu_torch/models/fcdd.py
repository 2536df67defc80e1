"""FCDD, the fully convolutional data description (counterpart of
:mod:`ich_tpu.models.fcdd`; reference ``FCDD_BaseNet.py`` and
``FCDD_net.py``): a VGG-11-BN-style stack that scores each cell of a 1/8
resolution map, and the receptive-field Gaussian upsample that spreads the
scores back over the input.

The receptive field's (extent, jump, shift) is static metadata of the
layer plan, computed once (:func:`receptive_field`: (62, 8, 3.5) for
``_VGG_PLAN``). :func:`receptive_upsample` is the JAX package's
``lax.conv_transpose`` of the score map with an unnormalised ``r x r``
Gaussian (:func:`gkern`) at stride ``j``, VALID, cropped at offset ``(r -
1) // 2 - int(s)``. ``lax.conv_transpose`` correlates the dilated input
with the kernel as it is, where torch's ``conv_transpose2d`` uses it
flipped, so the port hands torch the kernel flipped back: the two agree for
any kernel, not only for the symmetric Gaussian.

Channels-first. ``FCDD_CNN_VGG``'s submodules carry the reference torch
keys: ``features.{0,4,8,11,15,18}`` the convs, the next index their
BatchNorms, and ``conv_final``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ich_tpu_torch.interop.from_jax import walk_fcdd
from ich_tpu_torch.models.init import init_like_flax
from ich_tpu_torch.models.layers import BatchNorm2d, Conv2d
from ich_tpu_torch.utils.config import NETWORKS

# FCDD_CNN_VGG's layer plan: (kind, kernel, stride, channels); convs pad SAME
_VGG_PLAN = (
    ("conv", 3, 1, 64), ("pool", 2, 2, None),
    ("conv", 3, 1, 128), ("pool", 2, 2, None),
    ("conv", 3, 1, 256), ("conv", 3, 1, 256), ("pool", 2, 2, None),
    ("conv", 3, 1, 512), ("conv", 3, 1, 512),
)


def receptive_field(plan=_VGG_PLAN) -> Tuple[int, int, float]:
    """(extent r, jump j, shift s) of the score map, the closed form of the
    reference's per-layer bookkeeping: convs pad ``(k - 1) // 2``, pools
    pad 0."""
    r, j, s = 1, 1, 0.0
    for kind, k, st, _ in plan:
        pad = (k - 1) // 2 if kind == "conv" else 0
        r = r + (k - 1) * j
        s = s + ((k - 1) / 2 - pad) * j
        j = j * st
    return r, j, s


def kernel_size_to_std(k: int) -> float:
    """Reference ``FCDD_BaseNet.py:13-15``."""
    return float(np.log10(0.45 * k + 1) + 0.25) if k < 32 else 10.0


def gkern(k: int, std: Optional[float] = None) -> torch.Tensor:
    """(k, k) float32 Gaussian with peak 1 (``FCDD_BaseNet.py:17-32``): an
    even size duplicates the centre sample of the (k - 1)-point window and
    halves it. Computed in float64 with numpy, as the JAX package does."""
    if std is None:
        std = kernel_size_to_std(k)
    n = k - 1 if k % 2 == 0 else k
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    g = np.exp(-0.5 * (x / std) ** 2)
    if k % 2 == 0:
        g = np.insert(g, (k - 1) // 2, g[(k - 1) // 2]) / 2.0
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def conv_transpose_lax(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_transpose(x, kernel, (stride, stride), "VALID")`` for one
    channel: (B, 1, h, w) -> (B, 1, (h - 1) stride + k, (w - 1) stride + k).
    torch's transposed conv flips the kernel that lax uses as it is."""
    k = torch.flip(kernel, dims=(0, 1)).to(x.device, x.dtype)
    return F.conv_transpose2d(x, k[None, None], stride=stride)


def receptive_upsample(scores: torch.Tensor, out_hw: Tuple[int, int],
                       r: Optional[int] = None, j: Optional[int] = None,
                       s: Optional[float] = None, std: Optional[float] = None) -> torch.Tensor:
    """(B, 1, h, w) low-resolution scores -> (B, 1, H, W): each score spread
    over its receptive field by the ``r x r`` Gaussian, centres aligned with
    the input grid (reference ``ReceptiveModule.receptive_upsample``)."""
    if r is None or j is None or s is None:
        r, j, s = receptive_field()
    up = conv_transpose_lax(scores.to(torch.float32), gkern(r, std), j)
    off = (r - 1) // 2 - int(s)
    return up[:, :, off: off + out_hw[0], off: off + out_hw[1]]


class FCDD_CNN_VGG(nn.Module):
    """VGG-11-BN-style anomaly scorer (reference ``FCDD_net.py:9-47``):
    (B, 1, H, W) -> (B, 1, H/8, W/8) scores, or with ``ad=False`` the
    512-channel feature map. The weights are flax's ``init`` of the JAX
    ``FCDD_CNN_VGG`` from ``key``."""

    _flax_walk = staticmethod(walk_fcdd)

    def __init__(self, in_channels: int = 1, key: Optional[torch.Tensor] = None):
        super().__init__()
        layers, c = [], in_channels
        for kind, k, st, ch in _VGG_PLAN:
            if kind == "conv":
                layers += [Conv2d(c, ch, k, padding=(k - 1) // 2),
                           BatchNorm2d(ch, eps=1e-5, momentum=0.1), nn.ReLU()]
                c = ch
            else:
                layers.append(nn.MaxPool2d(k, st))
        self.features = nn.Sequential(*layers)
        self.conv_final = Conv2d(c, 1, 1)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, ad: bool = True) -> torch.Tensor:
        x = self.features(x)
        return self.conv_final(x) if ad else x

    @staticmethod
    def heatmap(scores: torch.Tensor, out_hw: Tuple[int, int],
                std: Optional[float] = None) -> torch.Tensor:
        """The pseudo-Huber map ``sqrt(x^2 + 1) - 1`` of the scores,
        receptive-upsampled to ``out_hw`` (reference ``FCDD.py:242-253``)."""
        a = torch.sqrt(scores.to(torch.float32) ** 2 + 1.0) - 1.0
        return receptive_upsample(a, out_hw, std=std)


NETWORKS.add("FCDD_CNN_VGG", lambda in_shape=None, bias=True, key=None, **kw: FCDD_CNN_VGG(key=key))
