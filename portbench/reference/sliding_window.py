"""Plain Gaussian-blended sliding-window segmentation of a (D, H, W) HU
volume, as the JAX package's ``UNet3D.segment_volume`` defines it: the
HU window to [0, 1]; patches on a grid of stride ``patch * (1 - overlap)``
per axis, the last start clamped to ``dim - patch``; each patch's
probabilities weighted by a separable Gaussian (sigma patch/8, peak 1,
floor 1e-2), summed, and divided by the summed weights."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def gaussian(patch, device) -> torch.Tensor:
    ws = []
    for n in patch:
        x = np.arange(n, dtype=np.float64)
        ws.append(np.exp(-0.5 * ((x - (n - 1) / 2.0) / max(n / 8.0, 1e-3)) ** 2))
    m = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    return torch.from_numpy(np.maximum(m / m.max(), 1e-2).astype(np.float32)).to(device)


def starts(dim: int, patch: int, overlap: float):
    if dim <= patch:
        return [0]
    step = max(1, int(patch * (1.0 - overlap)))
    s = list(range(0, dim - patch + 1, step))
    return s if s[-1] == dim - patch else s + [dim - patch]


def window_ct(vol: torch.Tensor, center: float, width: float) -> torch.Tensor:
    lo = center - width / 2.0
    return torch.clamp((vol - lo) / width, 0.0, 1.0)


@torch.no_grad()
def probabilities(net: Callable[[torch.Tensor], torch.Tensor], vol_hu: torch.Tensor, patch,
                  overlap: float, window, block: int = 32) -> torch.Tensor:
    """(D, H, W) float32 probabilities; ``net`` maps (B, 1, *patch) to
    (B, 1, *patch) probabilities, called on ``block`` patches at a time."""
    x = window_ct(vol_hu.float(), *window)
    pd, ph, pw = patch
    grid = [(z, y, w) for z in starts(x.shape[0], pd, overlap)
            for y in starts(x.shape[1], ph, overlap) for w in starts(x.shape[2], pw, overlap)]
    g = gaussian(patch, x.device)
    acc = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    for i in range(0, len(grid), block):
        cs = grid[i:i + block]
        batch = torch.stack([x[z:z + pd, y:y + ph, w:w + pw] for z, y, w in cs])[:, None]
        probs = net(batch)[:, 0].float() * g
        for (z, y, w), p in zip(cs, probs):
            acc[z:z + pd, y:y + ph, w:w + pw] += p
            wsum[z:z + pd, y:y + ph, w:w + pw] += g
    return acc / wsum
