"""Seeded synthetic head CTs, drawn on the device in a few large calls.

The construction is ``chip_smoke.py``'s ``head_ct_and_mask`` (air, an
elliptic skull, brain with noise, and a few hyperdense bleeds with their
mask), copied here so that the benchmark's inputs do not move when that
script does; the per-voxel noise is drawn by a ``torch.Generator`` on the
device, the few scalars from numpy's generator of the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def generators(seed: int, device) -> Tuple[np.random.Generator, torch.Generator]:
    """A numpy generator for scalars and a torch generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    return np.random.default_rng(int(seed)), gen


def head_ct_and_mask(rng: np.random.Generator, gen: torch.Generator, shape, device,
                     n_bleeds: Tuple[int, int] = (2, 5)):
    """(H, W, Z) float32 HU volume and uint8 mask of its bleeds, on
    ``device``; ``n_bleeds`` bounds the number of bleeds (low, high)."""
    h, w, z = shape
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    r = ((yy - h / 2) / (0.42 * h)) ** 2 + ((xx - w / 2) / (0.36 * w)) ** 2
    brain = r <= 0.85
    plane = torch.where(r <= 1.0, 1000.0, -1000.0)
    plane = torch.where(brain, 35.0, plane)
    noise = torch.randn((h, w, z), generator=gen, device=device) * 8.0
    vol = plane[..., None] + noise * brain[..., None]
    mask = torch.zeros((h, w, z), dtype=torch.uint8, device=device)
    zz = torch.arange(z, dtype=torch.float32, device=device)
    for _ in range(int(rng.integers(*n_bleeds))):
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
        cz, rad = rng.uniform(0.3, 0.7) * z, rng.uniform(0.03, 0.08) * h
        blob = ((((yy - cy) ** 2 + (xx - cx) ** 2)[..., None] / rad ** 2
                 + ((zz - cz) / (z / 6)) ** 2) <= 1.0)
        bleed = blob & brain[..., None]
        vol = torch.where(bleed, float(rng.uniform(60, 85)), vol)
        mask[bleed] = 1
    return vol, mask


def window(vol: torch.Tensor, center_width) -> torch.Tensor:
    """The HU window (center, width) to [0, 1]."""
    center, width = center_width
    return torch.clamp((vol - (center - width / 2)) / width, 0.0, 1.0)


def volumes_dhw(seed: int, n: int, shape_dhw, device, hu_window=None):
    """``n`` (D, H, W) volumes and their masks on ``device``: HU, or with
    ``hu_window`` (center, width) windowed to [0, 1]."""
    rng, gen = generators(seed, device)
    d, h, w = shape_dhw
    vols, masks = [], []
    for _ in range(n):
        v, m = head_ct_and_mask(rng, gen, (h, w, d), device)
        v = v if hu_window is None else window(v, hu_window)
        vols.append(v.permute(2, 0, 1).contiguous())
        masks.append(m.permute(2, 0, 1).contiguous())
    return vols, masks


def slices(seed: int, n: int, hw, positive_share: float, hu_window, device,
           chunk: int = 256):
    """``n`` (H, W) slices windowed by ``hu_window`` (center, width) to
    [0, 1] and their masks, on ``device``: the construction above in one
    plane, with one to three round bleeds in ``round(n * positive_share)``
    of them (chosen by the seed)."""
    rng, gen = generators(seed, device)
    h, w = hw
    n_pos = int(round(n * positive_share))
    count = np.zeros(n, np.int64)
    count[rng.permutation(n)[:n_pos]] = rng.integers(1, 4, n_pos)
    cy = torch.from_numpy(rng.uniform(0.35, 0.65, (n, 3)) * h).float().to(device)
    cx = torch.from_numpy(rng.uniform(0.35, 0.65, (n, 3)) * w).float().to(device)
    rad = torch.from_numpy(rng.uniform(0.03, 0.08, (n, 3)) * h).float().to(device)
    hu = torch.from_numpy(rng.uniform(60, 85, (n, 3))).float().to(device)
    used = torch.from_numpy(np.arange(3)[None, :] < count[:, None]).to(device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    r = ((yy - h / 2) / (0.42 * h)) ** 2 + ((xx - w / 2) / (0.36 * w)) ** 2
    brain = r <= 0.85
    plane = torch.where(brain, 35.0, torch.where(r <= 1.0, 1000.0, -1000.0))
    images = torch.empty((n, h, w), dtype=torch.float32, device=device)
    masks = torch.empty((n, h, w), dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        vol = plane + torch.randn((e - s, h, w), generator=gen, device=device) * 8.0 * brain
        mask = torch.zeros((e - s, h, w), dtype=torch.bool, device=device)
        for j in range(3):
            blob = (((yy - cy[s:e, j, None, None]) ** 2 + (xx - cx[s:e, j, None, None]) ** 2)
                    <= rad[s:e, j, None, None] ** 2) & brain & used[s:e, j, None, None]
            vol = torch.where(blob, hu[s:e, j, None, None], vol)
            mask |= blob
        images[s:e] = window(vol, hu_window)
        masks[s:e] = mask.float()
    return images, masks
