"""The 2D train augmentation of ``configs/unet2d*.json`` (Translate,
Rotate, Scale, HFlip) worked out again: each transform's parameters from
its key as the JAX package draws them, the maps composed about the image
centre, and one warp, bilinear for the image and nearest (round half to
even) for the mask, samples outside the input 0 as scipy's
``mode='constant'``. A frozen copy of the arithmetic of
``ich_tpu_torch/ops/transforms.py`` and ``ops/warp.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import rng


def affine(key: np.ndarray, spec: dict, batch: int, h: int, w: int):
    """The composed inverse maps ``p_in = M (p_out - c) + c + o``: (B, 2, 2)
    and (B, 2) float32 on the host; transform i draws from ``split(key,
    n)[i]``."""
    keys = rng.split(key, len(spec))
    m = np.tile(np.eye(2, dtype=np.float32), (batch, 1, 1))
    o = np.zeros((batch, 2), np.float32)
    for k, (name, kw) in zip(keys, spec.items()):
        mt = np.tile(np.eye(2, dtype=np.float32), (batch, 1, 1))
        ot = np.zeros((batch, 2), np.float32)
        if name == "Translate":
            ky, kx = rng.split(k)
            sy = rng.uniform(ky, (batch,), h * kw["low"], h * kw["high"])
            sx = rng.uniform(kx, (batch,), w * kw["low"], w * kw["high"])
            ot = np.stack([-sy, -sx], 1)
        elif name == "Rotate":
            th = torch.from_numpy(rng.uniform(k, (batch,), kw["low"], kw["high"])) * (
                math.pi / 180.0)
            c, s = torch.cos(th).numpy(), torch.sin(th).numpy()
            mt = np.stack([np.stack([c, s], 1), np.stack([-s, c], 1)], 1)
        elif name == "Scale":
            inv = (1.0 / torch.from_numpy(rng.uniform(k, (batch,), kw["low"], kw["high"]))).numpy()
            mt = inv[:, None, None] * np.eye(2, dtype=np.float32)
        elif name == "HFlip":
            sign = np.where(rng.bernoulli(k, kw["p"], (batch,)), -1.0, 1.0).astype(np.float32)
            mt[:, 1, 1] = sign
        else:
            raise ValueError(f"augmentation {name!r} has no reference")
        m, o = _compose(m, o, mt.astype(np.float32), ot.astype(np.float32))
    return m, o


def _compose(m1, o1, m2, o2):
    """Transform 1 then transform 2: ``M = M1 M2``, ``o = M1 o2 + o1``,
    each entry summed in the program's order."""
    m = m1[:, :, 0, None] * m2[:, None, 0, :] + m1[:, :, 1, None] * m2[:, None, 1, :]
    o = m1[:, :, 0] * o2[:, None, 0] + m1[:, :, 1] * o2[:, None, 1] + o1
    return m.astype(np.float32), o.astype(np.float32)


def warp(img: torch.Tensor, m: torch.Tensor, o: torch.Tensor, order: int) -> torch.Tensor:
    """(B, H, W) images sampled at the maps' coordinates."""
    b, h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=img.device) - cy)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=img.device) - cx)[None, None, :]
    c = [[m[:, i, j, None, None] for j in range(2)] for i in range(2)]
    y = c[0][0] * yy + c[0][1] * xx + cy + o[:, 0, None, None]
    x = c[1][0] * yy + c[1][1] * xx + cx + o[:, 1, None, None]
    inside = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    flat = img.reshape(b, h * w)

    def at(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = torch.gather(flat, 1, (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1))
        return torch.where(ok, v.reshape(b, h, w), 0.0)

    if order == 0:
        out = at(torch.round(y).long(), torch.round(x).long())
    else:
        y0, x0 = torch.floor(y), torch.floor(x)
        wy, wx = y - y0, x - x0
        y0, x0 = y0.long(), x0.long()
        out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x0 + 1) * (1 - wy) * wx
               + at(y0 + 1, x0) * wy * (1 - wx) + at(y0 + 1, x0 + 1) * wy * wx)
    return torch.where(inside, out, 0.0)
