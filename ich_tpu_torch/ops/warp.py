"""Batched affine warping (counterpart of :mod:`ich_tpu.ops.warp`).

Every geometric transform contributes an inverse coordinate map
``p_in = M (p_out - c) + c + o`` about the image centre ``c = (n - 1) / 2``;
consecutive transforms are fused by composing the maps, and one batched
gather samples the input: order 1 (bilinear) for images, order 0 (nearest)
for masks, with scipy's ``mode='constant'`` semantics. The JAX package's
two-pass matmul warp exists because gathers are slow on a TPU; on the card
the exact gather is the warp.

The arithmetic is written out element by element, in the JAX package's
order, so that the card and the CPU sample the same coordinates bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch


def identity_affine(batch: int, device: str | torch.device = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    m = torch.eye(2, dtype=torch.float32, device=device).expand(batch, 2, 2).clone()
    o = torch.zeros((batch, 2), dtype=torch.float32, device=device)
    return m, o


def compose_affine(
    m1: torch.Tensor, o1: torch.Tensor, m2: torch.Tensor, o2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse inverse maps: transform 1 applied to the image first, then
    transform 2. Combined inverse map = f1 ∘ f2: M = M1 M2, o = M1 o2 + o1."""
    m = m1[:, :, 0, None] * m2[:, None, 0, :] + m1[:, :, 1, None] * m2[:, None, 1, :]
    o = m1[:, :, 0] * o2[:, None, 0] + m1[:, :, 1] * o2[:, None, 1] + o1
    return m, o


def _sample_coords(
    m: torch.Tensor, o: torch.Tensor, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input-space (y, x) sample coordinates for every output pixel.
    Returns two (B, H, W) tensors."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=m.device) - cy)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=m.device) - cx)[None, None, :]

    def coef(t: torch.Tensor) -> torch.Tensor:
        return t[:, None, None]

    y_in = coef(m[:, 0, 0]) * yy + coef(m[:, 0, 1]) * xx + cy + coef(o[:, 0])
    x_in = coef(m[:, 1, 0]) * yy + coef(m[:, 1, 1]) * xx + cx + coef(o[:, 1])
    return y_in, x_in


def _gather_2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Batched pixel gather: img (B, H, W, C), yi/xi int64 (B, H', W') ->
    (B, H', W', C)."""
    b, h, w, c = img.shape
    hp, wp = yi.shape[1:]
    flat = img.reshape(b, h * w, c)
    idx = (yi * w + xi).reshape(b, hp * wp, 1).expand(b, hp * wp, c)
    return torch.gather(flat, 1, idx).reshape(b, hp, wp, c)


def affine_warp(
    image: torch.Tensor,
    m: torch.Tensor,
    o: torch.Tensor,
    order: int = 1,
    cval: float = 0.0,
) -> torch.Tensor:
    """Warp a batch of images by per-sample inverse affine maps.

    image: (B, H, W) or (B, H, W, C); m: (B, 2, 2); o: (B, 2) (pixel offsets,
    y then x). Order 1 = bilinear (images), order 0 = nearest with
    round-half-to-even (masks; binary data stays binary). A sample whose
    coordinate falls outside the input extent ``[0, n - 1]`` is exactly
    ``cval``, as scipy's ``mode='constant'``."""
    squeeze = image.dim() == 3
    if squeeze:
        image = image[..., None]
    b, h, w = image.shape[:3]
    y, x = _sample_coords(m, o, h, w)
    in_extent = ((y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1))[..., None]
    cval_t = torch.tensor(cval, dtype=image.dtype, device=image.device)

    if order == 0:
        yi = torch.round(y).long().clamp(0, h - 1)
        xi = torch.round(x).long().clamp(0, w - 1)
        out = torch.where(in_extent, _gather_2d(image, yi, xi), cval_t)
    else:
        y0 = torch.floor(y)
        x0 = torch.floor(x)
        wy = (y - y0)[..., None]
        wx = (x - x0)[..., None]
        y0i = y0.long()
        x0i = x0.long()

        def corner(dy: int, dx: int) -> torch.Tensor:
            yi, xi = y0i + dy, x0i + dx
            inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
            v = _gather_2d(image, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
            return torch.where(inb, v, cval_t)

        out = (
            corner(0, 0) * (1 - wy) * (1 - wx)
            + corner(0, 1) * (1 - wy) * wx
            + corner(1, 0) * wy * (1 - wx)
            + corner(1, 1) * wy * wx
        )
        out = torch.where(in_extent, out, cval_t)
    return out[..., 0] if squeeze else out
