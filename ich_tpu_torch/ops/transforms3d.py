"""On-device, batched augmentation of 3D patches (counterpart of
:mod:`ich_tpu.ops.transforms3d`).

Every transform takes a jax.random key (:mod:`ich_tpu_torch.utils.rng`)
and a (B, D, H, W[, C]) batch, and draws from the key exactly the
parameters that the JAX package's transform draws from it, on the host;
``Compose3D`` hands transform i ``split(key, len(transforms))[i]``. Each
random transform splits into a draw (``affine_params``, ``flip_flags``) and
an apply on given values, so that the draws can be injected.

- :class:`Flip3D`: random flips along chosen spatial axes;
- :class:`RotateInPlane`: one random (H, W) rotation per sample, shared
  across depth, image order 1 and mask order 0;
- :class:`AffineAugment3D`: that rotation composed with random H and W
  flips into one warp;
- photometric jitter is the rank-agnostic
  :class:`ich_tpu_torch.ops.transforms.AdjustBrightness` / ``AdjustContrast``.

The in-plane warp folds depth into the batch and runs the exact gather of
:func:`ich_tpu_torch.ops.warp.affine_warp`, the route the JAX package takes
off the TPU; its two-pass matmul warp is a TPU formulation and is not
ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ich_tpu_torch.ops.transforms import AdjustBrightness, _matrix, _on
from ich_tpu_torch.ops.warp import affine_warp, compose_affine
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRANSFORMS


class Flip3D:
    """Random independent flips along the given spatial axes (1=D, 2=H,
    3=W of a (B, D, H, W[, C]) batch)."""

    def __init__(self, p: float = 0.5, axes: Sequence[int] = (2, 3)):
        self.p = p
        self.axes = tuple(axes)

    def flip_flags(self, key, batch: int) -> torch.Tensor:
        """(len(axes), B) bool on the host: whether each sample flips along
        axis i, ``bernoulli(fold_in(key, i), p, (B,))``."""
        return torch.stack([rng.bernoulli(rng.fold_in(key, i), self.p, (batch,))
                            for i in range(len(self.axes))])

    def apply_flags(self, x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
        for ax, flip in zip(self.axes, flags):
            f = flip.reshape((-1,) + (1,) * (x.dim() - 1))
            x = torch.where(f, torch.flip(x, dims=(ax,)), x)
        return x

    def __call__(self, key, image, mask=None):
        flags = _on(self.flip_flags(key, image.shape[0]), image)
        out = self.apply_flags(image, flags)
        return (out, self.apply_flags(mask, flags)) if mask is not None else out

    def __str__(self):
        return f"Flip3D(p={self.p}, axes={list(self.axes)})"


def _rotation_affine(key, batch: int, low: float, high: float):
    """(m, o) on the host: a rotation by ``uniform(key, (B,), low, high)``
    degrees per sample, no offset."""
    th = rng.uniform(key, (batch,), low, high) * (math.pi / 180.0)
    c, s = torch.cos(th), torch.sin(th)
    return _matrix(c, s, -s, c), torch.zeros((batch, 2))


def _warp_inplane(x: torch.Tensor, m: torch.Tensor, o: torch.Tensor, order: int) -> torch.Tensor:
    """Warp every (H, W) slice of a (B, D, H, W[, C]) batch by its sample's
    inverse map: depth folded into the batch, ``m`` and ``o`` repeated D
    times, one exact gather."""
    b, d = x.shape[:2]
    slabs = x.reshape((b * d,) + tuple(x.shape[2:]))
    out = affine_warp(slabs, m.repeat_interleave(d, dim=0), o.repeat_interleave(d, dim=0),
                      order=order)
    return out.reshape(x.shape)


class _InPlaneAffine:
    """Base of the in-plane warps: ``affine_params(key, batch) -> (m, o)``
    on the host, then the image warped at order 1 and the mask at order 0."""

    def affine_params(self, key, batch: int):
        raise NotImplementedError

    def __call__(self, key, image, mask=None):
        m, o = (_on(t, image) for t in self.affine_params(key, image.shape[0]))
        out = _warp_inplane(image, m, o, order=1)
        return (out, _warp_inplane(mask, m, o, order=0)) if mask is not None else out


class RotateInPlane(_InPlaneAffine):
    """Random (H, W)-plane rotation of a volume batch: one angle per
    sample, the same across depth."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def affine_params(self, key, batch):
        return _rotation_affine(key, batch, self.low, self.high)

    def __str__(self):
        return f"RotateInPlane(low={self.low}, high={self.high})"


class AffineAugment3D(_InPlaneAffine):
    """In-plane rotation and random H / W flips composed into one warp per
    batch (image order 1, mask order 0). Draws from ``kr, kh, kw =
    split(key, 3)``: the angles from ``kr``, the H flips from ``kh`` and the
    W flips from ``kw`` (each only if enabled)."""

    def __init__(self, rotate: Tuple[float, float] = (-10.0, 10.0),
                 p_flip: float = 0.5, flip_h: bool = True, flip_w: bool = True):
        self.rotate = (float(rotate[0]), float(rotate[1]))
        self.p_flip = p_flip
        self.flip_h, self.flip_w = flip_h, flip_w

    def affine_params(self, key, batch):
        kr, kh, kw = rng.split(key, 3)
        m, o = _rotation_affine(kr, batch, *self.rotate)
        one, zero = torch.ones(batch), torch.zeros(batch)

        def sign(k, enabled: bool) -> torch.Tensor:
            if not enabled:
                return one
            return torch.where(rng.bernoulli(k, self.p_flip, (batch,)), -1.0, 1.0)

        sy = sign(kh, self.flip_h)
        sx = sign(kw, self.flip_w)
        return compose_affine(m, o, _matrix(sy, zero, zero, sx), torch.zeros_like(o))

    def __str__(self):
        return (f"AffineAugment3D(rotate={self.rotate}, p_flip={self.p_flip}, "
                f"flip_h={self.flip_h}, flip_w={self.flip_w})")


class Compose3D:
    """Sequential 3D pipeline; the 2D photometric transforms compose too.
    Transform i draws from ``split(key, len(transforms))[i]``, as in the JAX
    package."""

    def __init__(self, *transforms):
        self.transforms = tuple(transforms)

    def __call__(self, key, image, mask=None):
        for k, t in zip(rng.split(key, max(1, len(self.transforms))), self.transforms):
            if mask is not None:
                image, mask = t(k, image, mask)
            else:
                image = t(k, image)
        return (image, mask) if mask is not None else image

    def __str__(self):
        return "Compose3D(\n" + "\n".join("    " + str(t) for t in self.transforms) + "\n)"


TRANSFORMS.add("Flip3D", Flip3D)
TRANSFORMS.add("RotateInPlane", RotateInPlane)
TRANSFORMS.add("AffineAugment3D", AffineAugment3D)


def default_patch_augmentation(
    rotate: Tuple[float, float] = (-10, 10),
    flip_axes: Sequence[int] = (2, 3),
    brightness: Optional[Tuple[float, float]] = (-0.1, 0.1),
) -> Compose3D:
    """The 3D trainer's standard patch augmentation: rotation and the
    in-plane flips as one :class:`AffineAugment3D` warp, a depth flip (axis
    1) if requested as a separate :class:`Flip3D`, then
    ``AdjustBrightness(p=0.5)``."""
    parts = [AffineAugment3D(rotate, p_flip=0.5, flip_h=2 in flip_axes, flip_w=3 in flip_axes)]
    if 1 in flip_axes:
        parts.append(Flip3D(p=0.5, axes=(1,)))
    if brightness is not None:
        parts.append(AdjustBrightness(p=0.5, low=brightness[0], high=brightness[1]))
    return Compose3D(*parts)
