"""On-device, batched augmentation of 3D patches (counterpart of
:mod:`ich_tpu.ops.transforms3d`).

Every transform takes a (B, D, H, W[, C]) batch and one ``torch.Generator``
on the batch's device, and draws from it in a fixed order; ``Compose3D``
hands the same generator to each transform in turn. Each random transform
splits into a draw (``affine_params``, ``flip_flags``) and an apply on given
values, so that the draws can be injected.

- :class:`Flip3D`: random flips along chosen spatial axes;
- :class:`RotateInPlane`: one random (H, W) rotation per sample, shared
  across depth, image order 1 and mask order 0;
- :class:`AffineAugment3D`: that rotation composed with random H and W
  flips into one warp;
- photometric jitter is the rank-agnostic
  :class:`ich_tpu_torch.ops.transforms.AdjustBrightness` / ``AdjustContrast``,
  whose factors ``Compose3D`` draws from its generator.

The 2D transforms draw from jax.random's keys (:mod:`ich_tpu_torch.utils.
rng`); these still draw from a torch generator, the same kinds of draws as
the JAX package's but another stream.

The in-plane warp folds depth into the batch and runs the exact gather of
:func:`ich_tpu_torch.ops.warp.affine_warp`, the route the JAX package takes
off the TPU; its two-pass matmul warp is a TPU formulation and is not
ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ich_tpu_torch.ops.transforms import AdjustBrightness, _matrix
from ich_tpu_torch.ops.warp import affine_warp, compose_affine
from ich_tpu_torch.utils.config import TRANSFORMS


def _uniform(gen: torch.Generator, batch, low: float, high: float) -> torch.Tensor:
    """Draws of shape ``batch`` uniform on [low, high)."""
    u = torch.rand(batch, generator=gen, device=gen.device, dtype=torch.float32)
    return low + (high - low) * u


def _bernoulli(gen: torch.Generator, batch: int, p: float) -> torch.Tensor:
    """(B,) bool, True with probability ``p``, as ``jax.random.bernoulli``."""
    return torch.rand(batch, generator=gen, device=gen.device) < p


class Flip3D:
    """Random independent flips along the given spatial axes (1=D, 2=H,
    3=W of a (B, D, H, W[, C]) batch)."""

    def __init__(self, p: float = 0.5, axes: Sequence[int] = (2, 3)):
        self.p = p
        self.axes = tuple(axes)

    def flip_flags(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """(len(axes), B) bool: whether each sample flips along each axis,
        drawn axis by axis."""
        return torch.stack([_bernoulli(gen, batch, self.p) for _ in self.axes])

    def apply_flags(self, x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
        for ax, flip in zip(self.axes, flags):
            f = flip.reshape((-1,) + (1,) * (x.dim() - 1))
            x = torch.where(f, torch.flip(x, dims=(ax,)), x)
        return x

    def __call__(self, gen, image, mask=None):
        flags = self.flip_flags(gen, image.shape[0])
        out = self.apply_flags(image, flags)
        return (out, self.apply_flags(mask, flags)) if mask is not None else out

    def __str__(self):
        return f"Flip3D(p={self.p}, axes={list(self.axes)})"


def _rotation_affine(gen: torch.Generator, batch: int, low: float, high: float):
    """(m, o): a rotation by an angle uniform on [low, high) degrees per
    sample, no offset."""
    th = _uniform(gen, batch, low, high) * (math.pi / 180.0)
    c, s = torch.cos(th), torch.sin(th)
    return _matrix(c, s, -s, c), torch.zeros((batch, 2), device=gen.device)


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
    """Base of the in-plane warps: ``affine_params(gen, batch) -> (m, o)``,
    then the image warped at order 1 and the mask at order 0."""

    def affine_params(self, gen: torch.Generator, batch: int):
        raise NotImplementedError

    def __call__(self, gen, image, mask=None):
        m, o = self.affine_params(gen, image.shape[0])
        out = _warp_inplane(image, m, o, order=1)
        return (out, _warp_inplane(mask, m, o, order=0)) if mask is not None else out


class RotateInPlane(_InPlaneAffine):
    """Random (H, W)-plane rotation of a volume batch: one angle per
    sample, the same across depth."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def affine_params(self, gen, batch):
        return _rotation_affine(gen, batch, self.low, self.high)

    def __str__(self):
        return f"RotateInPlane(low={self.low}, high={self.high})"


class AffineAugment3D(_InPlaneAffine):
    """In-plane rotation and random H / W flips composed into one warp per
    batch (image order 1, mask order 0). Draws: the angles, then the H
    flips, then the W flips (each only if enabled)."""

    def __init__(self, rotate: Tuple[float, float] = (-10.0, 10.0),
                 p_flip: float = 0.5, flip_h: bool = True, flip_w: bool = True):
        self.rotate = (float(rotate[0]), float(rotate[1]))
        self.p_flip = p_flip
        self.flip_h, self.flip_w = flip_h, flip_w

    def affine_params(self, gen, batch):
        m, o = _rotation_affine(gen, batch, *self.rotate)
        one = torch.ones(batch, device=gen.device)
        zero = torch.zeros(batch, device=gen.device)

        def sign(enabled: bool) -> torch.Tensor:
            if not enabled:
                return one
            return torch.where(_bernoulli(gen, batch, self.p_flip), -1.0, 1.0)

        sy = sign(self.flip_h)
        sx = sign(self.flip_w)
        return compose_affine(m, o, _matrix(sy, zero, zero, sx), torch.zeros_like(o))

    def __str__(self):
        return (f"AffineAugment3D(rotate={self.rotate}, p_flip={self.p_flip}, "
                f"flip_h={self.flip_h}, flip_w={self.flip_w})")


class Compose3D:
    """Sequential 3D pipeline; the 2D photometric transforms compose too.
    Each transform draws from the one generator in turn: a photometric one
    its (apply, factor) per sample, in this order."""

    def __init__(self, *transforms):
        self.transforms = tuple(transforms)

    def __call__(self, gen, image, mask=None):
        for t in self.transforms:
            if isinstance(t, AdjustBrightness):
                b = image.shape[0]
                apply = torch.rand(b, generator=gen, device=gen.device) < t.p
                image = t.apply_factors(image, apply, _uniform(gen, b, t.low, t.high))
            elif mask is not None:
                image, mask = t(gen, image, mask)
            else:
                image = t(gen, image)
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
