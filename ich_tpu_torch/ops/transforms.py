"""On-device, batched augmentation (counterpart of :mod:`ich_tpu.ops.transforms`).

Every transform takes a whole batch (B, H, W[, C]) and an explicit
``torch.Generator`` on the batch's device; the mask-aware ``Compose`` fuses
consecutive geometric transforms into one affine warp, which the image
(order 1) and the mask (order 0) share. Out-of-bounds samples are 0, as
scipy's defaults.

Ported: the affine transforms of ``configs/unet2d.json`` (``Translate``,
``Rotate``, ``Scale``, ``HFlip``) and ``VFlip``, and the photometric
``AdjustBrightness`` and ``AdjustContrast`` (rank-agnostic, so the 3D patch
augmentation of :mod:`ich_tpu_torch.ops.transforms3d` uses them too). The
others are registered under their names by the SSL slice; until then
:func:`build_pipeline` raises a ``KeyError`` naming it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ich_tpu_torch.ops.warp import affine_warp, compose_affine, identity_affine
from ich_tpu_torch.utils.config import TRANSFORMS

NOT_PORTED = (
    "RandomCropResize", "Resize", "GaussianBlur", "RandomZCrop", "ToTensor", "ToTorchTensor",
    "RandomPatchSwap",
)


def _ensure_batched(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if x.dim() == 2:
        return x[None], True
    return x, False


def _uniform(gen: torch.Generator, batch: int, low: float, high: float) -> torch.Tensor:
    """``batch`` draws uniform on [low, high), as ``jax.random.uniform``."""
    u = torch.rand(batch, generator=gen, device=gen.device, dtype=torch.float32)
    return low + (high - low) * u


def _matrix(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) from four (B,) entries [[a, b], [c, d]]."""
    return torch.stack([torch.stack([a, b], dim=1), torch.stack([c, d], dim=1)], dim=1)


class Transform:
    """Base: ``__call__(gen, image, mask=None)`` on batched tensors."""

    def __call__(self, gen, image, mask=None):
        raise NotImplementedError

    def __add__(self, other):
        a = self.transforms if isinstance(self, Compose) else (self,)
        b = other.transforms if isinstance(other, Compose) else (other,)
        return Compose(*(a + b))


class AffineTransform(Transform):
    """Geometric transform expressed as a per-sample inverse affine map
    about the image centre; fusable in :class:`Compose`."""

    def affine_params(self, gen: torch.Generator, batch: int, hw: Tuple[int, int]):
        raise NotImplementedError

    def __call__(self, gen, image, mask=None):
        return Compose(self)(gen, image, mask)


class Translate(AffineTransform):
    """Random xy shift, fractions of H/W (reference ``transforms.py:158-203``:
    ``scipy.ndimage.shift`` order 1 image / 0 mask)."""

    def __init__(self, low: float = -0.1, high: float = 0.1):
        self.low, self.high = low, high

    def affine_params(self, gen, batch, hw):
        h, w = hw
        sy = _uniform(gen, batch, h * self.low, h * self.high)
        sx = _uniform(gen, batch, w * self.low, w * self.high)
        m, _ = identity_affine(batch, gen.device)
        # scipy shift(+s): out[i] = in[i - s]
        return m, torch.stack([-sy, -sx], dim=1)

    def __str__(self):
        return f"Translate(low={self.low}, high={self.high})"


class Rotate(AffineTransform):
    """Random in-plane rotation in degrees (reference ``transforms.py:269-312``:
    ``scipy.ndimage.rotate(axes=(1,0), reshape=False)``, order 1/0)."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def affine_params(self, gen, batch, hw):
        ang = _uniform(gen, batch, self.low, self.high)
        # output pixel p samples the input at R(-angle) (p - c) + c
        th = ang * (math.pi / 180.0)
        c, s = torch.cos(th), torch.sin(th)
        return _matrix(c, s, -s, c), torch.zeros((batch, 2), device=gen.device)

    def __str__(self):
        return f"Rotate(low={self.low}, high={self.high})"


class Scale(AffineTransform):
    """Random isotropic zoom about the centre, output shape kept by
    crop/pad (reference ``transforms.py:205-267``)."""

    def __init__(self, low: float = 0.9, high: float = 1.1):
        self.low, self.high = low, high

    def affine_params(self, gen, batch, hw):
        inv = 1.0 / _uniform(gen, batch, self.low, self.high)
        z = torch.zeros_like(inv)
        return _matrix(inv, z, z, inv), torch.zeros((batch, 2), device=gen.device)

    def __str__(self):
        return f"Scale(low={self.low}, high={self.high})"


class HFlip(AffineTransform):
    """Random horizontal flip — axis 1 (reference ``transforms.py:314-355``)."""

    axis = 1

    def __init__(self, p: float = 0.5):
        self.p = p

    def affine_params(self, gen, batch, hw):
        u = torch.rand(batch, generator=gen, device=gen.device, dtype=torch.float32)
        sign = torch.where(u < self.p, -1.0, 1.0)
        one, z = torch.ones_like(sign), torch.zeros_like(sign)
        diag = (one, sign) if self.axis == 1 else (sign, one)
        return _matrix(diag[0], z, z, diag[1]), torch.zeros((batch, 2), device=gen.device)

    def __str__(self):
        return f"{type(self).__name__}(p={self.p})"


class VFlip(HFlip):
    """Random vertical flip — axis 0 (reference ``transforms.py:357-398``)."""

    axis = 0


class AdjustBrightness(Transform):
    """Additive brightness jitter, clipped to [0, 1] (reference
    ``transforms.py:445-491``), on a batch of any rank: each sample, with
    probability ``p``, becomes ``clip(x + f, 0, 1)``, ``f`` uniform on
    [low, high)."""

    def __init__(self, p: float = 0.5, low: float = -0.3, high: float = 0.2):
        self.p, self.low, self.high = p, low, high

    def _factors(self, gen: torch.Generator, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(apply, factor) per sample, drawn in this order."""
        apply = torch.rand(batch, generator=gen, device=gen.device) < self.p
        return apply, _uniform(gen, batch, self.low, self.high)

    @staticmethod
    def _adjust(image: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return torch.clamp(image + f, 0.0, 1.0)

    def apply_factors(self, image: torch.Tensor, apply: torch.Tensor,
                      f: torch.Tensor) -> torch.Tensor:
        """The jitter with given (B,) ``apply`` flags and factors."""
        img_b, sq = _ensure_batched(image)
        shape = (-1,) + (1,) * (img_b.dim() - 1)
        out = torch.where(apply.reshape(shape), self._adjust(img_b, f.reshape(shape)), img_b)
        return out[0] if sq else out

    def __call__(self, gen, image, mask=None):
        out = self.apply_factors(image, *self._factors(gen, _ensure_batched(image)[0].shape[0]))
        return (out, mask) if mask is not None else out

    def __str__(self):
        return f"{type(self).__name__}(p={self.p}, low={self.low}, high={self.high})"


class AdjustContrast(AdjustBrightness):
    """Multiplicative contrast jitter, clipped to [0, 1] (reference
    ``transforms.py:493-539``): ``clip(x * f, 0, 1)``."""

    def __init__(self, p: float = 0.5, low: float = 0.5, high: float = 1.5):
        super().__init__(p=p, low=low, high=high)

    @staticmethod
    def _adjust(image: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return torch.clamp(image * f, 0.0, 1.0)


class Compose(Transform):
    """Mask-aware pipeline with affine fusion (reference
    ``transforms.py:21-70``: image-only or pairs, ``+`` concat, ``__str__``).

    Each run of consecutive :class:`AffineTransform` instances becomes one
    warp; all draws come from the one generator, in the order of the
    transforms."""

    def __init__(self, *transforms: Transform):
        self.transforms = tuple(transforms)

    def __call__(self, gen, image, mask=None):
        segments, run = [], []
        for t in self.transforms:
            if isinstance(t, AffineTransform):
                run.append(t)
                continue
            if run:
                segments.append(tuple(run))
                run = []
            segments.append(t)
        if run:
            segments.append(tuple(run))

        for seg in segments:
            if not isinstance(seg, tuple):
                out = seg(gen, image, mask)
                image, mask = out if mask is not None else (out, None)
                continue
            img_b, sq = _ensure_batched(image)
            b, hw = img_b.shape[0], tuple(img_b.shape[1:3])
            m, o = identity_affine(b, img_b.device)
            for t in seg:
                mt, ot = t.affine_params(gen, b, hw)
                m, o = compose_affine(m, o, mt, ot)
            image = affine_warp(img_b, m, o, order=1)
            if sq:
                image = image[0]
            if mask is not None:
                mask_b, msq = _ensure_batched(mask)
                mask = affine_warp(mask_b, m, o, order=0)
                if msq:
                    mask = mask[0]
        return (image, mask) if mask is not None else image

    def __str__(self):
        names = "\n".join("    " + str(t) for t in self.transforms)
        return f"Compose(\n{names}\n)"


def build_pipeline(spec: dict) -> Compose:
    """A :class:`Compose` from a JSON config dict {TransformName: kwargs}
    (the reference's ``getattr(tf, name)(**kwargs)``,
    ``UNet2D_scripts.py:128``), through the registry."""
    for name in spec:
        if name in NOT_PORTED:
            raise KeyError(f"transform {name!r} is not ported yet: it comes with the SSL "
                           f"slice of the port (ROADMAP.md §1)")
    return Compose(*(TRANSFORMS.build(name, **(kw or {})) for name, kw in spec.items()))


for _cls in (Translate, Rotate, Scale, HFlip, VFlip, AdjustBrightness, AdjustContrast):
    TRANSFORMS.add(_cls.__name__, _cls)
# the reference config's typo (GlobalContrastive_config.json), accepted as the JAX package does
TRANSFORMS.add("AdjustBrighness", AdjustBrightness)
