"""On-device, batched augmentation (counterpart of :mod:`ich_tpu.ops.transforms`).

Every transform takes a whole batch (B, H, W[, C]) and an explicit random
key (:mod:`ich_tpu_torch.utils.rng`), from which it draws exactly the
parameters the JAX package's transform draws from the same key, with the
same splits. The draws run on the host and reach the batch's device in
one copy each; the mask-aware ``Compose`` splits its key once per
transform and fuses consecutive geometric transforms into one affine warp
(composed on the host), which the image (order 1) and the mask (order 0)
share. Out-of-bounds samples are 0, as scipy's defaults.

Every name of the JAX package's ``TRANSFORMS`` registry is here: the affine
transforms (``Translate``, ``Rotate``, ``Scale``, ``HFlip``, ``VFlip`` and
the SSL views' ``RandomCropResize``), the photometric ``AdjustBrightness``
and ``AdjustContrast`` (rank-agnostic, so the 3D patch augmentation of
:mod:`ich_tpu_torch.ops.transforms3d` uses them too), ``GaussianBlur``,
``Resize``, ``RandomZCrop``, ``ToTensor`` (alias ``ToTorchTensor``) and the
context-restoration corruption ``RandomPatchSwap``.

A random transform draws its parameters in one method and applies given
parameters in another, so that a test can inject parameters:
``affine_params`` for the affine ones, ``_factors`` / ``apply_factors``
(photometric), ``draw`` / ``apply_params`` (blur), ``draw`` / ``crop`` (z
crop) and ``draw_geometry`` / ``apply`` (patch swap).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops.warp import affine_warp, compose_affine, identity_affine
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRANSFORMS


def _ensure_batched(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if x.dim() == 2:
        return x[None], True
    return x, False


def _on(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A host draw on ``like``'s device (one copy)."""
    return rng.to_device(x, like.device)


def _matrix(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) from four (B,) entries [[a, b], [c, d]]."""
    return torch.stack([torch.stack([a, b], dim=1), torch.stack([c, d], dim=1)], dim=1)


def _warp_pair(image: torch.Tensor, mask: Optional[torch.Tensor], m: torch.Tensor,
               o: torch.Tensor):
    """The image (order 1) and its mask (order 0) warped by one map."""
    img_b, sq = _ensure_batched(image)
    image = affine_warp(img_b, m, o, order=1)
    image = image[0] if sq else image
    if mask is None:
        return image
    mask_b, msq = _ensure_batched(mask)
    mask = affine_warp(mask_b, m, o, order=0)
    return image, (mask[0] if msq else mask)


class Transform:
    """Base: ``__call__(key, image, mask=None)`` on batched tensors."""

    def __call__(self, key, image, mask=None):
        raise NotImplementedError

    def __add__(self, other):
        a = self.transforms if isinstance(self, Compose) else (self,)
        b = other.transforms if isinstance(other, Compose) else (other,)
        return Compose(*(a + b))


class AffineTransform(Transform):
    """Geometric transform expressed as a per-sample inverse affine map
    about the image centre; fusable in :class:`Compose`.
    ``affine_params(key, batch, hw)`` returns the (B, 2, 2) matrices and (B,
    2) offsets on the host."""

    def affine_params(self, key, batch: int, hw: Tuple[int, int]):
        raise NotImplementedError

    def __call__(self, key, image, mask=None):
        """As the JAX package's: the transform's own warp from ``key``."""
        img_b = _ensure_batched(image)[0]
        m, o = self.affine_params(key, img_b.shape[0], tuple(img_b.shape[1:3]))
        return _warp_pair(image, mask, _on(m, img_b), _on(o, img_b))


class Translate(AffineTransform):
    """Random xy shift, fractions of H/W (reference ``transforms.py:158-203``:
    ``scipy.ndimage.shift`` order 1 image / 0 mask)."""

    def __init__(self, low: float = -0.1, high: float = 0.1):
        self.low, self.high = low, high

    def affine_params(self, key, batch, hw):
        h, w = hw
        ky, kx = rng.split(key)
        sy = rng.uniform(ky, (batch,), h * self.low, h * self.high)
        sx = rng.uniform(kx, (batch,), w * self.low, w * self.high)
        m, _ = identity_affine(batch)
        # scipy shift(+s): out[i] = in[i - s]
        return m, torch.stack([-sy, -sx], dim=1)

    def __str__(self):
        return f"Translate(low={self.low}, high={self.high})"


class Rotate(AffineTransform):
    """Random in-plane rotation in degrees (reference ``transforms.py:269-312``:
    ``scipy.ndimage.rotate(axes=(1,0), reshape=False)``, order 1/0)."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def affine_params(self, key, batch, hw):
        ang = rng.uniform(key, (batch,), self.low, self.high)
        # output pixel p samples the input at R(-angle) (p - c) + c
        th = ang * (math.pi / 180.0)
        c, s = torch.cos(th), torch.sin(th)
        return _matrix(c, s, -s, c), torch.zeros((batch, 2))

    def __str__(self):
        return f"Rotate(low={self.low}, high={self.high})"


class Scale(AffineTransform):
    """Random isotropic zoom about the centre, output shape kept by
    crop/pad (reference ``transforms.py:205-267``)."""

    def __init__(self, low: float = 0.9, high: float = 1.1):
        self.low, self.high = low, high

    def affine_params(self, key, batch, hw):
        inv = 1.0 / rng.uniform(key, (batch,), self.low, self.high)
        z = torch.zeros_like(inv)
        return _matrix(inv, z, z, inv), torch.zeros((batch, 2))

    def __str__(self):
        return f"Scale(low={self.low}, high={self.high})"


class HFlip(AffineTransform):
    """Random horizontal flip — axis 1 (reference ``transforms.py:314-355``)."""

    axis = 1

    def __init__(self, p: float = 0.5):
        self.p = p

    def affine_params(self, key, batch, hw):
        sign = torch.where(rng.bernoulli(key, self.p, (batch,)), -1.0, 1.0)
        one, z = torch.ones_like(sign), torch.zeros_like(sign)
        diag = (one, sign) if self.axis == 1 else (sign, one)
        return _matrix(diag[0], z, z, diag[1]), torch.zeros((batch, 2))

    def __str__(self):
        return f"{type(self).__name__}(p={self.p})"


class VFlip(HFlip):
    """Random vertical flip — axis 0 (reference ``transforms.py:357-398``)."""

    axis = 0


class RandomCropResize(AffineTransform):
    """torchvision ``RandomResizedCrop`` (reference ``transforms.py:541-632``):
    an area scale and a log-uniform aspect ratio, 10 tries, the first that
    fits taken, else the central crop of the whole image clamped to the
    ratio bounds; the crop resized back to the input size, as one affine map
    (half-pixel centres) that fuses with the rest of a :class:`Compose`."""

    def __init__(self, crop_scales=(0.08, 1.0), crop_ratios=(3 / 4, 4 / 3)):
        self.crop_scales = tuple(crop_scales)
        self.crop_ratios = tuple(crop_ratios)

    def affine_params(self, key, batch, hw):
        height, width = hw
        tries = 10
        k1, k2, k3, k4 = rng.split(key, 4)
        target_area = rng.uniform(k1, (batch, tries), *self.crop_scales) * (height * width)
        log_r = rng.uniform(k2, (batch, tries), math.log(self.crop_ratios[0]),
                            math.log(self.crop_ratios[1]))
        ar = torch.exp(log_r)
        ws = torch.round(torch.sqrt(target_area * ar))
        hs = torch.round(torch.sqrt(target_area / ar))
        ok = (ws > 0) & (ws <= width) & (hs > 0) & (hs <= height)
        first = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)  # the first try that fits
        any_ok = ok.any(dim=1)
        in_ratio = width / height
        if in_ratio < min(self.crop_ratios):
            fw, fh = width, round(width / min(self.crop_ratios))
        elif in_ratio > max(self.crop_ratios):
            fh, fw = height, round(height * max(self.crop_ratios))
        else:
            fw, fh = width, height
        w = torch.where(any_ok, ws.gather(1, first)[:, 0], float(fw))
        h = torch.where(any_ok, hs.gather(1, first)[:, 0], float(fh))
        iy = torch.floor(rng.uniform(k3, (batch,)) * (height - h + 1))
        jx = torch.floor(rng.uniform(k4, (batch,)) * (width - w + 1))
        iy = torch.where(any_ok, iy, torch.div(height - h, 2, rounding_mode="floor"))
        jx = torch.where(any_ok, jx, torch.div(width - w, 2, rounding_mode="floor"))
        # y_in = (y_out + 0.5) h / H - 0.5 + iy, written about the centre
        sy, sx = h / height, w / width
        z = torch.zeros_like(sy)
        cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
        oy = (cy + 0.5) * sy - 0.5 + iy - cy
        ox = (cx + 0.5) * sx - 0.5 + jx - cx
        return _matrix(sy, z, z, sx), torch.stack([oy, ox], dim=1)

    def __str__(self):
        return (f"RandomCropResize(crop_scales={self.crop_scales}, "
                f"crop_ratios={self.crop_ratios})")


class Resize(Transform):
    """Resize to (H, W): order 1 (antialiased linear, as
    :func:`ich_tpu_torch.ops.ct.resize`) for the image, order 0 for the mask
    (reference ``transforms.py:117-156``)."""

    def __init__(self, H: int = 256, W: int = 256):
        self.H, self.W = H, W

    def __call__(self, key, image, mask=None):
        img_b, sq = _ensure_batched(image)
        out = ct.resize(img_b, (img_b.shape[0], self.H, self.W) + tuple(img_b.shape[3:]), order=1)
        out = out[0] if sq else out
        if mask is None:
            return out
        mask_b, _ = _ensure_batched(mask)
        mout = ct.resize(mask_b, (mask_b.shape[0], self.H, self.W) + tuple(mask_b.shape[3:]),
                         order=0)
        return out, (mout[0] if sq else mout)

    def __str__(self):
        return f"Resize(H={self.H}, W={self.W})"


class GaussianBlur(Transform):
    """Random Gaussian blur with a sigma per sample (reference
    ``transforms.py:400-443``, ``skimage.filters.gaussian``): with
    probability ``p`` a sample is blurred by a normalised kernel of one
    fixed radius, ``ceil(4 max sigma)`` (17 taps at the default range), as
    two separable passes with edge padding; the whole batch runs as one
    grouped conv per pass, a kernel per sample and channel."""

    def __init__(self, p: float = 0.5, sigma: Tuple[float, float] = (0.1, 2.0)):
        self.p = p
        self.sigma = tuple(sigma)
        self.radius = max(1, int(math.ceil(4.0 * self.sigma[1])))

    def draw(self, key, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(apply, sigma) per sample on the host, from the two halves of
        ``split(key)``."""
        kp, ks = rng.split(key)
        return rng.bernoulli(kp, self.p, (batch,)), rng.uniform(ks, (batch,), *self.sigma)

    def kernels(self, apply: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
        """(B, 2 radius + 1) taps: the Gaussian, or a delta where a sample
        is not blurred."""
        xs = torch.arange(-self.radius, self.radius + 1, dtype=torch.float32, device=sig.device)
        k = torch.exp(-0.5 * (xs[None, :] / sig[:, None]) ** 2)
        k = k / torch.sum(k, dim=1, keepdim=True)
        delta = (xs == 0).to(torch.float32)
        return torch.where(apply[:, None], k, delta[None, :])

    def apply_params(self, image: torch.Tensor, apply: torch.Tensor,
                     sig: torch.Tensor) -> torch.Tensor:
        """The blur with given (B,) ``apply`` flags and sigmas."""
        img_b, sq = _ensure_batched(image)
        x = img_b if img_b.dim() == 4 else img_b[..., None]
        b, h, w, c = x.shape
        r = self.radius
        taps = self.kernels(apply, sig).repeat_interleave(c, dim=0)  # (B*C, K): sample, channel
        xg = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
        xg = F.conv2d(F.pad(xg, (0, 0, r, r), mode="replicate"), taps[:, None, :, None],
                      groups=b * c)
        xg = F.conv2d(F.pad(xg, (r, r, 0, 0), mode="replicate"), taps[:, None, None, :],
                      groups=b * c)
        out = xg.reshape(b, c, h, w).permute(0, 2, 3, 1)
        if img_b.dim() == 3:
            out = out[..., 0]
        return out[0] if sq else out

    def __call__(self, key, image, mask=None):
        img_b = _ensure_batched(image)[0]
        out = self.apply_params(image, *(_on(t, img_b) for t in self.draw(key, img_b.shape[0])))
        return (out, mask) if mask is not None else out

    def __str__(self):
        return f"GaussianBlur(sigma={self.sigma}, p={self.p})"


class AdjustBrightness(Transform):
    """Additive brightness jitter, clipped to [0, 1] (reference
    ``transforms.py:445-491``), on a batch of any rank: each sample, with
    probability ``p``, becomes ``clip(x + f, 0, 1)``, ``f`` uniform on
    [low, high)."""

    def __init__(self, p: float = 0.5, low: float = -0.3, high: float = 0.2):
        self.p, self.low, self.high = p, low, high

    def _factors(self, key, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(apply, factor) per sample on the host, from the two halves of
        ``split(key)``."""
        kp, kf = rng.split(key)
        return rng.bernoulli(kp, self.p, (batch,)), rng.uniform(kf, (batch,), self.low, self.high)

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

    def __call__(self, key, image, mask=None):
        img_b = _ensure_batched(image)[0]
        out = self.apply_factors(image, *(_on(t, img_b)
                                          for t in self._factors(key, img_b.shape[0])))
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


class RandomZCrop(Transform):
    """Random crop of ``Z`` slices along the last spatial axis of volumes
    (reference ``transforms.py:72-115``): (B, H, W, D) -> (B, H, W, Z), the
    start drawn per sample from [0, D - Z)."""

    def __init__(self, Z: int = 64):
        self.Z = Z

    def draw(self, key, batch: int, depth: int) -> torch.Tensor:
        """The (B,) starts on the host (``randint(key, (B,), 0, D - Z)``)."""
        return rng.randint(key, (batch,), 0, depth - self.Z)

    def crop(self, image: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
        """(B, H, W, D) (or one (H, W, D) volume) cropped at the (B,) starts
        ``z0``."""
        single = image.dim() == 3
        x = image[None] if single else image
        b, h, w, _ = x.shape[:4]
        idx = (z0[:, None] + torch.arange(self.Z, device=z0.device))
        idx = idx.reshape((b, 1, 1, self.Z) + (1,) * (x.dim() - 4))
        out = torch.gather(x, 3, idx.expand((b, h, w, self.Z) + tuple(x.shape[4:])))
        return out[0] if single else out

    def __call__(self, key, image, mask=None):
        b = 1 if image.dim() == 3 else image.shape[0]
        z0 = _on(self.draw(key, b, image.shape[-1] if image.dim() == 3 else image.shape[3]),
                 image)
        out = self.crop(image, z0)
        return (out, self.crop(mask, z0)) if mask is not None else out

    def __str__(self):
        return f"RandomZCrop(Z={self.Z})"


class RandomPatchSwap(Transform):
    """Context-restoration corruption (Chen 2019; reference
    ``transforms.py:672-759``): ``n`` times, two patches of h x w (a square
    with ``rotate``, each then turned by a random multiple of 90 degrees)
    change places, the same way in the image and the mask.

    The JAX package's algorithm: 10 candidate pairs per swap, the first
    whose patches do not overlap kept (the first candidate if none fits),
    and within a swap region 1 written, region 2 read again from the
    updated image, then written. :meth:`draw_geometry` draws every swap of
    the batch at once; :meth:`apply` loops over the ``n`` swaps only, each a
    gather and a scatter of S x S windows (S the largest side) of all
    images together in a zero-padded (H + S, W + S) buffer."""

    def __init__(
        self,
        n: int = 10,
        w: Union[int, Sequence[int]] = (10, 30),
        h: Union[int, Sequence[int]] = (10, 30),
        rotate: bool = False,
        tries: int = 10,
    ):
        self.n = n
        self.w = tuple(w) if isinstance(w, (list, tuple)) else (int(w), int(w) + 1)
        self.h = tuple(h) if isinstance(h, (list, tuple)) else (int(h), int(h) + 1)
        self.rotate = rotate
        self.tries = tries
        self.S = max(self.w[1], self.h[1])

    def draw_geometry(self, key, batch: int, hw: Tuple[int, int]):
        """(h, w, p1, p2, r1, r2) of every swap, on the host: (B, n) int64
        sizes, (B, n, 2) top-left corners (y, x) and (B, n) quarter turns
        (the patch from p2 turned by r1 goes to p1, the one from p1 turned
        by r2 to p2). The JAX package's key tree, vectorised: sample i of
        the batch takes ``split(key, B)[i]``, its swap j ``split(., n)[j]``,
        which splits into the keys of w, h, the candidates (one per try)
        and the turns."""
        H, W = hw
        shape = (batch, self.n)
        kw, kh, kp, kr = rng.split(rng.split(rng.split(key, batch), self.n), 4).unbind(-2)
        w = rng.randint(kw, (), self.w[0], self.w[1])
        h = w if self.rotate else rng.randint(kh, (), self.h[0], self.h[1])
        cand = rng.uniform(rng.split(kp, self.tries), (4,))  # (B, n, tries, 4)
        span = torch.stack([H - h, W - w], dim=-1)[:, :, None, :].to(torch.float32)
        p1 = torch.floor(cand[..., :2] * span).long()  # (B, n, tries, 2)
        p2 = torch.floor(cand[..., 2:] * span).long()
        d = (p1 - p2).abs()
        ok = ~((d[..., 0] <= h[..., None]) & (d[..., 1] <= w[..., None]))
        first = torch.argmax(ok.to(torch.uint8), dim=-1)[..., None, None].expand(batch, self.n, 1, 2)
        p1, p2 = p1.gather(2, first)[:, :, 0], p2.gather(2, first)[:, :, 0]
        if self.rotate:
            r1 = rng.randint(kr, (), 0, 4)
            r2 = rng.randint(rng.fold_in(kr, 1), (), 0, 4)
        else:
            r1 = r2 = torch.zeros(shape, dtype=torch.long)
        return h, w, p1, p2, r1, r2

    def _turn_index(self, h: torch.Tensor, k: torch.Tensor):
        """(B, n, S, S) row and column indices that read the top-left h x h
        block of an S x S window turned k quarter turns (``rot90``'s
        direction) back into the top-left corner."""
        a = torch.arange(self.S, device=h.device)
        i, j = a[:, None], a[None, :]
        last, k = h[..., None, None] - 1, k[..., None, None]
        rows = torch.where(k == 0, i, torch.where(k == 1, j, torch.where(k == 2, last - i,
                                                                         last - j)))
        cols = torch.where(k == 0, j, torch.where(k == 1, last - i, torch.where(k == 2, last - j,
                                                                              i)))
        return rows.clamp(0, self.S - 1), cols.clamp(0, self.S - 1)

    def apply(self, image: torch.Tensor, geometry, mask: Optional[torch.Tensor] = None):
        """The swaps of ``geometry`` (as :meth:`draw_geometry` returns it)
        on a (B, H, W[, C]) batch and its mask."""
        h, w, p1, p2, r1, r2 = (_on(g, image) for g in geometry)
        img_b, sq = _ensure_batched(image)
        x = img_b if img_b.dim() == 4 else img_b[..., None]
        ci = x.shape[-1]
        if mask is not None:
            mask_b, _ = _ensure_batched(mask)
            mk = mask_b if mask_b.dim() == 4 else mask_b[..., None]
            x = torch.cat([x, mk.to(x.dtype)], dim=-1)
        b, H, W, _ = x.shape
        S = self.S
        xp = F.pad(x, (0, 0, 0, S, 0, S))
        a = torch.arange(S, device=x.device)
        bi = torch.arange(b, device=x.device)[:, None, None]
        valid = ((a[:, None] < h[..., None, None]) & (a[None, :] < w[..., None, None]))[..., None]
        t1, t2 = self._turn_index(h, r1), self._turn_index(h, r2)

        def window(p):
            return p[:, 0, None, None] + a[:, None], p[:, 1, None, None] + a[None, :]

        for s in range(self.n):
            (y1, x1), (y2, x2) = window(p1[:, s]), window(p2[:, s])
            patch1, patch2 = xp[bi, y1, x1], xp[bi, y2, x2]
            to1 = patch2[bi, t1[0][:, s], t1[1][:, s]]
            to2 = patch1[bi, t2[0][:, s], t2[1][:, s]]
            xp[bi, y1, x1] = torch.where(valid[:, s], to1, patch1)
            xp[bi, y2, x2] = torch.where(valid[:, s], to2, xp[bi, y2, x2])
        out = xp[:, :H, :W]
        img_out = out[..., :ci] if img_b.dim() == 4 else out[..., 0]
        img_out = img_out[0] if sq else img_out
        if mask is None:
            return img_out
        mask_out = out[..., ci:] if mask_b.dim() == 4 else out[..., ci]
        return img_out, (mask_out[0] if sq else mask_out)

    def __call__(self, key, image, mask=None):
        img_b = _ensure_batched(image)[0]
        geometry = self.draw_geometry(key, img_b.shape[0], tuple(img_b.shape[1:3]))
        return self.apply(image, geometry, mask)

    def __str__(self):
        return (f"RandomPatchSwap(n={self.n}, w={list(self.w)}, h={list(self.h)}, "
                f"rotate={self.rotate})")


class ToTensor(Transform):
    """A channel axis on the image and mask (the reference's
    ``ToTorchTensor``, ``transforms.py:634-670``, converts host arrays to
    torch; here the batch is a tensor already)."""

    def __call__(self, key, image, mask=None):
        img_b, sq = _ensure_batched(image)
        if img_b.dim() == 3:
            img_b = img_b[..., None]
        out = img_b[0] if sq else img_b
        if mask is None:
            return out
        mask_b, msq = _ensure_batched(mask)
        if mask_b.dim() == 3:
            mask_b = mask_b[..., None]
        return out, (mask_b[0] if msq else mask_b)

    def __str__(self):
        return "ToTensor()"


class Compose(Transform):
    """Mask-aware pipeline with affine fusion (reference
    ``transforms.py:21-70``: image-only or pairs, ``+`` concat, ``__str__``).

    Each run of consecutive :class:`AffineTransform` instances becomes one
    warp, composed on the host; transform i draws from ``split(key,
    len(transforms))[i]``, as in the JAX package."""

    def __init__(self, *transforms: Transform):
        self.transforms = tuple(transforms)

    def __call__(self, key, image, mask=None):
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

        keys = iter(rng.split(key, max(1, len(self.transforms))))
        for seg in segments:
            if not isinstance(seg, tuple):
                out = seg(next(keys), image, mask)
                image, mask = out if mask is not None else (out, None)
                continue
            img_b = _ensure_batched(image)[0]
            b, hw = img_b.shape[0], tuple(img_b.shape[1:3])
            m, o = identity_affine(b)
            for t in seg:
                mt, ot = t.affine_params(next(keys), b, hw)
                m, o = compose_affine(m, o, mt, ot)
            out = _warp_pair(image, mask, _on(m, img_b), _on(o, img_b))
            image, mask = out if mask is not None else (out, None)
        return (image, mask) if mask is not None else image

    def __str__(self):
        names = "\n".join("    " + str(t) for t in self.transforms)
        return f"Compose(\n{names}\n)"


def build_pipeline(spec: dict) -> Compose:
    """A :class:`Compose` from a JSON config dict {TransformName: kwargs}
    (the reference's ``getattr(tf, name)(**kwargs)``,
    ``UNet2D_scripts.py:128``), through the registry."""
    return Compose(*(TRANSFORMS.build(name, **(kw or {})) for name, kw in spec.items()))


for _cls in (Translate, Rotate, Scale, HFlip, VFlip, Resize, GaussianBlur, AdjustBrightness,
             AdjustContrast, RandomCropResize, RandomZCrop, RandomPatchSwap, ToTensor):
    TRANSFORMS.add(_cls.__name__, _cls)
TRANSFORMS.add("ToTorchTensor", ToTensor)
# the reference config's typo (GlobalContrastive_config.json), accepted as the JAX package does
TRANSFORMS.add("AdjustBrighness", AdjustBrightness)
