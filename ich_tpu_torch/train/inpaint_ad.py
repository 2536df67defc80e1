"""Grid-inpainting anomaly detection (counterpart of
:mod:`ich_tpu.train.inpaint_ad`; reference
``InpaintAnomalyDetector.py``).

A slice is inpainted under shifted checkerboard grids
(:func:`make_grid_masks`); each pixel's inpainting errors over the grids
that cover it give a mean and a standard deviation (masked sums on the
device); the pixel's score is the KL divergence of N(mean, std) from the
null N(0, sigma0) (sigma0 the first quartile of the stds), or the
Wasserstein-1 distance of its sorted errors to a sorted null sample; the
scores are hysteresis-thresholded at q75 + alpha * IQR; the anomalies are
inpainted away one coarse cell at a time and the detection repeats on the
corrected slice, removing what now looks normal, with closing and opening
between passes. ``robust_anomaly_detect`` runs ``detect`` on the slice, its
mirror and rotations (scipy on the host, as in the JAX package) and
thresholds the mean of the back-transformed masks.

The error moments, the KL and W1 maps, the quantile thresholds and the
morphology run on the detector's device. ``inpaint_fn(images (B, H, W, 1),
masks (B, H, W, 1)) -> composite`` takes and returns numpy arrays (or
returns a tensor), as ``SNPatchGAN.inpaint`` does: the slice makes one host
round trip per grid batch and per anomaly cell. The cell order of every
pass is shuffled by ONE ``np.random.default_rng(seed)`` per ``detect``.
W1's null sample is the JAX package's: ``normal(key, (k, H, W))`` times
sigma0, ``key`` being ``PRNGKey(seed)`` itself for the first detection and
``fold_in(PRNGKey(seed), i + 1)`` for the i-th cleanup, drawn on the
detector's device (:mod:`ich_tpu_torch.utils.rng`).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.ops import morphology as morph
from ich_tpu_torch.utils import rng
from ich_tpu_torch.train.segmentation2d import resolve_device

logger = logging.getLogger(__name__)


def make_grid_masks(shape: Tuple[int, int], hole_size=(32, 32), step: int = 4) -> np.ndarray:
    """Shifted checkerboard grid masks (N, H, W) float32; every pixel is
    covered by the same number of grids (reference ``_get_grid_mask:229-259``)."""
    h, w = shape
    hh, hw = hole_size
    # +3 tiles: with dim % hole above the shift step, a +2 grid runs short
    a = np.zeros(h // hh + 3)
    a[::2] = 1
    b = np.zeros(w // hw + 3)
    b[::2] = 1
    grid = np.repeat(np.repeat(np.outer(a, b), hh, axis=0), hw, axis=1)
    masks = [grid[i: i + h, j: j + w]
             for i in range(0, 2 * hh, step) for j in range(0, 2 * hw, step)]
    return np.stack(masks).astype(np.float32)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class InpaintAnomalyDetector:
    """Grid-inpainting anomaly detector around a trained generator
    (``inpaint_fn``, e.g. ``SNPatchGAN.inpaint``); the JAX detector's
    arguments, and ``device`` for its maps (``cuda`` by default)."""

    def __init__(
        self,
        inpaint_fn: Callable,
        grid_hole: Tuple[int, int] = (32, 32),
        grid_step: int = 16,
        batch_size: int = 16,
        use_wasserstein: bool = False,
        alpha01: float = 1.5,
        alpha02: float = 3.0,
        alpha1: float = 1.5,
        alpha2: float = 3.0,
        n_iter: int = 3,
        early_stop: bool = True,
        tol: int = 25,
        inpainting_dilation_radius: Tuple[int, int] = (3, 3),
        grid_anomaly_inpaint=((64, 64), (64, 64)),
        cleaning_closing_radius: int = 2,
        cleaning_opening_radius: int = 2,
        shuffle_AD_mask_loader: bool = True,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.inpaint_fn = inpaint_fn
        self.grid_hole = grid_hole
        self.grid_step = grid_step
        self.batch_size = batch_size
        self.use_wasserstein = use_wasserstein
        if alpha01 > alpha02 or alpha1 > alpha2:
            raise ValueError("hysteresis thresholds need alpha01 <= alpha02 and alpha1 <= alpha2")
        self.alpha01, self.alpha02 = alpha01, alpha02
        self.alpha1, self.alpha2 = alpha1, alpha2
        self.shuffle_AD_mask_loader = shuffle_AD_mask_loader
        self.n_iter = n_iter
        self.early_stop = early_stop
        self.tol = tol
        self.inpainting_dilation_radius = inpainting_dilation_radius
        self.grid_anomaly_inpaint = grid_anomaly_inpaint
        self.cleaning_closing_radius = cleaning_closing_radius
        self.cleaning_opening_radius = cleaning_opening_radius
        self.seed = seed

    # -- device subroutines ---------------------------------------------------

    def _dev(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _error_moments(self, image: torch.Tensor, grids: torch.Tensor):
        """Per-pixel (mean, std) of the inpainting error over the grids that
        cover each pixel, with the masked errors (N, H, W) and the grids.
        ``image`` (H, W) and ``grids`` (N, H, W) on the device."""
        h, w = image.shape
        bs, n = self.batch_size, grids.shape[0]
        n_pad = int(math.ceil(n / bs) * bs)
        if n_pad != n:
            grids = torch.cat([grids, grids.new_zeros((n_pad - n, h, w))])
        img_b = image[None, ..., None].expand(bs, h, w, 1)
        img_host = _numpy(img_b)
        errs = []
        for i in range(0, n_pad, bs):
            g = grids[i: i + bs][..., None]
            out = self._dev(self.inpaint_fn(img_host, _numpy(g)))
            errs.append((out - img_b)[..., 0] * g[..., 0])
        err = torch.cat(errs)[:n]
        g = grids[:n]
        count = torch.clamp(torch.sum(g, dim=0), min=1.0)
        mean = torch.sum(err, dim=0) / count
        var = torch.sum((err - mean[None]) ** 2 * g, dim=0) / count
        return mean, torch.sqrt(var), err, g

    @staticmethod
    def kl_divergence_normal(p1, p2, eps: float = 1e-12) -> torch.Tensor:
        """KL of per-pixel normals (reference ``:332-346``):
        log(s1/s2) + (s2^2 + (m2-m1)^2)/(2 s1^2) - 1/2."""
        (m1, s1), (m2, s2) = p1, p2
        return (torch.log(s1 / (s2 + eps) + eps) + (s2 ** 2 + (m2 - m1) ** 2) / (2 * s1 ** 2 + eps)
                - 0.5)

    @staticmethod
    def pixelwise_wasserstein_1(p0_sorted: torch.Tensor, err: torch.Tensor, grid: torch.Tensor,
                                k: int) -> torch.Tensor:
        """W1 between each pixel's errors and a null sample: the N grid
        errors sorted (uncovered ones as +inf), the first k against the
        sorted null draws."""
        masked = torch.where(grid > 0, err, torch.full_like(err, float("inf")))
        s = torch.sort(masked, dim=0).values[:k]
        return torch.mean(torch.abs(s - p0_sorted), dim=0)

    def _null_normals(self, key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard normals for W1's null sample, ``normal(key, shape)`` on
        the detector's device."""
        return rng.normal(key, shape, self.device)

    def _distance_map(self, image: torch.Tensor, grids: torch.Tensor, key: torch.Tensor
                      ) -> torch.Tensor:
        mean, std, err, g = self._error_moments(image, grids)
        sigma0 = torch.clamp(torch.quantile(std.reshape(-1), 0.25), min=1e-6)
        std = torch.clamp(std, min=1e-6)
        if self.use_wasserstein:
            k = int(grids.sum(dim=0).min())  # samples per pixel
            p0 = self._null_normals(key, (k,) + tuple(image.shape)) * sigma0
            return self.pixelwise_wasserstein_1(torch.sort(p0, dim=0).values, err, g, k)
        p0 = (torch.zeros_like(mean), torch.ones_like(std) * sigma0)
        return self.kl_divergence_normal(p0, (mean, std))

    def _threshold(self, dmap: torch.Tensor, a_low: float, a_high: float) -> np.ndarray:
        q = torch.quantile(dmap.reshape(-1), torch.tensor([0.25, 0.75], device=dmap.device))
        q25, q75 = q[0], q[1]
        t_low = q75 + (q75 - q25) * a_low
        t_high = q75 + (q75 - q25) * a_high
        return _numpy(morph.hysteresis_threshold(dmap, t_low, t_high)) > 0

    def _dilate(self, ma: np.ndarray, radius: int) -> np.ndarray:
        return _numpy(morph.dilation(self._dev(ma), 2 * radius + 1)) > 0

    def _inpaint_anomaly(self, image: np.ndarray, mask: np.ndarray, grid_dim,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Inpaint the anomaly region one coarse grid cell at a time
        (reference ``_inpaint_anomaly:371-405``), the cells in a shuffled
        order with ``shuffle_AD_mask_loader``."""
        h, w = image.shape
        gh, gw = grid_dim if grid_dim is not None else (h, w)
        cells = [(i, j) for i in range(0, h, gh) for j in range(0, w, gw)]
        if self.shuffle_AD_mask_loader and len(cells) > 1:
            rng = rng or np.random.default_rng(self.seed)
            rng.shuffle(cells)
        im = image[None, ..., None]
        for i, j in cells:
            cell = np.zeros((h, w), np.float32)
            cell[i: i + gh, j: j + gw] = 1
            m = (cell * mask).astype(np.float32)
            if m.sum() == 0:
                continue
            im = _numpy(self.inpaint_fn(im, m[None, ..., None]))
        return np.asarray(im)[0, ..., 0]

    # -- main algorithm ----------------------------------------------------------

    def detect(self, image: np.ndarray, save_dir: Optional[str] = None,
               verbose: bool = False) -> np.ndarray:
        """Detect anomalies in one (H, W) slice; returns a boolean mask."""
        image = np.asarray(image, dtype=np.float32)
        if image.ndim == 3:
            image = image[..., 0] if image.shape[-1] in (1,) else image[0]
        grids = self._dev(make_grid_masks(image.shape, self.grid_hole, self.grid_step))
        # one generator threaded through every pass: the cell order changes
        # from pass to pass, as the reference's shuffled DataLoader's does
        shuffle_rng = np.random.default_rng(self.seed)
        key = rng.prng_key(self.seed)

        d0 = self._distance_map(self._dev(image), grids, key)
        ma = self._threshold(d0, self.alpha01, self.alpha02)
        if verbose:
            logger.info("Anomalous pixel detected : %d", int(ma.sum()))
        ma_dil = self._dilate(ma, self.inpainting_dilation_radius[0])
        corrected = self._inpaint_anomaly(image, ma_dil, self.grid_anomaly_inpaint[0],
                                          rng=shuffle_rng)
        if save_dir:
            self._save_step(save_dir, 0, d0, ma, corrected)

        ma_prev = ma
        for i in range(self.n_iter):
            di = self._distance_map(self._dev(corrected), grids, rng.fold_in(key, i + 1))
            ma_normal = self._threshold(di, self.alpha1, self.alpha2)
            ma = ma & ~ma_normal
            ma = _numpy(morph.opening(
                morph.closing(self._dev(ma), 2 * self.cleaning_closing_radius + 1),
                2 * self.cleaning_opening_radius + 1)) > 0
            ma_dil = self._dilate(ma, self.inpainting_dilation_radius[1])
            corrected = self._inpaint_anomaly(image, ma_dil, self.grid_anomaly_inpaint[1],
                                              rng=shuffle_rng)
            if verbose:
                logger.info("| Step %03d/%03d | Remaining anomalous pixels : %d |",
                            i + 1, self.n_iter, int(ma.sum()))
            if save_dir:
                self._save_step(save_dir, i + 1, di, ma, corrected)
            if self.early_stop and (ma_prev ^ ma).sum() < self.tol and i < self.n_iter - 1:
                break
            ma_prev = ma
        return ma

    def _save_step(self, save_dir, i, dmap, ma, corrected=None) -> None:
        """Per-step PNGs with the reference's conventions
        (``InpaintAnomalyDetector.py:168-171,215-218``): ``D{i}.png`` =
        sqrt(D + 1e-12) rescaled min -> 0, max -> 255; ``mA{i}.png`` = mask x
        255; ``im_corrected_{i}.png`` = the corrected slice rescaled."""
        os.makedirs(save_dir, exist_ok=True)

        def rescale_u8(x):
            x = np.asarray(x, dtype=np.float64)
            x = (x - x.min()) / max(x.max() - x.min(), 1e-12)
            return (x * 255).astype(np.uint8)

        save_png_gray(os.path.join(save_dir, f"D{i}.png"),
                      rescale_u8(np.sqrt(_numpy(dmap) + 1e-12)))
        save_png_gray(os.path.join(save_dir, f"mA{i}.png"), (ma * 255).astype(np.uint8))
        if corrected is not None:
            save_png_gray(os.path.join(save_dir, f"im_corrected_{i}.png"), rescale_u8(corrected))


def robust_anomaly_detect(
    image: np.ndarray,
    ad_inpainter: InpaintAnomalyDetector,
    angles_list: List[float] = (-15.0, -7.5, 7.5, 15.0),
    flip: bool = True,
    lower_frac: float = 0.5,
    upper_frac: float = 0.75,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    return_intermediate: bool = False,
):
    """Detections on the slice, its left-right mirror and its rotations
    (and their mirrors), each mapped back, averaged, and the mean map
    hysteresis-thresholded on the device (reference
    ``robust_anomaly_detect:407-481``). Returns (final, anomaly_map[,
    masks])."""
    import scipy.ndimage as ndi

    image = np.asarray(image, dtype=np.float32)
    masks = [ad_inpainter.detect(image, save_dir=_sub(save_dir, "normal"), verbose=verbose)]
    if flip:
        m = ad_inpainter.detect(np.flip(image, axis=1), save_dir=_sub(save_dir, "h-flipped"),
                                verbose=verbose)
        masks.append(np.flip(m, axis=1))
    for ang in angles_list:
        rot = ndi.rotate(image, ang, axes=(1, 0), reshape=False, order=1)
        m = ad_inpainter.detect(rot, save_dir=_sub(save_dir, f"rot{ang}"), verbose=verbose)
        masks.append(ndi.rotate(m.astype(float), -ang, axes=(1, 0), reshape=False, order=0) > 0.5)
        if flip:
            m = ad_inpainter.detect(np.flip(rot, axis=1), save_dir=_sub(save_dir, f"rot{ang}-flip"),
                                    verbose=verbose)
            m = np.flip(m, axis=1)
            masks.append(ndi.rotate(m.astype(float), -ang, axes=(1, 0), reshape=False,
                                    order=0) > 0.5)

    anomaly_map = np.stack([m.astype(float) for m in masks], axis=0).mean(axis=0)
    final = _numpy(morph.hysteresis_threshold(
        torch.as_tensor(anomaly_map, dtype=torch.float32).to(ad_inpainter.device),
        lower_frac, upper_frac)) > 0
    if return_intermediate:
        return final, anomaly_map, masks
    return final, anomaly_map


def _sub(save_dir, name):
    return os.path.join(save_dir, name) if save_dir else None
