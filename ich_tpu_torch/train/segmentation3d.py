"""3D patch training, sliding-window inference and evaluation
(counterpart of :class:`ich_tpu.train.segmentation3d.UNet3D`).

``train`` draws random fixed-size patches from whole volumes, with
probability ``pos_frac`` centred on a positive voxel: from a
device-resident stack (:class:`ich_tpu_torch.data.patch_sampler.
DevicePatchSampler`), or on the host (:func:`sample_patches`) when the
stack would not fit its budget or a mask is not binary. Each step draws
from its jax.random key as the JAX trainer's ``run_step`` does: with the
device sampler ``ks, key = split(key)`` and the patches from ``ks``, the
host sampler from its numpy generator and the key left whole; then
:class:`UNet2D`'s step (``aug_key, drop_key = split(key)``: the
augmentation from the first, dropout from the second; forward, loss,
backward, Adam) on (B, D, H, W) patches; the epoch hook validates with
``evaluate``.

A (D, H, W) HU volume is copied to the device, windowed there, segmented
by Gaussian-blended sliding-window inference (:mod:`ich_tpu_torch.ops.
sliding_window`) with the net in eval mode, and thresholded; only the uint8
mask, or for ``evaluate`` four confusion counts, come back.
``segment_volumes`` and ``evaluate`` keep two volumes queued on the device
before they fetch the oldest result. Under ``torch.profiler`` the copy to
the device shows as an ``upload`` range and the patch draw as ``sample``;
the sliding window has its own ranges.

With ``mesh=`` the trainer is data-parallel as :class:`UNet2D` is: every
rank draws the global batch's patches from the same draws (both samplers),
augments them whole and keeps its slice, and draws its rows of the
global batch's dropout masks; the GroupNorm net needs no statistics sync.
With more than one rank, ``segment_volumes`` of same-shaped volumes runs
one volume per rank through :func:`ich_tpu_torch.parallel.
volume_parallel_map`, each through the serial path's window, sliding
window and threshold, and gathers the uint8 masks.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import timedelta
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data import patch_sampler as ps
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops.metrics import (
    batch_binary_confusion_matrix,
    dice_from_counts,
    iou_from_counts,
)
from ich_tpu_torch.ops.sliding_window import sliding_window_inference
from ich_tpu_torch.train.loop import fit
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.train.segmentation2d import UNet2D, eval_mode, write_csv
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRAINERS
from ich_tpu_torch.utils.pipeline import fetch_pipelined

logger = logging.getLogger(__name__)

CSV_COLUMNS = ("volID", "label", "TP", "TN", "FP", "FN", "Dice", "IoU")


# the JAX package's budget for the device-resident patch stack
DEVICE_SAMPLER_BUDGET = 4 << 30


# copied from ich_tpu/train/segmentation3d.py (sample_patches, _pad_to)
def sample_patches(
    rng: np.random.Generator,
    dataset: VolumeDataset3D,
    batch_size: int,
    patch_size: Sequence[int],
    pos_frac: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side random 3D patch extraction (pure memcpy; the heavy
    augmentation runs on device). With probability ``pos_frac`` the patch is
    centered on a random positive voxel (foreground oversampling — the
    standard answer to ICH's extreme class imbalance)."""
    pd, ph, pw = patch_size
    imgs = np.empty((batch_size, pd, ph, pw), dtype=np.float32)
    msks = np.empty((batch_size, pd, ph, pw), dtype=np.float32)
    n = len(dataset)
    # lazy per-volume positive-voxel index cache (np.nonzero over a full
    # volume per sampled patch would dominate the host loop)
    cache = getattr(dataset, "_pos_cache", None)
    if cache is None:
        cache = {}
        dataset._pos_cache = cache
    for b in range(batch_size):
        vi = int(rng.integers(0, n))
        vol, mask = dataset.volumes[vi], dataset.masks[vi]
        vol_p, mask_p = _pad_to(vol, patch_size), _pad_to(mask, patch_size)
        d, h, w = vol_p.shape
        if pos_frac > 0 and rng.uniform() < pos_frac and mask_p.sum() > 0:
            if vi not in cache:
                cache[vi] = np.stack(np.nonzero(mask_p), axis=1)
            pos = cache[vi]
            c = pos[int(rng.integers(0, len(pos)))]
            start = [
                int(np.clip(c[0] - pd // 2, 0, d - pd)),
                int(np.clip(c[1] - ph // 2, 0, h - ph)),
                int(np.clip(c[2] - pw // 2, 0, w - pw)),
            ]
        else:
            start = [
                int(rng.integers(0, d - pd + 1)),
                int(rng.integers(0, h - ph + 1)),
                int(rng.integers(0, w - pw + 1)),
            ]
        sl = tuple(slice(s, s + p) for s, p in zip(start, patch_size))
        imgs[b], msks[b] = vol_p[sl], mask_p[sl]
    return imgs, msks


def _pad_to(vol: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    pads = [(0, max(0, p - s)) for p, s in zip(patch_size, vol.shape)]
    if any(p[1] for p in pads):
        return np.pad(vol, pads)
    return vol


class UNet3D(UNet2D):
    """Train a 3D U-Net on random patches; segment and score (D, H, W)
    volumes by sliding window. The constructor takes the JAX trainer's
    arguments, then :class:`UNet2D`'s (``n_epoch``, ``batch_size``, ``lr``,
    ``loss_fn``, ``augment_fn``, ``seed``, ``checkpoint_freq``, ``device``,
    ...). ``batch_size`` is the patches per train step, ``sw_batch_size``
    the patches per network call of the sliding window (``None``: its
    default, 128 on the coset path). ``on_device_sampling``: ``"auto"``
    takes the device sampler when its stack fits
    ``DEVICE_SAMPLER_BUDGET`` and every mask is binary, the host sampler
    otherwise; ``True`` and ``False`` force one or the other."""

    _spatial_ndim = 3

    def __init__(
        self,
        unet: nn.Module,
        patch_size: Sequence[int] = (64, 128, 128),
        steps_per_epoch: int = 100,
        pos_frac: float = 0.5,
        sw_overlap: float = 0.5,
        sw_batch_size: Optional[int] = None,
        on_device_sampling="auto",
        **kwargs,
    ):
        if on_device_sampling not in ("auto", True, False):
            raise ValueError(f"on_device_sampling must be 'auto', True or False, "
                             f"got {on_device_sampling!r}")
        super().__init__(unet, **kwargs)
        self.patch_size = tuple(patch_size)
        self.steps_per_epoch_cfg = steps_per_epoch
        self.pos_frac = pos_frac
        self.sw_overlap = sw_overlap
        self.sw_batch_size = sw_batch_size
        self.on_device_sampling = on_device_sampling
        self.outputs["eval"]["iou"] = {"all": None, "positive": None}

    # -- training -------------------------------------------------------------

    def _device_sampler(self, dataset: VolumeDataset3D) -> Optional[ps.DevicePatchSampler]:
        """The device sampler, or None for the host sampler, chosen before
        any upload; a forced device sampler raises on masks that are not
        binary."""
        if self.on_device_sampling is False:
            logger.info("Host patch sampling (on_device_sampling=False).")
            return None
        if self.on_device_sampling == "auto":
            est = ps.estimate_hbm_bytes(dataset, self.patch_size)
            if est > DEVICE_SAMPLER_BUDGET:
                logger.info("Host patch sampling: the device stack would take %.1f MB "
                            "(> %.0f MB budget).", est / 2**20, DEVICE_SAMPLER_BUDGET / 2**20)
                return None
            if not all(ps.is_binary_mask(m) for m in dataset.masks):
                logger.info("Host patch sampling: a mask is not binary.")
                return None
        sampler = ps.DevicePatchSampler(dataset, self.patch_size, self.pos_frac,
                                        device=self.device)
        logger.info("On-device patch sampling: %.1f MB on %s.", sampler.hbm_bytes / 2**20,
                    self.device)
        return sampler

    def _sample_step(self, state, draw: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                     key: torch.Tensor, device_sampler: bool = True) -> torch.Tensor:
        """One training step from the step's key: with the device sampler
        the (images, masks) patches come from ``draw(ks)``, ``ks, key =
        split(key)``; with the host sampler from ``draw(None)`` and the key
        stays whole. Then :meth:`UNet2D._step` from ``key``."""
        ks = None
        if device_sampler:
            with torch.profiler.record_function("keys"):
                ks, key = rng.split(key)
        with torch.profiler.record_function("sample"):
            images, masks = draw(ks)
        return self._step(state, images, masks, key)

    def train(
        self,
        dataset: VolumeDataset3D,
        valid_dataset: Optional[VolumeDataset3D] = None,
        checkpoint_path: Optional[str] = None,
    ) -> None:
        state = self._train_state(self.steps_per_epoch_cfg)
        sampler = self._device_sampler(dataset)

        # the host sampler's rng is seeded with seed + the first epoch of
        # this run, as the JAX trainer does (a resumed run draws anew)
        rng_box = {}

        def batches_fn(epoch):
            if "rng" not in rng_box:
                rng_box["rng"] = np.random.default_rng(self.seed + epoch)
            self.unet.train()
            return range(self.steps_per_epoch_cfg)

        def draw(ks):
            if sampler is not None:
                return sampler(ks, self.batch_size)
            return tuple(self._to_device(a) for a in sample_patches(
                rng_box["rng"], dataset, self.batch_size, self.patch_size, self.pos_frac))

        def run_step(state, _b, key):
            return self._sample_step(state, draw, key, sampler is not None)

        def epoch_hook(state, epoch, mean_losses, epoch_time):
            mean_loss = float(mean_losses) if mean_losses is not None else 0.0
            valid_str = ""
            v_all = v_pos = None
            if valid_dataset is not None:
                self.evaluate(valid_dataset, print_to_logger=False)
                v_all = self.outputs["eval"]["dice"]["all"]
                v_pos = self.outputs["eval"]["dice"]["positive"]
                valid_str = f"| Valid Dice: {v_all:.5f} | Valid Dice (Positive): {v_pos:.5f} "
            logger.info(
                "\t| Epoch: %03d/%03d | Train time: %s | Train Loss: %.6f %s|",
                epoch + 1, self.n_epoch,
                timedelta(seconds=int(epoch_time)), mean_loss, valid_str,
            )
            return [epoch + 1, mean_loss, v_all, v_pos]

        try:
            history, wall = fit(
                state, run_step, batches_fn, self.n_epoch, epoch_hook, seed=self.seed,
                checkpoint_path=checkpoint_path, checkpoint_freq=self.checkpoint_freq,
                name="3D U-Net (patch-based)", mesh=self.mesh,
            )
        finally:
            self.unet.eval()
            set_dropout_keys(self.unet, None)
        self.outputs["train"]["time"] = wall
        self.outputs["train"]["evolution"] = history

    # -- device work ------------------------------------------------------------

    def _upload(self, vol_data: np.ndarray) -> torch.Tensor:
        """A float32 copy of ``vol_data`` on the device."""
        with torch.profiler.record_function("upload"):
            arr = np.asarray(vol_data)
            if self.device.type == "cuda":
                # pinned + non_blocking: the copy does not wait for queued work
                host = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
                host.numpy()[...] = arr
                return host.to(self.device, non_blocking=True)
            return torch.from_numpy(np.array(arr, dtype=np.float32))

    def _enqueue(self, vol_data: np.ndarray, window: Optional[Tuple[float, float]],
                 threshold: float) -> torch.Tensor:
        """Upload, window and segment one volume with the net in eval mode;
        returns the (D, H, W) uint8 {0, 1} mask on the device, its work
        queued."""
        vol = self._upload(vol_data)
        if window is not None:
            vol = ct.window_ct(vol, window[0], window[1])
        with torch.inference_mode(), eval_mode(self.unet):
            probs = sliding_window_inference(
                self.unet, vol, patch_size=self.patch_size, overlap=self.sw_overlap,
                batch_size=self.sw_batch_size)
            return (probs[..., 0] >= threshold).to(torch.uint8)

    # -- inference ----------------------------------------------------------------

    def segment_volume(
        self,
        vol_data: np.ndarray,
        affine: Optional[np.ndarray] = None,
        save_fn: Optional[str] = None,
        window: Optional[Tuple[float, float]] = None,
        threshold: float = 0.5,
        return_pred: bool = True,
        **_: object,
    ):
        """Window on the device, then sliding-window segmentation of a raw
        (D, H, W) volume. Returns the uint8 {0, 255} mask if
        ``return_pred``; optionally writes it as NIfTI."""
        pred = self._finish(self._fetch(self._enqueue(vol_data, window, threshold)), affine,
                            save_fn)
        if return_pred:
            return pred

    segement_volume = segment_volume  # the reference's name

    def segment_volumes(
        self,
        volumes: Iterable[np.ndarray],
        affines: Optional[Sequence] = None,
        save_fns: Optional[Sequence[Optional[str]]] = None,
        window: Optional[Tuple[float, float]] = None,
        threshold: float = 0.5,
        return_preds: bool = False,
        pipeline_depth: int = 2,
        **_: object,
    ):
        """Pipelined multi-volume segmentation: up to ``pipeline_depth``
        volumes are queued on the device before the oldest mask is fetched
        (a volume's input, patch stack and probabilities take some 0.6 GB at
        64x512x512, so the queue is bounded). ``volumes`` is consumed
        lazily, except on a mesh of more than one rank, where same-shaped
        volumes go one per rank and every rank returns every mask; only
        rank 0 writes files."""
        return self._segment_all(lambda v: self._enqueue(v, window, threshold), volumes,
                                 affines, save_fns, return_preds, pipeline_depth)

    def predict_volume(self, vol: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """(D, H, W) preprocessed volume -> uint8 {0, 1} mask."""
        return self._fetch(self._enqueue(vol, None, threshold))

    # -- evaluation ---------------------------------------------------------------

    def evaluate(
        self,
        dataset: VolumeDataset3D,
        print_to_logger: bool = True,
        save_path: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """Sliding-window inference per volume, threshold 0.5, and the
        volume's TN/FP/FN/TP counted on the device; four numbers per volume
        come back. Fills ``outputs["eval"]`` (time, Dice and IoU over all
        volumes and over the ICH-positive ones) and returns the per-volume
        rows as a dict of numpy columns (``CSV_COLUMNS``); ``save_path``
        gets them as ``volume_prediction_scores.csv`` in pandas'
        ``to_csv`` layout (a leading unnamed index column)."""
        if print_to_logger:
            logger.info("Start evaluating the 3D U-Net.")
        start_time = time.time()

        def counts_iter():
            for vi in range(len(dataset)):
                pred = self._enqueue(dataset.volumes[vi], None, 0.5)
                mask = self._upload(dataset.masks[vi])
                tn, fp, fn, tp = batch_binary_confusion_matrix(pred[None], mask[None])
                yield torch.stack([tn[0], fp[0], fn[0], tp[0]])

        counts = np.asarray(list(fetch_pipelined(counts_iter(), depth=2)), np.float64)
        counts = counts.reshape(-1, 4)
        tn, fp, fn, tp = counts.T
        rows = {
            "volID": np.asarray([int(v) for v in dataset.vol_ids], np.int64),
            "label": np.asarray([int(m.max() > 0) for m in dataset.masks], np.int64),
            "TP": tp, "TN": tn, "FP": fp, "FN": fn,
            "Dice": dice_from_counts(tp, fp, fn),
            "IoU": iou_from_counts(tp, fp, fn),
        }
        if save_path and self._writes:
            os.makedirs(save_path, exist_ok=True)
            write_csv(os.path.join(save_path, "volume_prediction_scores.csv"),
                      ("",) + CSV_COLUMNS,
                      ([i] + [rows[c][i].item() for c in CSV_COLUMNS] for i in range(len(tp))))
        pos = rows["label"] == 1
        self.outputs["eval"]["time"] = time.time() - start_time
        for key, col in (("dice", "Dice"), ("iou", "IoU")):
            self.outputs["eval"][key] = {
                "all": float(np.mean(rows[col])),
                "positive": float(np.mean(rows[col][pos])) if pos.any() else float("nan"),
            }
        if print_to_logger:
            logger.info("Evaluation Dice: %.5f.", self.outputs["eval"]["dice"]["all"])
        return rows


TRAINERS.add("UNet3D", UNet3D)
