"""3D U-Net inference and evaluation (counterpart of the inference subset of
:class:`ich_tpu.train.segmentation3d.UNet3D`).

A (D, H, W) HU volume is copied to the device, windowed there, segmented
by Gaussian-blended sliding-window inference (:mod:`ich_tpu_torch.ops.
sliding_window`) and thresholded; only the uint8 mask, or for ``evaluate``
four confusion counts, come back. ``segment_volumes`` and ``evaluate`` keep
two volumes queued on the device before they fetch the oldest result.
Patch training (``train``, ``sample_patches``, the device patch sampler)
is not ported yet, nor the multi-device branch of ``segment_volumes``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops.metrics import (
    batch_binary_confusion_matrix,
    dice_from_counts,
    iou_from_counts,
)
from ich_tpu_torch.ops.sliding_window import sliding_window_inference
from ich_tpu_torch.train.segmentation2d import UNet2D, write_csv
from ich_tpu_torch.utils.pipeline import fetch_pipelined

logger = logging.getLogger(__name__)

CSV_COLUMNS = ("volID", "label", "TP", "TN", "FP", "FN", "Dice", "IoU")


class UNet3D(UNet2D):
    """Sliding-window segmentation of (D, H, W) volumes with a 3D U-Net;
    the weights plumbing (``get_state_dict``, ``save_model``,
    ``load_model``) is :class:`UNet2D`'s. ``batch_size`` is the training
    batch (kept for the trainer's signature); ``sw_batch_size`` is the
    number of patches per network call (``None``: the sliding window's
    default, 128 on the coset path)."""

    def __init__(
        self,
        unet: nn.Module,
        patch_size: Sequence[int] = (64, 128, 128),
        sw_overlap: float = 0.5,
        sw_batch_size: Optional[int] = None,
        batch_size: int = 16,
        device: str | torch.device = "cuda",
    ):
        super().__init__(unet, batch_size=batch_size, device=device)
        self.patch_size = tuple(patch_size)
        self.sw_overlap = sw_overlap
        self.sw_batch_size = sw_batch_size
        self.outputs = {"eval": {"time": None, "dice": {"all": None, "positive": None},
                                 "iou": {"all": None, "positive": None}}}

    # -- device work ------------------------------------------------------------

    def _upload(self, vol_data: np.ndarray) -> torch.Tensor:
        """A float32 copy of ``vol_data`` on the device."""
        arr = np.asarray(vol_data)
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy does not wait for queued work
            host = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
            host.numpy()[...] = arr
            return host.to(self.device, non_blocking=True)
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    def _enqueue(self, vol_data: np.ndarray, window: Optional[Tuple[float, float]],
                 threshold: float) -> torch.Tensor:
        """Upload, window and segment one volume; returns the (D, H, W)
        uint8 {0, 1} mask on the device, its work queued."""
        vol = self._upload(vol_data)
        if window is not None:
            vol = ct.window_ct(vol, window[0], window[1])
        with torch.inference_mode():
            probs = sliding_window_inference(
                self.unet, vol, patch_size=self.patch_size, overlap=self.sw_overlap,
                batch_size=self.sw_batch_size)
            return (probs[..., 0] >= threshold).to(torch.uint8)

    @staticmethod
    def _finish(dev_pred: torch.Tensor, affine, save_fn) -> np.ndarray:
        pred = dev_pred.cpu().numpy() * np.uint8(255)
        if save_fn:
            nifti.save(save_fn, pred, affine if affine is not None else np.eye(4))
        return pred

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
        pred = self._finish(self._enqueue(vol_data, window, threshold), affine, save_fn)
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
        lazily."""
        preds: List[np.ndarray] = []
        pending = []

        def drain_one():
            i, dev_pred = pending.pop(0)
            aff = affines[i] if affines is not None else None
            fn = save_fns[i] if save_fns is not None else None
            pred = self._finish(dev_pred, aff, fn)
            if return_preds:
                preds.append(pred)

        for i, vol_data in enumerate(volumes):
            pending.append((i, self._enqueue(vol_data, window, threshold)))
            if len(pending) >= max(1, pipeline_depth):
                drain_one()
        while pending:
            drain_one()
        return preds if return_preds else None

    def predict_volume(self, vol: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """(D, H, W) preprocessed volume -> uint8 {0, 1} mask."""
        return self._enqueue(vol, None, threshold).cpu().numpy()

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
        if save_path:
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
