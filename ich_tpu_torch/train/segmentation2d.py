"""2.5D U-Net serving (counterpart of the serving subset of
:class:`ich_tpu.train.segmentation2d.UNet2D`).

``segment_volume`` runs one whole volume on the device, step for step as
the JAX package's ``_segvol_body``: rot90 -> window -> linear resize to the
net's input -> the net over slice batches -> threshold at 0.5 -> nearest
resize back (in the rotated frame) -> rot90 back -> uint8 x255.
``segment_volumes`` keeps up to ``pipeline_depth`` volumes queued on the
device before it fetches the oldest result. Training and evaluation are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data import nifti
from ich_tpu_torch.ops import ct
from ich_tpu_torch.train import checkpoint as ckpt


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    return dev


class UNet2D:
    """Score (H, W, Z) volumes slice-wise with a 2D U-Net."""

    def __init__(self, unet: nn.Module, batch_size: int = 16,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.batch_size = batch_size

    # -- full-volume inference ----------------------------------------------

    def _segment(self, vol: torch.Tensor, input_size: Tuple[int, int],
                 window: Optional[Tuple[float, float]]) -> torch.Tensor:
        """(H, W, Zp) raw volume on the device, Zp a multiple of the batch
        size -> (H, W, Zp) uint8 {0, 1} mask on the device."""
        h, w, z_pad = vol.shape
        x = torch.rot90(vol, 1, dims=(0, 1))  # 90 deg ccw
        if window is not None:
            x = ct.window_ct(x, window[0], window[1], (0.0, 1.0))
        x = ct.resize(x, (input_size[0], input_size[1], z_pad), order=1)
        x = x.permute(2, 0, 1).unsqueeze(1).contiguous()  # (Zp, 1, h, w)
        pred = torch.cat([
            (self.unet(xb) >= 0.5).to(torch.uint8)[:, 0]
            for xb in x.split(self.batch_size)
        ])  # (Zp, h, w)
        pred = pred.permute(1, 2, 0)  # (h, w, Zp)
        # still in the rot90 frame: resize to the rotated dims (W, H) so the
        # rotate-back lands on the input's (H, W)
        pred = ct.resize_nearest(pred, (w, h, z_pad))
        return torch.rot90(pred, 1, dims=(1, 0))

    def _enqueue(self, vol_data: np.ndarray, input_size, window) -> Tuple[torch.Tensor, int]:
        """Pad z to a multiple of the batch size, copy to the device and
        queue the volume's work; returns the (H, W, Zp) device mask and z."""
        vol_data = np.asarray(vol_data, dtype=np.float32)
        h, w, z = vol_data.shape
        z_pad = -(-z // self.batch_size) * self.batch_size
        vol = torch.zeros((h, w, z_pad), dtype=torch.float32)
        vol[:, :, :z] = torch.from_numpy(vol_data)
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy does not wait for queued work
            vol = vol.pin_memory().to(self.device, non_blocking=True)
        with torch.inference_mode():
            return self._segment(vol, tuple(input_size), window), z

    @staticmethod
    def _finish(dev_pred: torch.Tensor, z: int, affine, save_fn) -> np.ndarray:
        pred = dev_pred[:, :, :z].cpu().numpy() * np.uint8(255)
        if save_fn:
            nifti.save(save_fn, pred, affine if affine is not None else np.eye(4))
        return pred

    def segment_volume(
        self,
        vol_data: np.ndarray,
        affine: Optional[np.ndarray] = None,
        save_fn: Optional[str] = None,
        window: Optional[Tuple[float, float]] = None,
        input_size: Tuple[int, int] = (256, 256),
        return_pred: bool = False,
    ):
        """Segment every slice of an (H, W, Z) volume. Returns a uint8
        {0, 255} volume if ``return_pred``; optionally writes NIfTI."""
        dev_pred, z = self._enqueue(vol_data, input_size, window)
        pred = self._finish(dev_pred, z, affine, save_fn)
        if return_pred:
            return pred

    def segment_volumes(
        self,
        volumes: Iterable[np.ndarray],
        affines: Optional[Sequence] = None,
        save_fns: Optional[Sequence[Optional[str]]] = None,
        window: Optional[Tuple[float, float]] = None,
        input_size: Tuple[int, int] = (256, 256),
        return_preds: bool = False,
        pipeline_depth: int = 4,
    ):
        """Pipelined multi-volume segmentation: up to ``pipeline_depth``
        volumes are queued on the device before the oldest result is
        fetched, so the device does not idle between volumes while its
        memory stays bounded. ``volumes`` is consumed lazily."""
        preds: List[np.ndarray] = []
        pending = []

        def drain_one():
            i, dev_pred, z = pending.pop(0)
            aff = affines[i] if affines is not None else None
            fn = save_fns[i] if save_fns is not None else None
            pred = self._finish(dev_pred, z, aff, fn)
            if return_preds:
                preds.append(pred)

        for i, vol_data in enumerate(volumes):
            pending.append((i, *self._enqueue(vol_data, input_size, window)))
            if len(pending) >= max(1, pipeline_depth):
                drain_one()
        while pending:
            drain_one()
        return preds if return_preds else None

    # -- weights --------------------------------------------------------------

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        return self.unet.state_dict()

    def save_model(self, export_fn: str) -> None:
        ckpt.save_params(export_fn, self.unet.state_dict())

    def load_model(self, import_fn: str) -> None:
        self.unet.load_state_dict(ckpt.load_params(import_fn))
