"""Autoencoder anomaly-detection trainer (counterpart of
:mod:`ich_tpu.train.ae_trainer`; reference ``AE.py``).

The reconstruction loss is ``L1 + L2 + lambda_GDL(epoch) * GDL``, the GDL
computed only while its weight is above 0. ``lambda_GDL`` is an
epoch-keyed schedule: each epoch takes the value of the largest key not
above it (0 before the first key), so a resume past a key replays its
weight. Epochs drop the last partial batch and replay their host
permutations from ``np.random.default_rng(seed)``
(:class:`ich_tpu_torch.train.ssl._SSLBase`). The anomaly map of a slice is
``|rec - im|``. ``validate`` writes ``rec_ep{e}_{i}.png`` (image |
reconstruction clipped to [0, 1]) with :mod:`ich_tpu_torch.data.png`.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data.core import batch_indices
from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.ops.losses import gdl_loss, l1_loss, mse_loss
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.train.segmentation2d import eval_mode
from ich_tpu_torch.train.ssl import _nhwc, _SSLBase
from ich_tpu_torch.train.state import TrainState
from ich_tpu_torch.utils.config import TRAINERS

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    """A numpy array or a tensor on any device as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


class AE(_SSLBase):
    """Reconstruction AE trained on normal slices; the anomaly score is
    ``|im - rec|``."""

    name = "reconstruction AE"

    def __init__(self, net: nn.Module, lambda_GDL: Optional[Dict[str, float]] = None, **kwargs):
        super().__init__(net, **kwargs)
        self.ep_GDL = {str(k): float(v) for k, v in (lambda_GDL or {}).items()}
        self.lambda_gdl = 0.0
        self.valid_path: Optional[str] = None
        self.valid_freq = 5
        self.outputs["eval"] = {"time": None, "l1_valid": None}

    def lambda_at(self, epoch: int) -> float:
        """The GDL weight of ``epoch``: the value of the largest schedule key
        not above it, 0 before the first key."""
        past = [int(k) for k in self.ep_GDL if int(k) <= epoch]
        return float(self.ep_GDL[str(max(past))]) if past else 0.0

    def _start_epoch(self, epoch: int) -> None:
        v = self.lambda_at(epoch)
        if v != self.lambda_gdl:
            self.lambda_gdl = v
            logger.info("Lambda GDL set to %s.", v)

    def _step(self, state: TrainState, images: torch.Tensor, key: torch.Tensor):
        """One step; dropout's masks from ``key``, as the JAX step's
        ``dropout_key(key)`` (``AENet`` has no Dropout: a no-op, as there)."""
        images = _nhwc(images)
        set_dropout_keys(state.model, key, self.mesh)
        with torch.profiler.record_function("net"):
            rec = state.model(images.movedim(-1, 1)).movedim(1, -1)
        with torch.profiler.record_function("loss"):
            loss = l1_loss(rec, images) + mse_loss(rec, images)
            if self.lambda_gdl > 0:
                loss = loss + self.lambda_gdl * gdl_loss(images, rec)
        return self._update(state, loss)

    def _validate_epoch(self, valid_dataset, epoch: int):
        if valid_dataset is None or (epoch + 1) % self.valid_freq != 0:
            return "", []
        l1 = self.validate(valid_dataset, save_path=self.valid_path, epoch=epoch + 1)
        return f"| Valid L1: {l1:.5f} ", []

    def train(self, dataset, valid_dataset=None, checkpoint_path: Optional[str] = None,
              valid_path: Optional[str] = None, valid_freq: int = 5) -> None:
        """``n_epoch`` epochs over ``dataset.images``; with a
        ``valid_dataset``, :meth:`validate` every ``valid_freq`` epochs,
        its PNGs under ``valid_path``."""
        self.valid_path, self.valid_freq = valid_path, valid_freq
        super().train(dataset, valid_dataset, checkpoint_path)

    @torch.inference_mode()
    def reconstruct(self, images) -> np.ndarray:
        """(N, H, W) float32 reconstructions of (N, H, W[, 1]) images (numpy
        or a tensor), the net in eval mode on the device."""
        plan = list(batch_indices(len(images), self.batch_size, shuffle=False, pad_wrap=False))
        out = []
        with eval_mode(self.net):
            for x in self._batches(images, plan):
                x = _nhwc(x.to(torch.float32))
                out.append(self.net(x.movedim(-1, 1)).movedim(1, -1)[..., 0].cpu())
        return torch.cat(out).numpy()

    def anomaly_map(self, images) -> np.ndarray:
        """``|rec - im|`` heatmaps (N, H, W) (reference
        ``AD_AE_scripts.py:152-176``)."""
        rec = self.reconstruct(images)
        return np.abs(rec - _host(images).reshape(rec.shape))

    def validate(self, dataset, save_path: Optional[str] = None, epoch: int = 0) -> float:
        """The L1 of the first 64 reconstructions; with ``save_path``,
        ``rec_ep{epoch}_{i}.png`` (image | reconstruction) for up to 8."""
        images = _host(dataset.images[: min(len(dataset.images), 64)])
        rec = self.reconstruct(images)
        images = images.reshape(rec.shape)
        l1 = float(np.abs(rec - images).mean())
        self.outputs["eval"]["l1_valid"] = l1
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            for i in range(min(8, len(images))):
                row = np.concatenate([images[i], np.clip(rec[i], 0, 1)], axis=1)
                save_png_gray(os.path.join(save_path, f"rec_ep{epoch}_{i}.png"),
                              (row * 255).astype(np.uint8))
        logger.info("Validation L1: %.5f", l1)
        return l1


TRAINERS.add("AE", AE)
