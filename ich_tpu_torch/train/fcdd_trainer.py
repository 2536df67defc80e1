"""FCDD anomaly-localization trainer (counterpart of
:mod:`ich_tpu.train.fcdd_trainer`; reference ``FCDD.py``).

Each step draws from ``ka, kp = split(key)`` as the JAX step does: a batch
of ellipse images from ``ka`` (:func:`ich_tpu_torch.ops.masks.
draw_ellipses_batch`), and ``uniform(kp, (B,))``. A normal slice (label 0)
whose uniform is below
``anomaly_proba`` takes the ellipses' values wherever they are above 0 and
the label 1; then the HSC loss of the net's score map, backward and Adam.
Epochs drop the last partial batch (:class:`ich_tpu_torch.train.ssl.
_SSLBase`), and each epoch with a ``valid_dataset`` logs its AUC.

Scoring runs the net in eval mode on the device: ``anomaly_scores`` is the
per-slice mean of the pseudo-Huber ``sqrt(f^2 + 1) - 1`` (the mean, as the
JAX package computes it); ``generate_heatmap`` its receptive-field
Gaussian upsample, min/max-scaled by ``get_min_max``'s quantiles, which
numpy takes on the host over the whole heat stack (``torch.quantile``
refuses more than 2^24 values: 512 slices of 256^2 are 2^25);
``grad_heatmap`` the input gradient of the summed per-slice scores
(``torch.autograd.grad``). ``localize_anomalies`` writes ``anomaly_{i}.png``
(image | heatmap) with :mod:`ich_tpu_torch.data.png`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data.core import batch_indices
from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
from ich_tpu_torch.ops.losses import hsc_loss
from ich_tpu_torch.ops.masks import draw_ellipses_batch
from ich_tpu_torch.ops.metrics import classification_metrics
from ich_tpu_torch.train.ae_trainer import _host
from ich_tpu_torch.train.segmentation2d import eval_mode
from ich_tpu_torch.train.ssl import _nhwc, _SSLBase
from ich_tpu_torch.train.state import TrainState
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRAINERS

logger = logging.getLogger(__name__)


def _label_column(labels) -> np.ndarray:
    """Labels (N,) or the first column of (N, K) multilabel rows, int32."""
    labels = np.asarray(labels)
    return (labels[:, 0] if labels.ndim > 1 else labels).astype(np.int32)


def pseudo_huber(scores: torch.Tensor) -> torch.Tensor:
    """``sqrt(f^2 + 1) - 1`` in float32 (float64 for float64 scores)."""
    s = scores.to(torch.promote_types(scores.dtype, torch.float32))
    return torch.sqrt(s ** 2 + 1.0) - 1.0


class FCDD(_SSLBase):
    name = "FCDD"

    def __init__(self, net: nn.Module, artificial_anomaly: bool = True,
                 anomaly_proba: float = 0.5, drawing_params: Optional[dict] = None,
                 gauss_std: Optional[float] = None, **kwargs):
        super().__init__(net, **kwargs)
        self.artificial_anomaly = artificial_anomaly
        self.anomaly_proba = anomaly_proba
        self.drawing_params = dict(drawing_params or {})
        self.gauss_std = gauss_std
        self.min_max: Optional[Tuple[float, float]] = None
        self.outputs["eval"] = {"time": None, "auc": None}

    # -- training ---------------------------------------------------------------

    def _train_batches(self, dataset, plan):
        labels = _label_column(dataset.labels)
        for idx, images in zip(plan, self._batches(dataset.images, plan)):
            yield images, self._to_device(labels[idx])

    def _train_step(self, state: TrainState, batch, key: torch.Tensor) -> torch.Tensor:
        return self._step(state, *batch, key)

    def draw_anomalies(self, key: torch.Tensor, batch: int, shape: Tuple[int, int],
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """A step's draws from ``ka, kp = split(key)``, as the JAX step
        draws them: (B, H, W) ellipse images on ``device`` from ``ka`` and
        the uniforms ``uniform(kp, (B,))`` on the host that decide each
        normal slice's corruption."""
        ka, kp = rng.split(key)
        return (draw_ellipses_batch(ka, batch, shape, device, **self.drawing_params),
                rng.uniform(kp, (batch,)))

    def _step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
              key: Optional[torch.Tensor], ellipses: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on (B, H, W[, 1]) images with labels (B,); the ellipse
        images (B, H, W) and the uniforms (B,) are drawn from ``key``
        (:meth:`draw_anomalies`) unless both are given."""
        images = _nhwc(images)
        labels = labels.to(images.device)
        b, h, w = images.shape[:3]
        if self.artificial_anomaly:
            with torch.profiler.record_function("anomalies"):
                if ellipses is None:
                    ellipses, u = self.draw_anomalies(key, b, (h, w), images.device)
                ell = ellipses.to(images.device, torch.float32)[..., None]
                corrupt = (rng.to_device(u, images.device) < self.anomaly_proba) & (labels == 0)
                images = torch.where(corrupt[:, None, None, None] & (ell > 0), ell, images)
                labels = torch.where(corrupt, torch.ones_like(labels), labels)
        with torch.profiler.record_function("net"):
            scores = state.model(images.movedim(-1, 1))
        with torch.profiler.record_function("loss"):
            loss = hsc_loss(scores, labels)
        return self._update(state, loss)

    def _validate_epoch(self, valid_dataset, epoch: int):
        if valid_dataset is None:
            return "", []
        auc = self.validate(valid_dataset)
        return f"| Valid AUC: {auc:.4f} ", [auc]

    # -- scoring and heatmaps -----------------------------------------------------

    def _eval_batches(self, images):
        """(B, 1, H, W) batches of ``images`` in order, on the device, in the
        net's dtype (float32; float64 for a net made double), the last one
        partial."""
        dtype = next(self.net.parameters()).dtype
        plan = list(batch_indices(len(images), self.batch_size, shuffle=False, pad_wrap=False))
        for x in self._batches(images, plan):
            yield _nhwc(x.to(dtype)).movedim(-1, 1)

    @torch.inference_mode()
    def anomaly_scores(self, images) -> np.ndarray:
        """Per-slice anomaly scores, the mean of ``sqrt(f^2 + 1) - 1`` over
        the score map (reference ``FCDD.py:172``)."""
        with eval_mode(self.net):
            out = [pseudo_huber(self.net(x)).flatten(1).mean(dim=1).cpu()
                   for x in self._eval_batches(images)]
        return torch.cat(out).numpy()

    @torch.inference_mode()
    def generate_heatmap(self, images, scale: bool = True) -> np.ndarray:
        """(N, H, W) receptive-field Gaussian heatmaps at the input's
        resolution; with ``scale`` and a ``min_max``, min/max-scaled and
        clipped to [0, 1] (reference ``generate_heatmap:242-253``)."""
        hw = tuple(images.shape[1:3])
        with eval_mode(self.net):
            heat = torch.cat([FCDD_CNN_VGG.heatmap(self.net(x), hw, std=self.gauss_std)[:, 0].cpu()
                              for x in self._eval_batches(images)]).numpy()
        if scale and self.min_max is not None:
            lo, hi = self.min_max
            heat = np.clip((heat - lo) / max(hi - lo, 1e-8), 0.0, 1.0)
        return heat

    def grad_heatmap(self, images, method: str = "grad", absolute: bool = True) -> np.ndarray:
        """(N, H, W): the gradient of the summed per-slice scores with
        respect to the input, times the input for ``"xgrad"``, optionally
        absolute, summed over the channels (reference
        ``FCDD_BaseNet.get_grad_heatmap:192-214``), the net in eval mode."""
        if method not in ("grad", "xgrad"):
            raise ValueError(f"method must be 'grad' or 'xgrad', got {method!r}")
        out = []
        with eval_mode(self.net):
            for x in self._eval_batches(images):
                x = x.detach().requires_grad_(True)
                total = pseudo_huber(self.net(x)).flatten(1).mean(dim=1).sum()
                (g,) = torch.autograd.grad(total, x)
                heat = x.detach() * g if method == "xgrad" else g
                if absolute:
                    heat = heat.abs()
                out.append(heat.sum(dim=1).cpu())
        return torch.cat(out).numpy()

    def get_min_max(self, images, quantiles=(0.025, 0.975)) -> Tuple[float, float]:
        """The heatmaps' quantile range over the whole stack, for display
        scaling (reference ``get_min_max:185-209``): numpy's linear
        quantiles on the host."""
        heat = self.generate_heatmap(images, scale=False)
        lo, hi = np.quantile(heat, quantiles[0]), np.quantile(heat, quantiles[1])
        self.min_max = (float(lo), float(hi))
        return self.min_max

    def validate(self, dataset) -> float:
        """The rank AUC of :meth:`anomaly_scores` against the labels."""
        labels = _label_column(dataset.labels)
        auc = classification_metrics(labels, self.anomaly_scores(dataset.images))["auc"]
        self.outputs["eval"]["auc"] = auc
        return auc

    def localize_anomalies(self, images, save_path: str, n: int = 8) -> None:
        """``anomaly_{i}.png`` (image | heatmap) for the first ``n`` images
        (reference ``localize_anomalies:211-240``); the heatmaps are scaled
        by their own range when no ``min_max`` is set."""
        os.makedirs(save_path, exist_ok=True)
        images = _host(images[:n])
        heat = self.generate_heatmap(images)
        if self.min_max is None:
            heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-8)
        images = images.reshape(heat.shape)
        for i in range(min(n, len(images))):
            row = np.concatenate([images[i], heat[i]], axis=1)
            save_png_gray(os.path.join(save_path, f"anomaly_{i}.png"),
                          (np.clip(row, 0, 1) * 255).astype(np.uint8))


TRAINERS.add("FCDD", FCDD)
