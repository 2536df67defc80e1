"""Slice-classification trainers (counterpart of
:mod:`ich_tpu.train.classifier`): encoder pretraining with labels and the
slice-triage gate of the anomaly-detection pipelines.

- ``BinaryClassifier``: ICH / no-ICH, class-weighted softmax cross entropy
  on the logits, scored by the softmax's positive column;
- ``MultiClassifier``: the 7-way multilabel RSNA vector, BCE on the logits
  with an optional positive weight, scored by the sigmoid.

Both are the SSL trainers' base (:class:`ich_tpu_torch.train.ssl._SSLBase`:
state, weights API, frozen transfer, outputs) with labelled batches. An
epoch has ``ceil(n / batch_size)`` steps, the last batch filled by wrapping
the permutation (:func:`ich_tpu_torch.data.core.batch_indices`), as the JAX
package plans it; the SSL trainers drop that batch instead. The permutation
of epoch ``e`` is the (e+1)-th of ``np.random.default_rng(seed)``, replayed
on a resume, so a resumed run is bit-equal to a straight one. Each step
splits its key as the JAX step does, ``ak, dk = split(key)``: the
augmentation (``augment_fn(ak, images)`` on (B, H, W, 1) batches) draws the
JAX package's parameters, and ``dk`` keys dropout's masks, which equal
the JAX package's.

``evaluate`` scores every slice on the device and computes the metrics of
:mod:`ich_tpu_torch.ops.metrics` (scikit-learn's, without scikit-learn);
with ``save_path`` it writes them to ``classifier_scores.json``. With a
``valid_dataset``, ``train`` evaluates it after each epoch, logs its AUC and
keeps its metrics in the epoch's history row.
"""

from __future__ import annotations

import logging
import time
from datetime import timedelta
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ich_tpu_torch.data.core import batch_indices
from ich_tpu_torch.ops.losses import softmax_cross_entropy, weighted_bce_with_logits
from ich_tpu_torch.ops.metrics import classification_metrics, multilabel_metrics
from ich_tpu_torch.train.loop import fit
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.train.segmentation2d import eval_mode
from ich_tpu_torch.train.ssl import _nhwc, _SSLBase
from ich_tpu_torch.train.state import TrainState
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRAINERS
from ich_tpu_torch.utils.logging import print_progressbar, save_json

logger = logging.getLogger(__name__)


class _ClassifierBase(_SSLBase):
    """A classifier trainer: ``net`` maps (B, C, H, W) images to (B, K)
    logits; ``augment_fn`` (optional) transforms each training batch;
    ``class_weight`` weighs the loss (per class for the binary CE, the
    positive term for the multilabel BCE)."""

    def __init__(self, net, augment_fn: Optional[Callable] = None, class_weight=None, **kwargs):
        super().__init__(net, **kwargs)
        self.augment_fn = augment_fn
        self.class_weight = class_weight
        self.name = type(self).__name__
        self.outputs["eval"] = {"time": None, "metrics": None}

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _scores(self, logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _metrics(self, labels: np.ndarray, scores: np.ndarray) -> Dict[str, float]:
        raise NotImplementedError

    def _train_step(self, state: TrainState, batch, key: torch.Tensor) -> torch.Tensor:
        return self._step(state, batch, key)

    def _step(self, state: TrainState, batch, key: torch.Tensor) -> torch.Tensor:
        images, labels = batch
        images = _nhwc(images)
        ak, dk = rng.split(key)
        if self.augment_fn is not None:
            with torch.profiler.record_function("augment"):
                images = self.augment_fn(ak, images)
        set_dropout_keys(state.model, dk, self.mesh)
        with torch.profiler.record_function("net"):
            logits = state.model(images.movedim(-1, 1))
        with torch.profiler.record_function("loss"):
            loss = self._loss(logits, labels)
        return self._update(state, loss)

    def _labelled_batches(self, dataset, plan):
        """(images, labels) per index row of ``plan`` on the device."""
        labels = self._to_device(np.asarray(dataset.labels))
        for idx, images in zip(plan, self._batches(dataset.images, plan)):
            yield images, labels.index_select(0, self._to_device(idx.astype(np.int64)))

    def train(self, dataset, valid_dataset=None, checkpoint_path: Optional[str] = None) -> None:
        """``n_epoch`` epochs of ``ceil(n / batch_size)`` steps over
        ``dataset`` (``.images`` (N, H, W[, C]) and ``.labels``)."""
        n = len(dataset)
        steps_per_epoch = max(1, int(np.ceil(n / self.batch_size)))
        state = self._train_state(steps_per_epoch)
        host_rng = np.random.default_rng(self.seed)
        drawn = [0]  # permutations consumed so far

        def batches_fn(epoch):
            while drawn[0] < epoch:
                host_rng.permutation(n)
                drawn[0] += 1
            drawn[0] += 1
            plan = list(batch_indices(n, self.batch_size, shuffle=True, rng=host_rng))
            self.net.train()
            for b, batch in enumerate(self._labelled_batches(dataset, plan)):
                if self.print_progress:
                    print_progressbar(b, len(plan), name="\t\tTrain Batch", erase=True)
                yield batch

        def epoch_hook(state, epoch, mean_losses, epoch_time):
            mean_loss = float(mean_losses) if mean_losses is not None else 0.0
            suffix, m = "", None
            if valid_dataset is not None:
                m = self.evaluate(valid_dataset, print_to_logger=False)
                suffix = f"| Valid AUC: {m.get('auc', m.get('auc_macro', float('nan'))):.4f} "
            logger.info("\t| Epoch: %03d/%03d | Train time: %s | Train Loss: %.6f %s|",
                        epoch + 1, self.n_epoch, timedelta(seconds=int(epoch_time)), mean_loss,
                        suffix)
            return [epoch + 1, mean_loss, m]

        try:
            history, wall = fit(
                state, self._train_step, batches_fn, self.n_epoch, epoch_hook, seed=self.seed,
                checkpoint_path=checkpoint_path, checkpoint_freq=self.checkpoint_freq,
                name=self.name,
            )
        finally:
            self.net.eval()
            set_dropout_keys(self.net, None)
        self.outputs["train"]["time"] = wall
        self.outputs["train"]["evolution"] = history

    def predict_scores(self, images) -> np.ndarray:
        """Class scores of a stack of images, the net in eval mode on the
        device; (N,) for the binary classifier, (N, K) for the multilabel."""
        n = len(images)
        plan = list(batch_indices(n, self.batch_size, shuffle=False, pad_wrap=False))
        with eval_mode(self.net), torch.inference_mode():
            scores = [self._scores(self.net(_nhwc(x).movedim(-1, 1)))
                      for x in self._batches(images, plan)]
        return torch.cat(scores).float().cpu().numpy()

    def evaluate(self, dataset, print_to_logger: bool = True,
                 save_path: Optional[str] = None) -> Dict[str, float]:
        """The metrics of the scores of every slice of ``dataset`` against
        its labels; with ``save_path``, ``<save_path>/classifier_scores.json``."""
        start = time.time()
        scores = self.predict_scores(dataset.images)
        m = self._metrics(np.asarray(dataset.labels), scores)
        self.outputs["eval"]["time"] = time.time() - start
        self.outputs["eval"]["metrics"] = m
        if print_to_logger:
            logger.info("Classifier eval: %s", m)
        if save_path:
            save_json(f"{save_path}/classifier_scores.json", m)
        return m


class BinaryClassifier(_ClassifierBase):
    """Two-way slice classifier: class-weighted CE on the logits."""

    def _loss(self, logits, labels):
        return softmax_cross_entropy(logits, labels, class_weights=self.class_weight)

    def _scores(self, logits):
        return torch.softmax(logits.float(), dim=-1)[:, 1]

    def _metrics(self, labels, scores):
        return classification_metrics(labels, scores)


class MultiClassifier(_ClassifierBase):
    """Multilabel slice classifier: BCE on the logits, the positive term
    weighted by ``class_weight`` (1 without one)."""

    def _loss(self, logits, labels):
        pw = float(self.class_weight) if self.class_weight is not None else 1.0
        return weighted_bce_with_logits(logits, labels, pos_weight=pw)

    def _scores(self, logits):
        return torch.sigmoid(logits.float())

    def _metrics(self, labels, scores):
        return multilabel_metrics(labels, scores)


TRAINERS.add("BinaryClassifier", BinaryClassifier)
TRAINERS.add("MultiClassifier", MultiClassifier)
