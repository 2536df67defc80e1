"""Self-supervised pretraining trainers (counterpart of
:mod:`ich_tpu.train.ssl`): context restoration and global / local
contrastive learning.

- ``ContextRestoration``: a U-Net without a final activation restores
  images corrupted by :class:`ich_tpu_torch.ops.transforms.RandomPatchSwap`
  (Chen 2019), under the MSE.
- ``Contrastive``: global NT-Xent on the L2-normalised MLP-head embeddings
  of a :class:`ich_tpu_torch.models.unet.UNetEncoder`, or local NT-Xent on
  regions of a :class:`ich_tpu_torch.models.unet.PartialUNet`'s feature maps
  (Chaitanya 2020), over two views of each batch.

Each step splits its key (``fit``'s, as the JAX loop folds it) as the JAX
train step does: ``ck, dk = split(key)`` for the corruption and dropout;
or ``k1, k2, kd1, kd2, kr = split(key, 5)`` for view 1, view 2, dropout of
the first forward, of the second, and the region cells. The corruption,
views, cells and dropout masks equal the JAX package's draws. The AE and
FCDD trainers built on this base take the step's key too: the AE keys
dropout with it, FCDD draws its ellipses and corruption flags from
``ka, kp = split(key)``. The two forwards of a
contrastive step run in train mode one after the other, so the second
starts from the running statistics the first updated, as in the JAX
package. Epochs drop the last partial batch (``n // batch_size`` steps);
the host permutation of each epoch is replayed from
``np.random.default_rng(seed)`` on a resume, so a resumed run is bit-equal
to a straight one.

``transfer_weights(..., freeze=True)`` keeps the transferred parameters
out of the optimizer (no Adam step, no L2 decay: the JAX package's zero
update) and out of autograd; their BatchNorm running statistics still move
in train mode. The optimizer is built with the same grouping again on a
resume.

``evaluate_representation`` embeds the bottleneck features
(:meth:`bottleneck_features`, on the device: the bottleneck average-pooled
to 4x4 and flattened channels last, as the JAX package does) in 2D with
scikit-learn's t-SNE, imported inside the method.

With ``mesh=`` the trainers are data-parallel as
:class:`ich_tpu_torch.train.segmentation2d.UNet2D` is (``batch_size`` is
the global batch): the patch swap, the views and the region cells are
drawn for the global batch and each rank keeps its slice, each forward
syncs its BatchNorm statistics over the ranks, the global contrastive loss
gathers the embeddings of every rank (:func:`ich_tpu_torch.ops.losses.
info_nce_loss`), and the gradients of the parameters that are not frozen
are averaged before Adam.
"""

from __future__ import annotations

import logging
import time
from datetime import timedelta
from typing import Dict, List, Optional, Set

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data.core import batch_indices
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops.losses import (
    info_nce_loss,
    local_info_nce_loss,
    mse_loss,
    sample_region_cells,
)
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.loop import fit
from ich_tpu_torch.parallel.mesh import shard_batch
from ich_tpu_torch.train.segmentation2d import (
    UNet2D,
    data_parallel,
    eval_mode,
    resolve_device,
)
from ich_tpu_torch.train.state import TrainState, make_optimizer, make_schedule
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRAINERS
from ich_tpu_torch.utils.logging import print_progressbar, save_json

logger = logging.getLogger(__name__)


def _nhwc(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, 1); (B, H, W, C) unchanged."""
    return images[..., None] if images.dim() == 3 else images


class _SSLBase:
    """State, batches, weights and outputs shared by the SSL trainers. The
    constructor takes the JAX trainer's arguments; ``num_workers`` is
    accepted for the configs and unused. With a ``mesh`` the trainer runs
    on the mesh's device and ``device`` is not used."""

    name = "SSL network"

    def __init__(
        self,
        net: nn.Module,
        n_epoch: int = 100,
        batch_size: int = 32,
        lr: float = 1e-3,
        lr_scheduler: str = "ExponentialLR",
        lr_scheduler_kwargs: Optional[dict] = None,
        weight_decay: float = 1e-6,
        seed: int = 0,
        checkpoint_freq: int = 1,
        num_workers: int = 0,
        device: str | torch.device = "cuda",
        print_progress: bool = False,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.net = data_parallel(net.to(self.device).eval(), mesh)
        self.n_epoch = n_epoch
        self.batch_size = batch_size
        self.lr = lr
        self.lr_scheduler = lr_scheduler
        self.lr_scheduler_kwargs = dict(lr_scheduler_kwargs or {"gamma": 0.95})
        self.weight_decay = weight_decay
        self.seed = seed
        self.checkpoint_freq = checkpoint_freq
        self.print_progress = print_progress

        self.state: Optional[TrainState] = None
        self._state_steps: Optional[int] = None  # steps_per_epoch of the schedule
        self.frozen: Set[str] = set()  # parameter names kept out of the optimizer
        self.outputs = {
            "train": {"time": None, "evolution": None},
            "eval": {"time": None, "repr": None},
        }

    # -- state ------------------------------------------------------------------

    def _train_state(self, steps_per_epoch: int, rebuild: bool = False) -> TrainState:
        """The optimizer over the parameters not frozen and the schedule,
        built anew (the step count kept) when the epoch length changes or
        the frozen set does."""
        if self.state is None or rebuild or self._state_steps != steps_per_epoch:
            params = [p for k, p in self.net.named_parameters() if k not in self.frozen]
            self.state = TrainState(
                self.net,
                make_optimizer(params, self.lr, weight_decay=self.weight_decay),
                make_schedule(self.lr_scheduler, self.lr, steps_per_epoch,
                              **self.lr_scheduler_kwargs),
                self.state.step if self.state is not None else 0,
                self.mesh,
            )
            self._state_steps = steps_per_epoch
        return self.state

    def transfer_weights(self, source_state_dict: Dict[str, torch.Tensor], freeze: bool = False,
                         verbose: bool = False) -> List[str]:
        """Key-intersection transfer from another model's ``state_dict``;
        with ``freeze``, the transferred parameters stay fixed in training
        (reference ``Contrastive.py:227-253``). Returns the keys moved."""
        src = {k: torch.as_tensor(v) for k, v in source_state_dict.items()}
        new, moved = ckpt.transfer_weights(self.net.state_dict(), src, verbose)
        self.net.load_state_dict(new)
        if freeze and moved:
            self.frozen = ckpt.freeze_mask((k for k, _ in self.net.named_parameters()), moved)
            for k, p in self.net.named_parameters():
                p.requires_grad_(k not in self.frozen)
            if self.state is not None:
                self._train_state(self._state_steps, rebuild=True)
        return moved

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def save_model(self, export_fn: str) -> None:
        ckpt.save_params(export_fn, self.net.state_dict())

    def load_model(self, import_fn: str, image_shape=(256, 256)) -> None:
        """Load weights written by :meth:`save_model`; ``image_shape`` is the
        JAX API's and not used (the net holds its parameters from
        construction)."""
        self.net.load_state_dict(ckpt.load_params(import_fn))

    def save_outputs(self, export_fn: str) -> None:
        save_json(export_fn, self.outputs)

    # -- training ---------------------------------------------------------------

    # the supervised trainer's helpers, which read only ``self.device`` and
    # ``self.mesh``
    _to_device = UNet2D._to_device
    _writes = UNet2D._writes

    def _local(self, *xs: torch.Tensor):
        """This rank's slices of global-batch tensors (all of them without
        a mesh)."""
        return xs if self.mesh is None else shard_batch(xs, self.mesh)

    def _batches(self, images, plan: List[np.ndarray]):
        """The images of each index row of ``plan`` on the device: gathered
        there from a ``device_cache``d dataset, else on the host and
        copied."""
        for idx in plan:
            if isinstance(images, torch.Tensor):
                yield images.index_select(0, self._to_device(idx.astype(np.int64)))
            else:
                yield self._to_device(images[idx])

    def _step(self, state: TrainState, images: torch.Tensor, key: torch.Tensor):
        raise NotImplementedError

    def _train_step(self, state: TrainState, batch: torch.Tensor, key: torch.Tensor
                    ) -> torch.Tensor:
        return self._step(state, batch, key)

    def _update(self, state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    def _start_epoch(self, epoch: int) -> None:
        """Called before each epoch's first batch (the AE's GDL weight)."""

    def _train_batches(self, dataset, plan: List[np.ndarray]):
        """The training batches of one epoch's ``plan``: the images."""
        return self._batches(dataset.images, plan)

    def _validate_epoch(self, valid_dataset, epoch: int):
        """(log suffix, extra history columns) after each epoch; the SSL
        trainers validate nothing."""
        return "", []

    def train(self, dataset, valid_dataset=None, checkpoint_path: Optional[str] = None) -> None:
        """``n_epoch`` epochs of ``len(dataset) // batch_size`` steps over
        ``dataset.images``; ``valid_dataset`` goes to
        :meth:`_validate_epoch` after each epoch (the SSL trainers accept it
        for the JAX API and leave it unused, as there)."""
        n = len(dataset)
        steps_per_epoch = max(1, n // self.batch_size)  # the last partial batch is dropped
        state = self._train_state(steps_per_epoch)
        host_rng = np.random.default_rng(self.seed)
        drawn = [0]  # permutations consumed so far

        def batches_fn(epoch):
            # epoch e always takes the (e+1)-th permutation of the seed
            while drawn[0] < epoch:
                host_rng.permutation(n)
                drawn[0] += 1
            drawn[0] += 1
            plan = list(batch_indices(n, self.batch_size, shuffle=True, rng=host_rng,
                                      drop_last=True))
            self._start_epoch(epoch)
            self.net.train()
            for b, batch in enumerate(self._train_batches(dataset, plan)):
                if self.print_progress:
                    print_progressbar(b, len(plan), name="\t\tTrain Batch", erase=True)
                yield batch

        def epoch_hook(state, epoch, mean_losses, epoch_time):
            mean_loss = float(mean_losses) if mean_losses is not None else 0.0
            suffix, extra = self._validate_epoch(valid_dataset, epoch)
            logger.info("\t| Epoch: %03d/%03d | Train time: %s | Train Loss: %.6f %s|",
                        epoch + 1, self.n_epoch, timedelta(seconds=int(epoch_time)), mean_loss,
                        suffix)
            return [epoch + 1, mean_loss, *extra]

        try:
            history, wall = fit(
                state, self._train_step, batches_fn, self.n_epoch, epoch_hook, seed=self.seed,
                checkpoint_path=checkpoint_path, checkpoint_freq=self.checkpoint_freq,
                name=self.name, mesh=self.mesh,
            )
        finally:
            self.net.eval()
            set_dropout_keys(self.net, None)
        self.outputs["train"]["time"] = wall
        self.outputs["train"]["evolution"] = history

    # -- representation ----------------------------------------------------------

    @torch.inference_mode()
    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, F) bottleneck features: a (B, C, h, w) bottleneck
        average-pooled to about 4x4 (the reference's
        ``AdaptiveAvgPool2d((4, 4))`` when 4 divides h and w) and flattened
        in (y, x, C) order, or the encoder's pooled (B, C)."""
        _, bott = self.net(_nhwc(images).movedim(-1, 1), return_bottleneck=True)
        if bott.dim() == 4:
            b, c, h, w = bott.shape
            fh, fw = max(1, h // 4), max(1, w // 4)
            bott = bott[:, :, : (h // fh) * fh, : (w // fw) * fw].permute(0, 2, 3, 1)
            bott = bott.reshape(b, h // fh, fh, w // fw, fw, c).mean(dim=(2, 4))
        return bott.reshape(bott.shape[0], -1)

    def bottleneck_features(self, dataset, max_samples: int = 2000) -> np.ndarray:
        """(n, F) float32 features of the first ``min(len(dataset),
        max_samples)`` images, the net in eval mode on the device."""
        n = min(len(dataset), max_samples)
        plan = list(batch_indices(n, self.batch_size, shuffle=False, pad_wrap=False))
        with eval_mode(self.net):
            feats = [self._features(x) for x in self._batches(dataset.images, plan)]
        return torch.cat(feats).float().cpu().numpy()

    def evaluate_representation(self, dataset, labels: Optional[np.ndarray] = None,
                                max_samples: int = 2000) -> np.ndarray:
        """Bottleneck features -> t-SNE 2D, stored in ``outputs["eval"]
        ["repr"]`` as [[x, y, label...], ...] (reference
        ``ContextRestoration.py:196-220``)."""
        from sklearn.manifold import TSNE

        start = time.time()
        feats = self.bottleneck_features(dataset, max_samples)
        n = len(feats)
        emb = TSNE(n_components=2, init="pca", random_state=self.seed).fit_transform(feats)
        payload = emb
        if labels is not None:
            payload = np.concatenate([emb, np.asarray(labels)[:n].reshape(n, -1)], axis=1)
        self.outputs["eval"]["time"] = time.time() - start
        self.outputs["eval"]["repr"] = payload.tolist()
        return emb

    evaluate = evaluate_representation


class ContextRestoration(_SSLBase):
    """Patch-swap context restoration (Chen 2019; reference
    ``ContextRestoration.py``). ``net`` is a U-Net without a final
    activation; ``corrupt`` is the step's corruption, ``corrupt(key,
    images)`` on (B, H, W, 1) batches."""

    name = "context-restoration U-Net"

    def __init__(self, net: nn.Module, n_swap: int = 10, swap_w=(10, 30), swap_h=(10, 30),
                 swap_rotate: bool = True, **kwargs):
        super().__init__(net, **kwargs)
        self.corrupt = T.RandomPatchSwap(n=n_swap, w=swap_w, h=swap_h, rotate=swap_rotate)

    def _train_step(self, state: TrainState, batch: torch.Tensor, key: torch.Tensor
                    ) -> torch.Tensor:
        return self._step(state, batch, key)

    def _step(self, state: TrainState, images: torch.Tensor, key: torch.Tensor):
        images = _nhwc(images)
        ck, dk = rng.split(key)
        with torch.profiler.record_function("corrupt"):
            corrupted = self.corrupt(ck, images)
        corrupted, images = self._local(corrupted, images)
        set_dropout_keys(state.model, dk, self.mesh)
        with torch.profiler.record_function("net"):
            recon = state.model(corrupted.movedim(-1, 1)).movedim(1, -1)
        with torch.profiler.record_function("loss"):
            loss = mse_loss(recon, images)
        return self._update(state, loss)


class Contrastive(_SSLBase):
    """Global (encoder NT-Xent) or local (partial-decoder region NT-Xent)
    contrastive pretraining (reference ``Contrastive.py``). ``aug_pipeline``
    makes a view of a batch, ``aug(key, images)``, and is called twice a
    step; the default is the JAX package's SimCLR-style pipeline."""

    def __init__(self, net: nn.Module, is_global: bool = True, tau: float = 0.5,
                 n_region: int = 13, K: int = 3, aug_pipeline: Optional[T.Compose] = None,
                 **kwargs):
        super().__init__(net, **kwargs)
        self.is_global = is_global
        self.tau = tau
        self.n_region = n_region
        self.K = K
        self.name = ("global contrastive encoder" if is_global
                     else "local contrastive partial U-Net")
        self.aug = aug_pipeline or T.Compose(
            T.RandomCropResize((0.4, 0.8)), T.HFlip(0.5),
            T.GaussianBlur(0.5, (0.1, 2.0)),
            T.AdjustBrightness(0.5, -0.2, 0.2), T.AdjustContrast(0.5, 0.8, 1.2),
        )

    def _train_step(self, state: TrainState, batch: torch.Tensor, key: torch.Tensor
                    ) -> torch.Tensor:
        return self._step(state, batch, key)

    def _step(self, state: TrainState, images: torch.Tensor, key: torch.Tensor):
        images = _nhwc(images)
        k1, k2, kd1, kd2, kr = rng.split(key, 5)
        with torch.profiler.record_function("views"):
            v1 = self.aug(k1, images)
            v2 = self.aug(k2, images)
        v1, v2 = self._local(v1, v2)
        with torch.profiler.record_function("net"):
            set_dropout_keys(state.model, kd1, self.mesh)
            o1 = state.model(v1.movedim(-1, 1))
            set_dropout_keys(state.model, kd2, self.mesh)
            o2 = state.model(v2.movedim(-1, 1))
        with torch.profiler.record_function("loss"):
            if self.is_global:
                # L2-normalised embeddings (reference Contrastive.py:142-144)
                z1 = o1 / torch.clamp(torch.linalg.vector_norm(o1, dim=1, keepdim=True), min=1e-8)
                z2 = o2 / torch.clamp(torch.linalg.vector_norm(o2, dim=1, keepdim=True), min=1e-8)
                loss = info_nce_loss(z1, z2, tau=self.tau, mesh=self.mesh)
            else:
                f1, f2 = o1.movedim(1, -1), o2.movedim(1, -1)
                cells = None
                if self.mesh is not None:  # drawn for the global batch, then sliced
                    b, h, w, _ = f1.shape
                    cells, = self._local(sample_region_cells(
                        kr, b * self.mesh.size, (h // self.K) * (w // self.K), self.n_region))
                loss = local_info_nce_loss(f1, f2, kr, tau=self.tau, K=self.K,
                                           n_region=self.n_region, cells=cells)
        return self._update(state, loss)


TRAINERS.add("ContextRestoration", ContextRestoration)
TRAINERS.add("Contrastive", Contrastive)
