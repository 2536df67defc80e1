"""SN-PatchGAN inpainting trainer (counterpart of :mod:`ich_tpu.train.gan`).

Each step (reference ``SNPatchGAN.py``; ``ich_tpu/train/gan.py:158-209``):

1. the free-form masks, drawn from ``km, kg = split(key)``'s ``km`` as
   the JAX step draws them (:func:`ich_tpu_torch.ops.masks.
   random_ff_masks`: the draws on the host, the render on the device)
   before anything else, or given;
2. the D step: the generator in train mode without gradient, its BatchNorm
   update discarded (the G step starts again from the same statistics);
   the composite ``im * (1 - m) + fine * m``; the discriminator in train
   mode on the real batch, then on the fake one, as two calls (BatchNorm
   statistics and the spectral-norm ``u`` carried from the first into the
   second); the hinge loss, backward, Adam;
3. the G step: the generator in train mode (its statistics updated once);
   the updated discriminator in eval mode (running statistics, one power
   step that stores nothing), its parameters out of autograd; ``lambda_L1 *
   (DiscountedL1(coarse) + DiscountedL1(fine)) + lambda_gan * -mean
   D(fake)``, backward, Adam. The two DiscountedL1 terms launch the EDT
   kernels of ``csrc/edt.cu`` on the card: two transforms a step.

Both optimizers are Adam with betas (0.5, 0.999) and L2 ``weight_decay``
under their own schedule of the shared step count. An epoch has ``n //
batch_size`` steps (the last partial batch dropped); the host permutations
come from one ``np.random.default_rng(seed + e0)``, created at the first
epoch ``e0`` that runs (0, or the first after a resume), as the JAX package
plans them. ``inpaint`` runs the generator in eval mode (numpy in, numpy
out), the entry of the inpainting anomaly detector. Validation masks are
drawn from ``PRNGKey(1234)``, the JAX package's masks, and the PNGs are
written by :mod:`ich_tpu_torch.data.png`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data.core import batch_indices
from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.models.layers import stats_frozen
from ich_tpu_torch.ops.losses import discounted_l1_loss, hinge_d_loss, hinge_g_loss
from ich_tpu_torch.ops.masks import random_ff_masks
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.loop import fit
from ich_tpu_torch.train.segmentation2d import eval_mode, resolve_device
from ich_tpu_torch.train.state import make_optimizer, make_schedule
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import TRAINERS
from ich_tpu_torch.utils.logging import save_json

logger = logging.getLogger(__name__)

VALID_MASK_SEED = 1234


@dataclasses.dataclass
class GANState:
    """Both networks, their optimizers and schedules, and the step count;
    ``state_dict`` has the ``model`` / ``optimizer`` / ``step`` keys that
    :func:`ich_tpu_torch.train.loop.fit` checkpoints."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_schedule: Callable[[int], float]
    d_schedule: Callable[[int], float]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": {"generator": self.generator.state_dict(),
                          "discriminator": self.discriminator.state_dict()},
                "optimizer": {"generator": self.g_opt.state_dict(),
                              "discriminator": self.d_opt.state_dict()},
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.generator.load_state_dict(state["model"]["generator"])
        self.discriminator.load_state_dict(state["model"]["discriminator"])
        self.g_opt.load_state_dict(state["optimizer"]["generator"])
        self.d_opt.load_state_dict(state["optimizer"]["discriminator"])
        self.step = int(state["step"])


def _adam_step(opt: torch.optim.Optimizer, schedule: Callable[[int], float], step: int) -> None:
    for group in opt.param_groups:
        group["lr"] = schedule(step)
    opt.step()


@contextlib.contextmanager
def _no_param_grad(net: nn.Module):
    """``net``'s parameters out of autograd inside the block."""
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class SNPatchGAN:
    """Two-network inpainting GAN trainer with the JAX package's API:
    ``train`` / ``inpaint`` / ``validate`` / ``save_model`` / ``load_model``
    / ``save_outputs``. ``generator`` and ``discriminator`` are the port's
    modules (weights from their construction); ``num_workers`` is accepted
    for the configs and unused."""

    def __init__(
        self,
        generator: nn.Module,
        discriminator: nn.Module,
        n_epoch: int = 100,
        batch_size: int = 16,
        lr_g: float = 1e-3,
        lr_d: float = 1e-3,
        lr_scheduler: str = "ExponentialLR",
        lr_scheduler_kwargs: Optional[dict] = None,
        gammaL1: float = 0.99,
        lambda_L1: float = 0.5,
        lambda_gan: float = 0.5,
        weight_decay: float = 1e-6,
        mask_kwargs: Optional[dict] = None,
        seed: int = 0,
        checkpoint_freq: int = 3,
        num_workers: int = 0,
        device: str | torch.device = "cuda",
        print_progress: bool = False,
    ):
        self.device = resolve_device(device)
        self.generator = generator.to(self.device).eval()
        self.discriminator = discriminator.to(self.device).eval()
        self.n_epoch = n_epoch
        self.batch_size = batch_size
        self.lr_g, self.lr_d = lr_g, lr_d
        self.lr_scheduler = lr_scheduler
        self.lr_scheduler_kwargs = dict(lr_scheduler_kwargs or {"gamma": 0.95})
        self.gammaL1 = gammaL1
        self.lambda_L1 = lambda_L1
        self.lambda_gan = lambda_gan
        self.weight_decay = weight_decay
        self.mask_kwargs = dict(mask_kwargs or {})
        self.seed = seed
        self.checkpoint_freq = checkpoint_freq
        self.print_progress = print_progress

        self.state: Optional[GANState] = None
        self._state_steps: Optional[int] = None  # steps_per_epoch of the schedules
        self.outputs = {
            "train": {"time": None, "evolution": None},
            "eval": {"time": None, "l1_valid": None},
        }

    # -- state ------------------------------------------------------------------

    def _train_state(self, steps_per_epoch: int) -> GANState:
        """Both optimizers and schedules, built anew (the step count kept)
        when the epoch length changes: the schedules decay per epoch."""
        if self.state is None or self._state_steps != steps_per_epoch:
            def opt(net, lr):
                return make_optimizer(net.parameters(), lr, weight_decay=self.weight_decay,
                                      betas=(0.5, 0.999))

            def sched(lr):
                return make_schedule(self.lr_scheduler, lr, steps_per_epoch,
                                     **self.lr_scheduler_kwargs)

            self.state = GANState(
                self.generator, self.discriminator,
                opt(self.generator, self.lr_g), opt(self.discriminator, self.lr_d),
                sched(self.lr_g), sched(self.lr_d),
                self.state.step if self.state is not None else 0)
            self._state_steps = steps_per_epoch
        return self.state

    # -- the step -----------------------------------------------------------------

    def _train_step(self, state: GANState, images: torch.Tensor, key: torch.Tensor):
        return self._step(state, images, key)

    def _step(self, state: GANState, images: torch.Tensor, key: Optional[torch.Tensor],
              masks: Optional[torch.Tensor] = None):
        """One D step and one G step on (B, H, W[, 1]) images; the masks
        (B, H, W[, 1]) are drawn from the first half of ``split(key)``
        unless given. Returns the G loss, the D loss and the L1 term as 0-d
        tensors."""
        if images.dim() == 3:
            images = images[..., None]
        b, h, w = images.shape[:3]
        G, D = state.generator, state.discriminator
        with torch.profiler.record_function("masks"):
            if masks is None:
                km, _ = rng.split(key)
                masks = random_ff_masks(km, b, (h, w), images.device, **self.mask_kwargs)
            masks = masks.to(images.device, torch.float32)
            if masks.dim() == 3:
                masks = masks[..., None]

        with torch.profiler.record_function("d_step"):
            with torch.no_grad(), stats_frozen(G):
                fine0, _ = G(images, masks)
            fake0 = images * (1 - masks) + fine0 * masks
            d_loss = hinge_d_loss(D(images, masks), D(fake0, masks))
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            _adam_step(state.d_opt, state.d_schedule, state.step)

        with torch.profiler.record_function("g_step"):
            fine, coarse = G(images, masks)
            fake = images * (1 - masks) + fine * masks
            with eval_mode(D), _no_param_grad(D):
                d_fake = D(fake, masks)
            with torch.profiler.record_function("edt_loss"):
                l1 = (discounted_l1_loss(coarse, images, masks, gamma=self.gammaL1)
                      + discounted_l1_loss(fine, images, masks, gamma=self.gammaL1))
            g_loss = self.lambda_L1 * l1 + self.lambda_gan * hinge_g_loss(d_fake)
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
            _adam_step(state.g_opt, state.g_schedule, state.step)
        state.step += 1
        return g_loss.detach(), d_loss.detach(), l1.detach()

    # -- public API -----------------------------------------------------------------

    def _images_on_device(self, images, idx: np.ndarray) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.index_select(0, torch.as_tensor(idx.astype(np.int64),
                                                          device=images.device))
        return torch.as_tensor(np.asarray(images[idx], np.float32)).to(self.device)

    def epoch_plan(self, n: int) -> Callable[[int], list]:
        """``epoch -> [index arrays]``: ``n // batch_size`` shuffled batches
        (``drop_last``) from one ``default_rng(seed + e0)``, created at the
        first epoch ``e0`` asked for."""
        box = {}

        def plan(epoch: int) -> list:
            if "rng" not in box:
                box["rng"] = np.random.default_rng(self.seed + epoch)
            return list(batch_indices(n, self.batch_size, shuffle=True, rng=box["rng"],
                                      drop_last=True))

        return plan

    def train(self, dataset, valid_dataset=None, checkpoint_path: Optional[str] = None,
              valid_path: Optional[str] = None, valid_freq: int = 5) -> None:
        """``n_epoch`` epochs over ``dataset.images`` (N, H, W), numpy or a
        tensor on the device; masks are drawn each step. With a
        ``valid_dataset``, :meth:`validate` every ``valid_freq`` epochs."""
        images = dataset.images
        n = len(images)
        state = self._train_state(max(1, n // self.batch_size))
        plan = self.epoch_plan(n)

        def batches_fn(epoch):
            self.generator.train()
            self.discriminator.train()
            for idx in plan(epoch):
                yield self._images_on_device(images, idx)

        def epoch_hook(state, epoch, mean_losses, epoch_time):
            means = mean_losses if mean_losses is not None else np.zeros(3)
            eg, ed, el1 = (float(v) for v in means)
            logger.info("\t| Epoch: %03d/%03d | Time: %s | G loss: %.5f | D loss: %.5f | "
                        "L1: %.5f |", epoch + 1, self.n_epoch,
                        timedelta(seconds=int(epoch_time)), eg, ed, el1)
            if valid_dataset is not None and (epoch + 1) % valid_freq == 0:
                self.validate(valid_dataset, save_path=valid_path, epoch=epoch + 1)
            return [epoch + 1, eg, ed, el1]

        try:
            history, wall = fit(state, self._train_step, batches_fn, self.n_epoch, epoch_hook,
                                seed=self.seed, checkpoint_path=checkpoint_path,
                                checkpoint_freq=self.checkpoint_freq, name="SN-PatchGAN")
        finally:
            self.generator.eval()
            self.discriminator.eval()
        self.outputs["train"]["time"] = wall
        self.outputs["train"]["evolution"] = history

    def inpaint(self, images, masks) -> np.ndarray:
        """Composite inpainting of (B, H, W[, 1]) images on the ``mask ==
        1`` regions, the generator in eval mode (its mode restored);
        (B, H, W, 1) float32 numpy."""
        imgs = torch.as_tensor(np.ascontiguousarray(images, np.float32)).to(self.device)
        msks = torch.as_tensor(np.ascontiguousarray(masks, np.float32)).to(self.device)
        if imgs.dim() == 3:
            imgs = imgs[..., None]
        if msks.dim() == 3:
            msks = msks[..., None]
        with eval_mode(self.generator), torch.inference_mode():
            fine, _ = self.generator(imgs, msks)
            out = imgs * (1 - msks) + fine * msks
        return out.cpu().numpy()

    def validate(self, dataset, save_path: Optional[str] = None, epoch: int = 0) -> float:
        """Inpaint the first ``batch_size`` images (the dataset's masks if
        it has them, else fixed masks from ``PRNGKey(1234)``), log the
        masked L1 and, with ``save_path``, write
        ``valid_ep{epoch}_{i}.png`` (image | mask | inpainted) for up to 8."""
        images = torch.as_tensor(dataset.images[: self.batch_size]).cpu().numpy()
        if getattr(dataset, "masks", None) is not None:
            masks = torch.as_tensor(dataset.masks[: self.batch_size]).cpu().numpy()
        else:
            masks = random_ff_masks(rng.prng_key(VALID_MASK_SEED), len(images),
                                    images.shape[1:3], self.device,
                                    **self.mask_kwargs).cpu().numpy()
        out = self.inpaint(images, masks)
        l1 = float(np.abs((out[..., 0] - images) * masks).sum() / max(masks.sum(), 1))
        self.outputs["eval"]["l1_valid"] = l1
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            for i in range(min(8, len(images))):
                row = np.concatenate([images[i], masks[i], out[i, ..., 0]], axis=1)
                save_png_gray(os.path.join(save_path, f"valid_ep{epoch}_{i}.png"),
                              (np.clip(row, 0, 1) * 255).astype(np.uint8))
        logger.info("Validation masked L1: %.5f", l1)
        return l1

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        """Both networks' ``state_dict``s under ``generator.`` and
        ``discriminator.``."""
        return {**{f"generator.{k}": v for k, v in self.generator.state_dict().items()},
                **{f"discriminator.{k}": v for k, v in self.discriminator.state_dict().items()}}

    def save_model(self, export_fn: str) -> None:
        ckpt.save_params(export_fn, self.get_state_dict())

    def load_model(self, import_fn: str, image_shape=(256, 256)) -> None:
        """Load weights written by :meth:`save_model`; ``image_shape`` is the
        JAX API's and not used (the networks hold their parameters from
        construction)."""
        sd = ckpt.load_params(import_fn)
        for prefix, net in (("generator.", self.generator), ("discriminator.", self.discriminator)):
            net.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                 if k.startswith(prefix)})

    def save_outputs(self, export_fn: str) -> None:
        save_json(export_fn, self.outputs)


TRAINERS.add("SNPatchGAN", SNPatchGAN)
