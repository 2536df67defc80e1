"""3D patch training: ``UNet3D.train`` -> ``fit`` -> a batch of patches
drawn by ``DevicePatchSampler`` from the step's key, the configuration's
net in train mode, Dice, backward and Adam, over a device-resident
``VolumeDataset3D``. One warm epoch is set-up. The check follows
set-up's first steps from the seed and the window's first step from the
program's state as the window began (``common.training``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.common import data, manifest
from portbench.common.training import N_CHECKED, Steps, against, fit_window, judge
from portbench.common.weights import load_into
from portbench.reference import rng, sampler
from portbench.reference.fp8 import quant_e4m3
from portbench.reference.train import dice_terms, exact_fp32, lr_at, run_steps


def tiny(cell: dict, patch: int) -> None:
    """Cut ``cell`` for a CPU test, around the net's tiny patch edge
    ``patch``: three volumes of ``patch`` x 4 ``patch`` x 4 ``patch``, 4
    patches a step, 4 steps an epoch."""
    cell["config_data"]["train"].update(patch_size=[patch] * 3, batch_size=4,
                                        steps_per_epoch=4)
    cell["traffic"].update(volumes=3, volume_shape=[patch, 4 * patch, 4 * patch])


class Driver:
    unit = "steps"

    def __init__(self, cell: dict, seed: int, device):
        from ich_tpu_torch.data.core import VolumeDataset3D
        from ich_tpu_torch.train.segmentation3d import UNet3D

        self.cfg, self.traffic = cell["config_data"], cell["traffic"]
        self.seed, self.device = seed, torch.device(device)
        net_cfg, tr = self.cfg["net"], self.cfg["train"]
        self.arch = manifest.net(net_cfg)  # nets/<arch>.py
        self.patch = tuple(tr["patch_size"])
        vols, masks = self._volumes()
        _, gen = data.generators(seed + 1, self.device)
        self.weights = self.arch.make_weights(net_cfg, gen, self.device)
        self.arch.calibrate_final_bias(self.weights, net_cfg, self._central_patches(vols[0]),
                                       train=True)
        dataset = VolumeDataset3D([v.cpu().numpy() for v in vols],
                                  [m.cpu().numpy() for m in masks],
                                  np.arange(len(vols), dtype=np.int32))
        del vols, masks
        net = self.arch.build(net_cfg, self.device)
        load_into(net, self.weights)
        self.dataset = dataset
        self.trainer = UNet3D(
            net, patch_size=self.patch, steps_per_epoch=tr["steps_per_epoch"],
            pos_frac=tr["pos_frac"], on_device_sampling=True, n_epoch=1,
            batch_size=tr["batch_size"], lr=tr["lr"], lr_scheduler=tr["lr_scheduler"],
            lr_scheduler_kwargs=tr["lr_scheduler_kwargs"], loss_fn=tr["loss_fn"],
            loss_fn_kwargs=tr["loss_fn_kwargs"], weight_decay=tr["weight_decay"], seed=seed,
            device=self.device)
        self.recorder = Steps(self.trainer, tr["loss_fn_kwargs"], tr["weight_decay"],
                              tr["steps_per_epoch"])
        self.trainer.train(self.dataset)  # the warm epoch
        self.voxels_per_step = tr["batch_size"] * int(np.prod(self.patch))

    def work(self) -> dict:
        """A step's FLOPs, from the shapes."""
        return {"flops": self.arch.flops(self.cfg["net"], self.cfg["train"]["batch_size"],
                                         self.patch, train=True)}

    def _volumes(self):
        return data.volumes_dhw(self.seed, self.traffic["volumes"],
                                self.traffic["volume_shape"], self.device,
                                self.cfg["data"]["window"])

    def _central_patches(self, vol: torch.Tensor) -> torch.Tensor:
        """Four central patches of a windowed volume: (4, 1, p, p, p)."""
        p = self.patch[0]
        d, h, w = vol.shape
        x = vol[:p, h // 2 - p:h // 2 + p, w // 2 - p:w // 2 + p]
        return x.reshape(p, 2, p, 2, p).permute(1, 3, 0, 2, 4).reshape(4, 1, p, p, p)

    def annotate(self) -> None:
        """Nothing: the per-layer metrics read the program's own ranges."""

    def window(self, seconds: float) -> dict:
        steps, elapsed = fit_window(self.trainer, self.dataset, seconds)
        self.record = self.recorder.record()
        del self.recorder
        return {"units": steps, "attempted": steps, "failed": 0, "seconds": elapsed,
                "metrics": {"train_mvox_per_s": steps * self.voxels_per_step / elapsed / 1e6}}

    def free(self) -> None:
        del self.trainer, self.dataset
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def lr_of(self, s: int) -> float:
        tr = self.cfg["train"]
        return lr_at(tr, tr["steps_per_epoch"], s)

    def reference(self, record: dict, quant=None, half_batch: bool = False) -> dict:
        """The reference's records from the same volumes and draws (the
        sampler's tables and starts, the gather, the net, Dice and Adam):
        set-up's first steps from the seed (``first``), and the window's
        first step from the program's state as the window began
        (``window``; ``fit`` counts the window's epochs from 0 again, so it
        replays set-up's first keys). ``quant`` puts the net in a lower
        precision; ``half_batch`` plants a fault: the loss over the first
        half of each batch alone."""
        net_cfg, tr = self.cfg["net"], self.cfg["train"]
        vols, masks = self._volumes()
        tables = sampler.Tables([m.cpu().numpy() for m in masks], self.patch)
        root = rng.fold_in(rng.prng_key(self.seed), 0)
        b, w = tr["batch_size"], tr["steps_per_epoch"]

        def loss_of(s, params, bufs):
            ks, _ = rng.split(rng.fold_in(root, s % w))
            vi, st = tables.starts(ks, b, tr["pos_frac"])
            x, y = sampler.gather(vols, masks, vi, st, self.patch)
            if half_batch:
                x, y = x[:b // 2], y[:b // 2]
            pred = self.arch.forward(params, x[:, None], net_cfg, train=True, quant=quant)
            kw = tr["loss_fn_kwargs"]
            return dice_terms(pred, y, p=kw["p"], alpha=kw["alpha"])

        at = record["at"][w]
        with exact_fp32():
            first = run_steps(self.weights, {}, N_CHECKED, loss_of, self.lr_of,
                              tr["weight_decay"])
            window = run_steps({k: at[k] for k in self.weights}, {}, 1,
                               lambda s, p, q: loss_of(w + s, p, q),
                               lambda s: self.lr_of(w + s), tr["weight_decay"])
        return {"first": first, "window": window}

    def check(self, detail: bool = False) -> dict:
        return judge(self.record, self.reference(self.record), self.lr_of, detail)

    def control(self) -> dict:
        """The reference in fp8 in the program's place (the optimizer's
        replay has nothing of it to judge)."""
        return against(self.reference(self.record, quant=quant_e4m3),
                       self.reference(self.record), detail=True)
