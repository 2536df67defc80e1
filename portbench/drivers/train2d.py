"""2.5D supervised training: ``UNet2D.train`` -> ``fit`` -> the train step
(augmentation, keyed dropout, BatchNorm, Dice, backward, Adam) over a
device-cached ``SliceDataset2D``, as the k-fold driver and the study
train. One warm epoch is set-up. The check follows set-up's first steps
from the seed and the window's first step from the program's state as
the window began (``common.training``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.common import data, manifest
from portbench.common.training import N_CHECKED, Steps, fit_window, judge
from portbench.common.weights import load_into
from portbench.reference import augment, rng
from portbench.reference.train import dice_terms, exact_fp32, lr_at, run_steps


def tiny(cell: dict, patch: int) -> None:
    """Cut ``cell`` for a CPU test: 32 slices of 32 x 32, 8 a step (the
    net's patch edge is a 3D cell's)."""
    cell["config_data"]["data"]["slice_shape"] = [32, 32]
    cell["config_data"]["train"]["batch_size"] = 8
    cell["traffic"].update(slices=32)


class Driver:
    unit = "steps"

    def __init__(self, cell: dict, seed: int, device, dtype=None):
        from ich_tpu_torch.data.core import SliceDataset2D
        from ich_tpu_torch.ops.transforms import build_pipeline
        from ich_tpu_torch.train.segmentation2d import UNet2D

        self.cell, self.cfg = cell, cell["config_data"]
        self.traffic = cell["traffic"]
        self.seed, self.device = seed, torch.device(device)
        net_cfg, tr = self.cfg["net"], self.cfg["train"]
        self.arch = manifest.net(net_cfg)  # nets/<arch>.py
        n, hw = self.traffic["slices"], tuple(self.cfg["data"]["slice_shape"])
        self.steps_per_epoch = -(-n // tr["batch_size"])
        images, masks = data.slices(seed, n, hw, self.traffic["positive_share"],
                                    self.cfg["data"]["window"], self.device)
        _, gen = data.generators(seed + 1, self.device)
        self.weights = self.arch.make_weights(net_cfg, gen, self.device)
        self.arch.calibrate_final_bias(self.weights, net_cfg, images[:32, None], train=True)
        net = self.arch.build(net_cfg, self.device, dtype)
        load_into(net, self.weights)
        self.buffers0 = {k: v.clone() for k, v in net.state_dict().items()
                         if "running" in k}
        ids = np.arange(n, dtype=np.int32)
        self.dataset = SliceDataset2D(images, masks, ids // 64, ids % 64).device_cache(
            self.device)
        self.trainer = UNet2D(
            net, n_epoch=1, batch_size=tr["batch_size"], lr=tr["lr"],
            lr_scheduler=tr["lr_scheduler"], lr_scheduler_kwargs=tr["lr_scheduler_kwargs"],
            loss_fn=tr["loss_fn"], loss_fn_kwargs=tr["loss_fn_kwargs"],
            weight_decay=tr["weight_decay"],
            augment_fn=build_pipeline(self.cfg["data"]["augmentation"]), seed=seed,
            device=self.device)
        self.recorder = Steps(self.trainer, tr["loss_fn_kwargs"], tr["weight_decay"],
                              self.steps_per_epoch)
        self.trainer.train(self.dataset)  # the warm epoch
        self.voxels_per_step = tr["batch_size"] * hw[0] * hw[1]

    def work(self) -> dict:
        """A step's FLOPs and the dropout's bytes, from the shapes."""
        net_cfg, b = self.cfg["net"], self.cfg["train"]["batch_size"]
        hw = tuple(self.cfg["data"]["slice_shape"])
        return {"flops": self.arch.flops(net_cfg, b, hw, train=True),
                "dropout_bytes": self.arch.dropout_bytes(net_cfg, b, hw)}

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
        return lr_at(self.cfg["train"], self.steps_per_epoch, s)

    def reference(self, record: dict, half_batch: bool = False) -> dict:
        """The reference's records from the same inputs and draws: set-up's
        first steps from the seed (``first``), and the window's first step
        from the program's state as the window began (``window``; ``fit``
        counts the window's epochs from 0 again, so it replays set-up's
        first permutation and keys). ``half_batch`` plants a fault: the
        loss over the first half of each batch alone."""
        net_cfg, tr = self.cfg["net"], self.cfg["train"]
        n, hw = self.traffic["slices"], tuple(self.cfg["data"]["slice_shape"])
        images, masks = data.slices(self.seed, n, hw, self.traffic["positive_share"],
                                    self.cfg["data"]["window"], self.device)
        b, w = tr["batch_size"], self.steps_per_epoch
        perm = np.random.default_rng(self.seed).permutation(n)
        spec = self.cfg["data"]["augmentation"]
        paths = self.arch.dropout_paths(net_cfg)
        keep = np.float32(1.0 - net_cfg["p_dropout"])
        root = rng.fold_in(rng.prng_key(self.seed), 0)

        def loss_of(s, params, bufs):
            j = s % w  # the step's batch in its epoch
            aug_key, drop_key = rng.split(rng.fold_in(root, j))
            idx = torch.from_numpy(perm[j * b:(j + 1) * b]).to(self.device)
            m, o = (torch.from_numpy(a).to(self.device)
                    for a in augment.affine(aug_key, spec, b, *hw))
            x = augment.warp(images[idx], m, o, order=1)[:, None]
            y = augment.warp(masks[idx], m, o, order=0)

            def dropout(level, t):
                tl = t.movedim(1, -1)
                bits = rng.philox_bits(rng.dropout_rbg_key(drop_key, paths[level]),
                                       tl.numel(), t.device).view(tl.shape)
                u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
                return torch.where(u < float(keep), tl / float(keep), 0.0).movedim(-1, 1)

            pred = self.arch.forward(params, x, net_cfg, train=True, running=bufs,
                                     dropout=dropout)
            if half_batch:
                pred, y = pred[:b // 2], y[:b // 2]
            kw = tr["loss_fn_kwargs"]
            return dice_terms(pred, y, p=kw["p"], alpha=kw["alpha"])

        at = record["at"][w]
        with exact_fp32():
            first = run_steps(self.weights, self.buffers0, N_CHECKED, loss_of, self.lr_of,
                              tr["weight_decay"])
            window = run_steps({k: at[k] for k in self.weights},
                               {k: at[k] for k in self.buffers0}, 1,
                               lambda s, p, q: loss_of(w + s, p, q),
                               lambda s: self.lr_of(w + s), tr["weight_decay"])
        return {"first": first, "window": window}

    def check(self, detail: bool = False) -> dict:
        return judge(self.record, self.reference(self.record), self.lr_of, detail)

    def control(self) -> dict:
        """The program's own bf16 compute path (``UNet(dtype=bfloat16)``) in
        place of its float32 one, on the same inputs, through set-up and
        a window of one epoch."""
        twin = Driver(self.cell, self.seed, self.device, dtype=torch.bfloat16)
        twin.window(0.0)
        twin.free()
        return twin.check()
