"""Data-parallel 2.5D supervised training: ``UNet2D(..., mesh=...).train`` ->
``fit`` on every rank of a group of the cell's ``chips`` cards, one
process a card (``common/ranks.py``): the weights broadcast from rank 0,
BatchNorm synced over the ranks, each rank's slice of the global batch
(the configuration's ``batch_size`` a card) augmented with the whole
batch and kept, its rows of the global dropout masks, the gradients
averaged before Adam. Rank 0 times, traces and judges; the others train
alongside it, and the window ends through the program's own stop, agreed
over the ranks at an epoch's end (``preemption.requested_global``).

The check is ``train2d``'s numbers against a plain data-parallel step over
the same shards (``reference/data_parallel.py``), run by a group of its
own after the program's has closed; the gradients the program's steps
are judged by are its optimizer's, the mean over the ranks."""

from __future__ import annotations

import shutil
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench.common import data, manifest
from portbench.common.ranks import Ranks
from portbench.common.training import N_CHECKED, Steps
from portbench.common.weights import load_into
from portbench.drivers import train2d
from portbench.reference import augment, data_parallel, rng
from portbench.reference.train import dice_terms, exact_fp32, lr_at, run_steps

GATE_TIMEOUT = timedelta(minutes=20)  # a helper's wait for rank 0's window and its reading


def tiny(cell: dict, patch: int) -> None:
    """Cut ``cell`` for a CPU test: 32 slices of 32 x 32, 2 a card a step
    (the net's patch edge is a 3D cell's)."""
    cell["config_data"]["data"]["slice_shape"] = [32, 32]
    cell["config_data"]["train"]["batch_size"] = 2
    cell["traffic"].update(slices=32)


def _trainer(cell: dict, seed: int, mesh, dtype, weights=None):
    """This rank's trainer over the device-cached dataset; rank 0 loads
    ``weights``, which the trainer broadcasts."""
    from ich_tpu_torch.data.core import SliceDataset2D
    from ich_tpu_torch.ops.transforms import build_pipeline
    from ich_tpu_torch.train.segmentation2d import UNet2D

    cfg, traffic = cell["config_data"], cell["traffic"]
    tr, n = cfg["train"], traffic["slices"]
    images, masks = data.slices(seed, n, tuple(cfg["data"]["slice_shape"]),
                                traffic["positive_share"], cfg["data"]["window"], mesh.device)
    net = manifest.net(cfg["net"]).build(cfg["net"], mesh.device, dtype)
    if weights is not None:
        load_into(net, weights)
    ids = np.arange(n, dtype=np.int32)
    dataset = SliceDataset2D(images, masks, ids // 64, ids % 64).device_cache(mesh.device)
    trainer = UNet2D(
        net, n_epoch=1, batch_size=tr["batch_size"] * mesh.size, lr=tr["lr"],
        lr_scheduler=tr["lr_scheduler"], lr_scheduler_kwargs=tr["lr_scheduler_kwargs"],
        loss_fn=tr["loss_fn"], loss_fn_kwargs=tr["loss_fn_kwargs"],
        weight_decay=tr["weight_decay"],
        augment_fn=build_pipeline(cfg["data"]["augmentation"]), seed=seed, mesh=mesh)
    return trainer, dataset


def _train_rank(mesh, cell: dict, seed: int, dtype, gate: str) -> None:
    """A helper rank: set-up's warm epoch, then, once rank 0 opens its
    window, training until the agreed stop; it returns once rank 0 has
    read its window."""
    from ich_tpu_torch.utils import preemption

    trainer, dataset = _trainer(cell, seed, mesh, dtype)
    trainer.train(dataset)
    store = dist.FileStore(gate, -1)
    store.wait(["window"], GATE_TIMEOUT)
    trainer.n_epoch = 1 << 30
    trainer.train(dataset)
    preemption.reset()
    store.wait(["free"], GATE_TIMEOUT)


class _OptimizerGrads:
    """Makes each of ``recorder``'s steps hold the gradients as the
    optimizer takes them, the mean over the ranks (plus the decay), where
    its hooks on the parameters see this rank's own: a hook before every
    optimizer step, while the recorder still records."""

    def __init__(self, recorder: Steps, trainer, weight_decay: float):
        self.recorder, self.trainer, self.wd = recorder, trainer, weight_decay
        self.names = {id(p): k for k, p in trainer.unet.named_parameters()}
        self.handle = register_optimizer_step_pre_hook(self._hook)

    def _hook(self, opt, args, kwargs) -> None:
        grads = self.recorder.grads
        if self.trainer.state is None or self.trainer.state.step != len(grads) - 1:
            return
        grads[-1] = {self.names[id(p)]: p.grad.detach() + self.wd * p.detach()
                     for g in opt.param_groups for p in g["params"]
                     if p.grad is not None and id(p) in self.names}

    def remove(self) -> None:
        self.handle.remove()


def _broadcast(tensors: dict, mesh) -> None:
    for k in sorted(tensors):
        dist.broadcast(tensors[k], src=0, group=mesh.group)


def _reference(mesh, cell: dict, seed: int, variants, states=None) -> list:
    """This rank's part of the plain data-parallel steps, every rank
    together, once for each of ``variants`` (``(half_batch, plant)``, the
    faults :meth:`Driver.reference` takes): set-up's first steps from the
    seed's weights and BatchNorm averages, and the window's first step
    from the program's state as the window began (``states``: rank 0's
    three dicts, which the others receive). Returns rank 0's records, the
    loss and terms of its shard, one a variant (the helper ranks' go
    unread)."""
    cfg, traffic = cell["config_data"], cell["traffic"]
    net_cfg, tr = cfg["net"], cfg["train"]
    arch = manifest.net(net_cfg)
    dev, world, r = mesh.device, mesh.size, mesh.rank
    if states is None:
        shapes = arch.param_shapes(net_cfg)
        params = {k: torch.empty(s, device=dev) for k, s in shapes.items()}
        bufs = arch.running_stats(net_cfg, dev)
        states = (params, bufs, {**{k: v.clone() for k, v in params.items()},
                                 **{k: v.clone() for k, v in bufs.items()}})
    for s in states:
        _broadcast(s, mesh)
    weights, buffers0, at = states

    n, hw = traffic["slices"], tuple(cfg["data"]["slice_shape"])
    images, masks = data.slices(seed, n, hw, traffic["positive_share"], cfg["data"]["window"],
                                dev)
    b = tr["batch_size"]
    big = b * world
    w = -(-n // big)
    perm = np.random.default_rng(seed).permutation(n)
    spec = cfg["data"]["augmentation"]
    paths = arch.dropout_paths(net_cfg)
    keep = np.float32(1.0 - net_cfg["p_dropout"])
    root = rng.fold_in(rng.prng_key(seed), 0)

    def loss_of(s, params, bufs, half_batch, plant):
        j = s % w
        aug_key, drop_key = rng.split(rng.fold_in(root, j))
        mine = slice(r * b, (r + 1) * b)
        idx = torch.from_numpy(perm[j * big:(j + 1) * big][mine]).to(dev)
        m, o = (torch.from_numpy(a[mine]).to(dev)
                for a in augment.affine(aug_key, spec, big, *hw))
        x = augment.warp(images[idx], m, o, order=1)[:, None]
        y = augment.warp(masks[idx], m, o, order=0)

        def dropout(level, t):
            tl = t.movedim(1, -1)
            bits = data_parallel.philox_from(rng.dropout_rbg_key(drop_key, paths[level]),
                                             r * tl.numel(), tl.numel(), dev).view(tl.shape)
            u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
            return torch.where(u < float(keep), tl / float(keep), 0.0).movedim(-1, 1)

        p = data_parallel.averaged(params, mesh.group, plant)
        if plant == "local_stats":
            pred = arch.forward(p, x, net_cfg, train=True, running=bufs, dropout=dropout)
        else:
            with data_parallel.GlobalBatchStats(mesh.group, world):
                pred = arch.forward(p, x, net_cfg, train=True, running=bufs, dropout=dropout)
        if half_batch:
            pred, y = pred[:b // 2], y[:b // 2]
        kw = tr["loss_fn_kwargs"]
        return dice_terms(pred, y, p=kw["p"], alpha=kw["alpha"])

    def lr_of(s):
        return lr_at(tr, w, s)

    out = []
    with exact_fp32():
        for half_batch, plant in variants:
            first = run_steps(weights, buffers0, N_CHECKED,
                              lambda s, p, q: loss_of(s, p, q, half_batch, plant), lr_of,
                              tr["weight_decay"])
            window = run_steps({k: at[k] for k in weights}, {k: at[k] for k in buffers0}, 1,
                               lambda s, p, q: loss_of(w + s, p, q, half_batch, plant),
                               lambda s: lr_of(w + s), tr["weight_decay"])
            out.append({"first": first, "window": window})
    return out


class Driver(train2d.Driver):
    unit = "steps"

    def __init__(self, cell: dict, seed: int, device, dtype=None):
        self.cell, self.cfg = cell, cell["config_data"]
        self.traffic, self.seed, self.dtype = cell["traffic"], seed, dtype
        self.world = cell["chips"]
        net_cfg, tr = self.cfg["net"], self.cfg["train"]
        self.arch = manifest.net(net_cfg)  # nets/<arch>.py
        self.gate_dir = tempfile.mkdtemp(prefix="portbench-gate-")
        self.gate = f"{self.gate_dir}/gate"
        self.ranks = Ranks(self.world, device, _train_rank, args=(cell, seed, dtype, self.gate))
        mesh = self.ranks.mesh
        self.device = mesh.device
        n, hw = self.traffic["slices"], tuple(self.cfg["data"]["slice_shape"])
        self.steps_per_epoch = -(-n // (tr["batch_size"] * self.world))
        images, _ = data.slices(seed, 32, hw, self.traffic["positive_share"],
                                self.cfg["data"]["window"], self.device)
        _, gen = data.generators(seed + 1, self.device)
        self.weights = self.arch.make_weights(net_cfg, gen, self.device)
        self.arch.calibrate_final_bias(self.weights, net_cfg, images[:32, None], train=True)
        del images
        self.buffers0 = {k: v.clone() for k, v in
                         self.arch.running_stats(net_cfg, self.device).items()}
        self.trainer, self.dataset = _trainer(cell, seed, mesh, dtype, self.weights)
        self.recorder = Steps(self.trainer, tr["loss_fn_kwargs"], tr["weight_decay"],
                              self.steps_per_epoch)
        self.optimizer_grads = _OptimizerGrads(self.recorder, self.trainer, tr["weight_decay"])
        self.trainer.train(self.dataset)  # the warm epoch, every rank
        self.voxels_per_step = tr["batch_size"] * self.world * hw[0] * hw[1]

    def window(self, seconds: float) -> dict:
        """``train2d``'s window on rank 0, the helpers let into theirs as it
        opens; ``train_mvox_per_s`` counts the global batch's voxels,
        ``units`` the steps (each rank's, taken together)."""
        dist.FileStore(self.gate, -1).set("window", "1")
        try:
            return super().window(seconds)
        finally:
            self.optimizer_grads.remove()

    def free(self) -> None:
        dist.FileStore(self.gate, -1).set("free", "1")
        del self.trainer, self.dataset
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            self.ranks.close()
        finally:
            shutil.rmtree(self.gate_dir, ignore_errors=True)

    def reference(self, record: dict, half_batch: bool = False, plant=None) -> dict:
        """The plain data-parallel steps over the same shards: set-up's
        first steps from the seed, the window's first from the program's
        state as the window began. ``half_batch`` plants the loss over the
        first half of each shard alone; ``plant``, one of
        ``reference/data_parallel.py``'s faults."""
        return self.references(record, [(half_batch, plant)])[0]

    def references(self, record: dict, variants) -> list:
        """:meth:`reference` for each ``(half_batch, plant)`` of
        ``variants``, on one group of ``chips`` ranks of its own."""
        ranks = Ranks(self.world, self.device, _reference,
                      args=(self.cell, self.seed, list(variants)))
        try:
            at = record["at"][self.steps_per_epoch]
            states = ({k: v.clone() for k, v in self.weights.items()},
                      {k: v.clone() for k, v in self.buffers0.items()},
                      {k: v.clone() for k, v in at.items()})
            return _reference(ranks.mesh, self.cell, self.seed, variants, states)
        finally:
            ranks.close()

    def control(self) -> dict:
        """The program's own bf16 compute path (``UNet(dtype=bfloat16)``) in
        place of its float32 one, through set-up and a window of one
        epoch, on a group of its own."""
        twin = Driver(self.cell, self.seed, self.device, dtype=torch.bfloat16)
        twin.window(0.0)
        twin.free()
        return twin.check()
