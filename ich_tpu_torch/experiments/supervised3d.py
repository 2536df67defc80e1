"""Supervised 3D patch training and sliding-window evaluation (counterpart
of ``scripts/unet3d.py``).

The SegICH 3D volumes of ``dataset.patient_numbers`` are loaded, windowed
and resampled (:func:`ich_tpu_torch.data.datasets.load_segich_3d`); the last
``max(1, int(0.2 n))`` volumes are the test set. A 3D U-Net from ``net``
trains on random patches of ``data.patch_size`` (``UNet3D.train``, with its
checkpoint and resume), then ``evaluate`` scores the test volumes by
sliding window and the run writes ``volume_prediction_scores.csv``,
``trained_unet3d.bin`` and ``outputs.json`` under ``OUTPUT/exp_name``. The
JSON config schema is the JAX package's (``configs/unet3d.json``). Run it
as::

    python -m ich_tpu_torch.experiments.supervised3d CONFIG.json [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import torch

from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.data.datasets import load_segich_3d
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.train.segmentation3d import UNet3D
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.logging import setup_logger


def split_test(ds: VolumeDataset3D) -> Tuple[VolumeDataset3D, VolumeDataset3D]:
    """(train, test): the last ``max(1, int(0.2 n))`` volumes are the test set."""
    n_test = max(1, int(0.2 * len(ds)))
    return (VolumeDataset3D(ds.volumes[:-n_test], ds.masks[:-n_test], ds.vol_ids[:-n_test]),
            VolumeDataset3D(ds.volumes[-n_test:], ds.masks[-n_test:], ds.vol_ids[-n_test:]))


def build_unet3d_from_cfg(net_cfg: dict, seed: int = 0, device: str | torch.device = "cpu",
                          **unet_kw) -> UNet:
    """The config's 3D U-Net with the JAX script's defaults, built on
    ``device``, its weights flax's ``init`` from ``PRNGKey(seed)``;
    ``unet_kw`` (``dtype``, ``remat``) go to :class:`UNet` as they are."""
    with torch.device(resolve_device(device)):
        return UNet(depth=net_cfg.get("depth", 4), ndim=3,
                    top_filter=net_cfg.get("top_filter", 16),
                    midchannels_factor=net_cfg.get("midchannels_factor", 1),
                    p_dropout=net_cfg.get("p_dropout", 0.0), norm=net_cfg.get("norm", "group"),
                    key=rng.prng_key(seed), **unet_kw)


def build_trainer3d(cfg: dict, net: UNet, device: str | torch.device = "cuda",
                    **overrides) -> UNet3D:
    """A ``UNet3D`` of ``net`` with the config's ``data.patch_size`` and
    ``train`` settings; ``overrides`` replace constructor arguments."""
    tr = cfg["train"]
    kw = dict(
        patch_size=tuple(cfg["data"].get("patch_size", (64, 128, 128))),
        steps_per_epoch=tr.get("steps_per_epoch", 100),
        pos_frac=tr.get("pos_frac", 0.5),
        n_epoch=tr["n_epoch"], batch_size=tr["batch_size"], lr=tr["lr"],
        loss_fn=tr.get("loss_fn", "BinaryDiceLoss"),
        loss_fn_kwargs=tr.get("loss_fn_kwargs", {"reduction": "mean", "p": 2, "alpha": 0.2}),
        sw_overlap=tr.get("sw_overlap", 0.5), sw_batch_size=tr.get("sw_batch_size"),
        seed=cfg.get("seed", 42), device=device,
    )
    return UNet3D(net, **{**kw, **overrides})


def run_supervised_3d(cfg: dict, device: str | torch.device = "cuda") -> UNet3D:
    """Load, split, train, evaluate and write the artifacts; returns the
    trained ``UNet3D`` (``trainer.outputs`` holds the scores)."""
    win = (cfg["data"]["win_center"], cfg["data"]["win_width"])
    ds = load_segich_3d(cfg["path"]["DATA"], cfg["dataset"]["patient_numbers"], window=win,
                        out_spacing=tuple(cfg["data"].get("out_spacing", (-1, -1, 2.5))))
    train, test = split_test(ds)
    trainer = build_trainer3d(cfg, build_unet3d_from_cfg(cfg["net"], seed=cfg.get("seed", 42),
                                                         device=device),
                              device)
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    trainer.train(train, valid_dataset=None,
                  checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    trainer.evaluate(test, save_path=out_dir)
    trainer.save_model(os.path.join(out_dir, "trained_unet3d.bin"))
    trainer.save_outputs(os.path.join(out_dir, "outputs.json"))
    print(f"Dice (all): {trainer.outputs['eval']['dice']['all']:.4f}; artifacts at {out_dir}")
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> UNet3D:
    ap = argparse.ArgumentParser(description="Supervised 3D U-Net patch training.")
    ap.add_argument("config", help="JSON config (the schema of configs/unet3d.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    return run_supervised_3d(cfg, device=args.device)


if __name__ == "__main__":
    main()
