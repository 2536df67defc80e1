"""SN-PatchGAN inpainting training on the non-ICH RSNA slices (counterpart
of ``scripts/inpainting_gan.py``): the slices of ``path.RSNA_DATA`` loaded
at the config's window and size (``load_rsna_slices``), those with label
column 0 equal to 0 kept, and ``SNPatchGAN`` trained on them with the
config's generator (``SAGatedGenerator`` with ``net.self_attention``, else
``GatedGenerator`` with contextual attention; ``net.lat_channels``,
``net.remat``), discriminator (``net.disc_channels``), ``train`` and
``mask`` sections. Writes ``checkpoint.bin`` (resumed from when present),
``valid/valid_ep{e}_{i}.png`` every 5 epochs, ``snpatchgan.bin`` and
``outputs.json`` under ``<OUTPUT>/<exp_name>``. Validation inpaints the first batch under fixed
masks drawn from ``PRNGKey(1234)``. Run it as::

    python -m ich_tpu_torch.experiments.inpainting_gan CONFIG.json [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.experiments.pretrain_finetune import load_pretrain_data
from ich_tpu_torch.models.inpainting import GatedGenerator, PatchDiscriminator, SAGatedGenerator
from ich_tpu_torch.train.gan import SNPatchGAN
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.utils.logging import setup_logger
from ich_tpu_torch.utils import rng

DISC_CHANNELS = (64, 128, 256, 256, 256, 256)


def build_gan_nets(cfg: dict, device: str | torch.device = "cpu"):
    """The config's generator and discriminator, built on ``device``, their
    weights flax's ``init`` from the two halves of ``split(PRNGKey(seed))``,
    as the JAX trainer draws them."""
    n, seed = cfg["net"], cfg.get("seed", 42)
    gen_cls = SAGatedGenerator if n.get("self_attention", True) else GatedGenerator
    kg, kd = rng.split(rng.prng_key(seed))
    with torch.device(resolve_device(device)):
        g = gen_cls(lat_channels=n.get("lat_channels", 32), return_coarse=True,
                    remat=bool(n.get("remat", False)), key=kg)
        d = PatchDiscriminator(out_channels=tuple(n.get("disc_channels", DISC_CHANNELS)), key=kd)
    return g, d


def build_gan(cfg: dict, device: str | torch.device = "cuda") -> SNPatchGAN:
    g, d = build_gan_nets(cfg, device)
    tr = cfg["train"]
    return SNPatchGAN(
        g, d, n_epoch=tr["n_epoch"], batch_size=tr["batch_size"],
        lr_g=tr.get("lr_g", 1e-4), lr_d=tr.get("lr_d", 4e-4),
        lambda_L1=tr.get("lambda_L1", 0.5), lambda_gan=tr.get("lambda_gan", 0.5),
        gammaL1=tr.get("gammaL1", 0.99), mask_kwargs=cfg.get("mask", {}),
        checkpoint_freq=tr.get("checkpoint_freq", 3), seed=cfg.get("seed", 42), device=device)


def run_inpainting_gan(cfg: dict, dataset, device: str | torch.device = "cuda") -> str:
    """Train on the non-ICH slices of ``dataset`` (RSNA slices with
    multilabel rows); returns the output dir."""
    normal = np.asarray(dataset.labels)[:, 0] == 0
    images = np.asarray(dataset.images)[normal]
    gan = build_gan(cfg, device)
    data = LabeledSliceDataset(images, np.zeros(len(images), np.int32))
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    gan.train(data.device_cache(gan.device), valid_dataset=data,
              checkpoint_path=os.path.join(out_dir, "checkpoint.bin"),
              valid_path=os.path.join(out_dir, "valid"))
    gan.save_model(os.path.join(out_dir, "snpatchgan.bin"))
    gan.save_outputs(os.path.join(out_dir, "outputs.json"))
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="SN-PatchGAN inpainting on non-ICH RSNA slices.")
    ap.add_argument("config", help="JSON config (the schema of configs/inpainting_gan.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    out = run_inpainting_gan(cfg, load_pretrain_data(cfg), device=args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
