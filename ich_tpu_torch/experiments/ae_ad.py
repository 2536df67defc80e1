"""Autoencoder training and AE-based anomaly detection (counterpart of
``scripts/ae_ad.py``).

Training: the slices of ``path.RSNA_DATA`` (``load_rsna_slices`` at the
config's window and size, ``dataset.n_max``) whose label column 0 is 0 train
an ``AENet`` (``net``: ``latent_channels``, ``bottelneck_channels`` in the
reference's spelling, ``n_conv``, ``bilinear``, ``kernel_size``; weights
drawn from ``seed``) under ``train``'s ``n_epoch``, ``batch_size``, ``lr``
and ``lambda_GDL``. Writes ``checkpoint.bin`` (resumed from when present),
``valid/rec_ep{e}_{i}.png`` every 5 epochs, ``ae.bin`` and
``outputs.json`` under ``<OUTPUT>/<exp_name>``.

``--detect``: the weights of ``ad.model_path`` map every slice of the
SegICH 2D tree at ``path.DATA`` (``load_segich_2d``) to ``|rec - im|``;
each map is thresholded by hysteresis between its q75 and q75 + ``ad.alpha``
(1.5) x IQR, and the slices are scored into ``slice_prediction_scores.csv``
(with the pixel AUC of each slice with a lesion) and
``volume_prediction_scores.csv``. Run it as::

    python -m ich_tpu_torch.experiments.ae_ad CONFIG.json [--detect] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.core import SliceDataset2D
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.experiments.pretrain_finetune import load_pretrain_data
from ich_tpu_torch.models.ae import AENet
from ich_tpu_torch.ops import morphology as morph
from ich_tpu_torch.ops.metrics import pixel_auc
from ich_tpu_torch.postprocessing.update_pred import slice_score_row, write_prediction_scores
from ich_tpu_torch.train.ae_trainer import AE
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.utils.logging import setup_logger
from ich_tpu_torch.utils import rng


def build_ae(cfg: dict, device: str | torch.device = "cuda") -> AE:
    """The config's AE trainer, the net's weights drawn from ``seed``."""
    n, tr, seed = cfg.get("net", {}), cfg["train"], cfg.get("seed", 42)
    with torch.device(resolve_device(device)):  # the weights drawn on the device
        net = AENet(
            latent_channels=n.get("latent_channels", 64),
            bottleneck_channels=n.get("bottelneck_channels", 64), n_conv=n.get("n_conv", 3),
            bilinear=n.get("bilinear", False), kernel_size=n.get("kernel_size", 5),
            key=rng.prng_key(seed))
    return AE(net, lambda_GDL=tr.get("lambda_GDL"), n_epoch=tr["n_epoch"],
              batch_size=tr["batch_size"], lr=tr["lr"], seed=seed, device=device)


def train_ae(cfg: dict, dataset, device: str | torch.device = "cuda") -> str:
    """Train on the non-ICH slices of ``dataset`` (RSNA slices with
    multilabel rows); returns the output dir."""
    ae = build_ae(cfg, device)
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    imgs = np.asarray(dataset.images)[np.asarray(dataset.labels)[:, 0] == 0]
    n = len(imgs)
    data = SliceDataset2D(imgs, np.zeros_like(imgs), np.arange(n), np.zeros(n, np.int32))
    ae.train(data.device_cache(ae.device), valid_dataset=data,
             checkpoint_path=os.path.join(out_dir, "checkpoint.bin"),
             valid_path=os.path.join(out_dir, "valid"))
    ae.save_model(os.path.join(out_dir, "ae.bin"))
    ae.save_outputs(os.path.join(out_dir, "outputs.json"))
    return out_dir


def detect_ae(cfg: dict, device: str | torch.device = "cuda") -> tuple:
    """Score every slice of ``path.DATA``; returns (output dir, the slice
    columns, the volume table)."""
    ae = build_ae(cfg, device)
    ae.load_model(cfg["ad"]["model_path"])
    test = load_segich_2d(cfg["path"]["DATA"],
                          window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                          size=cfg["data"]["size"])
    amaps = ae.anomaly_map(test.images)
    alpha = cfg["ad"].get("alpha", 1.5)
    rows = []
    for i in range(len(test)):
        a = torch.from_numpy(amaps[i]).to(ae.device)
        lo, hi = morph.quantile_iqr_thresholds(a, alpha)
        pred = morph.hysteresis_threshold(a, lo, hi).cpu().numpy()
        t = test.masks[i]
        rows.append(slice_score_row(
            pred, t, test.vol_ids[i], test.slice_nbrs[i],
            pixel_AUC=pixel_auc(amaps[i], t) if t.max() > 0 else float("nan")))
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    cols, (_, vol) = write_prediction_scores(rows, out_dir)
    return out_dir, cols, vol


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="AE training, or AE anomaly detection on SegICH.")
    ap.add_argument("config", help="JSON config (path, data, net, train, ad)")
    ap.add_argument("--detect", action="store_true",
                    help="run anomaly detection instead of training")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    if args.detect:
        out, cols, vol = detect_ae(cfg, args.device)
        auc = np.asarray(cols.get("pixel_AUC", [np.nan]), np.float64)
        print(f"volume Dice (all): {np.mean(vol['Dice']):.4f}; pixel AUC (pos slices): "
              f"{np.nanmean(auc) if np.isfinite(auc).any() else float('nan'):.4f}")
    else:
        out = train_ae(cfg, load_pretrain_data(cfg), args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
