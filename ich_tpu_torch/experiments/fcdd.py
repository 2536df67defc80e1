"""FCDD anomaly localization: training and volume evaluation (counterpart
of ``scripts/fcdd.py``; the schema of ``configs/fcdd.json``).

Training: every slice of ``path.RSNA_DATA`` (``load_rsna_slices``) with its
label column 0 trains ``FCDD_CNN_VGG`` (weights drawn from ``seed``) with
the ``anomaly`` section's synthetic ellipses (``artificial``, ``proba``,
``drawing_params``, ``gauss_std``) under ``train``'s ``n_epoch``,
``batch_size`` and ``lr``, logging the slices' AUC each epoch; then the
heatmap range of the first 512 slices, ``localization/anomaly_{i}.png``,
``fcdd.bin`` and ``outputs.json`` under ``<OUTPUT>/<exp_name>``
(``checkpoint.bin`` is resumed from when present).

``--eval-volumes``: the weights of ``ad.model_path`` make the heatmaps of
the SegICH 2D tree at ``path.DATA``, scaled by the range of its first 512
slices and thresholded at ``ad.threshold`` (0.5); the slices are scored
into ``slice_prediction_scores.csv`` (with the pixel AUC of each slice with
a lesion) and ``volume_prediction_scores.csv``. Run it as::

    python -m ich_tpu_torch.experiments.fcdd CONFIG.json [--eval-volumes] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.experiments.pretrain_finetune import load_pretrain_data
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
from ich_tpu_torch.ops.metrics import pixel_auc
from ich_tpu_torch.postprocessing.update_pred import slice_score_row, write_prediction_scores
from ich_tpu_torch.train.fcdd_trainer import FCDD
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.utils.logging import setup_logger
from ich_tpu_torch.utils import rng

MIN_MAX_SLICES = 512  # the slices whose heatmaps set the display range


def build_fcdd(cfg: dict, device: str | torch.device = "cuda") -> FCDD:
    """The config's FCDD trainer, the net's weights drawn from ``seed``."""
    an, tr, seed = cfg.get("anomaly", {}), cfg["train"], cfg.get("seed", 42)
    with torch.device(resolve_device(device)):  # the weights drawn on the device
        net = FCDD_CNN_VGG(key=rng.prng_key(seed))
    return FCDD(net, artificial_anomaly=an.get("artificial", True),
                anomaly_proba=an.get("proba", 0.5), drawing_params=an.get("drawing_params", {}),
                gauss_std=an.get("gauss_std"), n_epoch=tr["n_epoch"],
                batch_size=tr["batch_size"], lr=tr["lr"], seed=seed, device=device)


def train_fcdd(cfg: dict, dataset, device: str | torch.device = "cuda") -> str:
    """Train on ``dataset`` (RSNA slices with multilabel rows); returns the
    output dir."""
    f = build_fcdd(cfg, device)
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    data = LabeledSliceDataset(dataset.images, np.asarray(dataset.labels)[:, 0]).device_cache(
        f.device)
    f.train(data, valid_dataset=data, checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    f.get_min_max(data.images[:MIN_MAX_SLICES])
    f.localize_anomalies(data.images, os.path.join(out_dir, "localization"))
    f.save_model(os.path.join(out_dir, "fcdd.bin"))
    f.save_outputs(os.path.join(out_dir, "outputs.json"))
    return out_dir


def eval_volumes(cfg: dict, device: str | torch.device = "cuda") -> tuple:
    """Score every slice of ``path.DATA``; returns (output dir, the slice
    columns, the volume table)."""
    size = cfg["data"]["size"]
    f = build_fcdd(cfg, device)
    f.load_model(cfg["ad"]["model_path"])
    test = load_segich_2d(cfg["path"]["DATA"],
                          window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                          size=size)
    f.get_min_max(test.images[:MIN_MAX_SLICES])
    heat = f.generate_heatmap(test.images)
    thr = cfg["ad"].get("threshold", 0.5)
    rows = []
    for i in range(len(test)):
        t = test.masks[i]
        rows.append(slice_score_row(
            (heat[i] >= thr).astype(np.float32), t, test.vol_ids[i], test.slice_nbrs[i],
            pixel_AUC=pixel_auc(heat[i], t) if t.max() > 0 else float("nan")))
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    cols, (_, vol) = write_prediction_scores(rows, out_dir)
    return out_dir, cols, vol


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="FCDD training, or its evaluation on SegICH.")
    ap.add_argument("config", help="JSON config (the schema of configs/fcdd.json)")
    ap.add_argument("--eval-volumes", action="store_true",
                    help="evaluate on the SegICH dataset instead of training")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    if args.eval_volumes:
        out, cols, vol = eval_volumes(cfg, args.device)
        auc = np.asarray(cols.get("pixel_AUC", [np.nan]), np.float64)
        print(f"volume Dice: {np.mean(vol['Dice']):.4f}; pixel AUC (pos slices): "
              f"{np.nanmean(auc) if np.isfinite(auc).any() else float('nan'):.4f}")
    else:
        out = train_fcdd(cfg, load_pretrain_data(cfg), args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
