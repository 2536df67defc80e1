"""Inpainting anomaly detection over a SegICH 2D dataset (counterpart of
``scripts/ad_inpainting.py``): the trained SN-PatchGAN generator
(``ad.generator_path``, a ``snpatchgan.bin``) inpaints, an optional
ResNet-18 gate (``ad.classifier_path``, a ``resnet_classifier.bin``)
scores every slice in one batched pass, and ``robust_anomaly_detect`` runs
on each slice scoring at least ``ad.gate_threshold`` (0.5); the others get
an empty prediction. Writes ``slice_prediction_scores.csv`` and
``volume_prediction_scores.csv`` under ``<OUTPUT>/<exp_name>``. With
``--export-attention DIR``, each slice's anomaly map goes to
``DIR/{vol}/{slice}_attention.png`` and the rows to ``DIR/info.csv``, the
bytes pandas' ``DataFrame(rows).to_csv`` writes. The ``ad`` section's keys
and defaults are the JAX script's (``grid_hole`` [32, 32], ``grid_step``
16, ``batch_size`` 16, ``use_wasserstein`` false, ``n_iter`` 3, ``angles``
[-15, -7.5, 7.5, 15], ``flip`` true). Run it as::

    python -m ich_tpu_torch.experiments.ad_inpainting CONFIG.json \\
        [--export-attention DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.data.table import write_csv
from ich_tpu_torch.experiments.inpainting_gan import build_gan_nets
from ich_tpu_torch.models.resnet import resnet18
from ich_tpu_torch.postprocessing.update_pred import slice_score_row, write_prediction_scores
from ich_tpu_torch.train.classifier import BinaryClassifier
from ich_tpu_torch.train.gan import SNPatchGAN
from ich_tpu_torch.train.inpaint_ad import InpaintAnomalyDetector, robust_anomaly_detect
from ich_tpu_torch.utils.logging import setup_logger

INFO_COLUMNS = ("PatientNumber", "SliceNumber", "attention_fn")


def save_attention_map(export_dir: str, vol_id: int, slice_nbr: int, amap: np.ndarray) -> str:
    """Write one slice's anomaly map, clipped to [0, 1], as the 8-bit PNG
    ``export_dir/{vol}/{slice}_attention.png``; returns its path relative
    to ``export_dir``."""
    os.makedirs(os.path.join(export_dir, str(vol_id)), exist_ok=True)
    rel = f"{vol_id}/{slice_nbr}_attention.png"
    save_png_gray(os.path.join(export_dir, rel), (np.clip(amap, 0, 1) * 255).astype(np.uint8))
    return rel


def write_attention_info(export_dir: str, rows: Sequence[tuple]) -> None:
    """``export_dir/info.csv``: a leading index, then (PatientNumber,
    SliceNumber, attention_fn) per row."""
    write_csv(os.path.join(export_dir, "info.csv"), ("",) + INFO_COLUMNS,
              ([j, *r] for j, r in enumerate(rows)))


def build_detector(cfg: dict, device: str | torch.device = "cuda") -> InpaintAnomalyDetector:
    """The detector around the generator of ``ad.generator_path``."""
    ad = cfg["ad"]
    gan = SNPatchGAN(*build_gan_nets(cfg), device=device)  # the seeded weights are replaced
    gan.load_model(ad["generator_path"])
    return InpaintAnomalyDetector(
        gan.inpaint, grid_hole=tuple(ad.get("grid_hole", (32, 32))),
        grid_step=ad.get("grid_step", 16), batch_size=ad.get("batch_size", 16),
        use_wasserstein=ad.get("use_wasserstein", False), n_iter=ad.get("n_iter", 3),
        device=device)


def run_ad_inpainting(cfg: dict, export_attention: Optional[str] = None,
                      device: str | torch.device = "cuda") -> tuple:
    """Detect on every slice of ``path.DATA``; returns (output dir, the
    volume table of :func:`write_prediction_scores`)."""
    ad = cfg["ad"]
    test = load_segich_2d(cfg["path"]["DATA"],
                          window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                          size=cfg["data"]["size"])
    det = build_detector(cfg, device)
    gate_scores = None
    if ad.get("classifier_path"):
        gate = BinaryClassifier(resnet18(num_classes=2), device=device)
        gate.load_model(ad["classifier_path"])
        gate_scores = gate.predict_scores(test.images)  # one batched pass

    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    rows, att_rows = [], []
    for i in range(len(test)):
        img = test.images[i]
        vid, snb = int(test.vol_ids[i]), int(test.slice_nbrs[i])
        if gate_scores is None or float(gate_scores[i]) >= ad.get("gate_threshold", 0.5):
            pred, amap = robust_anomaly_detect(img, det,
                                               angles_list=ad.get("angles", [-15, -7.5, 7.5, 15]),
                                               flip=ad.get("flip", True))
        else:
            pred, amap = np.zeros_like(img, dtype=bool), np.zeros_like(img)
        rows.append(slice_score_row(pred, test.masks[i], vid, snb))
        if export_attention:
            att_rows.append((vid, snb, save_attention_map(export_attention, vid, snb, amap)))
    _, (_, vol) = write_prediction_scores(rows, out_dir)
    if export_attention and att_rows:
        write_attention_info(export_attention, att_rows)
    return out_dir, vol


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Inpainting anomaly detection on SegICH 2D slices.")
    ap.add_argument("config", help="JSON config (path.DATA, path.OUTPUT, data, net, ad)")
    ap.add_argument("--export-attention", default=None,
                    help="dir to export the anomaly maps as the attention channel + info.csv")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    out, vol = run_ad_inpainting(cfg, args.export_attention, device=args.device)
    dice = float(np.mean(vol["Dice"])) if len(vol["Dice"]) else float("nan")
    print(f"volume Dice (all): {dice:.4f}; artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
