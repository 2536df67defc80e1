"""Supervised segmentation with an anomaly-attention channel (counterpart of
``scripts/attention_unet2d.py``; reference ``adUNet2D_scripts.py``).

``path.DATA/info.csv`` lists each slice with its ``CT_fn``, ``mask_fn`` and
``attention_fn`` (an anomaly map, for example one that ``ad_inpainting
--export-attention`` wrote, its path relative to ``path.DATA``): the
rows of the export's ``info.csv`` merged into the dataset's by
(``PatientNumber``, ``SliceNumber``); this CLI does not merge them.
:func:`ich_tpu_torch.data.datasets.load_segich_attention_2d` stacks slice
and map as two channels, ``net.gated`` is set and ``net.in_channels`` taken
from the data, and the patients are split into ``split.n_fold`` folds
stratified by whether they have a lesion (:func:`stratified_kfold`, with
``seed``: scikit-learn's ``StratifiedKFold`` folds), then
:func:`run_supervised_2d` trains and evaluates each fold. Run it as::

    python -m ich_tpu_torch.experiments.attention_unet2d CONFIG.json [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.datasets import load_segich_attention_2d
from ich_tpu_torch.experiments.supervised2d import run_supervised_2d, stratified_kfold
from ich_tpu_torch.utils.logging import setup_logger


def run_attention_unet2d(cfg: dict, device: str | torch.device = "cuda") -> str:
    """The k-fold experiment on the attention tree; returns the output dir."""
    cfg = copy.deepcopy(cfg)
    full = load_segich_attention_2d(cfg["path"]["DATA"],
                                    window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                                    size=cfg["data"]["size"])
    cfg.setdefault("net", {}).update(gated=True, in_channels=int(full.images.shape[-1]))
    vols = np.unique(full.vol_ids)
    has_ich = np.asarray([full.masks[full.vol_ids == v].max() > 0 for v in vols]).astype(int)
    splits = list(stratified_kfold(has_ich, cfg["split"]["n_fold"], shuffle=True,
                                   seed=cfg.get("seed", 42)))

    def folds(k):
        tr_idx, te_idx = splits[k]
        tr = np.isin(full.vol_ids, vols[tr_idx])
        te = np.isin(full.vol_ids, vols[te_idx])
        return full.subset(np.nonzero(tr)[0]), full.subset(np.nonzero(te)[0])

    return run_supervised_2d(cfg, datasets_by_fold=folds, device=device)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Gated U-Net on (slice, anomaly map) pairs, k-fold.")
    ap.add_argument("config", help="JSON config (the schema of configs/unet2d.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    out = run_attention_unet2d(cfg, device=args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
