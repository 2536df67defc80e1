"""The label-efficiency sweep (BASELINE config 5; counterpart of
``scripts/label_efficiency.py``): pretrain once on the RSNA slices, then
run the k-fold fine-tune on the SegICH 2D CSV tree at several fractions of
the labelled training patients, and print each fraction's
``average_scores.txt``. Run it as::

    python -m ich_tpu_torch.experiments.label_efficiency CONFIG.json \\
        [--pretrain {none,context_restoration,contrastive,classifier}] \\
        [--fractions 0.1,0.25,0.5,1.0] [--low-label-recipe] [--device cuda]

``--low-label-recipe``: below 15% of the labels, cap the negative slices at
0.25x the positive ones (the reference's ``frac_negative``,
``UNet2D_scripts.py:121-123``) and double the fine-tune's epochs.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from ich_tpu_torch.experiments.pretrain_finetune import (
    PRETRAIN,
    label_efficiency_sweep,
    load_pretrain_data,
)
from ich_tpu_torch.utils.logging import setup_logger

LOW_LABEL_RECIPE = {"below": 0.15, "frac_negative": 0.25, "epoch_mult": 2}


def main(argv: Optional[Sequence[str]] = None) -> Dict[float, str]:
    ap = argparse.ArgumentParser(description="Pretrain once, fine-tune at label fractions.")
    ap.add_argument("config", help="JSON config (the schema of "
                                   "configs/contrastive_global_local.json)")
    ap.add_argument("--pretrain", choices=("none",) + tuple(PRETRAIN), default="contrastive")
    ap.add_argument("--fractions", default="0.1,0.25,0.5,1.0")
    ap.add_argument("--low-label-recipe", action=argparse.BooleanOptionalAction, default=False,
                    help="below 15%% of the labels: cap negatives at 0.25x the positives and "
                         "double the epochs")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    weights = None
    if args.pretrain != "none":
        weights = PRETRAIN[args.pretrain](cfg, load_pretrain_data(cfg), device=args.device)
    fracs = tuple(float(f) for f in args.fractions.split(","))
    results = label_efficiency_sweep(
        cfg, weights, None, fractions=fracs, seed=cfg.get("seed", 42),
        low_label_recipe=LOW_LABEL_RECIPE if args.low_label_recipe else None,
        device=args.device)
    for frac, out in results.items():
        with open(os.path.join(out, "average_scores.txt")) as fh:
            print(f"fraction {frac:.0%}: {fh.read().strip()}")
    return results


if __name__ == "__main__":
    main()
