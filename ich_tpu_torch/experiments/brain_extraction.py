"""The brain-extraction U-Net (counterpart of ``scripts/brain_extraction.py``):
the k-fold experiment of :mod:`ich_tpu_torch.experiments.supervised2d` on a
SegICH 2D tree whose masks are brain masks, then a final model trained on
every slice (the gate of the ICH pipelines), written as
``final_brain_unet.bin`` beside the k-fold artifacts. Run it as::

    python -m ich_tpu_torch.experiments.brain_extraction CONFIG.json [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from ich_tpu_torch.data.datasets import load_brain_extract_2d
from ich_tpu_torch.experiments.supervised2d import build_unet_from_cfg, run_supervised_2d
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.utils.logging import setup_logger


def train_on_all(cfg: dict, out_dir: str, device: str | torch.device = "cuda") -> str:
    """The final brain U-Net trained on every slice of ``path.DATA``
    (checkpointed to ``final_checkpoint.bin``); returns its weights file."""
    ds = load_brain_extract_2d(cfg["path"]["DATA"],
                               window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
                               size=cfg["data"]["size"])
    tr = cfg["train"]
    seed = cfg.get("seed", 42)
    trainer = UNet2D(build_unet_from_cfg(cfg["net"], seed=seed, device=device),
                     n_epoch=tr["n_epoch"], batch_size=tr["batch_size"], lr=tr["lr"],
                     loss_fn=tr.get("loss_fn", "BinaryDiceLoss"),
                     loss_fn_kwargs=tr.get("loss_fn_kwargs", {"reduction": "mean"}),
                     seed=seed, device=device)
    trainer.train(ds.device_cache(trainer.device),
                  checkpoint_path=os.path.join(out_dir, "final_checkpoint.bin"))
    fn = os.path.join(out_dir, "final_brain_unet.bin")
    trainer.save_model(fn)
    return fn


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Brain-extraction U-Net: k-fold, then train-on-all.")
    ap.add_argument("config", help="JSON config (the schema of configs/unet2d.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    out = run_supervised_2d(cfg, device=args.device)
    print(f"CV artifacts at {out}")
    setup_logger()
    fn = train_on_all(cfg, out, device=args.device)
    print(f"Final model at {fn}")
    return out


if __name__ == "__main__":
    main()
