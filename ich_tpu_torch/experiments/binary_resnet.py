"""The ResNet slice-triage classifier (counterpart of
``scripts/binary_resnet.py``): a ResNet (``net.name``, ResNet18 by default)
trained ICH / no-ICH on label column 0 of the RSNA slices of
``path.RSNA_DATA``, its weights the gate of the anomaly-detection
pipelines. Writes ``resnet_classifier.bin``, ``classifier_scores.json``
(the metrics on the training slices) and ``outputs.json`` under
``<OUTPUT>/<exp_name>``. Run it as::

    python -m ich_tpu_torch.experiments.binary_resnet CONFIG.json [--device cuda]
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
from ich_tpu_torch.models.resnet import FACTORIES
from ich_tpu_torch.train.classifier import BinaryClassifier
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.utils.logging import setup_logger
from ich_tpu_torch.utils import rng


def run_binary_resnet(cfg: dict, dataset, device: str | torch.device = "cuda") -> str:
    """Train and evaluate the triage ResNet on ``dataset`` (RSNA slices
    with multilabel rows); returns the output dir."""
    data = LabeledSliceDataset(dataset.images, np.asarray(dataset.labels)[:, 0].astype(np.int32))
    seed = cfg.get("seed", 42)
    with torch.device(resolve_device(device)):  # the weights drawn on the device
        net = FACTORIES[cfg["net"].get("name", "ResNet18")](num_classes=2,
                                                            key=rng.prng_key(seed))
    tr = cfg["train"]
    clf = BinaryClassifier(
        net, n_epoch=tr["n_epoch"], batch_size=tr["batch_size"], lr=tr["lr"],
        lr_scheduler=tr.get("lr_scheduler", "ExponentialLR"),
        lr_scheduler_kwargs=tr.get("lr_scheduler_kwargs", {"gamma": 0.95}),
        weight_decay=tr.get("weight_decay", 1e-6), class_weight=tr.get("class_weight"),
        seed=seed, device=device)
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    data = data.device_cache(clf.device)
    clf.train(data, checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    clf.evaluate(data, save_path=out_dir)
    clf.save_model(os.path.join(out_dir, "resnet_classifier.bin"))
    clf.save_outputs(os.path.join(out_dir, "outputs.json"))
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="ResNet ICH / no-ICH slice classifier.")
    ap.add_argument("config", help="JSON config (path.RSNA_DATA, data, net.name, train)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    out = run_binary_resnet(cfg, load_pretrain_data(cfg), device=args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
