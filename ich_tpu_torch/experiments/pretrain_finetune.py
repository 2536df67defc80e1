"""Pretraining, then the k-fold supervised fine-tune, and the
label-efficiency sweep (counterpart of
:mod:`ich_tpu.experiments.pretrain_finetune`).

- ``pretrain_context_restoration``: patch-swap restoration of a U-Net
  (``configs/context_restoration.json``), artifacts under
  ``<OUTPUT>/<exp_name>/pretrain``;
- ``pretrain_contrastive``: global NT-Xent on the U-Net encoder, then, with
  a ``local`` section, local NT-Xent on the partial U-Net with the
  transferred encoder frozen (``configs/contrastive_global_local.json``),
  under ``pretrain_global`` and ``pretrain_local``;
- ``pretrain_classifier``: ICH / no-ICH (or, with ``multi``, 7-way
  multilabel) classification of the RSNA slices by the U-Net encoder with
  an ``MLP_head + (n_out,)`` head, under ``pretrain_classifier``;
- ``run_supervised_2d_with_init`` / ``finetune_kfold``: the k-fold
  experiment of :mod:`ich_tpu_torch.experiments.supervised2d` with the
  pretrained weights moved into each fold's U-Net by key intersection; the
  encoder and, after the local phase, the first decoder stages move;
- ``label_efficiency_sweep``: that fine-tune at several label fractions
  (BASELINE config 5), each fold's training patients subsampled, with the
  optional low-label recipe.

Each phase writes ``checkpoint.bin`` (and resumes from it),
``pretrained.bin`` and ``outputs.json``. Run it as::

    python -m ich_tpu_torch.experiments.pretrain_finetune \\
        {context_restoration,contrastive,classifier} CONFIG.json [--multi] [--device cuda]

which loads the RSNA slices of ``path.RSNA_DATA`` (its ``slice_info.csv``,
as :func:`ich_tpu_torch.data.datasets.write_rsna_slice_info` writes it),
pretrains, and fine-tunes on the SegICH 2D data of ``path.DATA``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.datasets import load_rsna_slices
from ich_tpu_torch.experiments.supervised2d import (
    build_unet_from_cfg,
    run_supervised_2d,
    subsample_label_fraction,
)
from ich_tpu_torch.models.unet import PartialUNet, UNetEncoder
from ich_tpu_torch.train.classifier import BinaryClassifier, MultiClassifier
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.train.ssl import ContextRestoration, Contrastive
from ich_tpu_torch.utils import preemption, rng
from ich_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]


def _abort_if_preempted(phase: str) -> None:
    """A preempted phase checkpointed and stopped early: the next phase must
    not start from half-trained weights and write finished artifacts."""
    if preemption.requested():
        logger.warning("Preempted during %s: leaving checkpoint for resume.", phase)
        raise SystemExit(143)


def _phase_dir(cfg: dict, phase: str) -> str:
    out_dir = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"], phase)
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def build_encoder(cfg: dict, mlp_head: Optional[Tuple[int, ...]] = None,
                  device: str | torch.device = "cpu") -> UNetEncoder:
    """The global phase's encoder (or, with ``mlp_head``, the classifier's);
    the defaults are ``build_unet_from_cfg``'s, so that its weights move
    into the fine-tune U-Net. Built on ``device``."""
    n = cfg["net"]
    head = mlp_head or tuple(n.get("MLP_head", (256, 128)))
    with torch.device(resolve_device(device)):
        return UNetEncoder(
            depth=n.get("depth", 5), top_filter=n.get("top_filter", 64),
            midchannels_factor=n.get("midchannels_factor", 2), mlp_head=head,
            p_dropout=n.get("p_dropout", 0.0), key=rng.prng_key(cfg.get("seed", 42)))


def build_partial_unet(cfg: dict, device: str | torch.device = "cpu") -> PartialUNet:
    """The local phase's partial U-Net, built on ``device``."""
    n, lc = cfg["net"], cfg["local"]
    with torch.device(resolve_device(device)):
        return PartialUNet(
            depth=n.get("depth", 5), n_decoder=lc.get("n_decoder", 3),
            top_filter=n.get("top_filter", 64), midchannels_factor=n.get("midchannels_factor", 2),
            head_channel=tuple(lc.get("head_channel", (64, 32))),
            p_dropout=n.get("p_dropout", 0.0), key=rng.prng_key(cfg.get("seed", 42)))


def _train_kwargs(tr: dict) -> dict:
    return dict(n_epoch=tr["n_epoch"], batch_size=tr["batch_size"], lr=tr["lr"],
                lr_scheduler=tr.get("lr_scheduler", "ExponentialLR"),
                lr_scheduler_kwargs=tr.get("lr_scheduler_kwargs", {"gamma": 0.95}),
                weight_decay=tr.get("weight_decay", 1e-6))


def pretrain_context_restoration(cfg: dict, dataset, device: str | torch.device = "cuda"
                                 ) -> StateDict:
    """Context-restoration pretraining; returns the pretrained weights."""
    seed = cfg.get("seed", 42)
    net = build_unet_from_cfg({**cfg["net"], "use_final_activation": False}, seed=seed,
                              device=device)
    corruption = cfg.get("corruption", {})
    cr = ContextRestoration(
        net, n_swap=corruption.get("n_swap", 10), swap_w=corruption.get("swap_w", (10, 30)),
        swap_h=corruption.get("swap_h", (10, 30)), swap_rotate=corruption.get("rotate", True),
        seed=seed, device=device, **_train_kwargs(cfg["train"]))
    out_dir = _phase_dir(cfg, "pretrain")
    cr.train(dataset, checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    _abort_if_preempted("context-restoration pretrain")
    try:
        labels = getattr(dataset, "labels", None)
        if labels is not None:
            labels = np.asarray(labels)
            labels = labels[:, 0] if labels.ndim > 1 else labels
        cr.evaluate_representation(dataset, labels=labels, max_samples=512)
    except Exception as e:  # t-SNE is best-effort reporting (scikit-learn may be absent)
        logger.warning("representation eval skipped: %s", e)
    cr.save_model(os.path.join(out_dir, "pretrained.bin"))
    cr.save_outputs(os.path.join(out_dir, "outputs.json"))
    return cr.get_state_dict()


def pretrain_contrastive(cfg: dict, dataset, local_dataset=None, aug_pipeline=None,
                         local_aug_pipeline=None, device: str | torch.device = "cuda"
                         ) -> StateDict:
    """Global NT-Xent, then with ``cfg["local"]`` the local phase with the
    transferred encoder frozen; returns the last phase's weights.
    ``aug_pipeline`` replaces the default views in both phases and
    ``local_aug_pipeline`` in the local phase only."""
    seed = cfg.get("seed", 42)
    glob = Contrastive(build_encoder(cfg, device=device), is_global=True, tau=cfg.get("tau", 0.5),
                       aug_pipeline=aug_pipeline, seed=seed, device=device,
                       **_train_kwargs(cfg["train"]))
    out_dir = _phase_dir(cfg, "pretrain_global")
    glob.train(dataset, checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    _abort_if_preempted("global contrastive pretrain")
    glob.save_model(os.path.join(out_dir, "pretrained.bin"))
    glob.save_outputs(os.path.join(out_dir, "outputs.json"))
    weights = glob.get_state_dict()

    lc = cfg.get("local")
    if lc:
        tr = cfg["train"]
        local = Contrastive(
            build_partial_unet(cfg, device=device), is_global=False, tau=lc.get("tau", 0.5),
            K=lc.get("K", 3), n_region=lc.get("n_region", 13),
            aug_pipeline=local_aug_pipeline or aug_pipeline,
            n_epoch=lc.get("n_epoch", tr["n_epoch"]),
            batch_size=lc.get("batch_size", tr["batch_size"]),
            lr=lc.get("lr", tr["lr"]), seed=seed, device=device)
        local.transfer_weights(weights, freeze=lc.get("freeze", True), verbose=True)
        out_dir = _phase_dir(cfg, "pretrain_local")
        local.train(local_dataset or dataset,
                    checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
        _abort_if_preempted("local contrastive pretrain")
        local.save_model(os.path.join(out_dir, "pretrained.bin"))
        local.save_outputs(os.path.join(out_dir, "outputs.json"))
        weights = local.get_state_dict()
    return weights


def pretrain_classifier(cfg: dict, dataset, multi: bool = False,
                        device: str | torch.device = "cuda") -> StateDict:
    """ICH / no-ICH (label column 0) or, with ``multi``, 7-way multilabel
    classification pretraining of the U-Net encoder, its head ``MLP_head +
    (2,)`` or ``+ (7,)``; returns the pretrained weights."""
    tr = cfg["train"]
    n_out = 7 if multi else 2
    enc = build_encoder(cfg, tuple(cfg["net"].get("MLP_head", (256,))) + (n_out,),
                        device=device)
    cls = (MultiClassifier if multi else BinaryClassifier)(
        enc, class_weight=tr.get("class_weight"), seed=cfg.get("seed", 42), device=device,
        **_train_kwargs(tr))
    labels = np.asarray(dataset.labels)
    if not multi and labels.ndim > 1:
        dataset = LabeledSliceDataset(dataset.images, labels[:, 0].astype(np.int32))
    out_dir = _phase_dir(cfg, "pretrain_classifier")
    cls.train(dataset, checkpoint_path=os.path.join(out_dir, "checkpoint.bin"))
    _abort_if_preempted("classification pretrain")
    cls.evaluate(dataset, print_to_logger=True, save_path=out_dir)
    cls.save_model(os.path.join(out_dir, "pretrained.bin"))
    cls.save_outputs(os.path.join(out_dir, "outputs.json"))
    return cls.get_state_dict()


def run_supervised_2d_with_init(cfg: dict, pretrained: Optional[StateDict], datasets_by_fold,
                                device: str | torch.device = "cuda") -> str:
    """``run_supervised_2d`` with the pretrained weights moved into each
    fold's net; returns the experiment's output dir."""
    return run_supervised_2d(cfg, datasets_by_fold=datasets_by_fold,
                             init_state_dict=pretrained, device=device)


def finetune_kfold(cfg: dict, pretrained: StateDict, datasets_by_fold,
                   device: str | torch.device = "cuda") -> str:
    """The k-fold fine-tune from pretrained weights (the reference's
    phase 3, ``ContextRestoration_UNet2D_scripts.py:310-312``)."""
    return run_supervised_2d_with_init(cfg, pretrained, datasets_by_fold, device)


def label_efficiency_sweep(
    cfg: dict,
    pretrained: Optional[StateDict],
    datasets_by_fold: Optional[Callable],
    fractions: Sequence[float] = (0.1, 0.25, 0.5, 1.0),
    seed: int = 42,
    low_label_recipe: Optional[dict] = None,
    device: str | torch.device = "cuda",
) -> Dict[float, str]:
    """The fine-tune at each label ``fraction`` (BASELINE config 5) under
    ``<exp_name>_frac<100 fraction>``: each fold's training patients
    subsampled (with ``np.random.default_rng(seed + k)`` on ``datasets_by_fold``'s
    volumes, or by the CSV path's ``dataset.label_fraction``), the test
    split whole. ``low_label_recipe`` (``{"below": 0.15, "frac_negative":
    0.25, "epoch_mult": 2}``): below ``below``, negative slices are capped
    at ``frac_negative`` x the positive ones and the fine-tune runs
    ``epoch_mult`` times the epochs. Returns {fraction: output dir}."""
    results = {}
    for frac in fractions:
        sub_cfg = {**cfg, "exp_name": f"{cfg['exp_name']}_frac{int(frac * 100)}",
                   "dataset": {**cfg.get("dataset", {}), "label_fraction": frac}}
        if low_label_recipe and frac < low_label_recipe.get("below", 0.15):
            sub_cfg["dataset"]["frac_negative"] = low_label_recipe.get("frac_negative", 0.25)
            sub_cfg["train"] = {**cfg["train"], "n_epoch": int(
                cfg["train"]["n_epoch"] * low_label_recipe.get("epoch_mult", 2))}
        frac_folds = None  # the CSV path applies dataset.label_fraction itself
        if datasets_by_fold is not None:
            def frac_folds(k, frac=frac):
                train_ds, test_ds = datasets_by_fold(k)
                if frac < 1.0:
                    keep = subsample_label_fraction(np.unique(train_ds.vol_ids), frac,
                                                    np.random.default_rng(seed + k))
                    train_ds = train_ds.subset(np.nonzero(np.isin(train_ds.vol_ids, keep))[0])
                return train_ds, test_ds
        out = run_supervised_2d_with_init(sub_cfg, pretrained, frac_folds, device=device)
        results[frac] = out
        logger.info("label fraction %.0f%% -> %s", frac * 100, out)
    return results


def load_pretrain_data(cfg: dict):
    """The RSNA slices of ``path.RSNA_DATA`` at the config's window and size."""
    return load_rsna_slices(
        cfg["path"]["RSNA_DATA"], window=(cfg["data"]["win_center"], cfg["data"]["win_width"]),
        size=cfg["data"]["size"], n_max=cfg.get("dataset", {}).get("n_max"))


PRETRAIN = {"context_restoration": pretrain_context_restoration,
            "contrastive": pretrain_contrastive, "classifier": pretrain_classifier}


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Pretraining, then the k-fold fine-tune.")
    ap.add_argument("phase", choices=tuple(PRETRAIN))
    ap.add_argument("config", help="JSON config (the schema of configs/context_restoration.json "
                                   "or configs/contrastive_global_local.json)")
    ap.add_argument("--multi", action="store_true",
                    help="classifier: 7-way multilabel pretraining (default: binary)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.multi and args.phase != "classifier":
        ap.error("--multi is an option of the classifier phase")
    with open(args.config) as f:
        cfg = json.load(f)
    setup_logger()
    kw = {"multi": True} if args.multi else {}
    weights = PRETRAIN[args.phase](cfg, load_pretrain_data(cfg), device=args.device, **kw)
    out = run_supervised_2d_with_init(cfg, weights, None, device=args.device)
    print(f"Artifacts at {out}")
    return out


if __name__ == "__main__":
    main()
