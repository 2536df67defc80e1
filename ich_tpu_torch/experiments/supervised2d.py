"""Supervised 2D ICH segmentation: the patient-level stratified k-fold
experiment (counterpart of :mod:`ich_tpu.experiments.supervised2d`).

Per fold: the patient split, negative subsampling, a per-fold ``log.txt``,
``UNet2D.train`` with on-device augmentation, per-epoch validation,
checkpoints and resume, then ``evaluate`` with its CSVs and prediction
BMPs, ``trained_unet.bin`` and ``outputs.json``; a fold with an
``outputs.json`` is skipped. Then the fold aggregate (mean ± 1.96σ),
``all_volume_prediction.csv`` and the config re-dump. The JSON config
schema is the JAX package's (``configs/unet2d.json``). The CSV path reads
``ct_info.csv`` and ``patient_info.csv`` into :class:`ich_tpu_torch.data.
table.Table`s and the slices with the numpy TIFF and BMP readers: it needs
neither pandas nor PIL.

Differences from the JAX experiment: the fold split is :func:`stratified_kfold`
(numpy; the same folds as scikit-learn's ``StratifiedKFold``) and
``model_path_to_load`` names a port weights file (for example one converted
by ``scripts/jax_to_torch_model.py``). As in the JAX experiment, the
analysis PDF ``results_overview.pdf``
(:func:`ich_tpu_torch.postprocessing.analyse_exp.analyse_supervised_exp`)
is best-effort: where it fails, for example without matplotlib, a warning
says why. Run it as::

    python -m ich_tpu_torch.experiments.supervised2d CONFIG.json [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import math
import os
import re
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.data.segich import load_segich_2d, split_summary_table, subsample_negatives
from ich_tpu_torch.data.table import pandas_float, read_csv, unique_in_order
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops.metrics import fold_aggregate
from ich_tpu_torch.ops.transforms import Compose, build_pipeline
from ich_tpu_torch.postprocessing.analyse_exp import analyse_supervised_exp
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.segmentation2d import UNet2D, resolve_device
from ich_tpu_torch.utils import preemption, rng
from ich_tpu_torch.utils.logging import setup_logger


def build_augment_fn(spec: dict) -> Optional[Compose]:
    """The config's ``augmentation.train`` as one pipeline, called as
    ``pipe(key, images, masks)``; None for an empty spec."""
    return build_pipeline(spec) if spec else None


def build_unet_from_cfg(net_cfg: dict, norm: str = "batch", seed: int = 0,
                        device: str | torch.device = "cpu") -> UNet:
    """The config's U-Net (gated with ``gated``) built on ``device``, its
    weights flax's ``init`` from ``PRNGKey(seed)``, as the JAX trainer of
    that seed draws them (drawn there: the same values on any device)."""
    with torch.device(resolve_device(device)):
        return UNet(
            depth=net_cfg.get("depth", 5),
            ndim=3 if net_cfg.get("3D", False) else 2,
            bilinear=net_cfg.get("bilinear", False),
            in_channels=net_cfg.get("in_channels", 1),
            out_channels=net_cfg.get("out_channels", 1),
            top_filter=net_cfg.get("top_filter", 64),
            midchannels_factor=net_cfg.get("midchannels_factor", 2),
            p_dropout=net_cfg.get("p_dropout", 0.5),
            use_final_activation=net_cfg.get("use_final_activation", True),
            norm=net_cfg.get("norm", norm),
            gated=net_cfg.get("gated", False),
            key=rng.prng_key(seed),
        )


def subsample_label_fraction(ids: np.ndarray, fraction: float, rng) -> np.ndarray:
    """Patient/volume-level label-efficiency subsampling: keep a random
    ``fraction`` of the unique ids (at least one)."""
    ids = np.asarray(ids)
    return rng.permutation(ids)[: max(1, int(round(fraction * len(ids))))]


def stratified_kfold(
    y: Sequence, n_splits: int, shuffle: bool = True, seed: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train positions, test positions) per fold: scikit-learn's
    ``StratifiedKFold(n_splits, shuffle, random_state=seed).split(X, y)``,
    the same folds for the same labels and seed. Each class's samples are
    dealt to the folds round robin over the sorted labels, in blocks, and
    the block of fold numbers is shuffled per class with
    ``np.random.RandomState(seed)``."""
    y = np.asarray(y).ravel()
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered in order of first appearance, as scikit-learn does
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         f"in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    positions = np.arange(len(y))
    for i in range(n_splits):
        yield positions[test_folds != i], positions[test_folds == i]


_INT = re.compile(r"[+-]?\d+")


def _pandas_round_trip(column: Sequence[str]) -> list:
    """A CSV column as pandas reads and writes it again: an integer column
    as it is, any other as float64 (:func:`ich_tpu_torch.data.table.
    pandas_float`, which may drop digits past the 17th), written as its
    ``repr`` and NaN as an empty field."""
    if all(_INT.fullmatch(t) for t in column):
        return list(column)
    values = (pandas_float(t) if t else float("nan") for t in column)
    return ["" if math.isnan(v) else repr(v) for v in values]


def _concat_volume_csvs(paths: Sequence[str], out_fn: str) -> None:
    """The folds' ``volume_prediction_scores.csv`` one after the other under
    a fresh leading index: pandas' ``concat(...).reset_index(drop=True)
    .to_csv`` of the files as ``read_csv`` reads them."""
    header, rows = None, []
    for path in paths:
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows.extend(reader)
    rows = list(zip(*(_pandas_round_trip(c) for c in zip(*rows)))) if rows else rows
    with open(out_fn, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + header)
        w.writerows([i] + list(r) for i, r in enumerate(rows))


def run_supervised_2d(
    cfg: dict,
    datasets_by_fold: Optional[Callable] = None,
    init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    device: str | torch.device = "cuda",
) -> str:
    """Run the k-fold experiment; returns the experiment output dir.

    ``datasets_by_fold``: optional callable (fold_k) -> (train_ds, test_ds)
    in place of the CSV loading (tests, synthetic runs).
    ``init_state_dict``: optional pretrained weights transferred into each
    fold's net before training (key intersection).
    """
    seed = cfg.get("seed", 42)
    n_fold = cfg["split"]["n_fold"]
    out_path = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    os.makedirs(out_path, exist_ok=True)

    data_dir = cfg["path"]["DATA"]
    win = (cfg["data"]["win_center"], cfg["data"]["win_width"])
    size = cfg["data"]["size"]
    augment_fn = build_augment_fn(cfg["data"].get("augmentation", {}).get("train", {}))

    if datasets_by_fold is None:
        data_info_df = read_csv(os.path.join(data_dir, "ct_info.csv"))
        patient_df = read_csv(os.path.join(data_dir, "patient_info.csv"))
        patient_ids = patient_df["PatientNumber"]
        shuffle = cfg["split"].get("shuffle", True)
        folds = stratified_kfold(patient_df["Hemorrhage"], n_fold, shuffle,
                                 seed if shuffle else None)
    else:
        folds = range(n_fold)

    for k, fold in enumerate(folds):
        fold_dir = os.path.join(out_path, f"Fold_{k + 1}")
        if os.path.exists(os.path.join(fold_dir, "outputs.json")):
            continue
        os.makedirs(fold_dir, exist_ok=True)
        logger = setup_logger(os.path.join(fold_dir, "log.txt"))
        ckpt_path = os.path.join(fold_dir, "checkpoint.bin")
        if os.path.exists(ckpt_path):
            logger.info("\n" + "#" * 30 + "\n Recovering Session \n" + "#" * 30)
        logger.info("Experiment : %s", cfg["exp_name"])
        logger.info("Cross-Validation fold %02d/%02d", k + 1, n_fold)

        if datasets_by_fold is not None:
            train_ds, test_ds = datasets_by_fold(k)
        else:
            train_idx, test_idx = fold  # positions in patient_info.csv
            slice_ids = data_info_df["PatientNumber"]
            train_df = data_info_df[np.isin(slice_ids, patient_ids[train_idx])]
            test_df = data_info_df[np.isin(slice_ids, patient_ids[test_idx])]
            label_fraction = cfg["dataset"].get("label_fraction", 1.0)
            if label_fraction < 1.0:
                train_ids = train_df["PatientNumber"]
                keep = subsample_label_fraction(
                    unique_in_order(train_ids), label_fraction,
                    np.random.default_rng(seed + k))
                train_df = train_df[np.isin(train_ids, keep)]
            train_df = subsample_negatives(train_df, cfg["dataset"]["frac_negative"], seed)
            logger.info("\n%s", split_summary_table(data_info_df, train_df, test_df))
            train_ds = load_segich_2d(data_dir, train_df, window=win, size=size)
            test_ds = load_segich_2d(data_dir, test_df, window=win, size=size)
            logger.info("Data will be loaded from %s.", data_dir)

        tr = cfg["train"]
        trainer = UNet2D(
            build_unet_from_cfg(cfg["net"], seed=seed + k, device=device),
            n_epoch=tr["n_epoch"],
            batch_size=tr["batch_size"],
            lr=tr["lr"],
            lr_scheduler=tr.get("lr_scheduler", "ExponentialLR"),
            lr_scheduler_kwargs=tr.get("lr_scheduler_kwargs", {"gamma": 0.96}),
            loss_fn=tr.get("loss_fn", "BinaryDiceLoss"),
            loss_fn_kwargs=tr.get("loss_fn_kwargs", {"reduction": "mean"}),
            weight_decay=tr.get("weight_decay", 1e-6),
            augment_fn=augment_fn,
            seed=seed + k,
            print_progress=cfg.get("print_progress", False),
            device=device,
        )
        if tr.get("model_path_to_load"):
            trainer.transfer_weights(ckpt.load_params(tr["model_path_to_load"]), verbose=True)
        if init_state_dict is not None:
            trainer.transfer_weights(init_state_dict, verbose=True)

        # per-epoch validation reads the test set every epoch: keep it on
        # the device too
        validate = tr.get("validate_epoch", False)
        if validate:
            test_ds = test_ds.device_cache(trainer.device)
        trainer.train(
            train_ds.device_cache(trainer.device),
            valid_dataset=test_ds if validate else None,
            checkpoint_path=ckpt_path,
        )
        if preemption.requested():
            # the fit loop checkpointed and stopped early: leave the
            # checkpoint for the restart and write no outputs.json (which
            # would mark the fold done)
            logger.warning("Preempted during fold %d: leaving checkpoint for "
                           "resume and aborting the k-fold pipeline.", k + 1)
            raise SystemExit(143)
        trainer.evaluate(test_ds, save_path=os.path.join(fold_dir, "pred"))
        trainer.save_model(os.path.join(fold_dir, "trained_unet.bin"))
        logger.info("Trained U-Net saved at %s", os.path.join(fold_dir, "trained_unet.bin"))
        trainer.save_outputs(os.path.join(fold_dir, "outputs.json"))
        logger.info("Trained statistics saved at %s", os.path.join(fold_dir, "outputs.json"))
        if os.path.exists(ckpt_path):
            os.remove(ckpt_path)
            logger.info("Checkpoint deleted.")

    # -- aggregate folds (reference :197-223) --------------------------------
    logger = logging.getLogger()
    scores = []
    for k in range(n_fold):
        with open(os.path.join(out_path, f"Fold_{k + 1}/outputs.json")) as f:
            out = json.load(f)
        scores.append([out["eval"]["dice"]["all"], out["eval"]["dice"]["positive"]])
    scores = np.asarray(scores, dtype=np.float64)
    (m_all, ci_all), (m_pos, ci_pos) = fold_aggregate(scores[:, 0]), fold_aggregate(scores[:, 1])
    with open(os.path.join(out_path, "average_scores.txt"), "w") as f:
        f.write(f"Dice = {m_all} +/- {ci_all}\n")
        f.write(f"Dice (Positive) = {m_pos} +/- {ci_pos}\n")
    logger.info("Average Scores saved at %s", os.path.join(out_path, "average_scores.txt"))

    _concat_volume_csvs(
        [os.path.join(out_path, f"Fold_{i + 1}/pred/volume_prediction_scores.csv")
         for i in range(n_fold)],
        os.path.join(out_path, "all_volume_prediction.csv"))

    with open(os.path.join(out_path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    try:
        analyse_supervised_exp(out_path, data_dir, n_fold,
                               save_fn=os.path.join(out_path, "results_overview.pdf"))
    except Exception as e:  # the PDF is best-effort (matplotlib, prediction artifacts)
        logger.warning("analysis PDF skipped: %s", e)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Supervised 2D U-Net k-fold experiment.")
    ap.add_argument("config", help="JSON config (the schema of configs/unet2d.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    return run_supervised_2d(cfg, device=args.device)


if __name__ == "__main__":
    main()
