"""Brain-mask filtering of saved predictions (counterpart of
:mod:`ich_tpu.postprocessing.update_pred`; the reference's
``update_pred_folder:27``, ``update_Kfold_folder:113`` and
``update_anomaly_pred_folder:187``): every saved slice prediction ANDed
with a brain mask, the prediction bitmaps rewritten, the slice and volume
confusion CSVs and the ``outputs.json`` Dice recomputed.

Without pandas or PIL: the BMPs go through
:func:`ich_tpu_torch.data.bmp.read_bmp` and :func:`save_bmp_gray`, and the
CSVs are written by the writer of ``UNet2D.evaluate``, as pandas'
``to_csv`` writes the JAX package's frames (the same bytes); the
per-volume sums are over integer counts, exact in any order.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from ich_tpu_torch.data.bmp import read_bmp, save_bmp_gray
from ich_tpu_torch.data.core import SliceDataset2D
from ich_tpu_torch.experiments.supervised2d import _concat_volume_csvs
from ich_tpu_torch.ops.metrics import dice_from_counts, fold_aggregate
from ich_tpu_torch.train.segmentation2d import write_score_csvs

SCORE_COLUMNS = ("volID", "slice", "label", "TP", "FP", "FN", "Dice")


def slice_score_row(pred, target, vol_id, slice_nbr, **extra) -> dict:
    """One per-slice confusion and Dice row (the schema of the AD CLIs and
    of :func:`write_prediction_scores`; the reference's smoothed Dice,
    ``update_pred.py:101-103``)."""
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    tp = float((pred * target).sum())
    fp = float((pred * (1 - target)).sum())
    fn = float(((1 - pred) * target).sum())
    row = {"volID": int(vol_id), "slice": int(slice_nbr),
           "label": int(target.max() > 0), "TP": tp, "FP": fp, "FN": fn,
           "Dice": dice_from_counts(tp, fp, fn)}
    row.update(extra)
    return row


def write_prediction_scores(rows: list, out_dir: str) -> tuple:
    """Write ``slice_prediction_scores.csv`` and the volume-aggregated
    ``volume_prediction_scores.csv`` of :func:`slice_score_row` rows; with
    no rows, header-only CSVs. Returns the slice columns and
    :func:`ich_tpu_torch.train.segmentation2d.volume_table`'s result."""
    names = list(SCORE_COLUMNS)
    for r in rows:
        names += [k for k in r if k not in names]
    cols = {k: [r.get(k) for r in rows] for k in names}
    return cols, write_score_csvs(out_dir, cols, names, ("TP", "FP", "FN"))


def update_pred_folder(fold_dir: str, dataset: SliceDataset2D, brain_masks: np.ndarray,
                       pred_subdir: str = "pred") -> dict:
    """Filter every ``{vol}/{slice}.bmp`` under ``fold_dir/pred_subdir`` by
    the row's brain mask (``brain_masks`` (N, H, W), aligned with
    ``dataset``), rewrite the bitmaps, both CSVs and ``outputs.json``'s
    Dice; returns the updated outputs."""
    pred_dir = os.path.join(fold_dir, pred_subdir)
    keys = ("volID", "slice", "label", "TP", "TN", "FP", "FN", "pred_fn", "Dice")
    cols = {k: [] for k in keys}
    for i in range(len(dataset)):
        vid, snb = int(dataset.vol_ids[i]), int(dataset.slice_nbrs[i])
        rel = f"{vid}/{snb}.bmp"
        fn = os.path.join(pred_dir, rel)
        if not os.path.exists(fn):
            continue
        pred = (read_bmp(fn) > 0).astype(np.float32)
        brain = (np.asarray(brain_masks[i]) > 0).astype(np.float32)
        if brain.shape != pred.shape:
            raise ValueError(f"brain mask shape {brain.shape} != pred {pred.shape}")
        pred = pred * brain
        save_bmp_gray(fn, (pred * 255).astype(np.uint8))
        target = (np.asarray(dataset.masks[i]) > 0).astype(np.float32)
        row = slice_score_row(pred, target, vid, snb, pred_fn=rel,
                              TN=float(((1 - pred) * (1 - target)).sum()))
        for k in keys:
            cols[k].append(row[k])
    _, vol = write_score_csvs(pred_dir, cols, keys, ("TP", "TN", "FP", "FN"))

    out_fn = os.path.join(fold_dir, "outputs.json")
    outputs = {}
    if os.path.exists(out_fn):
        with open(out_fn) as f:
            outputs = json.load(f)
    pos = vol["label"] == 1
    outputs.setdefault("eval", {})["dice"] = {
        "all": float(np.mean(vol["Dice"])) if len(vol["Dice"]) else float("nan"),
        "positive": float(np.mean(vol["Dice"][pos])) if pos.any() else float("nan"),
    }
    with open(out_fn, "w") as f:
        json.dump(outputs, f)
    return outputs


def update_kfold_folder(exp_dir: str, n_fold: int,
                        dataset_for_fold: Callable[[int], SliceDataset2D],
                        brain_masks_for_fold: Callable[[int], np.ndarray]) -> None:
    """:func:`update_pred_folder` on every fold, then the aggregate
    ``average_scores.txt`` and ``all_volume_prediction.csv`` anew."""
    scores = []
    for k in range(n_fold):
        out = update_pred_folder(os.path.join(exp_dir, f"Fold_{k + 1}"), dataset_for_fold(k),
                                 brain_masks_for_fold(k))
        scores.append([out["eval"]["dice"]["all"], out["eval"]["dice"]["positive"]])
    scores = np.asarray(scores, dtype=np.float64)
    (m_all, ci_all), (m_pos, ci_pos) = fold_aggregate(scores[:, 0]), fold_aggregate(scores[:, 1])
    with open(os.path.join(exp_dir, "average_scores.txt"), "w") as f:
        f.write(f"Dice = {m_all} +/- {ci_all}\n")
        f.write(f"Dice (Positive) = {m_pos} +/- {ci_pos}\n")
    _concat_volume_csvs(
        [os.path.join(exp_dir, f"Fold_{k + 1}/pred/volume_prediction_scores.csv")
         for k in range(n_fold)],
        os.path.join(exp_dir, "all_volume_prediction.csv"))


def update_anomaly_pred_folder(pred_dir: str, dataset: SliceDataset2D, brain_masks: np.ndarray,
                               heatmap_loader: Optional[Callable[[int], np.ndarray]] = None
                               ) -> dict:
    """Anomaly-map variant: heatmaps zeroed outside the brain, thresholded
    at 0.5 and scored into both CSVs. ``heatmap_loader(i)`` gives the float
    map of dataset row i; by default ``{vol}/{slice}.npy`` under
    ``pred_dir``, rows without one skipped. Returns the slice columns."""
    rows = []
    for i in range(len(dataset)):
        vid, snb = int(dataset.vol_ids[i]), int(dataset.slice_nbrs[i])
        if heatmap_loader is not None:
            heat = heatmap_loader(i)
        else:
            fn = os.path.join(pred_dir, f"{vid}/{snb}.npy")
            if not os.path.exists(fn):
                continue
            heat = np.load(fn)
        heat = heat * (np.asarray(brain_masks[i]) > 0)
        pred = (heat >= 0.5).astype(np.float32)
        target = (np.asarray(dataset.masks[i]) > 0).astype(np.float32)
        rows.append(slice_score_row(pred, target, vid, snb))
    cols, _ = write_prediction_scores(rows, pred_dir)
    return cols
