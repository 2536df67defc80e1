"""Experiment report PDFs (counterpart of
``ich_tpu/postprocessing/analyse_exp.py``; the reference's
``code/src/postprocessing/analyse_exp.py:26,196``):

- :func:`analyse_supervised_exp`: the k-fold report, fold loss and Dice
  curves with CI bands, per-volume confusion-count bars, slice against
  volume Dice, and the best and worst predictions over their CT slices;
- :func:`analyse_representation_exp`: the pretraining report, the loss
  curve and the bottleneck t-SNE coloured by label.

Each is split in two. :func:`supervised_tables` and
:func:`representation_tables` compute what is drawn with numpy and
:func:`ich_tpu_torch.data.table.read_csv`, and the slices are read with
the port's TIFF, BMP and PNG readers, without pandas or PIL; the drawing
needs matplotlib, imported inside the functions that draw. Rows are ranked
by Dice as pandas' ``sort_values`` ranks them (its ``nargsort``, ties
included), so the picks are the JAX report's.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ich_tpu_torch.data.segich import NO_MASK, read_image
from ich_tpu_torch.data.table import read_csv
from ich_tpu_torch.postprocessing.plots import (
    curve_std,
    imshow_pred,
    metric_barplot,
    plot_tsne,
    pyplot,
)

CM_COLUMNS = ("TP", "TN", "FP", "FN")
# the overlay grid's rows: (ascending, label, title)
GRID_SPECS = ((False, 1, "Highest Dice (ICH)"), (True, 1, "Lowest Dice (ICH)"),
              (False, 0, "Highest Dice (non-ICH)"), (True, 0, "Lowest Dice (non-ICH)"))


def nargsort(values: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The order in which pandas' ``sort_values`` puts ``values`` (its
    ``nargsort`` with the default quicksort): NaNs last, and for a
    descending sort the values reversed before and after the argsort."""
    values = np.asarray(values, dtype=np.float64)
    mask = np.isnan(values)
    idx = np.arange(len(values))
    keys, keep = values[~mask], idx[~mask]
    if not ascending:
        keys, keep = keys[::-1], keep[::-1]
    order = keep[keys.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, idx[mask]]).astype(np.intp)


def load_fold_histories(exp_folder: str) -> List[np.ndarray]:
    """Each fold's ``outputs.json`` training evolution, in fold order."""
    hist = []
    for fn in sorted(glob.glob(os.path.join(exp_folder, "Fold_*/outputs.json"))):
        with open(fn) as f:
            hist.append(np.asarray(json.load(f)["train"]["evolution"], dtype=float))
    return hist


def exp_window(exp_folder: str, default=(50.0, 200.0)) -> Tuple[float, float]:
    """The HU window (center, width) of the experiment's re-dumped
    ``config.json`` (the reference reads ``cfg['data']['win_center' /
    'win_width']``, ``analyse_exp.py:152``), else ``default``."""
    try:
        with open(os.path.join(exp_folder, "config.json")) as f:
            cfg = json.load(f)
        return float(cfg["data"]["win_center"]), float(cfg["data"]["win_width"])
    except (OSError, ValueError, KeyError, TypeError):
        return default


def find_slice_files(data_path: str, vol_id: int, slice_nbr: int):
    """The raw CT slice and ground-truth mask of (volume, slice): from the
    dataset's ``ct_info.csv`` first (the layout ``data_preparation
    gen-2d-seg`` writes), then the reference's PhysioNet path patterns
    (``analyse_exp.py:141-165``). Returns (ct path or None, mask path or
    None)."""
    csv_fn = os.path.join(data_path, "ct_info.csv")
    if os.path.exists(csv_fn):
        df = read_csv(csv_fn)
        hits = np.nonzero((df["PatientNumber"] == vol_id) & (df["SliceNumber"] == slice_nbr))[0]
        if len(hits):
            i = hits[0]
            ct = os.path.join(data_path, str(df["CT_fn"][i]))
            m = df["mask_fn"][i] if "mask_fn" in df.columns else None
            mask = (os.path.join(data_path, m)
                    if isinstance(m, str) and m not in NO_MASK else None)
            return (ct if os.path.exists(ct) else None,
                    mask if mask is not None and os.path.exists(mask) else None)
    for ct_pat, m_pat in (
        (f"Patient_CT/{vol_id:03d}/{slice_nbr}.tif",
         f"Patient_CT/{vol_id:03d}/{slice_nbr}_ICH_Seg.bmp"),
        (f"{vol_id:03d}/ct_scans/{slice_nbr}.tif",
         f"{vol_id:03d}/masks/{slice_nbr}_ICH.bmp"),
    ):
        ct = os.path.join(data_path, ct_pat)
        if os.path.exists(ct):
            m = os.path.join(data_path, m_pat)
            return ct, (m if os.path.exists(m) else None)
    return None, None


def load_overlay_triplet(exp_folder: str, data_path: Optional[str], row: dict, window):
    """(windowed CT in [0, 1], target bool, prediction bool) of one slice
    row, the prediction nearest-resized to the CT's resolution (reference
    ``analyse_exp.py:168-171``); (None, None, None) without its prediction
    file, (None, None, pred) without its CT."""
    pred_fn = os.path.join(exp_folder, f"Fold_{int(row['Fold'])}/pred", str(row["pred_fn"]))
    if not os.path.exists(pred_fn):
        return None, None, None
    pred = read_image(pred_fn) > 0
    ct_fn, mask_fn = (None, None)
    if data_path is not None:
        ct_fn, mask_fn = find_slice_files(data_path, int(row["volID"]), int(row["slice"]))
    if ct_fn is None:
        return None, None, pred
    ct = read_image(ct_fn).astype(np.float32)
    c, w = window
    ct = np.clip((ct - (c - w / 2.0)) / max(w, 1e-6), 0.0, 1.0)
    target = np.zeros(ct.shape, dtype=bool)
    if mask_fn is not None:
        target = read_image(mask_fn) > 0
    if pred.shape != ct.shape:
        import scipy.ndimage as ndi

        zoom = (ct.shape[0] / pred.shape[0], ct.shape[1] / pred.shape[1])
        pred = ndi.zoom(pred.astype(np.uint8), zoom, order=0) > 0
    return ct, target, pred


def _concat_slice_tables(exp_folder: str, n_fold: int) -> Optional[Dict[str, np.ndarray]]:
    """The folds' ``slice_prediction_scores.csv`` one after the other with
    a ``Fold`` column (pandas' ``concat(...).reset_index(drop=True)``)."""
    parts = []
    for i in range(n_fold):
        fn = os.path.join(exp_folder, f"Fold_{i + 1}/pred/slice_prediction_scores.csv")
        if os.path.exists(fn):
            t = read_csv(fn)
            cols = dict(t.columns)
            cols["Fold"] = np.full(len(t), i + 1, np.int64)
            parts.append(cols)
    if not parts:
        return None
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _fold_curves(hist: Sequence[np.ndarray]):
    """The training-evolution panel's series (x, then one column per fold,
    NaN padded) and names: the train loss, and the validation Dice (all and
    ICH) where the folds logged it."""
    if not hist:
        return [], []
    max_len = max(h.shape[0] for h in hist)

    def col(i):
        cols = []
        for h in hist:
            c = h[:, i].astype(float) if h.shape[1] > i else np.full(h.shape[0], np.nan)
            cols.append(np.pad(c, (0, max_len - len(c)), constant_values=np.nan))
        return np.stack(cols, axis=1)

    x = np.arange(1, max_len + 1)[:, None]
    series = [np.concatenate([x, col(1)], axis=1)]
    names = ["Train Loss"]
    if hist[0].shape[1] > 3 and not np.all(np.isnan(col(2))):
        series += [np.concatenate([x, col(2)], axis=1), np.concatenate([x, col(3)], axis=1)]
        names += ["Dice (all)", "Dice (ICH)"]
    return series, names


def supervised_tables(exp_folder: str, n_fold: int = 10, n_overlay: int = 8) -> dict:
    """What :func:`analyse_supervised_exp` draws, as arrays:

    - ``hist``: each fold's training evolution; ``curves`` and
      ``curve_names``: the training-evolution series;
    - ``confusion``: the volumes' (TP, TN, FP, FN) rows, all, ICH and
      non-ICH;
    - ``dice_groups`` and ``dice_names``: volume Dice (and slice Dice) as
      (n, 1) columns; ``volume_dice``: the histogram's values;
    - ``slices``: the folds' slice rows as columns with ``Fold``, or None;
    - ``picks``: the positions in ``slices`` of the two lowest and the
      highest Dice of the ICH slices;
    - ``grid``: per row of :data:`GRID_SPECS`, the positions of its first
      ``n_overlay`` slices;
    - ``window``: the HU window of the overlays."""
    results = read_csv(os.path.join(exp_folder, "all_volume_prediction.csv"))
    hist = load_fold_histories(exp_folder)
    curves, curve_names = _fold_curves(hist)
    cm = np.stack([results[c] for c in CM_COLUMNS], axis=1)
    label = results["label"]
    slices = _concat_slice_tables(exp_folder, n_fold)
    dice_groups = [results["Dice"][:, None]]
    dice_names = ["Volume Dice"]
    picks: List[int] = []
    grid: List[List[int]] = [[] for _ in GRID_SPECS]
    if slices is not None:
        dice_groups.append(slices["Dice"][:, None])
        dice_names.append("Slice Dice")
        ich = np.nonzero(slices["label"] == 1)[0]
        ranked = ich[nargsort(slices["Dice"][ich])].tolist()
        picks = ranked[:2] + ranked[-1:]
        for r, (asc, lab, _) in enumerate(GRID_SPECS):
            pos = np.nonzero(slices["label"] == lab)[0]
            grid[r] = pos[nargsort(slices["Dice"][pos], ascending=asc)][:n_overlay].tolist()
    return {
        "hist": hist, "curves": curves, "curve_names": curve_names,
        "confusion": [cm, cm[label == 1], cm[label == 0]],
        "dice_groups": dice_groups, "dice_names": dice_names,
        "volume_dice": results["Dice"] if "Dice" in results.columns else None,
        "slices": slices, "picks": picks, "grid": grid, "window": exp_window(exp_folder),
    }


def slice_row(slices: Dict[str, np.ndarray], i: int) -> dict:
    """Row ``i`` of the slice columns as a dict of Python values."""
    return {k: v[i].item() if hasattr(v[i], "item") else v[i] for k, v in slices.items()}


def _overlay_grid_page(plt, exp_folder, data_path, tables, n_overlay):
    """The reference's 4-row panel (highest and lowest Dice, ICH and
    non-ICH) of predictions (red) and targets (green) over the windowed CT
    slice (reference ``analyse_exp.py:120-194``); None if no overlay could
    be drawn."""
    import matplotlib.patches as mpatches

    fig, axes = plt.subplots(4, n_overlay, figsize=(2.0 * n_overlay, 8.6), squeeze=False)
    shown = 0
    for r, ((_, _, title), rows) in enumerate(zip(GRID_SPECS, tables["grid"])):
        for ci in range(n_overlay):
            ax = axes[r][ci]
            ax.axis("off")
            if ci >= len(rows):
                continue
            row = slice_row(tables["slices"], rows[ci])
            ct, target, pred = load_overlay_triplet(exp_folder, data_path, row, tables["window"])
            if ct is None:
                continue
            imshow_pred(ct, pred, target=target, ax=ax,
                        pred_color="xkcd:vermillion", target_color="forestgreen")
            ax.set_title(f"{int(row['volID']):03d}/{int(row['slice']):02d}  Dice "
                         f"{row['Dice']:.2f}", fontsize=7)
            shown += 1
        axes[r][0].text(-0.15, 0.5, title, fontsize=9, fontweight="bold", rotation=90,
                        ha="center", va="center", transform=axes[r][0].transAxes)
    if shown == 0:
        plt.close(fig)
        return None
    handles = [mpatches.Patch(facecolor="forestgreen", alpha=0.6),
               mpatches.Patch(facecolor="xkcd:vermillion", alpha=0.6)]
    fig.legend(handles, ["Ground Truth", "Prediction"], loc="lower center", ncol=2,
               frameon=False)
    return fig


def analyse_supervised_exp(
    exp_folder: str,
    data_path: Optional[str] = None,
    n_fold: int = 10,
    save_fn: str = "results_overview.pdf",
    n_overlay: int = 8,
) -> str:
    """The k-fold report PDF: one page of panels, and a page of overlays
    where any could be drawn. Needs matplotlib. Returns ``save_fn``."""
    plt = pyplot()
    from matplotlib.backends.backend_pdf import PdfPages

    t = supervised_tables(exp_folder, n_fold, n_overlay)
    fig = plt.figure(figsize=(15, 12))
    gs = fig.add_gridspec(3, 3, hspace=0.35, wspace=0.3)

    ax = fig.add_subplot(gs[0, :2])  # 1. training evolution
    if t["curves"]:
        curve_std(t["curves"], t["curve_names"],
                  colors=["black", "tomato", "dodgerblue"][:len(t["curves"])], ax=ax)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Dice loss / Dice")
    ax.set_title("Training evolution", loc="left", fontweight="bold")

    ax = fig.add_subplot(gs[0, 2])  # 2. confusion counts per volume
    metric_barplot(t["confusion"], ["All", "ICH", "non-ICH"], list(CM_COLUMNS),
                   colors=["tomato", "dodgerblue", "cornflowerblue"], ax=ax)
    ax.set_yscale("symlog")
    ax.set_title("Volume confusion counts", loc="left", fontweight="bold")

    ax = fig.add_subplot(gs[1, 0])  # 3. slice against volume Dice
    metric_barplot(t["dice_groups"], t["dice_names"], ["Dice"], colors=["tomato", "dodgerblue"],
                   ax=ax)
    ax.set_ylim(0, 1.05)
    ax.set_title("Dice (volume vs slice)", loc="left", fontweight="bold")

    ax = fig.add_subplot(gs[1, 1:])  # 4. the volume Dice distribution
    if t["volume_dice"] is not None:
        ax.hist(t["volume_dice"], bins=20, color="dodgerblue", alpha=0.7)
    ax.set_xlabel("Volume Dice")
    ax.set_title("Volume Dice distribution", loc="left", fontweight="bold")

    axes = [fig.add_subplot(gs[2, i]) for i in range(3)]  # 5. best and worst overlays
    shown = 0
    for ax_i, idx in zip(axes, t["picks"]):
        row = slice_row(t["slices"], idx)
        ct, target, pred = load_overlay_triplet(exp_folder, data_path, row, t["window"])
        if pred is None:
            continue
        if ct is None:  # no raw data: the prediction bitmap alone
            ct, target = np.zeros(pred.shape, dtype=float), None
        imshow_pred(ct, pred, target=target, ax=ax_i, pred_color="xkcd:vermillion",
                    target_color="forestgreen")
        ax_i.set_title(f"vol {int(row['volID'])} slice {int(row['slice'])} Dice "
                       f"{row['Dice']:.2f}", fontsize=8)
        shown += 1
    for ax_i in axes[shown:]:
        ax_i.axis("off")

    with PdfPages(save_fn) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
        plt.close(fig)
        if t["slices"] is not None:
            grid = _overlay_grid_page(plt, exp_folder, data_path, t, n_overlay)
            if grid is not None:
                pdf.savefig(grid, bbox_inches="tight")
                plt.close(grid)
    return save_fn


def representation_tables(exp_folder: str) -> dict:
    """What :func:`analyse_representation_exp` draws: ``hist`` (the
    training evolution), and ``embedding`` and ``labels`` from
    ``outputs['eval']['repr']`` (None where the run stored none)."""
    with open(os.path.join(exp_folder, "outputs.json")) as f:
        out = json.load(f)
    hist = np.asarray(out["train"]["evolution"], dtype=float)
    payload = out["eval"].get("repr")
    emb = labels = None
    if payload is not None:
        payload = np.asarray(payload, dtype=float)
        emb = payload[:, :2]
        labels = payload[:, 2] if payload.shape[1] > 2 else None
    return {"hist": hist, "embedding": emb, "labels": labels}


def analyse_representation_exp(
    exp_folder: str,
    save_fn: str = "pretrain_overview.pdf",
    subtype_names=("ICH", "subtype1", "subtype2", "subtype3", "subtype4", "subtype5"),
) -> str:
    """The pretraining report: the loss curve and the t-SNE of the
    bottleneck representation coloured by label (reference
    ``analyse_exp.py:196-251``). Needs matplotlib. Returns ``save_fn``."""
    plt = pyplot()
    t = representation_tables(exp_folder)
    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(1, 2, 1)
    ax.plot(t["hist"][:, 0], t["hist"][:, 1], color="black")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title("Pretraining loss", loc="left", fontweight="bold")
    ax = fig.add_subplot(1, 2, 2)
    if t["embedding"] is not None:
        plot_tsne(t["embedding"], t["labels"], ax=ax, legend_names=None)
        ax.set_title("Bottleneck t-SNE", loc="left", fontweight="bold")
    else:
        ax.axis("off")
    fig.savefig(save_fn, bbox_inches="tight")
    plt.close(fig)
    return save_fn
