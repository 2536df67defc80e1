"""Exploration and figure CLI (counterpart of ``scripts/figures.py``; the
reference's ``figure_scripts/``), without pandas, PIL or click:

- ``dataset-stats``: slices per patient, slice labels and the positive
  fraction per patient of a SegICH 2D tree;
- ``explore``: the patient metadata figure (age histogram, gender bars)
  and, with ``--gif-patient``, that patient's CT slices with the ICH mask
  as a GIF;
- ``rsna-stats``: the RSNA class repartition, ICH against no ICH with a
  flow band into the per-subtype counts;
- ``view-volume``: a NIfTI volume as a slice montage, or (``--mode 3d``)
  as axial, coronal and sagittal maximum-intensity projections, each with
  the mask overlaid; the volume is windowed with
  :func:`ich_tpu_torch.ops.ct.window_ct` on ``--device``.

Each command has a function that returns the arrays it draws
(:func:`dataset_stats_arrays`, :func:`metadata_arrays`, :func:`gif_frames`,
:func:`rsna_stats_arrays`, :func:`montage_arrays`, :func:`mip_views`),
computed with numpy and the port's CSV, TIFF, BMP and NIfTI readers; the
drawing imports matplotlib (and imageio for the GIF) inside the functions
that draw. Run it as::

    python -m ich_tpu_torch.experiments.figures dataset-stats --data-dir DIR [--out-fn F.pdf]
    python -m ich_tpu_torch.experiments.figures explore --data-dir DIR [--out-dir OUT] \\
        [--gif-patient ID] [--fps 4]
    python -m ich_tpu_torch.experiments.figures rsna-stats --csv-path slice_info.csv \\
        [--out-fn F.pdf]
    python -m ich_tpu_torch.experiments.figures view-volume VOL.nii [--mask-path M.nii] \\
        [--out-fn F.png] [--win-center 50] [--win-width 200] [--n-slices 16] \\
        [--mode montage|3d] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.segich import NO_MASK, read_image
from ich_tpu_torch.data.table import read_csv, unique_in_order
from ich_tpu_torch.ops.ct import window_ct
from ich_tpu_torch.postprocessing.analyse_exp import nargsort
from ich_tpu_torch.postprocessing.plots import draw_curved_rect, imshow_pred, pred2gif, pyplot

RSNA_SUBTYPES = ("intraventricular", "intraparenchymal", "subarachnoid", "epidural", "subdural")


def _group_by(keys: np.ndarray, values: np.ndarray):
    """Per distinct key, in sorted order, the count and the mean of
    ``values`` (pandas' ``groupby(keys).size()`` and ``.mean()``)."""
    _, inv = np.unique(keys, return_inverse=True)
    count = np.bincount(inv)
    return count, np.bincount(inv, weights=values.astype(np.float64)) / count


def value_counts(values: np.ndarray) -> Tuple[list, np.ndarray]:
    """pandas' ``Series.value_counts()``: the distinct non-missing values in
    order of first appearance, sorted by count, descending, as
    ``sort_values`` sorts them."""
    values = np.asarray(values)
    present = np.asarray([not (isinstance(v, float) and v != v) for v in values.tolist()], bool)
    keys = unique_in_order(values[present]) if present.any() else values[:0]
    counts = np.asarray([np.sum(values[present] == k) for k in keys], np.int64)
    order = nargsort(counts, ascending=False)
    return [keys[i].item() if hasattr(keys[i], "item") else keys[i] for i in order], counts[order]


def dataset_stats_arrays(data_dir: str) -> Dict[str, np.ndarray]:
    """``slices_per_patient`` and ``positive_fraction`` (per patient, in
    patient order) and ``label_counts`` (non-ICH, ICH slices) of
    ``ct_info.csv``."""
    df = read_csv(os.path.join(data_dir, "ct_info.csv"))
    label = df["Hemorrhage"]
    count, frac = _group_by(df["PatientNumber"], label)
    return {"slices_per_patient": count, "positive_fraction": frac,
            "label_counts": np.asarray([np.sum(label == 0), np.sum(label == 1)], np.int64)}


def dataset_stats(data_dir: str, out_fn: str) -> None:
    plt = pyplot()
    a = dataset_stats_arrays(data_dir)
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    axes[0].hist(a["slices_per_patient"], bins=20, color="dodgerblue")  # Series.hist
    axes[0].grid(True)
    axes[0].set_title("Slices per patient")
    axes[1].bar(["non-ICH", "ICH"], a["label_counts"], color=["dodgerblue", "tomato"])
    axes[1].set_title("Slice labels")
    axes[2].hist(a["positive_fraction"], bins=20, color="tomato")
    axes[2].set_title("Positive-slice fraction per patient")
    fig.savefig(out_fn, bbox_inches="tight")
    plt.close(fig)
    print(f"Wrote {out_fn}")


def metadata_arrays(data_dir: str) -> Optional[dict]:
    """``age`` (per patient) and ``gender`` (the values and their counts,
    most frequent first) of ``patient_info.csv``; None without its Age and
    Gender columns."""
    df = read_csv(os.path.join(data_dir, "patient_info.csv"))
    if not {"Age", "Gender"} <= set(df.columns):
        return None
    names, counts = value_counts(df["Gender"])
    return {"age": df["Age"].astype(np.float64), "gender": names, "gender_counts": counts}


def _plot_metadata(meta: dict, out_dir: str) -> None:
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4),
                                   gridspec_kw=dict(width_ratios=[0.75, 0.25]))
    color = "#fdab48"  # the reference's xkcd:mango
    ax1.hist(meta["age"], color=color, bins=80 // 5, range=(0, 80))
    ax1.hist(meta["age"], histtype="step", color="black", bins=80 // 5, range=(0, 80),
             linewidth=1)
    ax1.set_xlabel("Patient age")
    ax1.set_ylabel("Count [-]")
    ax1.set_title("Patients Age Distribution")
    ax2.bar(np.arange(len(meta["gender"])) + 0.5, meta["gender_counts"],
            tick_label=list(meta["gender"]), width=0.8, color=color, edgecolor="black",
            linewidth=1)
    ax2.set_title("Patients Gender Distribution")
    for ax in (ax1, ax2):
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    meta_fn = os.path.join(out_dir, "metadata_stat.pdf")
    fig.savefig(meta_fn, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"Wrote {meta_fn}")


def gif_frames(data_dir: str, patient: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The patient's slices in slice order, each min-max scaled to [0, 1],
    and their ICH masks (zeros where a slice has no mask file)."""
    df = read_csv(os.path.join(data_dir, "ct_info.csv"))
    pos = np.nonzero(df["PatientNumber"] == patient)[0]
    if not len(pos):
        raise ValueError(f"no slices for patient {patient}")
    pos = pos[nargsort(df["SliceNumber"][pos])]
    imgs, masks = [], []
    for i in pos:
        im = read_image(os.path.join(data_dir, df["CT_fn"][i])).astype(np.float32)
        lo, hi = im.min(), im.max()
        imgs.append((im - lo) / max(hi - lo, 1e-6))
        fn = df["mask_fn"][i]
        if isinstance(fn, str) and fn not in NO_MASK:
            m = read_image(os.path.join(data_dir, fn)) > 0
        else:
            m = np.zeros(im.shape, bool)
        masks.append(m.astype(np.float32))
    return imgs, masks


def explore(data_dir: str, out_dir: str, gif_patient: Optional[int] = None,
            fps: int = 4) -> None:
    """The metadata figure (``figure_scripts/data_exploration.py:39-58``)
    and, with ``gif_patient``, the CT and mask GIF (``:239``)."""
    os.makedirs(out_dir, exist_ok=True)
    meta = metadata_arrays(data_dir)
    if meta is None:
        # gen-2d-seg without --demographics-csv: no metadata figure, but the
        # GIF below stays reachable
        print("patient_info.csv has no Age/Gender columns; skipping metadata_stat.pdf")
    else:
        _plot_metadata(meta, out_dir)
    if gif_patient is not None:
        imgs, masks = gif_frames(data_dir, gif_patient)
        gif_fn = os.path.join(out_dir, f"{gif_patient}_CT.gif")
        pred2gif(imgs, masks, gif_fn, fps=fps)
        print(f"Wrote {gif_fn}")


def rsna_stats_arrays(csv_path: str) -> dict:
    """``n_neg`` and ``n_pos`` slices, the ``subtypes`` present and their
    slice ``counts``, from a ``slice_info.csv``."""
    df = read_csv(csv_path)
    subtypes = [s for s in RSNA_SUBTYPES if s in df.columns]
    n_pos = int(df["Hemorrhage"].sum())
    return {"n_neg": int(len(df) - n_pos), "n_pos": n_pos, "subtypes": subtypes,
            "counts": np.asarray([df[s].sum() for s in subtypes])}


def _human(num, pos=None) -> str:
    mag = 0
    while abs(num) >= 1000:
        mag += 1
        num /= 1000.0
    return "%.0f%s" % (num, ["", "K", "M", "G"][mag])


def rsna_stats(csv_path: str, out_fn: str) -> None:
    """The RSNA class-repartition figure
    (``figure_scripts/RSNA_data_exploration.py:50-94``)."""
    plt = pyplot()
    from matplotlib.ticker import FuncFormatter

    a = rsna_stats_arrays(csv_path)
    fig, ax = plt.subplots(1, 1, figsize=(9, 4))
    ax.bar([0.5, 1.5], [a["n_neg"], a["n_pos"]], tick_label=["No ICH", "ICH"], width=0.8,
           color="orange", edgecolor="black", linewidth=1)
    ax.set_title("ICH by CT Slice", fontweight="bold", loc="left")
    ax.set_ylabel("Number of CT Slices")
    ax.yaxis.set_major_formatter(FuncFormatter(_human))
    ax.set_xlim(0, 6)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    top = ax.get_ylim()[1]  # flow band from the ICH bar into the subtype inset
    draw_curved_rect(1.9, 4.0, 0.0, a["n_pos"], 0.0, top, ax=ax, color="lightgray", alpha=0.5)
    ax_in = ax.inset_axes([4, 0, 2, top], transform=ax.transData)
    if a["subtypes"]:
        ax_in.bar(range(len(a["subtypes"])), a["counts"], tick_label=a["subtypes"], width=0.8,
                  color="orange", edgecolor="black", linewidth=1)
        ax_in.set_xticklabels(a["subtypes"], rotation=25, ha="right", fontsize=8)
    ax_in.set_title("Slices by ICH Type", fontweight="bold", loc="left", fontsize=10)
    ax_in.yaxis.set_ticks_position("right")
    ax_in.yaxis.set_major_formatter(FuncFormatter(_human))
    ax_in.patch.set_facecolor("lightgray")
    ax_in.patch.set_alpha(0.5)
    fig.savefig(out_fn, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"Wrote {out_fn}")


def load_windowed(vol_path: str, mask_path: Optional[str], window: Tuple[float, float],
                  device: str | torch.device = "cuda"):
    """(windowed float32 volume, mask or None, affine): the volume windowed
    by :func:`~ich_tpu_torch.ops.ct.window_ct` on ``device``."""
    vol, affine, _ = nifti.load(vol_path)
    x = torch.as_tensor(np.ascontiguousarray(vol, dtype=np.float32)).to(device)
    vol = window_ct(x, *window).cpu().numpy()
    mask = nifti.load(mask_path)[0] if mask_path else None
    return vol, mask, affine


def montage_arrays(vol: np.ndarray, mask: Optional[np.ndarray], n_slices: int) -> dict:
    """``z`` (``n_slices`` slice numbers spread over the depth) and, per z,
    the ``slices`` of the windowed volume and the ``masks`` (or None)."""
    zs = np.linspace(0, vol.shape[2] - 1, n_slices).astype(int)
    return {"z": zs, "slices": [vol[:, :, z] for z in zs],
            "masks": None if mask is None else [mask[:, :, z] > 0 for z in zs]}


def mip_views(vol: np.ndarray, mask: Optional[np.ndarray], affine: np.ndarray):
    """The axial, coronal and sagittal maximum-intensity projections as
    (title, MIP, mask MIP or None, aspect), head up in the through-plane
    views; the voxel spacing (from the affine) sets the aspect."""
    spacing = np.abs(np.asarray(affine)[:3, :3]).max(axis=0)
    sx, sy, sz = np.where(spacing > 0, spacing, 1.0)
    views = []
    for title, axis, aspect in (("Axial MIP", 2, sx / sy), ("Coronal MIP", 1, sz / sx),
                                ("Sagittal MIP", 0, sz / sy)):
        mip = vol.max(axis=axis)
        mmip = None if mask is None else (mask > 0).max(axis=axis).astype(float)
        if axis != 2:
            mip = mip.T[::-1]
            mmip = None if mmip is None else mmip.T[::-1]
        views.append((title, mip, mmip, aspect))
    return views


def view_volume(vol_path: str, mask_path: Optional[str] = None,
                out_fn: str = "volume_montage.png", win_center: float = 50.0,
                win_width: float = 200.0, n_slices: int = 16, mode: str = "montage",
                device: str | torch.device = "cuda") -> None:
    """A NIfTI volume as a slice montage or, with ``mode="3d"``, its MIP
    three-view (the matplotlib stand-in for the reference's pyvista
    rendering, ``figure_scripts/view_volume.py:24-212``), mask overlaid."""
    plt = pyplot()
    vol, mask, affine = load_windowed(vol_path, mask_path, (win_center, win_width), device)
    if mode == "3d":
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        for ax, (title, mip, mmip, aspect) in zip(axes, mip_views(vol, mask, affine)):
            ax.imshow(mip, cmap="gray", vmin=0, vmax=1, aspect=aspect)
            if mmip is not None:
                overlay = np.zeros(mmip.shape + (4,))
                overlay[mmip > 0] = (0.9, 0.2, 0.1, 0.55)
                ax.imshow(overlay, aspect=aspect)
            ax.set_title(title, fontsize=11, fontweight="bold", loc="left")
            ax.set_xticks([])
            ax.set_yticks([])
        fig.savefig(out_fn, bbox_inches="tight", dpi=150)
    else:
        m = montage_arrays(vol, mask, n_slices)
        ncol = 4
        nrow = -(-n_slices // ncol)
        fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 3 * nrow))
        for i, (ax, z) in enumerate(zip(np.ravel(axes), m["z"])):
            if m["masks"] is not None:
                imshow_pred(m["slices"][i], m["masks"][i], ax=ax)
            else:
                ax.imshow(m["slices"][i], cmap="gray")
                ax.set_xticks([])
                ax.set_yticks([])
            ax.set_title(f"z={z}", fontsize=8)
        for ax in np.ravel(axes)[len(m["z"]):]:
            ax.axis("off")
        fig.savefig(out_fn, bbox_inches="tight", dpi=100)
    plt.close(fig)
    print(f"Wrote {out_fn}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Dataset exploration figures.")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("dataset-stats", help="slice and patient counts of a SegICH 2D tree")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-fn", default="dataset_stats.pdf")
    p = sub.add_parser("explore", help="patient metadata figure and a patient's GIF")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--gif-patient", default=None, type=int,
                   help="also write <id>_CT.gif animating this patient's slices with the "
                        "ICH mask overlaid")
    p.add_argument("--fps", default=4, type=int)
    p = sub.add_parser("rsna-stats", help="RSNA class repartition")
    p.add_argument("--csv-path", required=True, help="slice_info.csv from gen-rsna-csv")
    p.add_argument("--out-fn", default="rsna_data_stats.pdf")
    p = sub.add_parser("view-volume", help="slice montage or MIP three-view of a NIfTI")
    p.add_argument("vol_path")
    p.add_argument("--mask-path", default=None)
    p.add_argument("--out-fn", default="volume_montage.png")
    p.add_argument("--win-center", default=50.0, type=float)
    p.add_argument("--win-width", default=200.0, type=float)
    p.add_argument("--n-slices", default=16, type=int)
    p.add_argument("--mode", default="montage", choices=["montage", "3d"],
                   help="'montage' = slice grid; '3d' = axial/coronal/sagittal MIP three-view")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    for name in ("data_dir", "csv_path", "vol_path", "mask_path"):
        path = getattr(args, name, None)
        if path is not None and not os.path.exists(path):
            ap.error(f"{name}: {path} does not exist")
    if args.command == "dataset-stats":
        dataset_stats(args.data_dir, args.out_fn)
    elif args.command == "explore":
        explore(args.data_dir, args.out_dir, args.gif_patient, args.fps)
    elif args.command == "rsna-stats":
        rsna_stats(args.csv_path, args.out_fn)
    else:
        view_volume(args.vol_path, args.mask_path, args.out_fn, args.win_center,
                    args.win_width, args.n_slices, args.mode, args.device)


if __name__ == "__main__":
    main()
