"""publicSegICH2D loading (counterpart of :mod:`ich_tpu.data.segich`): the
CSV-driven host path that decodes the whole (windowed, resized) dataset once
into dense arrays. Slices are ``.tif``, ``.bmp`` or ``.png`` files.

``ct_info.csv`` rows (PatientNumber, SliceNumber, CT_fn, mask_fn,
Hemorrhage) reference per-slice tif images and bmp masks; ``patient_info.csv``
holds (PatientNumber, Hemorrhage, ...). Neither pandas nor PIL is needed:
the CSVs are read into a :class:`ich_tpu_torch.data.table.Table`, the
images by the numpy TIFF and BMP readers. The functions also take a pandas
DataFrame where a caller passes one, and then return a DataFrame.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ich_tpu_torch.data.bmp import read_bmp
from ich_tpu_torch.data.core import SliceDataset2D
from ich_tpu_torch.data.png import read_png_gray
from ich_tpu_torch.data.table import read_csv
from ich_tpu_torch.data.tiff import read_tiff
from ich_tpu_torch.ops.ct import window_ct

NO_MASK = ("", "-", "None", "nan")  # mask_fn cells that name no mask file


def read_image(path: str) -> np.ndarray:
    """A ``.tif``, ``.bmp`` or 8-bit grayscale ``.png`` slice as PIL's
    ``np.asarray(Image.open(path))``."""
    if path.lower().endswith((".tif", ".tiff")):
        return read_tiff(path)
    if path.lower().endswith(".bmp"):
        return read_bmp(path)
    if path.lower().endswith(".png"):
        return read_png_gray(path)
    raise ValueError(f"{path}: only .tif, .bmp and .png slices are read")


def _resize_host(img: np.ndarray, size: int, order: int) -> np.ndarray:
    """Host-side resize at load time (scipy zoom; order 0 exact for masks)."""
    import scipy.ndimage as ndi

    if img.shape == (size, size):
        return img
    zoom = (size / img.shape[0], size / img.shape[1])
    return ndi.zoom(img, zoom, order=order)


def load_segich_2d(
    data_dir: str,
    info_df=None,
    window: Tuple[float, float] = (50, 200),
    size: int = 256,
) -> SliceDataset2D:
    """Decode a (subset of the) publicSegICH2D csv into a SliceDataset2D:
    images windowed to [0,1] and resized to ``size``; masks binary.
    ``info_df`` is a Table or DataFrame of ``ct_info.csv`` rows; None reads
    the file."""
    if info_df is None:
        info_df = read_csv(os.path.join(data_dir, "ct_info.csv"))
    rows = info_df.to_dict("records")
    n = len(rows)
    images = np.zeros((n, size, size), dtype=np.float32)
    masks = np.zeros((n, size, size), dtype=np.float32)
    vol_ids = np.zeros(n, dtype=np.int32)
    slice_nbrs = np.zeros(n, dtype=np.int32)
    for i, row in enumerate(rows):
        img = read_image(os.path.join(data_dir, str(row["CT_fn"]))).astype(np.float32)
        img = window_ct(torch.from_numpy(img), window[0], window[1]).numpy()
        images[i] = _resize_host(img, size, order=1)
        mask_fn = row.get("mask_fn", None)
        if isinstance(mask_fn, str) and mask_fn not in NO_MASK:
            m = read_image(os.path.join(data_dir, mask_fn)).astype(np.float32)
            masks[i] = _resize_host((m > 0).astype(np.float32), size, order=0)
        vol_ids[i] = int(row["PatientNumber"])
        slice_nbrs[i] = int(row["SliceNumber"])
    return SliceDataset2D(images, masks, vol_ids, slice_nbrs)


def subsample_negatives(info_df, frac_negative: float, seed: int):
    """Keep at most ``frac_negative x n_positive`` negative slices
    (reference ``UNet2D_scripts.py:121-123``): the rows pandas'
    ``neg.sample(n=n_remove, random_state=seed)`` removes, which are
    ``RandomState(seed).choice(len(neg), n_remove, replace=False)`` of the
    negative rows; the kept rows stay in the file's order."""
    hem = np.asarray(info_df["Hemorrhage"])
    neg = np.flatnonzero(hem == 0)
    n_remove = int(max(0, len(neg) - frac_negative * int(np.sum(hem == 1))))
    removed = neg[np.random.RandomState(seed).choice(len(neg), n_remove, replace=False)]
    index = np.asarray(info_df.index)
    return info_df[~np.isin(index, index[removed])]


def split_summary_table(all_df, train_df, test_df) -> str:
    """Plain-text split summary (the reference uses PrettyTable,
    ``UNet2D_scripts.py:225-234``)."""
    header = f"{'set':<8}{'N total':>10}{'N non-ICH':>12}{'N ICH':>8}{'frac non-ICH':>15}{'frac ICH':>12}"
    lines = [header, "-" * len(header)]
    for df, name in zip([all_df, train_df, test_df], ["All", "Train", "Test"]):
        hem = np.asarray(df["Hemorrhage"])
        n, n0, n1 = len(df), int((hem == 0).sum()), int((hem == 1).sum())
        lines.append(
            f"{name:<8}{n:>10}{n0:>12}{n1:>8}{n0 / max(n,1):>14.3%}{n1 / max(n,1):>11.3%}"
        )
    return "\n".join(lines)
