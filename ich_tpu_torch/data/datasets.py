"""Dataset loaders (counterpart of :mod:`ich_tpu.data.datasets`): the 3D
SegICH loader, the brain-extraction 2D loader, the attention U-Net's 2D
loader (image and anomaly map as two channels), the RSNA slice loader of
pretraining, the image / mask pair loader, and the RSNA label pivot of
``scripts/data_preparation.py gen-rsna-csv`` as a function. CSVs go through
the ``csv`` module or :mod:`ich_tpu_torch.data.table`: the loaders need no
pandas, and the images no PIL."""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.core import LabeledSliceDataset, SliceDataset2D, VolumeDataset3D
from ich_tpu_torch.data.dicom import read_ct_hu
from ich_tpu_torch.data.segich import NO_MASK, _resize_host, load_segich_2d, read_image
from ich_tpu_torch.data.table import read_csv, write_csv
from ich_tpu_torch.ops.ct import _resampled_shape, resample_ct, resize_nearest_zoom, window_ct

RSNA_LABEL_COLUMNS = ("Hemorrhage", "epidural", "intraparenchymal", "intraventricular",
                      "subarachnoid", "subdural", "no_Hemorrhage")
# the corrupted stage-2 slice, which the reference means to drop (generate_RSNA_csv.py:44)
RSNA_CORRUPT_FILE = "ID_6431af929.dcm"


def load_segich_3d(
    data_dir: str,
    patient_numbers: Sequence[int],
    window: Tuple[float, float] = (50, 200),
    out_spacing: Tuple[float, float, float] = (-1.0, -1.0, 2.5),
) -> VolumeDataset3D:
    """``<data_dir>/ct_scans/<pid:03>.nii`` and ``masks/<pid:03>.nii``,
    rot90, windowed, resampled from the header's spacing to ``out_spacing``
    (order 1 with the input's range kept for the image, nearest on
    ``scipy.ndimage.zoom``'s grid for the mask), then (H, W, Z) -> (Z, H, W).
    Runs on the CPU; returns numpy volumes."""
    vols, masks, ids = [], [], []
    for pid in patient_numbers:
        vol, _, hdr = nifti.load(os.path.join(data_dir, "ct_scans", f"{pid:03}.nii"))
        msk, _, _ = nifti.load(os.path.join(data_dir, "masks", f"{pid:03}.nii"))
        vol = np.rot90(vol, axes=(0, 1))
        msk = np.rot90(msk, axes=(0, 1))
        x = window_ct(torch.from_numpy(vol.astype(np.float32)), window[0], window[1])
        spacing = nifti.pixdim(hdr)
        x = resample_ct(x, spacing, out_spacing, preserve_range=True, order=1)
        shape = _resampled_shape(msk.shape, spacing, out_spacing)
        m = resize_nearest_zoom(torch.from_numpy((msk > 0).astype(np.float32)), shape)
        vols.append(np.transpose(x.numpy(), (2, 0, 1)))
        masks.append(np.transpose(m.numpy(), (2, 0, 1)))
        ids.append(pid)
    return VolumeDataset3D(vols, masks, np.asarray(ids))


def load_segich_attention_2d(
    data_dir: str,
    info_df=None,
    window: Tuple[float, float] = (50, 200),
    size: int = 256,
    attention_col: str = "attention_fn",
) -> SliceDataset2D:
    """2D slices with an anomaly-attention map stacked as channel 2
    (reference ``public_SegICH_AttentionDataset2D``, ``datasets.py:96-172``):
    images (N, size, size, 2). ``info_df`` (a Table or DataFrame) or
    ``<data_dir>/info.csv`` holds ``PatientNumber``, ``SliceNumber``,
    ``CT_fn``, ``mask_fn`` and ``attention_col``, the file names relative to
    ``data_dir``. Channel 0 is the windowed slice, channel 1 the attention
    map divided by its maximum, both resized at order 1; an attention entry
    of ``""``, ``"-"``, ``"None"`` or ``"nan"`` (or empty) leaves channel 1
    at 0. Masks as :func:`load_segich_2d`'s."""
    if info_df is None:
        info_df = read_csv(os.path.join(data_dir, "info.csv"))
    rows = info_df.to_dict("records")
    n = len(rows)
    images = np.zeros((n, size, size, 2), dtype=np.float32)
    masks = np.zeros((n, size, size), dtype=np.float32)
    vol_ids = np.zeros(n, dtype=np.int32)
    slice_nbrs = np.zeros(n, dtype=np.int32)
    for i, row in enumerate(rows):
        img = read_image(os.path.join(data_dir, str(row["CT_fn"]))).astype(np.float32)
        img = window_ct(torch.from_numpy(img), window[0], window[1]).numpy()
        images[i, :, :, 0] = _resize_host(img, size, order=1)
        att_fn = row.get(attention_col, None)
        if isinstance(att_fn, str) and att_fn not in NO_MASK:
            att = read_image(os.path.join(data_dir, att_fn)).astype(np.float32)
            att = att / max(att.max(), 1e-8)
            images[i, :, :, 1] = _resize_host(att, size, order=1)
        mask_fn = row.get("mask_fn", None)
        if isinstance(mask_fn, str) and mask_fn not in NO_MASK:
            m = read_image(os.path.join(data_dir, mask_fn)).astype(np.float32)
            masks[i] = _resize_host((m > 0).astype(np.float32), size, order=0)
        vol_ids[i] = int(row["PatientNumber"])
        slice_nbrs[i] = int(row["SliceNumber"])
    return SliceDataset2D(images, masks, vol_ids, slice_nbrs)


def load_img_mask_pairs(pairs: Sequence[Tuple[str, str]],
                        size: Optional[int] = None) -> SliceDataset2D:
    """(image_fn, mask_fn) pairs (reference ``ImgMaskDataset``,
    ``datasets.py:542-601``): each image read (``.tif``, ``.bmp`` or
    ``.png``) and divided by 255 when its maximum is above 1, each mask made
    binary (> 0), both resized to ``size`` (order 1 and 0) when given. Volume
    ids are the pair's index, slice numbers 0."""
    images, masks = [], []
    for im_fn, mask_fn in pairs:
        img = read_image(im_fn).astype(np.float32)
        if img.max() > 1:
            img = img / 255.0
        m = (read_image(mask_fn) > 0).astype(np.float32)
        if size is not None:
            img = _resize_host(img, size, order=1)
            m = _resize_host(m, size, order=0)
        images.append(img)
        masks.append(m)
    n = len(images)
    return SliceDataset2D(np.stack(images), np.stack(masks), np.arange(n), np.zeros(n, np.int32))


def load_brain_extract_2d(
    data_dir: str,
    info_df=None,
    window: Tuple[float, float] = (50, 200),
    size: int = 256,
) -> SliceDataset2D:
    """Brain-mask variant of the 2D loader (reference
    ``brain_extract_Dataset2D``, ``datasets.py:250-318``): the SegICH 2D
    schema, the ``mask_fn`` column naming brain masks instead of ICH
    masks."""
    return load_segich_2d(data_dir, info_df, window=window, size=size)


def _number(text: str):
    """A CSV cell as pandas reads it: an int, else a float, else NaN."""
    try:
        return int(text)
    except ValueError:
        return float(text) if text.strip() else float("nan")


def write_rsna_slice_info(label_csv: str, out_csv: str) -> int:
    """Pivot the RSNA stage-2 label csv (``ID,Label`` rows, ``ID =
    <sop>_<subtype>``) to one multilabel row per slice and write it as
    ``scripts/data_preparation.py gen-rsna-csv`` does with pandas:

    - rows per ``sop`` in sorted order, one column per subtype in sorted
      order, each the max over duplicated rows; ``any`` renamed
      ``Hemorrhage`` (a column of 0 when the csv has no ``any`` rows);
    - then ``filename`` (``<sop>.dcm``) and ``no_Hemorrhage = 1 -
      Hemorrhage``; ``ID_6431af929.dcm`` dropped;
    - the leading index column keeps each row's place before the drop;
      where a slice lacks a subtype the cell is empty and every label is
      written as a float, as pandas' ``unstack`` makes it.

    Returns the number of rows written."""
    table: Dict[str, Dict[str, object]] = defaultdict(dict)
    with open(label_csv, newline="") as f:
        for row in csv.DictReader(f):
            sop, subtype = row["ID"].rsplit("_", 1)
            value = _number(row["Label"])
            old = table[sop].get(subtype)
            table[sop][subtype] = value if old is None else max(old, value)
    sops = sorted(table)
    subtypes = sorted({st for labels in table.values() for st in labels})
    holes = any(st not in table[sop] for sop in sops for st in subtypes)

    def cell(v) -> str:
        if v is None or v != v:  # missing, NaN
            return ""
        return repr(float(v)) if holes else str(v)

    names = ["Hemorrhage" if st == "any" else st for st in subtypes]
    header = [""] + ["sop"] + names + ["filename"]
    if "any" not in subtypes:
        header.append("Hemorrhage")
    header.append("no_Hemorrhage")
    rows = []
    for i, sop in enumerate(sops):
        if sop + ".dcm" == RSNA_CORRUPT_FILE:
            continue
        labels = table[sop]
        row = [i, sop] + [cell(labels.get(st)) for st in subtypes] + [sop + ".dcm"]
        if "any" in subtypes:
            h = labels.get("any")
            row.append(cell(None if h is None else 1 - h))
        else:
            row += [0, 1]
        rows.append(row)
    write_csv(out_csv, header, rows)
    return len(rows)


def read_slice_info(path: str) -> List[Dict[str, str]]:
    """The rows of a ``slice_info.csv`` as dicts of strings (the leading
    index column dropped)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r.pop("", None)
    return rows


def load_rsna_slices(
    data_dir: str,
    slice_df=None,
    window: Tuple[float, float] = (50, 200),
    size: int = 256,
    n_max: Optional[int] = None,
    label_columns: Sequence[str] = RSNA_LABEL_COLUMNS,
) -> LabeledSliceDataset:
    """RSNA DICOM slices and their 7-way multilabel vectors (the reference's
    ``RSNA_dataset``, ``datasets.py:320-422``): each ``filename`` under
    ``data_dir`` read to HU, windowed, resized to ``size`` (scipy zoom,
    order 1). ``slice_df`` is the pivot's rows (a list of mappings, or
    anything with pandas' ``to_dict("records")``); None reads
    ``<data_dir>/slice_info.csv``. A label column the rows lack is 0. Runs on
    the CPU; returns numpy arrays."""
    if slice_df is None:
        rows: List[Mapping] = read_slice_info(os.path.join(data_dir, "slice_info.csv"))
    elif hasattr(slice_df, "to_dict"):
        rows = slice_df.to_dict("records")
    else:
        rows = list(slice_df)
    if n_max is not None:
        rows = rows[:n_max]
    n = len(rows)
    images = np.zeros((n, size, size), dtype=np.float32)
    labels = np.zeros((n, len(label_columns)), dtype=np.float32)
    for i, row in enumerate(rows):
        hu = read_ct_hu(os.path.join(data_dir, str(row["filename"])))
        img = window_ct(torch.from_numpy(hu), window[0], window[1]).numpy()
        images[i] = _resize_host(img, size, order=1)
        for j, col in enumerate(label_columns):
            if col in row:
                v = row[col]
                labels[i, j] = _number(v) if isinstance(v, str) else float(v)
    return LabeledSliceDataset(images, labels)
