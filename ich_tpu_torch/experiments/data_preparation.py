"""Dataset preparation CLI (counterpart of ``scripts/data_preparation.py``),
without pandas, PIL or click:

- ``gen-2d-seg``: NIfTI volumes (``ct_scans/`` and ``masks/``) to per-slice
  TIFFs and BMPs with ``ct_info.csv`` and ``patient_info.csv`` (volumes
  rotated by ``rot90``; masks written only for positive slices); with
  ``--demographics-csv`` the PhysioNet Age and Gender columns are merged in.
- ``gen-2d-brain``: the same for the brain masks.
- ``gen-rsna-csv``: the RSNA stage-2 label csv pivoted to ``slice_info.csv``.
- ``dicom-to-nifti``: one DICOM series to one NIfTI volume.
- ``qure-extract``: a CQ500 root to one NIfTI per patient and ``info.csv``,
  merged with ``ICH_probabilities.csv``.

Slices are written with :mod:`ich_tpu_torch.data.tiff` (int32, PIL's mode
``I``), masks with :mod:`ich_tpu_torch.data.bmp` and CSVs with
:func:`ich_tpu_torch.data.table.write_csv`, so that the files equal the JAX
script's: the same bytes for CSVs and BMPs, the same pixels for TIFFs. The
two merges reproduce pandas' (a left merge on ``PatientNumber``; an outer
merge on the patient id, its keys sorted), down to an int column turned
float by a missing cell. Run it as::

    python -m ich_tpu_torch.experiments.data_preparation gen-2d-seg --data-dir DIR \\
        --out-dir OUT [--demographics-csv Patient_demographics.csv]
    python -m ich_tpu_torch.experiments.data_preparation gen-2d-brain --data-dir DIR \\
        --out-dir OUT [--mask-subdir brain_masks]
    python -m ich_tpu_torch.experiments.data_preparation gen-rsna-csv --label-csv CSV \\
        --out-csv OUT.csv
    python -m ich_tpu_torch.experiments.data_preparation dicom-to-nifti --series-dir DIR \\
        --out-fn OUT.nii
    python -m ich_tpu_torch.experiments.data_preparation qure-extract --input-path ROOT \\
        --out-folder OUT
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.datasets import write_rsna_slice_info
from ich_tpu_torch.data.dicom import series_to_volume
from ich_tpu_torch.data.table import Table, parse_column, read_csv, write_csv
from ich_tpu_torch.data.tiff import write_tiff
from ich_tpu_torch.utils.logging import setup_logger


def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _as_pandas_column(cells: List) -> List:
    """A merged column's cells as pandas holds them: an int column with a
    missing cell turns float; missing cells are None (written empty)."""
    cells = [None if _missing(v) else v for v in cells]
    present = [v for v in cells if v is not None]
    if len(present) < len(cells) and all(
            isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
            for v in present):
        return [None if v is None else float(v) for v in cells]
    return cells


def _write_frame(path: str, columns: Dict[str, List]) -> None:
    """Columns (the leading index column named ``""`` first) written as
    pandas writes the frame they make."""
    cols = [_as_pandas_column(v) for v in columns.values()]
    write_csv(path, list(columns), zip(*cols))


def _check_keys(left, right, name: str) -> None:
    """pandas refuses to merge a column of numbers with one of strings."""
    def kind(vals):
        return {isinstance(v, str) for v in vals if not _missing(v)}

    if kind(left) | kind(right) == {True, False}:
        raise ValueError(f"cannot merge on {name!r}: numbers on one side, strings on the other")


def read_demographics(path: str) -> Table:
    """PhysioNet's ``Patient_demographics.csv`` as ``pd.read_csv(path,
    header=1, skipfooter=2, engine="python")`` reads it, with the unnamed
    first three columns renamed PatientNumber, Age and Gender
    (``generate_2DSegDataset.py:37-39``). As pandas' parser: the header is
    the second non-blank row, the footer is the file's last two rows (blank
    ones included), blank rows are dropped, and an empty header cell ``i``
    is named ``Unnamed: i``."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))

    def blank(r):
        return not (len(r) > 1 or (len(r) == 1 and r[0].strip()))

    nonblank = [i for i, r in enumerate(rows) if not blank(r)]
    if len(nonblank) < 2:
        raise ValueError(f"{path}: no header row")
    head = nonblank[1]
    names = [c if c else f"Unnamed: {j}" for j, c in enumerate(rows[head])]
    body = [r for r in rows[head + 1:len(rows) - 2] if not blank(r)]
    if any(len(r) > len(names) for r in body):
        raise ValueError(f"{path}: a row has more cells than the header")
    body = [r + [""] * (len(names) - len(r)) for r in body]
    cols = {n: parse_column([r[j] for r in body]) for j, n in enumerate(names)}
    renamed = {"Unnamed: 0": "PatientNumber", "Unnamed: 1": "Age", "Unnamed: 2": "Gender"}
    cols = {renamed.get(k, k): v for k, v in cols.items()}
    return Table(cols, np.arange(len(body)))


def _merge_demographics(patients: List[Dict], demo: Table) -> Dict[str, List]:
    """``patient_df.merge(demo[cols], on="PatientNumber", how="left")``:
    the patients in order, each once per matching demographics row (or once
    with empty cells)."""
    cols = [c for c in ("Age", "Gender") if c in demo.columns]
    keys = demo["PatientNumber"].tolist()
    _check_keys([p["PatientNumber"] for p in patients], keys, "PatientNumber")
    extra = {c: demo[c].tolist() for c in cols}
    out: Dict[str, List] = {k: [] for k in ("PatientNumber", "Hemorrhage", *cols)}
    for p in patients:
        hits = [j for j, k in enumerate(keys) if not _missing(k) and k == p["PatientNumber"]]
        for j in hits or [None]:
            out["PatientNumber"].append(p["PatientNumber"])
            out["Hemorrhage"].append(p["Hemorrhage"])
            for c in cols:
                out[c].append(None if j is None else extra[c][j])
    return out


def write_2d_dataset(data_dir: str, out_dir: str, mask_subdir: str,
                     demographics_csv: Optional[str] = None) -> int:
    """The SegICH 2D tree of ``scripts/data_preparation.py``'s
    ``_write_2d_dataset``; returns the number of slices written."""
    os.makedirs(out_dir, exist_ok=True)
    ct_rows, patients = [], []
    for fn in sorted(os.listdir(os.path.join(data_dir, "ct_scans"))):
        pid = int(os.path.splitext(fn.replace(".nii", ""))[0])
        vol, _, _ = nifti.load(os.path.join(data_dir, "ct_scans", fn))
        mask, _, _ = nifti.load(os.path.join(data_dir, mask_subdir, fn))
        vol = np.rot90(vol, axes=(0, 1))
        mask = np.rot90(mask, axes=(0, 1))
        os.makedirs(os.path.join(out_dir, str(pid), "ct"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, str(pid), "mask"), exist_ok=True)
        any_pos = 0
        for s in range(vol.shape[2]):
            ct_fn = f"{pid}/ct/{s}.tif"
            write_tiff(os.path.join(out_dir, ct_fn), vol[:, :, s].astype(np.int32))
            pos = int(mask[:, :, s].max() > 0)
            any_pos |= pos
            mask_fn = "-"
            if pos:  # masks written only for positive slices (reference)
                mask_fn = f"{pid}/mask/{s}.bmp"
                save_bmp_gray(os.path.join(out_dir, mask_fn),
                              ((mask[:, :, s] > 0) * 255).astype(np.uint8))
            ct_rows.append([len(ct_rows), pid, s, ct_fn, mask_fn, pos])
        patients.append({"PatientNumber": pid, "Hemorrhage": any_pos})
    write_csv(os.path.join(out_dir, "ct_info.csv"),
              ["", "PatientNumber", "SliceNumber", "CT_fn", "mask_fn", "Hemorrhage"], ct_rows)
    columns = {k: [p[k] for p in patients] for k in ("PatientNumber", "Hemorrhage")}
    if demographics_csv:
        columns = _merge_demographics(patients, read_demographics(demographics_csv))
    n = len(columns["PatientNumber"])
    _write_frame(os.path.join(out_dir, "patient_info.csv"), {"": list(range(n)), **columns})
    print(f"Wrote {len(ct_rows)} slices / {len(patients)} patients to {out_dir}")
    return len(ct_rows)


def _dcm_paths(series_dir: str) -> List[str]:
    return [os.path.join(series_dir, f) for f in sorted(os.listdir(series_dir))
            if f.lower().endswith(".dcm")]


def dicom_to_nifti(series_dir: str, out_fn: str) -> None:
    """Stack a DICOM series directory into one NIfTI volume
    (``qureAI_extract_as_nifti.py``)."""
    vol, affine = series_to_volume(_dcm_paths(series_dir))
    nifti.save(out_fn, vol, affine)
    print(f"Wrote {vol.shape} volume to {out_fn}")


def _outer_merge(rows: List[List], probs: Table) -> Dict[str, List]:
    """``pd.merge(fn_df, in_df, left_on="id", right_index=True,
    how="outer")`` of the rows (id, filename, n_slice) and the
    probabilities indexed by id, as columns: the keys sorted, each key's
    left rows by its right rows, the left index kept (empty on a right-only
    row)."""
    left_ids = [r[0] for r in rows]
    right_ids = probs.index.tolist()
    _check_keys(left_ids, right_ids, "id")
    right_cols = {k: v.tolist() for k, v in probs.columns.items()}
    names = ["", "id", "filename", "n_slice"] + list(right_cols)
    out: Dict[str, List] = {n: [] for n in names}
    for key in sorted(set(left_ids) | {k for k in right_ids if not _missing(k)}):
        lhits = [i for i, k in enumerate(left_ids) if k == key] or [None]
        rhits = [j for j, k in enumerate(right_ids) if k == key] or [None]
        for i in lhits:
            for j in rhits:
                out[""].append(i)
                out["id"].append(key)
                out["filename"].append(None if i is None else rows[i][1])
                out["n_slice"].append(None if i is None else rows[i][2])
                for c, vals in right_cols.items():
                    out[c].append(None if j is None else vals[j])
    return out


def qure_extract(input_path: str, out_folder: str) -> int:
    """The qureAI CQ500 layout to NIfTI volumes and ``info.csv``
    (``qureAI_extract_as_nifti.py:24-64``): each patient's series directory
    becomes ``<ID>.nii``; rows {id, filename, n_slice} are merged with
    ``ICH_probabilities.csv`` on the patient id (outer join). Returns the
    number of volumes written."""
    os.makedirs(out_folder, exist_ok=True)
    rows = []
    for name in sorted(os.listdir(input_path)):
        pdir = os.path.join(input_path, name)
        if not os.path.isdir(pdir):
            continue
        paths = _dcm_paths(pdir)
        if not paths:
            continue
        vol, affine = series_to_volume(paths)
        nifti.save(os.path.join(out_folder, f"{name}.nii"), vol, affine)
        rows.append([int(name), f"{name}.nii", len(paths)])
    if not rows:
        raise ValueError(f"{input_path}: no patient directory holds a DICOM series")
    columns = {"": list(range(len(rows))), **dict(zip(("id", "filename", "n_slice"),
                                                     map(list, zip(*rows))))}
    prob_fn = os.path.join(input_path, "ICH_probabilities.csv")
    if os.path.exists(prob_fn):
        columns = _outer_merge(rows, read_csv(prob_fn))
    _write_frame(os.path.join(out_folder, "info.csv"), columns)
    print(f"Wrote {len(rows)} volumes + info.csv to {out_folder}")
    return len(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Dataset preparation.")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("gen-2d-seg", help="NIfTI volumes and masks to a SegICH 2D tree")
    p.add_argument("--data-dir", required=True, help="dir with ct_scans/ and masks/ NIfTIs")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--demographics-csv", default=None,
                   help="PhysioNet Patient_demographics.csv; merges Age/Gender into "
                        "patient_info.csv (reference generate_2DSegDataset.py:37-39)")
    p = sub.add_parser("gen-2d-brain", help="NIfTI volumes and brain masks to a 2D tree")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--mask-subdir", default="brain_masks")
    p = sub.add_parser("gen-rsna-csv", help="pivot the RSNA stage-2 labels per slice")
    p.add_argument("--label-csv", required=True,
                   help="RSNA stage-2 train csv (ID,Label with ID=<sop>_<subtype>)")
    p.add_argument("--out-csv", required=True)
    p = sub.add_parser("dicom-to-nifti", help="one DICOM series to one NIfTI volume")
    p.add_argument("--series-dir", required=True)
    p.add_argument("--out-fn", required=True)
    p = sub.add_parser("qure-extract", help="a CQ500 root to NIfTI volumes and info.csv")
    p.add_argument("--input-path", required=True,
                   help="CQ500 root: one DICOM-series subdir per patient id + "
                        "ICH_probabilities.csv")
    p.add_argument("--out-folder", required=True)
    args = ap.parse_args(argv)
    for name in ("data_dir", "label_csv", "series_dir", "input_path", "demographics_csv"):
        path = getattr(args, name, None)
        if path is not None and not os.path.exists(path):
            ap.error(f"--{name.replace('_', '-')}: {path} does not exist")
    setup_logger()
    if args.command == "gen-2d-seg":
        write_2d_dataset(args.data_dir, args.out_dir, "masks", args.demographics_csv)
    elif args.command == "gen-2d-brain":
        write_2d_dataset(args.data_dir, args.out_dir, args.mask_subdir)
    elif args.command == "gen-rsna-csv":
        n = write_rsna_slice_info(args.label_csv, args.out_csv)
        print(f"Wrote {n} slice rows to {args.out_csv}")
    elif args.command == "dicom-to-nifti":
        dicom_to_nifti(args.series_dir, args.out_fn)
    else:
        qure_extract(args.input_path, args.out_folder)


if __name__ == "__main__":
    main()
