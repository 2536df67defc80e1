"""Synthetic head-CT-like slices for tests and the on-card smoke run,
copied from ``ich_tpu/data/synthetic.py`` (``_lesion_mask_2d``,
``synthetic_ich_slices``, ``synthetic_rsna_slices``, ``write_segich_tree``
and ``write_rsna_tree``; importing ``ich_tpu.data`` imports jax): a
skull-like bright ring, brain-tissue texture, and ellipsoidal hyperdense
"hemorrhage" lesions with matching masks, the same arrays and files for the
same seed as the JAX package's; also ``write_cq500_tree`` and
``synthetic_ich_volume``. The trees are written with the numpy TIFF, BMP
and DICOM writers and :func:`~ich_tpu_torch.data.table.write_csv`, without
PIL or pandas."""

from __future__ import annotations

import csv
import os
from typing import Tuple

import numpy as np

from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.core import LabeledSliceDataset, SliceDataset2D
from ich_tpu_torch.data.dicom import write_minimal_dicom
from ich_tpu_torch.data.table import write_csv
from ich_tpu_torch.data.tiff import write_tiff


def _lesion_mask_2d(
    rng: np.random.Generator, h: int, w: int, max_lesions: int = 2
) -> np.ndarray:
    mask = np.zeros((h, w), dtype=np.float32)
    n = rng.integers(0, max_lesions + 1)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx = rng.uniform(0.25 * h, 0.75 * h), rng.uniform(0.25 * w, 0.75 * w)
        ry, rx = rng.uniform(0.03, 0.12) * h, rng.uniform(0.03, 0.12) * w
        theta = rng.uniform(0, np.pi)
        ys, xs = yy - cy, xx - cx
        yr = ys * np.cos(theta) + xs * np.sin(theta)
        xr = -ys * np.sin(theta) + xs * np.cos(theta)
        mask[(yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0] = 1.0
    return mask


def synthetic_ich_slices(
    n_slices: int = 64,
    size: int = 64,
    n_volumes: int = 8,
    seed: int = 0,
    positive_frac: float = 0.6,
    lesion_intensity: float = 0.75,
    lesion_noise: float = 0.05,
    texture_amp: float = 0.0,
) -> SliceDataset2D:
    """Windowed-intensity [0,1] slices with lesions; returns SliceDataset2D.

    ``texture_amp > 0`` superimposes smooth per-patient low-frequency
    texture (gyri-like structure shared by all slices of a volume), and a
    ``lesion_intensity`` near the 0.35 tissue mean makes lesions
    low-contrast."""
    rng = np.random.default_rng(seed)
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
    brain = (r < 0.42 * h).astype(np.float32)
    skull = ((r >= 0.42 * h) & (r < 0.48 * h)).astype(np.float32)

    images = np.empty((n_slices, h, w), dtype=np.float32)
    masks = np.empty((n_slices, h, w), dtype=np.float32)
    vol_ids = np.repeat(np.arange(n_volumes), int(np.ceil(n_slices / n_volumes)))[:n_slices]
    slice_nbrs = np.concatenate(
        [np.arange((vol_ids == v).sum()) for v in range(n_volumes)]
    )[:n_slices]
    textures = {}
    if texture_amp > 0.0:
        for v in range(n_volumes):
            t = np.zeros((h, w), dtype=np.float32)
            for _ in range(4):
                fy, fx = rng.uniform(2.0, 7.0, size=2)
                ph = rng.uniform(0, 2 * np.pi, size=2)
                t += np.sin(2 * np.pi * fy * yy / h + ph[0]) * np.sin(
                    2 * np.pi * fx * xx / w + ph[1]
                )
            textures[v] = texture_amp * (t / 4.0).astype(np.float32)
    for i in range(n_slices):
        tissue = 0.35 + 0.08 * rng.standard_normal((h, w)).astype(np.float32)
        if texture_amp > 0.0:
            tissue = tissue + textures[int(vol_ids[i])]
        if rng.uniform() < positive_frac:
            lesion = _lesion_mask_2d(rng, h, w) * brain
        else:
            lesion = np.zeros((h, w), dtype=np.float32)
        img = tissue * brain + 1.0 * skull
        img = np.where(
            lesion > 0,
            lesion_intensity + lesion_noise * rng.standard_normal((h, w)),
            img,
        )
        images[i] = np.clip(img, 0.0, 1.0)
        masks[i] = lesion
    return SliceDataset2D(images, masks, vol_ids, slice_nbrs)


def synthetic_rsna_slices(
    n_slices: int = 128, size: int = 64, seed: int = 0, positive_frac: float = 0.4
) -> LabeledSliceDataset:
    """Slices with 7-way multilabel vectors in the pivot's column order
    (column 0 Hemorrhage, 1-5 one subtype per positive slice, 6
    no_Hemorrhage); ``labels[:, 0]`` is the binary target."""
    ds = synthetic_ich_slices(
        n_slices=n_slices, size=size, n_volumes=max(1, n_slices // 8),
        seed=seed, positive_frac=positive_frac,
    )
    rng = np.random.default_rng(seed + 1)
    has_ich = (ds.masks.reshape(n_slices, -1).max(axis=1) > 0).astype(np.float32)
    subtype = rng.integers(0, 5, size=n_slices)
    labels = np.zeros((n_slices, 7), dtype=np.float32)
    labels[:, 0] = has_ich
    labels[:, 6] = 1.0 - has_ich
    for i in range(n_slices):
        if has_ich[i]:
            labels[i, 1 + subtype[i]] = 1.0
    return LabeledSliceDataset(ds.images, labels)


def write_segich_tree(
    dataset: SliceDataset2D,
    out_dir: str,
    window: Tuple[float, float] = (50.0, 200.0),
) -> str:
    """A SliceDataset2D on disk in the publicSegICH-2D layout:

    - ``Patient_CT/{id:03d}/{slice}.tif`` CT slices (float32 TIFF, the [0,1]
      intensities un-windowed back to HU),
    - ``Patient_CT/{id:03d}/{slice}_ICH_Seg.bmp`` 8-bit masks of the
      positive slices only; ``mask_fn`` is ``None`` on the other rows,
    - ``ct_info.csv`` (PatientNumber, SliceNumber, CT_fn, mask_fn,
      Hemorrhage) and ``patient_info.csv`` (PatientNumber, Age, Gender,
      Hemorrhage), as pandas' ``to_csv`` writes them.

    The same files, byte for byte in the CSVs and pixel for pixel in the
    images, as the JAX package's writer (which uses pandas and PIL)."""
    c, w = window
    os.makedirs(os.path.join(out_dir, "Patient_CT"), exist_ok=True)
    rows, patients = [], {}
    for i in range(len(dataset)):
        vid = int(dataset.vol_ids[i])
        snb = int(dataset.slice_nbrs[i])
        os.makedirs(os.path.join(out_dir, "Patient_CT", f"{vid:03d}"), exist_ok=True)
        hu = dataset.images[i] * w + (c - w / 2.0)
        ct_fn = f"Patient_CT/{vid:03d}/{snb}.tif"
        write_tiff(os.path.join(out_dir, ct_fn), hu.astype(np.float32))
        pos = int(dataset.masks[i].max() > 0)
        mask_fn = "None"
        if pos:
            mask_fn = f"Patient_CT/{vid:03d}/{snb}_ICH_Seg.bmp"
            save_bmp_gray(os.path.join(out_dir, mask_fn),
                          ((dataset.masks[i] > 0) * 255).astype(np.uint8))
        rows.append([i, vid, snb, ct_fn, mask_fn, pos])
        patients[vid] = max(patients.get(vid, 0), pos)
    write_csv(os.path.join(out_dir, "ct_info.csv"),
              ["", "PatientNumber", "SliceNumber", "CT_fn", "mask_fn", "Hemorrhage"], rows)
    # demographics drawn per patient id from a fixed seed, as the JAX writer
    meta_rng = np.random.default_rng(1234)
    prows = []
    for j, (k, v) in enumerate(sorted(patients.items())):
        age = int(meta_rng.integers(18, 95))
        prows.append([j, k, age, "Male" if meta_rng.uniform() < 0.5 else "Female", v])
    write_csv(os.path.join(out_dir, "patient_info.csv"),
              ["", "PatientNumber", "Age", "Gender", "Hemorrhage"], prows)
    return out_dir


def write_rsna_tree(out_dir: str, n_slices: int = 12, size: int = 32, seed: int = 0) -> str:
    """An RSNA stage-2 tree on disk:

    - ``stage_2_train/ID_<sop>.dcm`` CT slices (explicit-VR LE, slope 1 /
      intercept -1024, as the real export),
    - ``stage_2_train.csv`` in the long label format (``ID,Label``, ``ID =
      ID_<sop>_<subtype>``, 6 rows per slice) with the real file's quirks:
      duplicated label rows and the corrupted ``ID_6431af929`` entry.

    Returns the label csv's path; :func:`ich_tpu_torch.data.datasets.
    write_rsna_slice_info` pivots it to the ``slice_info.csv`` that
    ``load_rsna_slices`` reads."""
    subtypes = ["any", "epidural", "intraparenchymal", "intraventricular",
                "subarachnoid", "subdural"]
    rng = np.random.default_rng(seed)
    ds = synthetic_ich_slices(n_slices=n_slices, size=size, seed=seed)
    dcm_dir = os.path.join(out_dir, "stage_2_train")
    os.makedirs(dcm_dir, exist_ok=True)
    rows = []
    for i in range(n_slices):
        sop = f"{seed:03x}{i:06x}"
        hu = ds.images[i] * 200.0 - 50.0  # back to a HU-like range
        write_minimal_dicom(
            os.path.join(dcm_dir, f"ID_{sop}.dcm"),
            np.round(hu + 1024.0).astype(np.int16),  # stored + intercept
            slope=1.0, intercept=-1024.0,
            position=(0.0, 0.0, float(i) * 5.0),
        )
        has_ich = int(ds.masks[i].max() > 0)
        labels = {"any": has_ich}
        sub = subtypes[1 + int(rng.integers(0, 5))]
        for st in subtypes[1:]:
            labels[st] = has_ich if st == sub else 0
        for st in subtypes:
            rows.append((f"ID_{sop}_{st}", labels[st]))
        if i % 3 == 0:  # the stage-2 csv contains duplicated rows
            rows.append((f"ID_{sop}_any", labels["any"]))
    # the corrupted slice: labels present, no readable pixel data
    for st in subtypes:
        rows.append((f"ID_6431af929_{st}", 0))
    with open(os.path.join(out_dir, "stage_2_train.csv"), "w", newline="") as f:
        wtr = csv.writer(f)
        wtr.writerow(["ID", "Label"])
        wtr.writerows(rows)
    return os.path.join(out_dir, "stage_2_train.csv")


def write_cq500_tree(
    out_dir: str, n_patients: int = 2, n_slices: int = 6, size: int = 32, seed: int = 0
) -> str:
    """A qureAI CQ500 root: one DICOM-series directory per numeric patient
    id, the files named NOT in z order (a slice's position is its
    ImagePositionPatient, by which ``series_to_volume`` sorts, as in the
    real series), plus ``ICH_probabilities.csv`` indexed by patient id
    (``qureAI_extract_as_nifti.py:55-60``)."""
    rng = np.random.default_rng(seed)
    prob_rows = []
    for pid in range(n_patients):
        pdir = os.path.join(out_dir, str(pid))
        os.makedirs(pdir, exist_ok=True)
        ds = synthetic_ich_slices(n_slices=n_slices, size=size, seed=seed + pid)
        order = rng.permutation(n_slices)  # filename order != z order
        for file_idx, z_idx in enumerate(order):
            hu = ds.images[z_idx] * 200.0 - 50.0
            write_minimal_dicom(
                os.path.join(pdir, f"CT-{file_idx:04d}.dcm"),
                np.round(hu + 1024.0).astype(np.int16),
                slope=1.0, intercept=-1024.0,
                spacing=(0.5, 0.5),
                position=(0.0, 0.0, float(z_idx) * 5.0),
            )
        prob_rows.append([pid, float(rng.uniform()), float(rng.uniform())])
    write_csv(os.path.join(out_dir, "ICH_probabilities.csv"), ["id", "ICH", "IPH"], prob_rows)
    return out_dir


def synthetic_ich_volume(
    size: int = 64, depth: int = 32, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """One (H, W, D) volume in raw HU-like units and its (H, W, D) mask."""
    ds = synthetic_ich_slices(n_slices=depth, size=size, n_volumes=1, seed=seed)
    vol = np.transpose(ds.images, (1, 2, 0))  # (H, W, D)
    mask = np.transpose(ds.masks, (1, 2, 0))
    # map [0,1] windowed intensity back to a HU-like range (win 50/200)
    vol_hu = vol * 200.0 + (50.0 - 100.0)
    return vol_hu.astype(np.float32), mask.astype(np.float32)
