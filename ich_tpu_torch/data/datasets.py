"""Dataset loaders (counterpart of :mod:`ich_tpu.data.datasets`; only the
3D SegICH loader is ported so far)."""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.ops.ct import _resampled_shape, resample_ct, resize_nearest_zoom, window_ct


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
