"""Dataset containers: ``VolumeDataset3D`` copied from ``ich_tpu/data/core.py``
(importing ``ich_tpu.data`` imports jax)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VolumeDataset3D:
    """Dense 3D dataset: list of (volume (D, H, W), mask (D, H, W), vol_id).
    Volumes may have different depths; patch sampling makes batches static."""

    volumes: list
    masks: list
    vol_ids: np.ndarray

    def __post_init__(self):
        self.vol_ids = np.asarray(self.vol_ids, dtype=np.int32)
        if not (len(self.volumes) == len(self.masks) == len(self.vol_ids)):
            raise ValueError("volumes/masks/vol_ids lengths differ")

    def __len__(self) -> int:
        return len(self.volumes)
