"""Dataset containers and batch plans, copied from ``ich_tpu/data/core.py``
(importing ``ich_tpu.data`` imports jax): ``batch_indices``,
``SliceDataset2D`` and ``LabeledSliceDataset`` (their ``device_cache``
moves the arrays to a torch device) and ``VolumeDataset3D``."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def batch_indices(
    n: int,
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
    pad_wrap: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index arrays of exactly ``batch_size``.

    With ``pad_wrap`` the final partial batch is filled by wrapping around
    the permutation (every sample still seen once per epoch; a few seen
    twice), as the JAX package does for its static shapes: the epoch means
    and evaluation rows then match it row for row.
    """
    order = np.arange(n)
    if shuffle:
        rng = rng or np.random.default_rng()
        order = rng.permutation(n)
    full = (n // batch_size) * batch_size
    for i in range(0, full, batch_size):
        yield order[i : i + batch_size]
    rem = n - full
    if rem and not drop_last:
        if pad_wrap:
            # tile until the pad is covered: with n < batch_size/2 a single
            # wrap (order[:batch_size-rem]) is too short
            reps = int(np.ceil((batch_size - rem) / n)) + 1
            wrapped = np.tile(order, reps)[: batch_size - rem]
            yield np.concatenate([order[full:], wrapped])
        else:
            yield order[full:]


def _as_f32(x):
    """float32 ``x``; a torch tensor stays a tensor on its device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.asarray(x, dtype=np.float32)


@dataclasses.dataclass
class SliceDataset2D:
    """Dense 2D slice dataset: images (N, H, W) or (N, H, W, C) float32,
    masks (N, H, W) {0,1}, vol_ids (N,) int32, slice_nbrs (N,) int32.
    Images and masks are numpy arrays, or torch tensors after
    :meth:`device_cache`."""

    images: np.ndarray
    masks: np.ndarray
    vol_ids: np.ndarray
    slice_nbrs: np.ndarray

    def __post_init__(self):
        self.images = _as_f32(self.images)
        self.masks = _as_f32(self.masks)
        self.vol_ids = np.asarray(self.vol_ids, dtype=np.int32)
        self.slice_nbrs = np.asarray(self.slice_nbrs, dtype=np.int32)
        n = len(self.images)
        if not (len(self.masks) == len(self.vol_ids) == len(self.slice_nbrs) == n):
            raise ValueError("images/masks/vol_ids/slice_nbrs lengths differ")

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_shape(self) -> Tuple[int, ...]:
        return tuple(self.images.shape[1:])

    def nchw_to_dense_vol_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """Map raw volume ids to dense [0, n_volumes) indices.
        Returns (dense_ids (N,) int32, unique_vol_ids (V,))."""
        uniq, dense = np.unique(self.vol_ids, return_inverse=True)
        return dense.astype(np.int32), uniq

    def subset(self, idx: np.ndarray) -> "SliceDataset2D":
        return SliceDataset2D(
            self.images[idx], self.masks[idx], self.vol_ids[idx], self.slice_nbrs[idx]
        )

    def device_cache(self, device: str | torch.device) -> "SliceDataset2D":
        """Images and masks as tensors on ``device``; batches are then
        gathered on the device."""
        def to(x):
            return torch.as_tensor(x).to(device)

        return SliceDataset2D(to(self.images), to(self.masks), self.vol_ids, self.slice_nbrs)


@dataclasses.dataclass
class LabeledSliceDataset:
    """Slices + labels for SSL and classification pretraining: images
    (N, H, W[, C]) float32, labels (N,) int or (N, K) multilabel float, the
    schema of the reference's RSNA modes (``datasets.py:320-422``). Images
    are a numpy array, or a torch tensor after :meth:`device_cache`; labels
    stay numpy."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        self.images = _as_f32(self.images)
        self.labels = np.asarray(self.labels)
        if len(self.images) != len(self.labels):
            raise ValueError("images/labels lengths differ")

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_shape(self) -> Tuple[int, ...]:
        return tuple(self.images.shape[1:])

    def device_cache(self, device: str | torch.device) -> "LabeledSliceDataset":
        """Images as a tensor on ``device``; batches are then gathered on the
        device."""
        return LabeledSliceDataset(torch.as_tensor(self.images).to(device), self.labels)


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
