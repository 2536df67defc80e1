"""Exact euclidean distance transform (counterpart of
:mod:`ich_tpu.ops.distance`).

Both functions take ``(..., H, W)`` tensors and run the separable two-pass
EDT of :mod:`ich_tpu_torch.ops.edt`: on a CUDA tensor through the min-plus
kernel, on a CPU tensor through its plain version.
"""

from __future__ import annotations

import torch

from ich_tpu_torch.ops.edt import distance_transform_edt_kernel


def distance_transform_edt(mask: torch.Tensor) -> torch.Tensor:
    """Euclidean distance from each pixel to the nearest pixel where
    ``mask == 0`` (``scipy.ndimage.distance_transform_edt``'s convention),
    per ``(H, W)`` image. Pixels where mask == 0 get 0; an image without a
    zero pixel saturates at ``sqrt(1e10) = 1e5``. Returns float32."""
    return distance_transform_edt_kernel(mask)


def distance_to_set(site: torch.Tensor) -> torch.Tensor:
    """Euclidean distance from every pixel to the nearest pixel where
    ``site == 1`` (the EDT of the complement)."""
    return distance_transform_edt(1.0 - site.to(torch.float32))
