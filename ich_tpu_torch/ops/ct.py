"""CT preprocessing (counterpart of :mod:`ich_tpu.ops.ct`).

Windowing is a clip+affine. Resizing reproduces the JAX package's two rules
exactly: order 0 is skimage's nearest rule, order 1 is
``jax.image.resize(method="linear")``, which antialiases when it
downsamples (``torch.nn.functional.interpolate`` does not by default). Both
are written as per-axis index or weight tables built on the host in float32
with the JAX package's arithmetic, then applied on the tensor's device.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def window_ct(
    ct_scan: torch.Tensor,
    win_center: float = 40.0,
    win_width: float = 120.0,
    out_range: Tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """HU window: affine rescale so [center-width/2, center+width/2] maps to
    ``out_range``, then clip. Integer input becomes float32."""
    x = ct_scan if ct_scan.is_floating_point() else ct_scan.to(torch.float32)
    win_min = win_center - win_width / 2.0
    win_max = win_center + win_width / 2.0
    lo, hi = out_range
    x = (hi - lo) * (x - win_min) / (win_max - win_min) + lo
    return torch.clamp(x, lo, hi)


# The index and weight tables are cached per (sizes, device): a fresh
# host-to-device copy from pageable memory would wait for all work queued on
# the stream and so stall a pipeline of volumes.
@functools.lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """skimage order-0 rule: output i samples input floor((i + 0.5) * in/out),
    in float32 like the JAX package."""
    idx = np.floor(
        (np.arange(n_out, dtype=np.float32) + np.float32(0.5))
        * np.float32(n_in / n_out)
    ).astype(np.int64)
    return torch.from_numpy(np.clip(idx, 0, n_in - 1)).to(device)


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize by integer gathers on each axis (exact for
    masks; keeps the dtype)."""
    out = x
    for axis, (n_out, n_in) in enumerate(zip(shape, x.shape)):
        if n_out == n_in:
            continue
        out = torch.index_select(out, axis, _nearest_index(n_in, n_out, x.device))
    return out


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(method="linear")`` along
    one axis: a triangle kernel on half-pixel centres, widened by in/out
    when downsampling (antialias), normalised per output sample, and zero
    for samples outside the input (``jax._src.image.scale.compute_weight_mat``)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    dist = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return torch.from_numpy(weights).to(device)


def resize(x: torch.Tensor, shape: Sequence[int], order: int = 1) -> torch.Tensor:
    """Resize with interpolation order 0 (nearest) or 1 (linear, antialiased
    when downsampling, as ``ich_tpu.ops.ct.resize``). Order 1 returns
    float32."""
    if order == 0:
        return resize_nearest(x, shape)
    if order != 1:
        raise ValueError(f"resize: order must be 0 or 1, got {order}")
    if len(shape) != x.dim():
        raise ValueError(f"resize: shape {tuple(shape)} vs ndim {x.dim()}")
    out = x.to(torch.float32)
    for axis, (n_out, n_in) in enumerate(zip(shape, x.shape)):
        if n_out == n_in:
            continue
        w = _linear_weights(n_in, n_out, x.device)
        # contract input axis `axis` with w's first axis; new axis goes last
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
    return out
