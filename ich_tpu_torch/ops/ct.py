"""CT preprocessing (counterpart of :mod:`ich_tpu.ops.ct`).

Windowing is a clip+affine. Resizing reproduces the JAX package's rules
exactly: order 0 is skimage's nearest rule, order 1 is
``jax.image.resize(method="linear")``, which antialiases when it
downsamples (``torch.nn.functional.interpolate`` does not by default).
Resampling to a spacing (``resample_ct``) uses ``scipy.ndimage.zoom``'s
endpoint-aligned grid instead: round-half-up nearest for order 0 and linear
without antialias for order 1. All are written as per-axis index or weight
tables built on the host in float32 with the JAX package's arithmetic, then
applied on the tensor's device.
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


def _triangle_weights(sample_f: np.ndarray, n_in: int, kernel_scale: np.float32) -> torch.Tensor:
    """The tail of ``jax._src.image.scale.compute_weight_mat``, in float32:
    (n_in, n_out) triangle-kernel weights of the input centres around each
    output's sample coordinate ``sample_f`` (half-pixel removed), widened by
    ``kernel_scale``, normalised per output sample, and zero for samples
    outside the input."""
    f32 = np.float32
    dist = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], weights, f32(0.0)).astype(f32))


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(method="linear")`` along
    one axis: a triangle kernel on half-pixel centres, widened by in/out
    when downsampling (antialias)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    return _triangle_weights(sample_f, n_in, kernel_scale).to(device)


def _contract_axes(x: torch.Tensor, shape: Sequence[int], weights) -> torch.Tensor:
    """Apply a per-axis (n_in, n_out) weight table ``weights(n_in, n_out,
    device)`` to every axis whose size changes; float32 out."""
    out = x.to(torch.float32)
    for axis, (n_out, n_in) in enumerate(zip(shape, x.shape)):
        if n_out == n_in:
            continue
        w = weights(n_in, n_out, x.device)
        # contract input axis `axis` with w's first axis; new axis goes last
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
    return out


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
    return _contract_axes(x, shape, _linear_weights)


def _resampled_shape(
    shape: Sequence[int],
    in_pixel_dim: Sequence[float],
    out_pixel_dim: Sequence[float],
) -> Tuple[int, ...]:
    """round(shape * in_dim / out_dim) per axis; ``-1`` in ``out_pixel_dim``
    keeps the input spacing on that axis."""
    in_d = np.asarray(in_pixel_dim, dtype=float)
    out_d = np.asarray(out_pixel_dim, dtype=float).copy()
    out_d[out_d == -1] = in_d[out_d == -1]
    new_shape = np.round(np.asarray(shape) * in_d / out_d).astype(int)
    return tuple(int(s) for s in new_shape)


def resample_ct(
    ct_scan: torch.Tensor,
    in_pixel_dim: Sequence[float],
    out_pixel_dim: Sequence[float] = (1.0, 1.0, 1.0),
    preserve_range: bool = True,
    order: int = 1,
) -> torch.Tensor:
    """Resample a volume to the spacing ``out_pixel_dim`` (``-1`` keeps an
    axis) on the tensor's device: order 0 is :func:`resize_nearest_zoom`,
    higher orders :func:`_resize_linear_zoom`. ``preserve_range`` rescales
    the output back to the input's min..max."""
    new_shape = _resampled_shape(ct_scan.shape, in_pixel_dim, out_pixel_dim)
    if order == 0:
        out = resize_nearest_zoom(ct_scan, new_shape)
    else:
        out = _resize_linear_zoom(ct_scan, new_shape)
    if preserve_range:
        in_min, in_max = torch.min(ct_scan), torch.max(ct_scan)
        o_min, o_max = torch.min(out), torch.max(out)
        ptp = torch.clamp(o_max - o_min, min=float(np.finfo(np.float32).tiny))
        out = (in_max - in_min) * (out - o_min) / ptp + in_min
    return out


@functools.lru_cache(maxsize=64)
def _zoom_nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``scipy.ndimage.zoom(order=0)``'s rule: output i samples input
    floor(i * (in-1)/(out-1) + 0.5), in float32 like the JAX package, with
    the endpoint clamped into the axis (scipy can land it just outside, at
    47.000000000000007 for 48->24, and then zeroes the last index)."""
    if n_out == 1:
        idx = np.zeros((1,), np.int64)
    else:
        idx = np.floor(np.arange(n_out, dtype=np.float32)
                       * np.float32((n_in - 1) / (n_out - 1)) + np.float32(0.5))
    idx = np.clip(idx.astype(np.int64), 0, n_in - 1)
    return torch.from_numpy(idx).to(device)


def resize_nearest_zoom(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize on ``scipy.ndimage.zoom``'s endpoint-aligned
    grid (the reference's ``resample_ct`` of masks); keeps the dtype."""
    out = x
    for axis, (n_out, n_in) in enumerate(zip(shape, x.shape)):
        if n_out == n_in:
            continue
        out = torch.index_select(out, axis, _zoom_nearest_index(n_in, n_out, x.device))
    return out


@functools.lru_cache(maxsize=64)
def _zoom_linear_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.scale_and_translate`` with
    scale (out-1)/(in-1), translation 0.5-0.5*scale, the triangle kernel and
    antialias off, as the JAX package's ``_resize_linear_zoom`` calls it:
    ``scipy.ndimage.zoom(order=1)``'s endpoint-aligned grid."""
    f32 = np.float32
    scale = f32((n_out - 1) / (n_in - 1) if n_out > 1 else 1.0)
    translation = f32(0.5) - f32(0.5) * scale
    inv_scale = f32(1.0) / scale
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - translation * inv_scale - f32(0.5))
    return _triangle_weights(sample_f, n_in, f32(1.0)).to(device)


def _resize_linear_zoom(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Linear resize on ``scipy.ndimage.zoom(order=1)``'s endpoint-aligned
    grid (input coordinate o * (in-1)/(out-1)), no antialias; float32 out."""
    return _contract_axes(x, shape, _zoom_linear_weights)
