"""Gaussian-blended sliding-window volumetric inference (counterpart of
:mod:`ich_tpu.ops.sliding_window`).

A (D, H, W[, C]) volume is tiled with overlapping patches; the network runs
over the patches in batches, each prediction is weighted by a separable
Gaussian importance map (sigma = patch/8, peak 1, floor 1e-2), summed into
a full-volume canvas and divided by the summed weights. Two routes, chosen
by the JAX package's rule (:func:`sliding_window_inference`):

- the coset path, when the stride divides every patch side: the patch grid
  splits into k^3 cosets of non-overlapping patches (k = patch/stride), so
  extraction and accumulation are reshapes and one slice-add per coset, and
  the summed weights are a data-independent canvas built once on the host;
- the general path: clamped patch starts (last patch at ``dim - patch``),
  patches gathered by slicing, and predictions and weights accumulated
  patch by patch. Eager torch runs the overlapping adds in order, so the
  JAX package's ``fori_loop``/``scan``, its padding mask and its
  optimization barriers, which exist for XLA, have no counterpart here.

The network ``apply_fn`` takes and returns channels-first batches,
(B, C, pd, ph, pw) -> (B, C_out, pd, ph, pw); volumes and results keep the
JAX package's channels-last layout.

Both paths run under ``torch.profiler`` ranges, side by side: ``patches``
(the padding and the patch stack), ``net`` (each call of ``apply_fn``) and
``blend`` (the Gaussian weights and the accumulation).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_importance_np(
    patch_size: Sequence[int], sigma_scale: float = 1.0 / 8.0
) -> np.ndarray:
    ws = []
    for n in patch_size:
        c = (n - 1) / 2.0
        sig = max(n * sigma_scale, 1e-3)
        x = np.arange(n, dtype=np.float64)
        ws.append(np.exp(-0.5 * ((x - c) / sig) ** 2))
    m = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    m = m / m.max()
    # floor the far corners (a 3-axis Gaussian corner is ~1e-10) so the
    # normalisation stays well-conditioned in float32
    return np.maximum(m, 1e-2)


# Cached on the device: a fresh upload from pageable host memory waits for
# all queued work and so stalls a pipeline of volumes.
@functools.lru_cache(maxsize=8)
def gaussian_importance_map(patch_size: Tuple[int, int, int],
                            device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(pd, ph, pw) float32 separable Gaussian weights peaking at the patch
    centre, never below 1e-2."""
    return torch.from_numpy(_gaussian_importance_np(patch_size).astype(np.float32)).to(device)


def patch_grid(dim: int, patch: int, step: int) -> np.ndarray:
    """Start coordinates tiling [0, dim) with stride ``step``, the last
    patch clamped to ``dim - patch``."""
    if dim <= patch:
        return np.asarray([0])
    starts = list(range(0, dim - patch + 1, step))
    if starts[-1] != dim - patch:
        starts.append(dim - patch)
    return np.asarray(starts)


def make_patch_coords(
    vol_shape: Sequence[int], patch_size: Sequence[int], overlap: float = 0.5
) -> np.ndarray:
    """(N, 3) int32 start coordinates covering the volume."""
    steps = [max(1, int(p * (1.0 - overlap))) for p in patch_size]
    axes = [patch_grid(d, p, s) for d, p, s in zip(vol_shape, patch_size, steps)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return g.astype(np.int32)


def _sliding_window_general(
    apply_fn: Callable,
    volume: torch.Tensor,  # (C, D, H, W), every side >= its patch side
    patch_size: Tuple[int, int, int],
    overlap: float,
    batch_size: int,
) -> torch.Tensor:
    """Clamped-grid path: (C_out, D, H, W) float32 blend."""
    pd, ph, pw = patch_size
    gmap = gaussian_importance_map(patch_size, volume.device)
    coords = make_patch_coords(volume.shape[1:], patch_size, overlap).tolist()
    acc = wacc = None
    for i in range(0, len(coords), batch_size):
        cs = coords[i:i + batch_size]
        with torch.profiler.record_function("patches"):
            patches = torch.stack([volume[:, z:z + pd, y:y + ph, x:x + pw] for z, y, x in cs])
        with torch.profiler.record_function("net"):
            preds = apply_fn(patches)
        with torch.profiler.record_function("blend"):
            preds = preds.to(torch.float32) * gmap
            if acc is None:
                acc = volume.new_zeros((preds.shape[1],) + volume.shape[1:], dtype=torch.float32)
                wacc = volume.new_zeros(volume.shape[1:], dtype=torch.float32)
            for (z, y, x), p in zip(cs, preds):
                acc[:, z:z + pd, y:y + ph, x:x + pw] += p
                wacc[z:z + pd, y:y + ph, x:x + pw] += gmap
    with torch.profiler.record_function("blend"):
        return acc / torch.clamp(wacc, min=1e-12)


def _cosets(dims: Tuple[int, int, int], patch_size: Tuple[int, int, int],
            stride: Tuple[int, int, int]):
    """Yield each coset of the regular grid over ``dims`` (every
    ``(dim - patch) % stride == 0``) as (origin, patches per axis): coset
    (cd, ch, cw) holds the patches with grid indices cd, cd+k, cd+2k, ...
    along the depth, and so on, k = patch/stride; they do not overlap."""
    k = [p // s for p, s in zip(patch_size, stride)]
    n = [(dims[i] - patch_size[i]) // stride[i] + 1 for i in range(3)]
    for cd in range(min(k[0], n[0])):
        for ch_ in range(min(k[1], n[1])):
            for cw in range(min(k[2], n[2])):
                counts = tuple((n[a] - 1 - ci) // k[a] + 1 for a, ci in enumerate((cd, ch_, cw)))
                yield (cd * stride[0], ch_ * stride[1], cw * stride[2]), counts


def _coset_weight_canvas(
    dims: Tuple[int, int, int],
    patch_size: Tuple[int, int, int],
    stride: Tuple[int, int, int],
) -> np.ndarray:
    """Reciprocal of the summed Gaussian weights of a regular coset grid,
    (D, H, W) float32, summed in float64 on the host (data-independent)."""
    gmap = _gaussian_importance_np(patch_size).astype(np.float32)
    pd, ph, pw = patch_size
    wacc = np.zeros(tuple(dims), np.float64)
    for (od, oh, ow), (md, mh, mw) in _cosets(dims, patch_size, stride):
        tile = np.tile(gmap.reshape(1, pd, 1, ph, 1, pw), (md, 1, mh, 1, mw, 1))
        wacc[od:od + md * pd, oh:oh + mh * ph, ow:ow + mw * pw] += tile.reshape(
            md * pd, mh * ph, mw * pw)
    return (1.0 / np.maximum(wacc, 1e-12)).astype(np.float32)


# a full-volume float32 canvas (67 MB at 64x512x512) per entry: the active
# shape and one more
@functools.lru_cache(maxsize=2)
def _coset_inv_weights(dims: Tuple[int, int, int], patch_size: Tuple[int, int, int],
                       stride: Tuple[int, int, int], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_coset_weight_canvas(dims, patch_size, stride)).to(device)


def _sliding_window_coset(
    apply_fn: Callable,
    volume: torch.Tensor,  # (C, D, H, W)
    patch_size: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    batch_size: int,
) -> torch.Tensor:
    """Regular-grid path: (C_out, D', H', W') float32 blend of the volume
    padded at the far end of each axis to the regular grid, every
    ``(dim' - patch) % stride == 0`` and ``dim' >= patch``."""
    pd, ph, pw = patch_size

    # 1. the padded volume's cosets' patches, as one global stack
    with torch.profiler.record_function("patches"):
        pads = [(p if dim <= p else p + -(-(dim - p) // s) * s) - dim
                for dim, p, s in zip(volume.shape[1:], patch_size, stride)]
        if any(pads):
            volume = F.pad(volume, (0, pads[2], 0, pads[1], 0, pads[0]))
        volume = volume.contiguous()
        c, dims = volume.shape[0], tuple(volume.shape[1:])
        cosets, stacks, total = [], [], 0
        for (od, oh, ow), (md, mh, mw) in _cosets(dims, patch_size, stride):
            view = volume[:, od:od + md * pd, oh:oh + mh * ph, ow:ow + mw * pw]
            patches = view.reshape(c, md, pd, mh, ph, mw, pw).permute(1, 3, 5, 0, 2, 4, 6)
            stacks.append(patches.reshape(md * mh * mw, c, pd, ph, pw))
            cosets.append(((od, oh, ow), (md, mh, mw), total))
            total += md * mh * mw
        stack = torch.cat(stacks)

    # 2. the network over the global stack in batch_size chunks, the tail at
    # its exact size, into one float32 stack; then the Gaussian weights
    preds = None
    for i in range(0, total, batch_size):
        with torch.profiler.record_function("net"):
            out = apply_fn(stack[i:i + batch_size])
            if preds is None:
                preds = torch.empty((total,) + out.shape[1:], dtype=torch.float32,
                                    device=volume.device)
            preds[i:i + batch_size] = out
    with torch.profiler.record_function("blend"):
        preds *= gaussian_importance_map(patch_size, volume.device)

        # 3. per coset, a reshape and one slice-add; then the reciprocal weights
        c_out = preds.shape[1]
        acc = volume.new_zeros((c_out,) + dims, dtype=torch.float32)
        for (od, oh, ow), (md, mh, mw), start in cosets:
            block = preds[start:start + md * mh * mw].reshape(md, mh, mw, c_out, pd, ph, pw)
            block = block.permute(3, 0, 4, 1, 5, 2, 6).reshape(c_out, md * pd, mh * ph, mw * pw)
            acc[:, od:od + md * pd, oh:oh + mh * ph, ow:ow + mw * pw] += block
        return acc * _coset_inv_weights(dims, patch_size, stride, volume.device)


def _route(patch_size: Tuple[int, int, int], overlap: float,
           batch_size: int | None) -> Tuple[bool, Tuple[int, int, int], int]:
    """(use the coset path, strides, batch size), by the JAX package's rule."""
    strides = tuple(max(1, int(p * (1.0 - overlap))) for p in patch_size)
    coset_ok = int(np.prod(patch_size)) <= 2 ** 20  # <= 101^3 voxels
    use_coset = coset_ok and all(p % s == 0 for p, s in zip(patch_size, strides))
    if batch_size is None:
        batch_size = 128 if use_coset else 4
    return use_coset, strides, batch_size


def sliding_window_inference(
    apply_fn: Callable,
    volume: torch.Tensor,
    patch_size: Sequence[int] = (128, 128, 128),
    overlap: float = 0.5,
    batch_size: int | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Segment a (D, H, W[, C]) volume with Gaussian-blended overlapping
    patches on the volume's device. ``apply_fn`` maps channels-first
    (B, C, pd, ph, pw) patches to (B, C_out, pd, ph, pw) probabilities.
    Returns (D, H, W, C_out) float32.

    The coset path runs iff ``prod(patch) <= 2**20`` and the stride
    ``max(1, int(p * (1 - overlap)))`` divides every patch side; otherwise
    the general path runs. In the JAX package the size limit avoids an XLA
    compile blow-up, which eager torch does not have; it is kept because
    the two routes tile an irregular shape differently (the coset path pads
    each axis up to a regular grid, the general path clamps the last patch:
    D = 100 with a 64 patch at 0.5 overlap gives starts 0/32/64 over a
    padded 128 against 0/32/36), so results near the far boundary depend on
    the route. ``batch_size=None`` is 128 on the coset path and 4 on the
    general one, as in the JAX package.

    ``compute_dtype`` casts the volume before patch extraction (blending
    stays float32).
    """
    squeeze_c = volume.dim() == 3
    vol = volume.unsqueeze(0) if squeeze_c else volume.permute(3, 0, 1, 2)  # (C, D, H, W)
    if compute_dtype is not None:
        vol = vol.to(compute_dtype)
    d, h, w = vol.shape[1:]
    patch_size = tuple(int(p) for p in patch_size)

    use_coset, strides, batch_size = _route(patch_size, overlap, batch_size)
    if use_coset:
        out = _sliding_window_coset(apply_fn, vol, patch_size, strides, batch_size)
    else:
        pads = [max(0, p - s) for p, s in zip(patch_size, (d, h, w))]
        if any(pads):
            vol = F.pad(vol, (0, pads[2], 0, pads[1], 0, pads[0]))
        out = _sliding_window_general(apply_fn, vol, patch_size, overlap, batch_size)
    return out[:, :d, :h, :w].permute(1, 2, 3, 0)
