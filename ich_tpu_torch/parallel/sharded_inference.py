"""Multi-rank volume inference (counterpart of
:mod:`ich_tpu.parallel.sharded_inference`).

- :func:`sliding_window_inference_sharded`: one volume's H axis split over
  the ranks. Each rank receives the ``patch - stride`` boundary rows of its
  ring neighbours (``batch_isend_irecv``; zeros stand in at the two global
  ends, the single-device path's zero padding), runs the coset sliding
  window on its extended slab and keeps its own rows; patches that straddle
  a boundary are computed by both neighbours instead of exchanging partial
  sums. The result is gathered on every rank. The patch grid near the
  global edges can differ from the single-device grid by one stride, so
  edge voxels may blend another patch set (the weights normalise either
  way): hold it against the JAX package's sharded function at the same
  rank count, not against the single-device path.
- :func:`volume_parallel_map`: same-shaped volumes, one per rank per
  round, the tail round padded by repeating its last volume, results
  gathered in order on every rank; the serving counterpart of batch-sharded
  training, with no collective but the gather.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ich_tpu_torch.ops.sliding_window import _sliding_window_coset, sliding_window_inference
from ich_tpu_torch.parallel.mesh import Mesh
from ich_tpu_torch.utils.pipeline import fetch_pipelined


def _gather(t: torch.Tensor, mesh: Mesh) -> list:
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return parts


def volume_parallel_map(
    body: Callable[[np.ndarray], torch.Tensor],
    volumes: Sequence[np.ndarray],
    mesh: Mesh,
    pipeline_depth: int = 2,
) -> Iterator[np.ndarray]:
    """Map ``body(volume) -> device tensor`` over same-shaped host volumes,
    one volume per rank per round; yields one host array per input volume,
    in order, on every rank. At most ``pipeline_depth`` rounds are queued
    before the oldest is fetched, so device memory holds a bounded number
    of inputs and outputs however many volumes come."""
    n = len(volumes)
    if n == 0:
        return
    shape = tuple(np.shape(volumes[0]))
    if any(tuple(np.shape(v)) != shape for v in volumes):
        raise ValueError("volume_parallel_map needs volumes of one shape")

    def rounds():
        for i in range(0, n, mesh.size):
            k = min(mesh.size, n - i)
            out = body(volumes[i + min(mesh.rank, k - 1)])
            yield k, _gather(out, mesh)

    for outs in fetch_pipelined(rounds(), depth=pipeline_depth,
                                fetch=lambda r: [o.cpu().numpy() for o in r[1][:r[0]]]):
        yield from outs


def _pad_to_grid(dim: int, p: int, s: int) -> int:
    return p if dim <= p else p + -(-(dim - p) // s) * s


def _halos(mine: torch.Tensor, halo: int, mesh: Mesh):
    """(top, bottom) ``halo`` rows along axis 2 of the (C, D, slab, W)
    slabs of the ranks above and below; zeros at the global ends."""
    top = mine.new_zeros(mine.shape[:2] + (halo,) + mine.shape[3:])
    bot = torch.zeros_like(top)
    ops = []
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, mine[:, :, :halo].contiguous(), mesh.rank - 1, mesh.group),
                dist.P2POp(dist.irecv, top, mesh.rank - 1, mesh.group)]
    if mesh.rank < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, mine[:, :, -halo:].contiguous(), mesh.rank + 1, mesh.group),
                dist.P2POp(dist.irecv, bot, mesh.rank + 1, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return top, bot


def sliding_window_inference_sharded(
    apply_fn: Callable,
    volume: torch.Tensor | np.ndarray,
    mesh: Mesh,
    patch_size: Sequence[int] = (64, 64, 64),
    overlap: float = 0.5,
    batch_size: int | None = None,
) -> torch.Tensor:
    """Blend a (D, H, W[, C]) volume, given whole on every rank, with its H
    axis split over the ranks and halo exchange; ``apply_fn`` maps
    (B, C, pd, ph, pw) patches to (B, C_out, pd, ph, pw). The stride must
    divide the patch (the coset path; overlap 0.5 or 0 for even patches).
    Returns (D, H, W, C_out) float32 on the mesh's device, on every rank."""
    volume = torch.as_tensor(volume)
    if volume.dim() == 3:
        volume = volume[..., None]
    d, h, w, _ = volume.shape
    patch_size = tuple(int(p) for p in patch_size)
    strides = tuple(max(1, int(p * (1.0 - overlap))) for p in patch_size)
    if any(p % s for p, s in zip(patch_size, strides)):
        raise ValueError(f"sharded inference needs the stride {strides} to divide the patch "
                         f"{patch_size} (for example overlap 0.5)")
    pd, ph, pw = patch_size
    sd, sh, sw = strides
    halo = ph - sh
    batch_size = 128 if batch_size is None else batch_size

    # D and W padded to the coset grid; H to n slabs of whole strides, each
    # at least one patch high
    d2, w2 = _pad_to_grid(d, pd, sd), _pad_to_grid(w, pw, sw)
    slab = max(ph, -(-h // (mesh.size * sh)) * sh)
    rows = volume[:, mesh.rank * slab:(mesh.rank + 1) * slab]  # this rank's shard
    mine = F.pad(rows.permute(3, 0, 1, 2).to(mesh.device, torch.float32),
                 (0, w2 - w, 0, slab - rows.shape[1], 0, d2 - d))  # (C, D2, slab, W2)
    with torch.inference_mode():
        # halo 0 (overlap 0) must not exchange: mine[:, :, -0:] is the whole slab
        if halo:
            top, bot = _halos(mine, halo, mesh)
            ext = torch.cat([top, mine, bot], dim=2)
        else:
            ext = mine
        ext_h = ext.shape[2]
        ext = F.pad(ext, (0, 0, 0, _pad_to_grid(ext_h, ph, sh) - ext_h))
        out = _sliding_window_coset(apply_fn, ext.contiguous(), patch_size, strides, batch_size)
        out = torch.cat(_gather(out[:, :, halo:halo + slab], mesh), dim=2)
    return out[:, :d, :h, :w].permute(1, 2, 3, 0)


def sliding_window_inference_volume_parallel(
    apply_fn: Callable,
    volumes,
    mesh: Mesh,
    patch_size: Sequence[int] = (64, 64, 64),
    overlap: float = 0.5,
    batch_size: int | None = None,
) -> np.ndarray:
    """(N, D, H, W[, C]) same-shaped volumes, one per rank per round
    (:func:`volume_parallel_map`), each through the unchanged single-volume
    :func:`ich_tpu_torch.ops.sliding_window.sliding_window_inference` on
    its rank's device. Returns (N, D, H, W, C_out) float32 on the host."""
    def body(v):
        with torch.inference_mode():
            return sliding_window_inference(
                apply_fn, torch.as_tensor(np.asarray(v, np.float32)).to(mesh.device),
                patch_size=patch_size, overlap=overlap, batch_size=batch_size)

    vols = [np.asarray(v) for v in volumes]
    vols = [v[..., None] if v.ndim == 3 else v for v in vols]
    return np.stack(list(volume_parallel_map(body, vols, mesh)))
