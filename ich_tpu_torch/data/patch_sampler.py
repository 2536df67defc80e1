"""Device-resident 3D patch sampling for patch training (counterpart of
:mod:`ich_tpu.data.patch_sampler`).

The whole dataset lives on the device, volumes zero-padded to a common
shape and stacked once, masks as uint8; each batch is drawn from the
step's jax.random key as the JAX package's ``_sample_batch`` draws it, then
gathered in one batched gather, so the training loop moves no patch bytes
through the host. The semantics are the host sampler's
(:func:`ich_tpu_torch.train.segmentation3d.sample_patches`): with
probability ``pos_frac`` the patch is centred on a uniformly chosen
positive voxel of its volume (start clipped into bounds), else its start is
uniform; a volume's extent is its own padded up to the patch size, so a
short volume is never sampled beyond its zero padding. Each volume's
positive-voxel table keeps at most ``max_pos`` entries, a uniform
subsample drawn from ``np.random.default_rng(seed_pad)`` when there are
more. Masks must be binary (0 and one positive value); the constructor
raises otherwise.

The draws (:mod:`ich_tpu_torch.utils.rng`) follow the JAX package's key
tree: sample i takes ``split(key, B)[i]``, which splits into ``kv, kb, kp,
ku``: the volume ``randint(kv, (), 0, n)``, the branch ``bernoulli(kb,
pos_frac)``, the table entry ``randint(kp, (), 0, max(cnt, 1))`` and the
uniform start ``randint(ku, (3,), 0, lim + 1)``, whose bounds depend on the
drawn volume. They run on the host from host copies of the volumes'
extents and positive-voxel counts, all B samples at once, and reach the
device in one copy; the table lookup, the clip and the gather run there.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.utils import rng


def estimate_hbm_bytes(dataset, patch_size: Sequence[int], max_pos: int = 16384) -> int:
    """Bytes the sampler's device stack will take, from shapes alone, so a
    budget can be checked before any upload."""
    patch = tuple(int(p) for p in patch_size)
    dmax = [0, 0, 0]
    for v in dataset.volumes:
        for a, (s, p) in enumerate(zip(v.shape, patch)):
            dmax[a] = max(dmax[a], s, p)
    n = len(dataset.volumes)
    voxels = n * dmax[0] * dmax[1] * dmax[2]
    return voxels * 4 + voxels * 1 + n * max_pos * 3 * 4  # f32 + u8 + table


def is_binary_mask(m: np.ndarray) -> bool:
    """True if ``m`` holds 0 and at most one positive value (0/1, 0/255,
    ...), which binarises exactly as the host sampler's foreground test."""
    m = np.asarray(m)
    mmax = m.max() if m.size else 0
    return not mmax or bool(((m == 0) | (m == mmax)).all())


class DevicePatchSampler:
    """Batched 3D patch sampler over a device-resident volume stack;
    ``sampler(key, batch_size)`` -> (B, pd, ph, pw) float32 images and
    masks on ``device``."""

    def __init__(
        self,
        dataset,
        patch_size: Sequence[int],
        pos_frac: float = 0.5,
        max_pos: int = 16384,
        seed_pad: int = 0,
        device: str | torch.device = "cuda",
    ):
        patch = tuple(int(p) for p in patch_size)
        n = len(dataset.volumes)
        # per-volume extents after padding up to the patch size (host parity)
        dims = np.asarray(
            [[max(s, p) for s, p in zip(v.shape, patch)] for v in dataset.volumes],
            dtype=np.int32,
        )
        dmax = tuple(int(m) for m in dims.max(axis=0))

        vols = np.zeros((n,) + dmax, dtype=np.float32)
        msks = np.zeros((n,) + dmax, dtype=np.uint8)
        rng = np.random.default_rng(seed_pad)
        pos_tab = np.zeros((n, max_pos, 3), dtype=np.int32)
        pos_cnt = np.zeros((n,), dtype=np.int32)
        for i, (v, m) in enumerate(zip(dataset.volumes, dataset.masks)):
            d, h, w = v.shape
            vols[i, :d, :h, :w] = v
            m = np.asarray(m)
            if not is_binary_mask(m):
                raise ValueError(
                    "DevicePatchSampler requires binary masks (one positive "
                    "value); graded/multi-label masks must use the host "
                    "sampler (sample_patches)."
                )
            msks[i, :d, :h, :w] = (m > 0).astype(np.uint8)
            pos = np.stack(np.nonzero(msks[i]), axis=1).astype(np.int32)
            if len(pos) > max_pos:
                pos = pos[rng.choice(len(pos), max_pos, replace=False)]
            if len(pos):
                pos_cnt[i] = len(pos)
                pos_tab[i, : len(pos)] = pos

        dev = torch.device(device)
        self.patch = patch
        self.pos_frac = float(pos_frac)
        self.device = dev
        self.dims = torch.from_numpy(dims).to(dev)
        self._patch_dev = torch.as_tensor(patch, device=dev)
        # the draws' bounds, on the host
        self._dims_host = dims.astype(np.int64)
        self._cnt_host = pos_cnt.astype(np.int64)
        self.pos_tab = torch.from_numpy(pos_tab).to(dev)
        self.pos_cnt = torch.from_numpy(pos_cnt).to(dev)
        self.vols = torch.from_numpy(vols).to(dev)
        self.msks = torch.from_numpy(msks).to(dev)
        self.hbm_bytes = vols.nbytes + msks.nbytes + pos_tab.nbytes

    def draw(self, key, batch_size: int) -> torch.Tensor:
        """The batch's draws from ``key`` on the host, as one (B, 6) int64
        tensor: the volume index, the branch (1: centred on a positive
        voxel; 0 where the volume has none), the table entry and the three
        uniform starts."""
        kv, kb, kp, ku = rng.split(rng.split(key, batch_size), 4).unbind(-2)
        vi = rng.randint(kv, (), 0, len(self._dims_host))
        cnt = torch.from_numpy(self._cnt_host)[vi]
        use_pos = rng.bernoulli(kb, self.pos_frac, ()) & (cnt > 0)
        j = rng.randint(kp, (), 0, cnt.clamp(min=1))
        lim = torch.from_numpy(self._dims_host)[vi] - torch.as_tensor(self.patch)
        start_uni = rng.randint(ku, (3,), 0, lim + 1)
        return torch.cat([torch.stack([vi, use_pos.long(), j], 1), start_uni], 1)

    def starts(self, draws: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vi, start) on the device from :meth:`draw`'s (B, 6) draws: (B,)
        volume indices and (B, 3) int64 patch starts, the positive branch's
        start ``clip(centre - patch // 2, 0, lim)``."""
        draws = rng.to_device(draws, self.device)
        vi, use_pos, j = draws[:, 0], draws[:, 1].bool(), draws[:, 2]
        lim = self.dims[vi].long() - self._patch_dev
        center = self.pos_tab[vi, j].long()
        start_pos = torch.minimum((center - self._patch_dev // 2).clamp(min=0), lim)
        return vi, torch.where(use_pos[:, None], start_pos, draws[:, 3:])

    def gather(self, vi: torch.Tensor, start: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (B, pd, ph, pw) patches at ``start`` of volumes ``vi``: one
        advanced-index gather each for the images and the masks."""
        pd, ph, pw = self.patch
        b = vi.shape[0]
        ar = [torch.arange(p, device=self.device) for p in self.patch]
        idx = (vi.reshape(b, 1, 1, 1),
               (start[:, 0:1] + ar[0]).reshape(b, pd, 1, 1),
               (start[:, 1:2] + ar[1]).reshape(b, 1, ph, 1),
               (start[:, 2:3] + ar[2]).reshape(b, 1, 1, pw))
        return self.vols[idx], self.msks[idx].to(torch.float32)

    def __call__(self, key, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.gather(*self.starts(self.draw(key, int(batch_size))))
