"""Device-resident 3D patch sampling for patch training (counterpart of
:mod:`ich_tpu.data.patch_sampler`).

The whole dataset lives on the device, volumes zero-padded to a common
shape and stacked once, masks as uint8; each batch is one batched draw from
the step's ``torch.Generator`` and one batched gather, so the training loop
moves no patch bytes through the host. The semantics are the host
sampler's (:func:`ich_tpu_torch.train.segmentation3d.sample_patches`): with
probability ``pos_frac`` the patch is centred on a uniformly chosen
positive voxel of its volume (start clipped into bounds), else its start is
uniform; a volume's extent is its own padded up to the patch size, so a
short volume is never sampled beyond its zero padding. Each volume's
positive-voxel table keeps at most ``max_pos`` entries, a uniform
subsample drawn from ``np.random.default_rng(seed_pad)`` when there are
more. Masks must be binary (0 and one positive value); the constructor
raises otherwise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


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


# the uniform draws are int64 reduced modulo their bound: at bounds below
# 2^22 the modulo bias is below 2^-40
_DRAW_HIGH = 1 << 62


class DevicePatchSampler:
    """Batched 3D patch sampler over a device-resident volume stack;
    ``sampler(gen, batch_size)`` -> (B, pd, ph, pw) float32 images and
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
        self.pos_tab = torch.from_numpy(pos_tab).to(dev)
        self.pos_cnt = torch.from_numpy(pos_cnt).to(dev)
        self.vols = torch.from_numpy(vols).to(dev)
        self.msks = torch.from_numpy(msks).to(dev)
        self.hbm_bytes = vols.nbytes + msks.nbytes + pos_tab.nbytes

    def draw(self, gen: torch.Generator, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's raw draws, in this order: (B,) uniforms on [0, 1)
        for the positive-or-uniform branch, then (B, 5) int64 on [0, 2^62)
        for the volume, the table entry and the three uniform starts."""
        u = torch.rand(batch_size, generator=gen, device=self.device)
        r = torch.randint(0, _DRAW_HIGH, (batch_size, 5), generator=gen, device=self.device,
                          dtype=torch.int64)
        return u, r

    def starts(self, u: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vi, start) from the raw draws: (B,) volume indices and (B, 3)
        int64 patch starts."""
        n = self.vols.shape[0]
        vi = r[:, 0] % n
        lim = self.dims[vi].long() - torch.as_tensor(self.patch, device=self.device)
        cnt = self.pos_cnt[vi].long()
        use_pos = (u < self.pos_frac) & (cnt > 0)
        j = r[:, 1] % cnt.clamp(min=1)
        center = self.pos_tab[vi, j].long()
        half = torch.as_tensor([p // 2 for p in self.patch], device=self.device)
        start_pos = torch.minimum((center - half).clamp(min=0), lim)
        start_uni = r[:, 2:] % (lim + 1)  # exact integers in [0, lim]
        return vi, torch.where(use_pos[:, None], start_pos, start_uni)

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

    def __call__(self, gen: torch.Generator, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.gather(*self.starts(*self.draw(gen, int(batch_size))))
