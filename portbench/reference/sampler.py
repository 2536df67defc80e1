"""3D patch sampling worked out again: the positive-voxel tables, a
batch's draws from the step's key, the starts and the patches. A frozen
copy of the semantics of ``ich_tpu_torch/data/patch_sampler.py`` (the JAX
package's ``_sample_batch``): sample i takes ``split(key, B)[i]``, split
into ``kv, kb, kp, ku``: the volume, the branch (centred on a positive
voxel with probability ``pos_frac``), the table entry and the uniform
start."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import rng


class Tables:
    """The volumes' extents and positive-voxel tables; each table keeps at
    most ``max_pos`` entries, a subsample drawn from
    ``np.random.default_rng(0)`` as volumes come."""

    def __init__(self, masks, patch, max_pos: int = 16384):
        self.patch = np.asarray(patch, np.int64)
        self.dims = np.asarray([[max(s, p) for s, p in zip(m.shape, patch)] for m in masks],
                               np.int64)
        pick = np.random.default_rng(0)
        self.tabs, self.cnt = [], []
        for m in masks:
            pos = np.stack(np.nonzero(np.asarray(m) > 0), axis=1).astype(np.int64)
            if len(pos) > max_pos:
                pos = pos[pick.choice(len(pos), max_pos, replace=False)]
            self.tabs.append(pos)
            self.cnt.append(len(pos))
        self.cnt = np.asarray(self.cnt, np.int64)

    def starts(self, key: np.ndarray, batch: int, pos_frac: float):
        """(volume index (B,), start (B, 3)) of a batch drawn from ``key``."""
        ks = rng.split(rng.split(key, batch), 4)  # (B, 4, 2)
        kv, kb, kp, ku = (ks[:, i] for i in range(4))
        vi = rng.randint(kv, (), 0, len(self.dims))
        cnt = self.cnt[vi]
        use_pos = rng.bernoulli(kb, pos_frac, ()) & (cnt > 0)
        j = rng.randint(kp, (), 0, np.maximum(cnt, 1))
        lim = self.dims[vi] - self.patch
        uni = rng.randint(ku, (3,), 0, lim + 1)
        out = uni.copy()
        for b in range(batch):
            if use_pos[b]:
                c = self.tabs[vi[b]][j[b]]
                out[b] = np.minimum(np.maximum(c - self.patch // 2, 0), lim[b])
        return vi, out


def gather(volumes, masks, vi, starts, patch):
    """(B, pd, ph, pw) image and float mask patches of the (D, H, W)
    tensors, each volume read with its zero padding up to the patch."""
    imgs, msks = [], []
    for v, s in zip(vi, starts):
        sl = tuple(slice(int(a), int(a) + p) for a, p in zip(s, patch))
        pad = [max(0, int(a) + p - n) for a, p, n in zip(s, patch, volumes[v].shape)]
        im, mk = volumes[v][sl], masks[v][sl].float()
        if any(pad):
            widths = (0, pad[2], 0, pad[1], 0, pad[0])
            im, mk = (torch.nn.functional.pad(t, widths) for t in (im, mk))
        imgs.append(im)
        msks.append((mk > 0).float())
    return torch.stack(imgs), torch.stack(msks)
