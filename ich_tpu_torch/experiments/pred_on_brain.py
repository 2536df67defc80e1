"""Brain-only post-filter of a k-fold experiment's predictions (counterpart
of ``scripts/pred_on_brain.py``): every saved slice prediction ANDed with
its brain mask, the scores recomputed
(:func:`ich_tpu_torch.postprocessing.update_pred.update_kfold_folder`).
Brain masks are ``{vol}/{slice}.bmp`` under ``--brain-dir``, resized to
``--size`` as PIL's ``NEAREST`` resizes them; a slice without one keeps
its whole prediction. Run it as::

    python -m ich_tpu_torch.experiments.pred_on_brain --exp-dir EXP --data-dir DATA \\
        --brain-dir BRAIN [--n-fold 10] [--size 256]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ich_tpu_torch.data.bmp import read_bmp
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.postprocessing.update_pred import update_kfold_folder
from ich_tpu_torch.utils.logging import setup_logger


def resize_nearest_pil(img: np.ndarray, shape) -> np.ndarray:
    """``img`` (H, W) resized to ``shape`` (h, w) as PIL's
    ``Image.resize((w, h), Image.NEAREST)``: output pixel x takes source
    index ``floor((x + 0.5) * in / out)`` along each axis (which
    ``scipy.ndimage.zoom(order=0)`` does not)."""
    img = np.asarray(img)

    def index(n_in, n_out):
        return np.minimum(np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.int64),
                          n_in - 1)

    return img[index(img.shape[0], shape[0])[:, None], index(img.shape[1], shape[1])[None, :]]


def brain_masks_for(ds, brain_dir: str, size: int) -> np.ndarray:
    """(N, size, size) float32 brain masks of the dataset's rows; 1 where a
    slice has no mask file."""
    masks = np.ones((len(ds), size, size), np.float32)
    for i in range(len(ds)):
        fn = os.path.join(brain_dir, f"{int(ds.vol_ids[i])}/{int(ds.slice_nbrs[i])}.bmp")
        if os.path.exists(fn):
            masks[i] = resize_nearest_pil(read_bmp(fn), (size, size)) > 0
    return masks


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Post-filter k-fold predictions by brain masks.")
    ap.add_argument("--exp-dir", required=True)
    ap.add_argument("--data-dir", required=True, help="SegICH 2D dataset dir (the targets)")
    ap.add_argument("--brain-dir", required=True,
                    help="dir of brain-mask BMPs laid out as {vol}/{slice}.bmp")
    ap.add_argument("--n-fold", default=10, type=int)
    ap.add_argument("--size", default=256, type=int)
    args = ap.parse_args(argv)
    for d in (args.exp_dir, args.data_dir, args.brain_dir):
        if not os.path.isdir(d):
            ap.error(f"no such directory: {d}")
    setup_logger()
    ds = load_segich_2d(args.data_dir, size=args.size)
    brain = brain_masks_for(ds, args.brain_dir, args.size)
    update_kfold_folder(args.exp_dir, args.n_fold, lambda k: ds, lambda k: brain)
    print(f"Updated {args.exp_dir}")
    return args.exp_dir


if __name__ == "__main__":
    main()
