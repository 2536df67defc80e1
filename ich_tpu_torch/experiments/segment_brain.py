"""Whole-volume segmentation CLI (counterpart of ``scripts/segment_brain.py``):
a trained 2D U-Net (a port ``state_dict``, as ``UNet2D.save_model`` or
:mod:`ich_tpu_torch.experiments.brain_extraction` writes it) segments each
NIfTI volume with ``UNet2D.segment_volumes`` (volumes decoded one at a time,
a bounded number queued on the device) and writes ``<name>_mask.nii.gz``.
Run it as::

    python -m ich_tpu_torch.experiments.segment_brain VOL.nii [...] -o OUT_DIR -m MODEL.bin \\
        [--depth 5] [--top-filter 32] [--midchannels-factor 1] [--size 256] \\
        [--win-center 50] [--win-width 200] [--batch-size 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from ich_tpu_torch.data import nifti
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.utils.logging import setup_logger


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description="Segment NIfTI volumes with a trained 2D U-Net.")
    ap.add_argument("vol_paths", nargs="+")
    ap.add_argument("--output-dir", "-o", required=True)
    ap.add_argument("--model", "-m", dest="model_path", required=True)
    ap.add_argument("--depth", default=5, type=int)
    ap.add_argument("--top-filter", default=32, type=int)
    ap.add_argument("--midchannels-factor", default=1, type=int)
    ap.add_argument("--size", default=256, type=int, help="network input size")
    ap.add_argument("--win-center", default=50.0, type=float)
    ap.add_argument("--win-width", default=200.0, type=float)
    ap.add_argument("--batch-size", default=16, type=int)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    setup_logger()
    trainer = UNet2D(UNet(depth=args.depth, top_filter=args.top_filter,
                          midchannels_factor=args.midchannels_factor, p_dropout=0.0),
                     batch_size=args.batch_size, device=args.device)
    trainer.load_model(args.model_path, image_shape=(args.size, args.size))
    os.makedirs(args.output_dir, exist_ok=True)
    out_fns = []
    for vp in args.vol_paths:
        name = os.path.basename(vp).replace(".nii.gz", "").replace(".nii", "")
        out_fns.append(os.path.join(args.output_dir, f"{name}_mask.nii.gz"))
    affines = []

    def stream():  # lazy decode: host memory bounded by the queue depth
        for vp in args.vol_paths:
            vol, affine, _ = nifti.load(vp)
            affines.append(affine)
            yield vol

    trainer.segment_volumes(stream(), affines=affines, save_fns=out_fns,
                            window=(args.win_center, args.win_width),
                            input_size=(args.size, args.size))
    for vp, out_fn in zip(args.vol_paths, out_fns):
        print(f"{vp} -> {out_fn}")
    return out_fns


if __name__ == "__main__":
    main()
