"""Watch-folder inference server on PyTorch: segment NIfTI volumes as they
arrive (counterpart of ``scripts/serve.py``).

Polls ``--watch-dir`` for new ``.nii``/``.nii.gz`` files, runs pipelined
full-volume segmentation (``--mode 2.5d``: slice batches of a 2D U-Net;
``--mode 3d``: Gaussian-blended ``--patch``^3 sliding window of a GroupNorm
3D U-Net in bf16), writes ``<name>_mask.nii.gz`` to
``--output-dir`` and a ``<name>.done`` marker. Masks are written to a temp
name and renamed, and a volume is marked done only after its mask is on
disk, so a restarted server re-processes exactly the unfinished files. A
file that fails to decode ``MAX_RETRIES`` times is quarantined with a
``<name>.failed`` marker.

Examples::

    python -m ich_tpu_torch.serve --watch-dir /in --output-dir /out \\
        --model model.pt --size 256
    python -m ich_tpu_torch.serve --watch-dir /in -o /out -m model.pt --once
    python -m ich_tpu_torch.serve --watch-dir /in -o /out -m model3d.pt \\
        --mode 3d --depth 4 --top-filter 16 --patch 64

``--model`` is a ``state_dict`` written by ``UNet2D.save_model`` or
``UNet3D.save_model`` (or by ``scripts/jax_to_torch_model.py`` from a JAX
model).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("ich_tpu_torch.serve")

MAX_BATCH = 16  # volumes decoded per serve cycle (bounds host memory)
MAX_RETRIES = 3  # decode failures before a file is quarantined (.failed)


def _vol_name(fn: str) -> str:
    """Basename with ONLY the trailing .nii/.nii.gz stripped (a blanket
    str.replace would collapse e.g. a.nii and a.nii.gz — or scan.nii.bak —
    onto one done-marker and silently drop one of them)."""
    fn = os.path.basename(fn)
    for suf in (".nii.gz", ".nii"):
        if fn.endswith(suf):
            return fn[: -len(suf)]
    return fn


def _pending(watch_dir: str, output_dir: str, settle_s: float = 0.0):
    """Unprocessed volume paths (sorted for deterministic order). Files
    modified less than ``settle_s`` ago are skipped — an uploader may still
    be writing them. Our own ``*_mask.nii.gz`` outputs are excluded so
    watch_dir == output_dir does not re-ingest its results."""
    out = []
    seen = set()
    now = time.time()
    for fn in sorted(os.listdir(watch_dir)):
        if fn.startswith("."):
            continue  # our own .<name>_mask.tmp.* and other hidden files
        if not (fn.endswith(".nii") or fn.endswith(".nii.gz")):
            continue
        name = _vol_name(fn)
        if name.endswith("_mask"):
            continue
        if name in seen:
            # a.nii AND a.nii.gz share mask/done names: serve the first
            logger.error("skipping %s: name %r collides with another watch "
                         "file; rename one of them", fn, name)
            continue
        seen.add(name)
        if os.path.exists(os.path.join(output_dir, f"{name}.done")):
            continue
        if os.path.exists(os.path.join(output_dir, f"{name}.failed")):
            continue
        path = os.path.join(watch_dir, fn)
        try:
            if settle_s and now - os.path.getmtime(path) < settle_s:
                continue
        except OSError:
            continue  # raced with a delete
        out.append(path)
    return out


def _build_trainer(mode: str, model_path: str, depth: int, top_filter: int, patch: int,
                   device: str):
    import torch

    from ich_tpu_torch.models.unet import UNet

    if mode == "2.5d":
        from ich_tpu_torch.train.segmentation2d import UNet2D

        tr = UNet2D(UNet(depth=depth, top_filter=top_filter, p_dropout=0.0), device=device)
    else:
        from ich_tpu_torch.train.segmentation3d import UNet3D

        tr = UNet3D(UNet(depth=depth, ndim=3, top_filter=top_filter, p_dropout=0.0,
                         norm="group", dtype=torch.bfloat16),
                    patch_size=(patch,) * 3, device=device)
    tr.load_model(model_path)
    return tr


def _existing_path(p: str) -> str:
    if not os.path.exists(p):
        raise argparse.ArgumentTypeError(f"path {p!r} does not exist")
    return p


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ich_tpu_torch.serve",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--watch-dir", required=True, type=_existing_path)
    p.add_argument("--output-dir", "-o", required=True)
    p.add_argument("--model", "-m", dest="model_path", required=True, type=_existing_path)
    p.add_argument("--mode", choices=["2.5d", "3d"], default="2.5d")
    p.add_argument("--depth", default=5, type=int)
    p.add_argument("--top-filter", default=32, type=int)
    p.add_argument("--size", default=256, type=int, help="2.5d network input size")
    p.add_argument("--patch", default=64, type=int, help="3d sliding-window patch")
    p.add_argument("--win-center", default=50.0, type=float)
    p.add_argument("--win-width", default=200.0, type=float)
    p.add_argument("--poll-s", default=2.0, type=float)
    p.add_argument("--once", action="store_true", help="drain the current backlog and exit")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _record_decode_failure(output_dir: str, name: str, path: str, err: Exception) -> None:
    """Persist the retry count (so quarantine survives restarts); after
    MAX_RETRIES failures write the .failed marker."""
    retry_fn = os.path.join(output_dir, f"{name}.retries")
    try:
        with open(retry_fn) as f:
            n_fail = int(f.read().strip()) + 1
    except (OSError, ValueError):
        n_fail = 1
    with open(retry_fn, "w") as f:
        f.write(str(n_fail))
    logger.warning("decode failed (%d/%d) for %s: %s", n_fail, MAX_RETRIES, path, err)
    if n_fail >= MAX_RETRIES:
        with open(os.path.join(output_dir, f"{name}.failed"), "w") as f:
            f.write(f"{type(err).__name__}: {err}\n")
        os.remove(retry_fn)
        logger.error("quarantined %s (.failed marker)", path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from ich_tpu_torch.data import nifti

    os.makedirs(args.output_dir, exist_ok=True)
    trainer = _build_trainer(args.mode, args.model_path, args.depth, args.top_filter,
                             args.patch, args.device)
    out_dir = args.output_dir
    logger.info("serving %s -> %s (%s on %s)", args.watch_dir, out_dir, args.mode,
                trainer.device)

    while True:
        batch = _pending(args.watch_dir, out_dir,
                         settle_s=0.0 if args.once else min(args.poll_s, 2.0))[:MAX_BATCH]
        if not batch:
            if args.once:
                break
            time.sleep(args.poll_s)
            continue

        # decode up front with per-file isolation: one torn or corrupt upload
        # must not take down the server or wedge the queue
        names, vols, affines = [], [], []
        for vp in batch:
            name = _vol_name(vp)
            try:
                vol, affine, _ = nifti.load(vp)  # NIfTI layout: (H, W, D)
            except Exception as e:  # any decode error: count it, keep serving
                _record_decode_failure(out_dir, name, vp, e)
                continue
            retry_fn = os.path.join(out_dir, f"{name}.retries")
            if os.path.exists(retry_fn):
                os.remove(retry_fn)
            names.append(name)
            affines.append(affine)
            # the 3D path takes (D, H, W), the loader's layout; 2.5D (H, W, D)
            vols.append(np.transpose(vol, (2, 0, 1)) if args.mode == "3d" else vol)
        if not names:
            if args.once:
                break
            time.sleep(args.poll_s)
            continue
        tmp_fns = [os.path.join(out_dir, f".{n}_mask.tmp.nii.gz") for n in names]

        t0 = time.time()
        window = (args.win_center, args.win_width)
        if args.mode == "3d":
            preds = trainer.segment_volumes(iter(vols), window=window, return_preds=True)
            for pred, affine, tmp in zip(preds, affines, tmp_fns):
                nifti.save(tmp, np.transpose(pred, (1, 2, 0)), affine)
        else:
            trainer.segment_volumes(iter(vols), affines=affines, save_fns=tmp_fns,
                                    window=window, input_size=(args.size, args.size))
        for name, tmp in zip(names, tmp_fns):
            final = os.path.join(out_dir, f"{name}_mask.nii.gz")
            os.replace(tmp, final)
            # done-marker AFTER the mask rename: a crash in between re-runs
            # the volume, never hands off a missing mask
            with open(os.path.join(out_dir, f"{name}.done"), "w") as f:
                f.write(final + "\n")
            print(f"{name} -> {final}")
        logger.info("served %d volume(s) in %.1fs", len(names), time.time() - t0)
        if args.once and not _pending(args.watch_dir, out_dir):
            break


if __name__ == "__main__":
    main()
