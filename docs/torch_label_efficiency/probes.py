"""Probes of the label-efficiency study: where the port's Dice comes from
when two machines or two versions of the port disagree (the low-label
scratch arm; the CR arm under the keyed dropout). A record
of how the probe numbers beside these snapshots were measured, kept with
them; not a module of ``ich_tpu_torch``. Run from the repo's root; each
subcommand prints one ``PROBE`` JSON line per result::

    python docs/torch_label_efficiency/probes.py sweep OUT \\
        --seeds 42,43 [--arms scratch,pretrained] [--fractions 0.1,0.25] \\
        [--device cuda] [--no-tf32] [--no-cudnn] [--inits DIR] \\
        [--dropout-fold N | --torch-dropout]
    python docs/torch_label_efficiency/probes.py save-inits DIR
    python docs/torch_label_efficiency/probes.py digests
    python docs/torch_label_efficiency/probes.py evaluate OUT --seed 43 [--cpu]
    python docs/torch_label_efficiency/probes.py masks

- ``sweep``: the study's arms (scratch) at its fractions (10% labels) for
  each seed on ``--device`` (the card by default), with cuDNN's TF32 or
  cuDNN itself off, or with every U-Net's initial net read from
  ``DIR/init<seed>.pt`` (the nets another torch drew: fold k of seed s
  starts from ``s + k``, the CR pretraining of seed s from ``s``), or
  with another dropout stream: ``--dropout-fold N`` folds ``N`` into
  every step's dropout key (another stream of XLA's Philox masks, drawn
  as the study draws them), ``--torch-dropout`` draws every mask with
  ``F.dropout`` from torch's generator, seeded with the seed (the kind of
  masks the port drew before its dropout was keyed);
- ``save-inits``: the initial nets this torch draws (on the host, as the
  study does) for the fine-tune seeds of seeds 42-49 (fold ``k`` of seed
  ``s`` starts from seed ``s + k``: 42-53);
- ``digests``: the library versions and SHA-256 digests of the study's
  data, folds, kept patients, one augmented batch, one dropout mask and
  one initial net, drawn on the host, to hold two machines against each
  other;
- ``evaluate``: each fold's trained net of an ``OUT`` sweep evaluated on
  the card, and also on the CPU with ``--cpu``;
- ``masks``: the keyed masks of each Dropout of the study's U-Net over
  three fine-tune steps of seed 42 at batch 16 of 64², drawn on the host
  by the plain version: the share they keep and the correlation between
  two samples, two steps, two channels and two neighbours along W and H.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from ich_tpu_torch.experiments import label_efficiency_study as S  # noqa: E402
from ich_tpu_torch.experiments import pretrain_finetune, supervised2d  # noqa: E402
from ich_tpu_torch.models.layers import Dropout  # noqa: E402
from ich_tpu_torch.train.segmentation2d import UNet2D  # noqa: E402
from ich_tpu_torch.utils import rng as prng  # noqa: E402

SEEDS = tuple(range(42, 50))
NET = S.base_cfg("", "scratch")["net"]


def _probe(**kw) -> None:
    print("PROBE", json.dumps(kw, sort_keys=True), flush=True)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _dropout_stream(fold: int, torch_dropout: bool):
    """Swap the study's dropout stream (see ``sweep``); returns the undo."""
    import torch.nn.functional as F

    from ich_tpu_torch.models import layers

    undo = []
    if fold:
        set_keys = layers.set_dropout_keys

        def folded(net, key, mesh=None):
            set_keys(net, None if key is None else prng.fold_in(key, fold), mesh)

        for m in list(sys.modules.values()):
            if (getattr(m, "__name__", "").startswith("ich_tpu_torch.train.")
                    and getattr(m, "set_dropout_keys", None) is set_keys):
                m.set_dropout_keys = folded
                undo.append(lambda m=m: setattr(m, "set_dropout_keys", set_keys))
    if torch_dropout:
        forward = Dropout.forward
        Dropout.forward = lambda self, x: F.dropout(x, self.p, self.training)
        undo.append(lambda: setattr(Dropout, "forward", forward))
    return lambda: [u() for u in undo]


def sweep(out: str, seeds: Sequence[int], device: str, inits: Optional[str] = None,
          arms: Sequence[str] = ("scratch",), fractions: Sequence[float] = (0.1,),
          dropout_fold: int = 0, torch_dropout: bool = False) -> None:
    build = supervised2d.build_unet_from_cfg

    def injected(cfg, norm="batch", seed=0):
        net = build(cfg, norm, seed)
        net.load_state_dict(torch.load(os.path.join(inits, f"init{seed}.pt")))
        return net

    # the k-fold driver and the CR pretraining build their U-Nets through
    # these names
    modules = (supervised2d, pretrain_finetune)
    if inits:
        for m in modules:
            m.build_unet_from_cfg = injected
    undo = _dropout_stream(dropout_fold, torch_dropout)
    try:
        for seed in seeds:
            torch.manual_seed(seed)
            res = S.main(os.path.join(out, f"seed{seed}"), seed=seed, arms=tuple(arms),
                         fractions=tuple(fractions), device=device)
            _probe(seed=seed, device=device, cudnn=torch.backends.cudnn.enabled,
                   cudnn_tf32=torch.backends.cudnn.allow_tf32, inits=inits,
                   dropout_fold=dropout_fold, torch_dropout=torch_dropout,
                   dice=res["scratch"]["0.1"] if list(arms) == ["scratch"] else res)
    finally:
        undo()
        for m in modules:
            m.build_unet_from_cfg = build


def save_inits(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for seed in range(SEEDS[0], SEEDS[-1] + S.N_FOLDS):
        torch.save(supervised2d.build_unet_from_cfg(NET, seed=seed).state_dict(),
                   os.path.join(out, f"init{seed}.pt"))
    _probe(saved=out, torch=torch.__version__)


def digests() -> None:
    import scipy

    lab, unl = S.make_datasets()
    by_fold = S.folds_fn(lab)
    kept = {f"{s}/{k}/{f}": supervised2d.subsample_label_fraction(
                np.unique(by_fold(k)[0].vol_ids), f, np.random.default_rng(s + k)).tolist()
            for s in SEEDS for k in range(S.N_FOLDS) for f in (0.1, 0.25, 0.5)}
    key = prng.prng_key(123456789)
    aug = supervised2d.build_augment_fn(S.base_cfg("", "scratch")["data"]["augmentation"]["train"])
    x, y = torch.from_numpy(lab.images[:16])[..., None], torch.from_numpy(lab.masks[:16])[..., None]
    xa, ya = aug(key, x, y)
    drop = Dropout(0.1).train()
    drop.key = tuple(int(w) & 0xFFFFFFFF for w in key.tolist())
    net = supervised2d.build_unet_from_cfg(NET, seed=43)
    w = net.state_dict()["down_block.0.conv1.weight"]
    _probe(numpy=np.__version__, torch=torch.__version__, scipy=scipy.__version__,
           labeled=_digest(lab.images, lab.masks, lab.vol_ids),
           unlabeled=_digest(unl.images, unl.masks, unl.vol_ids),
           test_patients=_digest(*[np.unique(by_fold(k)[1].vol_ids) for k in range(S.N_FOLDS)]),
           kept_patients=_digest(np.frombuffer(json.dumps(kept, sort_keys=True).encode(),
                                               np.uint8)),
           augmented_batch=_digest(xa, ya), dropout_mask=_digest(drop(torch.ones(16, 16, 64, 64))),
           init_net_seed43=_digest(*net.state_dict().values()),
           init_conv1_std=float(w.std()))


def evaluate(out: str, seed: int, devices: Sequence[str] = ("cuda",)) -> None:
    by_fold = S.folds_fn(S.make_datasets()[0])
    with open(os.path.join(out, f"seed{seed}", "results.json")) as f:
        recorded = json.load(f)["scratch"]["0.1"]
    for k in range(S.N_FOLDS):
        fold = os.path.join(out, f"seed{seed}", "scratch_frac10", f"Fold_{k + 1}")
        dice = {}
        for dev in devices:
            t = UNet2D(supervised2d.build_unet_from_cfg(NET), device=dev)
            t.load_model(os.path.join(fold, "trained_unet.bin"))
            t.evaluate(by_fold(k)[1], print_to_logger=False)
            dice[dev] = t.outputs["eval"]["dice"]["positive"]
        _probe(seed=seed, fold=k + 1, recorded=recorded[k], **dice)


def masks(seed: int = 42, steps: int = 3, batch: int = 16) -> None:
    from ich_tpu_torch.models.layers import set_dropout_keys
    from ich_tpu_torch.ops.dropout import keyed_dropout_plain

    net = supervised2d.build_unet_from_cfg(NET, seed=seed)
    drops = [(n, m) for n, m in net.named_modules() if isinstance(m, Dropout)]
    side, drawn = S.SIZE, {n: [] for n, _ in drops}
    for step in range(steps):
        key = prng.split(prng.fold_in(prng.fold_in(prng.prng_key(seed), 0), step))[1]
        set_dropout_keys(net, key)
        for i, (n, m) in enumerate(drops):
            shape = (batch, NET["top_filter"] << i, side >> i, side >> i)
            drawn[n].append(keyed_dropout_plain(torch.ones(shape), (*m.key, m.fold), m.p) != 0)

    def corr(a, b):
        return float(np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1])

    for n, ms in drawn.items():
        m = ms[0]
        _probe(dropout=n, shape=list(m.shape), keep=float(torch.stack(ms).float().mean()),
               samples=corr(m[0], m[1]), steps=corr(ms[0], ms[1]), channels=corr(m[:, 0], m[:, 1]),
               w=corr(m[..., :-1], m[..., 1:]), h=corr(m[..., :-1, :], m[..., 1:, :]))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Probes of the label-efficiency study.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sweep")
    p.add_argument("out")
    p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    p.add_argument("--arms", default="scratch")
    p.add_argument("--fractions", default="0.1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-tf32", action="store_true", help="cuDNN's TF32 off")
    p.add_argument("--no-cudnn", action="store_true", help="PyTorch's own CUDA convolutions")
    p.add_argument("--inits", help="dir of init<seed>.pt nets (save-inits)")
    p.add_argument("--dropout-fold", type=int, default=0,
                   help="fold N into every step's dropout key (another Philox stream)")
    p.add_argument("--torch-dropout", action="store_true",
                   help="F.dropout from torch's generator, seeded with the seed")
    sub.add_parser("save-inits").add_argument("out")
    sub.add_parser("digests")
    p = sub.add_parser("evaluate")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--cpu", action="store_true", help="evaluate on the CPU too")
    sub.add_parser("masks")
    args = ap.parse_args(argv)
    if args.cmd == "sweep":
        torch.backends.cudnn.allow_tf32 = not args.no_tf32
        torch.backends.cudnn.enabled = not args.no_cudnn
        sweep(args.out, [int(s) for s in args.seeds.split(",")], args.device, args.inits,
              args.arms.split(","), [float(f) for f in args.fractions.split(",")],
              args.dropout_fold, args.torch_dropout)
    elif args.cmd == "save-inits":
        save_inits(args.out)
    elif args.cmd == "digests":
        digests()
    elif args.cmd == "masks":
        masks()
    else:
        evaluate(args.out, args.seed, ("cuda", "cpu") if args.cpu else ("cuda",))


if __name__ == "__main__":
    main()
