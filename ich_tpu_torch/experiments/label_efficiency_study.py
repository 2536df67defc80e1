"""The paired label-efficiency study: scratch against context-restoration,
global contrastive and local(+global) contrastive pretraining at
10/25/50/100% labels, 5-fold CV, several training seeds (counterpart of
``benchmarks/label_efficiency_bench.py``; its constants, configs, views,
splits and report are copied from there).

The synthetic task is hard at low labels: low-contrast lesions (intensity
0.48 against tissue 0.35) over smooth per-patient texture, structure that
context restoration learns from the unlabelled slices. All arms share the
folds and the training seed, so the per-(fold, fraction) Dice deltas are
paired; beside the fold-aggregate mean ± 1.96σ the report gives the 95%
CI of the mean paired delta and a Wilcoxon signed-rank p.

One seed of the arms, on the card::

    python -m ich_tpu_torch.experiments.label_efficiency_study --out DIR/seed42 \\
        --seed 42 --arms scratch,pretrained,contrastive,contrastive_local [--device cuda]

``--rescue`` runs the 10%-labels rescue probe instead: fraction 0.1 only,
a quarter of the negative slices kept and 80 fine-tune epochs.
``--report-only`` pools every ``DIR/*/results.json`` into one table;
``--snapshots REFERENCE_DIR`` writes ``table.md`` and ``comparison.md``
for a directory of per-seed snapshots (``seedNN.json``,
``rescue_seedNN.json``, and the runs' ``provenance.json``) against the JAX
package's (``REFERENCE_DIR/label_efficiency_seedNN.json``).

Writes ``results.json``, ``provenance.json`` (per arm: the torch and CUDA
versions, the device's name, the TF32 modes it ran in and the draw
scheme), a markdown table and, where matplotlib is installed, the curve
figure.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ich_tpu_torch.data.synthetic import synthetic_ich_slices
from ich_tpu_torch.experiments.pretrain_finetune import (
    label_efficiency_sweep,
    pretrain_context_restoration,
    pretrain_contrastive,
)
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.train.segmentation2d import resolve_device
from ich_tpu_torch.utils.logging import setup_logger

FRACTIONS = (0.1, 0.25, 0.5, 1.0)
N_FOLDS = 5
N_PATIENTS = 20
SLICES_PER_PATIENT = 8
SIZE = 64
HARD = dict(lesion_intensity=0.48, lesion_noise=0.06, texture_amp=0.12)
# the study's scale; ``main(scale=...)`` overrides entries for the smoke
# run and the CPU tests only
SCALE = {"n_folds": N_FOLDS, "n_epoch": 40, "pretrain_epochs": 30, "size": SIZE}
RESCUE = {"frac_negative": 0.25, "epoch_mult": 2}


def make_datasets(seed: int = 7, size: int = SIZE):
    """The labelled (20 patients x 8 slices) and unlabelled (768 slices)
    sets, the JAX study's arrays for the same seed."""
    labeled = synthetic_ich_slices(
        n_slices=N_PATIENTS * SLICES_PER_PATIENT, size=size,
        n_volumes=N_PATIENTS, seed=seed, positive_frac=0.7, **HARD,
    )
    unlabeled = synthetic_ich_slices(
        n_slices=768, size=size, n_volumes=96, seed=seed + 1,
        positive_frac=0.5, **HARD,
    )
    return labeled, unlabeled


def folds_fn(labeled, n_folds: int = N_FOLDS):
    """Patient-level k-fold splits shared by every arm and seed."""
    patients = np.unique(labeled.vol_ids)
    rng = np.random.default_rng(123)
    perm = rng.permutation(patients)
    chunks = np.array_split(perm, n_folds)

    def by_fold(k):
        test_p = chunks[k]
        test_idx = np.nonzero(np.isin(labeled.vol_ids, test_p))[0]
        train_idx = np.nonzero(~np.isin(labeled.vol_ids, test_p))[0]
        return labeled.subset(train_idx), labeled.subset(test_idx)

    return by_fold


def base_cfg(out_root: str, name: str) -> dict:
    return {
        "exp_name": name,
        "seed": 42,
        "path": {"OUTPUT": out_root, "DATA": ""},
        "split": {"n_fold": N_FOLDS},
        "data": {"win_center": 50, "win_width": 200, "size": SIZE,
                 "augmentation": {"train": {
                     "Translate": {"low": -0.1, "high": 0.1},
                     "Rotate": {"low": -10, "high": 10},
                     "HFlip": {"p": 0.5},
                 }}},
        "net": {"depth": 4, "top_filter": 16, "midchannels_factor": 1,
                "p_dropout": 0.1, "norm": "batch"},
        "train": {"n_epoch": 40, "batch_size": 16, "lr": 1e-3,
                  "lr_scheduler": "ExponentialLR",
                  "lr_scheduler_kwargs": {"gamma": 0.95},
                  "loss_fn": "BinaryDiceLoss",
                  "loss_fn_kwargs": {"alpha": 0.2, "reduction": "mean"}},
    }


def collect_dice(exp_dir: str, n_folds: int = N_FOLDS) -> np.ndarray:
    vals = []
    for k in range(n_folds):
        with open(os.path.join(exp_dir, f"Fold_{k + 1}", "outputs.json")) as f:
            out = json.load(f)
        vals.append(float(out["eval"]["dice"]["positive"]))
    return np.asarray(vals)


def _pretrain_cr(out_root, seed, unlabeled, device="cuda", n_epoch=30):
    pre_cfg = base_cfg(out_root, "cr_pretrain")
    pre_cfg["seed"] = seed
    pre_cfg["train"] = {**pre_cfg["train"], "n_epoch": n_epoch, "batch_size": 32}
    pre_cfg["corruption"] = {"n_swap": 10, "swap_w": (6, 14), "swap_h": (6, 14),
                             "rotate": True}
    return pretrain_context_restoration(pre_cfg, unlabeled, device=device)


def _contrastive_cfg(out_root, seed, name, n_epoch=30):
    pre_cfg = base_cfg(out_root, name)
    pre_cfg["seed"] = seed
    pre_cfg["net"] = {**pre_cfg["net"], "MLP_head": (256, 128)}
    pre_cfg["train"] = {**pre_cfg["train"], "n_epoch": n_epoch, "batch_size": 32}
    return pre_cfg


def _global_views():
    # Crop + flip + blur views: brightness/contrast jitter is an NT-Xent
    # collapse attractor at this toy scale (the embeddings collapse and the
    # loss pins at ln(2B - 1)); geometric views escape it.
    return T.Compose(T.RandomCropResize((0.4, 0.8)), T.HFlip(0.5),
                     T.GaussianBlur(0.5, (0.1, 2.0)))


def _pretrain_contrastive(out_root, seed, unlabeled, device="cuda", n_epoch=30):
    pre_cfg = _contrastive_cfg(out_root, seed, "contrastive_pretrain", n_epoch)
    return pretrain_contrastive(pre_cfg, unlabeled, aug_pipeline=_global_views(),
                                device=device)


def _pretrain_contrastive_local(out_root, seed, unlabeled, device="cuda", n_epoch=30):
    """Global NT-Xent, then the local phase (Chaitanya 2020: the partial
    U-Net with the transferred encoder frozen, region NT-Xent on the
    partial decoder's maps), scaled to the study's net: depth 4 gives
    n_decoder 2, one stage short of the full decoder as in the reference's
    local config, and head (64, 32). The global phase's config is the
    ``contrastive`` arm's, so at one seed the two arms share global weights
    and the comparison isolates the local phase."""
    pre_cfg = _contrastive_cfg(out_root, seed, "contrastive_local_pretrain", n_epoch)
    pre_cfg["local"] = {"n_decoder": 2, "head_channel": (64, 32), "K": 3,
                        "n_region": 13, "n_epoch": n_epoch, "batch_size": 32,
                        "freeze": True}
    # the reference's milder local views (crop 0.7-1.0 and blur) without
    # its contrast jitter (the collapse attractor of _global_views)
    local_views = T.Compose(T.RandomCropResize((0.7, 1.0)),
                            T.GaussianBlur(0.5, (0.1, 1.5)))
    return pretrain_contrastive(pre_cfg, unlabeled, aug_pipeline=_global_views(),
                                local_aug_pipeline=local_views, device=device)


PRETRAINERS = {"pretrained": _pretrain_cr, "contrastive": _pretrain_contrastive,
               "contrastive_local": _pretrain_contrastive_local}
# where each pretrainer's phases write their outputs.json, under out_root
PRETRAIN_PHASES = {"pretrained": ("cr_pretrain/pretrain",),
                   "contrastive": ("contrastive_pretrain/pretrain_global",),
                   "contrastive_local": ("contrastive_local_pretrain/pretrain_global",
                                         "contrastive_local_pretrain/pretrain_local")}


def subsample_negative_slices(ds, frac_negative, rng):
    """Keep every ICH-positive slice and a ``frac_negative`` share of the
    negative ones (the reference's ``UNet2D_scripts.py:121-123``)."""
    pos = np.asarray(ds.masks).reshape(len(ds), -1).sum(axis=1) > 0
    neg_idx = np.nonzero(~pos)[0]
    keep_neg = rng.choice(neg_idx, int(round(frac_negative * len(neg_idx))),
                          replace=False)
    idx = np.sort(np.concatenate([np.nonzero(pos)[0], keep_neg]))
    return ds.subset(idx)


def _last_losses(out_root: str, arm: str) -> Dict[str, float]:
    """The last epoch's mean loss of each of ``arm``'s pretraining phases."""
    losses = {}
    for phase in PRETRAIN_PHASES.get(arm, ()):
        with open(os.path.join(out_root, phase, "outputs.json")) as f:
            losses[os.path.basename(phase)] = json.load(f)["train"]["evolution"][-1][1]
    return losses


# the random streams of a run: initial nets, augmentation, corruption, views
# and region cells are jax.random's threefry draws (utils/rng.py), dropout
# XLA's Philox stream under flax's rbg keys (ops/dropout.py)
DRAWS = "threefry2x32, jax.random 0.9.0 partitionable; dropout rbg philox4x32-10"


def _provenance(dev: torch.device) -> dict:
    """What a run's Dice depends on beyond the study's code: torch, CUDA,
    the device, the TF32 modes and the draw scheme."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "draws": DRAWS}


def main(out_root: str, seed: int = 42,
         arms: Sequence[str] = ("scratch", "pretrained", "contrastive"),
         fractions: Sequence[float] = FRACTIONS, rescue: bool = False,
         device: str | torch.device = "cuda", scale: Optional[dict] = None) -> dict:
    """One multi-arm sweep at training seed ``seed``; returns the results
    ({arm: {fraction: [Dice per fold]}}). The fold splits are fixed, so
    every arm and seed sees the same splits and the per-(fold, seed) deltas
    are paired; fold k of seed s draws its initial net, shuffles,
    augmentation, dropout and kept patients from seed s + k (so seeds s and
    s + 1 share four of their five streams). Run several seeds and pool
    them with ``pooled_report``.

    ``rescue``: the 10%-labels rescue recipe (a quarter of the negative
    slices, twice the fine-tune epochs) at fraction 0.1 only."""
    dev = resolve_device(device)
    sc = {**SCALE, **(scale or {})}
    os.makedirs(out_root, exist_ok=True)
    labeled, unlabeled = make_datasets(size=sc["size"])
    by_fold = folds_fn(labeled, sc["n_folds"])
    if rescue:
        fractions = (0.1,)
        inner = by_fold

        def by_fold(k):  # the same splits, the negatives subsampled
            tr, te = inner(k)
            rng = np.random.default_rng(1000 * seed + k)
            return subsample_negative_slices(tr, RESCUE["frac_negative"], rng), te

    # Arms merge into an existing results.json: the splits ignore the
    # training seed and each arm's Dice depends only on (arm, seed, fold),
    # so an arm run later pairs with the arms already measured at the seed.
    # provenance.json merges alike, so that arms run under another torch or
    # on another device can be told apart.
    res_path = os.path.join(out_root, "results.json")
    prov_path = os.path.join(out_root, "provenance.json")
    results, provenance = {}, {}
    if os.path.exists(res_path):
        with open(res_path) as f:
            results = json.load(f)
        print(f"merging new arms into existing {res_path} (has: {sorted(results)})")
    if os.path.exists(prov_path):
        with open(prov_path) as f:
            provenance = json.load(f)
    for arm in arms:
        t0 = time.perf_counter()
        init = None
        if arm != "scratch":
            init = PRETRAINERS[arm](out_root, seed, unlabeled, device=dev,
                                    n_epoch=sc["pretrain_epochs"])
        t1 = time.perf_counter()
        cfg = base_cfg(out_root, arm)
        cfg["seed"] = seed
        cfg["split"] = {"n_fold": sc["n_folds"]}
        cfg["train"] = {**cfg["train"], "n_epoch": sc["n_epoch"] * (
            RESCUE["epoch_mult"] if rescue else 1)}
        dirs = label_efficiency_sweep(cfg, init, by_fold, fractions=fractions, seed=seed,
                                      device=dev)
        results[arm] = {str(frac): collect_dice(d, sc["n_folds"]).tolist()
                        for frac, d in dirs.items()}
        provenance[arm] = _provenance(dev)
        with open(res_path, "w") as f:  # checkpoint after every arm
            json.dump(results, f, indent=1)
        with open(prov_path, "w") as f:
            json.dump(provenance, f, indent=1)
        print(json.dumps({"arm": arm, "seed": seed, "rescue": rescue, **provenance[arm],
                          "pretrain_s": t1 - t0, "finetune_s": time.perf_counter() - t1,
                          "last_pretrain_loss": _last_losses(out_root, arm)}))
    report(results, out_root)
    return results


ARM_LABELS = {"scratch": "scratch", "pretrained": "CR-pretrained",
              "contrastive": "contrastive", "contrastive_local": "contrastive+local"}
ARMS = tuple(ARM_LABELS)


def _run_files(parent_dir: str, prefix: Optional[str] = None) -> List[str]:
    """The per-seed results under ``parent_dir``. With ``prefix``, the
    committed snapshots only (``label_efficiency_<prefix>NN.json`` of the
    JAX package, ``<prefix>NN.json`` of the port). Without, as the JAX
    study pools: one ``*/results.json`` per seed dir, else the JAX
    package's snapshots, else ``results.json`` itself."""
    if prefix:
        patterns = (f"label_efficiency_{prefix}*.json", f"{prefix}*.json")
    else:
        patterns = ("*/results.json", "label_efficiency_seed*.json")
    for pattern in patterns:
        files = sorted(glob.glob(os.path.join(parent_dir, pattern)))
        if files:
            return files
    return [] if prefix else [os.path.join(parent_dir, "results.json")]


def _load_runs(parent_dir: str, prefix: Optional[str] = None) -> tuple:
    """(pooled {arm: {fraction: values}}, per-seed results, their files)."""
    pooled, per_seed = {}, []
    files = _run_files(parent_dir, prefix)
    for fn in files:
        with open(fn) as f:
            res = json.load(f)
        per_seed.append(res)
        for arm, by_frac in res.items():
            for frac, vals in by_frac.items():
                pooled.setdefault(arm, {}).setdefault(frac, []).extend(vals)
    return pooled, per_seed, files


def pooled_report(parent_dir: str, out_root: Optional[str] = None,
                  prefix: Optional[str] = None) -> dict:
    """Pool the per-(fold, seed) results of every run under ``parent_dir``
    (or of its ``prefix`` snapshots) into one paired table. Two-arm seed
    runs pool next to three-arm ones: each arm's paired deltas use only the
    seeds where that arm and scratch both ran."""
    pooled, per_seed, files = _load_runs(parent_dir, prefix)
    print(f"pooled {len(files)} runs")
    report(pooled, out_root or parent_dir, per_seed=per_seed)
    return pooled


def _paired(per_seed, arm, frac):
    """Paired (scratch, arm) value arrays over the seeds that ran both."""
    s, p = [], []
    for res in per_seed:
        if (arm in res and frac in res.get(arm, {})
                and frac in res.get("scratch", {})):
            s.extend(res["scratch"][frac])
            p.extend(res[arm][frac])
    return np.asarray(s), np.asarray(p)


def _wilcoxon_p(d: np.ndarray) -> float:
    """The paired Wilcoxon signed-rank p, NaN for 4 deltas or fewer, for
    all-zero deltas and where scipy refuses the input."""
    try:
        from scipy.stats import wilcoxon

        return wilcoxon(d).pvalue if len(d) > 4 and np.any(d != 0) else np.nan
    except (ImportError, ValueError):
        return np.nan


def report(results, out_root, per_seed=None) -> str:
    """The markdown table (written to ``label_efficiency_table.md``) and,
    where matplotlib is installed, the curve figure; returns the table."""
    arms = [a for a in ARMS if a in results]
    pre_arms = [a for a in arms if a != "scratch"]
    if per_seed is None:
        per_seed = [results]
    head = "| labels | scratch (±1.96σ) |"
    sep = "|---|---|"
    for a in pre_arms:
        head += f" {ARM_LABELS[a]} (±1.96σ) | paired Δ [95% CI] |"
        sep += "---|---|"
    lines = [head, sep]
    for frac in FRACTIONS:
        if str(frac) not in results["scratch"]:
            continue
        s = np.asarray(results["scratch"][str(frac)])
        row = f"| {int(frac * 100)}% | {s.mean():.3f} ± {1.96 * s.std(ddof=1):.3f} |"
        for a in pre_arms:
            if str(frac) not in results[a]:
                # an arm measured on another fraction grid (a rescue-only
                # arm pooled next to the full sweep)
                row += " — | — |"
                continue
            p = np.asarray(results[a][str(frac)])
            sp, pp = _paired(per_seed, a, str(frac))
            d = pp - sp
            ci = 1.96 * d.std(ddof=1) / np.sqrt(len(d)) if len(d) > 1 else np.nan
            row += (f" {p.mean():.3f} ± {1.96 * p.std(ddof=1):.3f} "
                    f"| {d.mean():+.3f} [{d.mean() - ci:+.3f}, {d.mean() + ci:+.3f}]"
                    f" (n={len(d)}, p={_wilcoxon_p(d):.3g}) |")
        lines.append(row)
    table = "\n".join(lines)
    print(table)
    with open(os.path.join(out_root, "label_efficiency_table.md"), "w") as f:
        f.write(table + "\n")
    _figure(results, arms, out_root)
    return table


def _figure(results, arms, out_root) -> None:
    try:
        from ich_tpu_torch.postprocessing.plots import curve_std, pyplot

        plt = pyplot()
    except ImportError as e:
        print(f"figure skipped: {e}")
        return
    fracs = [f for f in FRACTIONS if str(f) in results["scratch"]]
    fig, ax = plt.subplots(figsize=(5, 4))
    xs = np.asarray(fracs) * 100
    series, labels = [], []
    for arm in arms:
        if any(str(f) not in results[arm] for f in fracs):
            continue  # an arm measured on another fraction grid
        cols = np.stack([np.asarray(results[arm][str(f)]) for f in fracs])
        series.append(np.concatenate([xs[:, None], cols], axis=1))
        labels.append(ARM_LABELS[arm])
    curve_std(series, labels, ax=ax)
    ax.set_xlabel("% of labeled patients")
    ax.set_ylabel("volumetric Dice (ICH-positive)")
    fig.tight_layout()
    fig.savefig(os.path.join(out_root, "label_efficiency.png"), dpi=150)
    plt.close(fig)


def _ci(x: np.ndarray) -> tuple:
    """(mean, half-width of its 95% CI, 1.96·σ/√n, n)."""
    x = np.asarray(x, dtype=np.float64)
    return float(x.mean()), float(1.96 * x.std(ddof=1) / np.sqrt(len(x))), len(x)


def _overlap(a: tuple, b: tuple) -> bool:
    return a[0] - a[1] <= b[0] + b[1] and b[0] - b[1] <= a[0] + a[1]


def _seed_of(path: str) -> Optional[int]:
    """The training seed in a run's name (``seed42.json``,
    ``label_efficiency_rescue_seed42.json``, ``seed42/results.json``)."""
    name = os.path.basename(path)
    if name == "results.json":
        name = os.path.basename(os.path.dirname(path))
    m = re.search(r"(\d+)\D*$", name)
    return int(m.group(1)) if m else None


def _n_streams(files, per_seed, arms, frac) -> int:
    """How many random streams the pooled cells of ``arms`` at ``frac``
    drew from: fold k of seed s trains from stream s + k, so the 40 cells
    of 8 consecutive seeds share 12. The cells' count where a run's name
    holds no seed."""
    runs = [(_seed_of(fn), len(res[arms[0]][frac])) for fn, res in zip(files, per_seed)
            if all(frac in res.get(a, {}) for a in arms)]
    if any(seed is None for seed, _ in runs):
        return sum(n for _, n in runs)
    return len({seed + k for seed, n in runs for k in range(n)})


def _difference(port: tuple, ref: tuple, n_port: int, n_ref: int) -> tuple:
    """Port − JAX with its 95% CI, each side's half-width widened from its
    cells' count to its streams' count (``_n_streams``): (difference,
    half-width, streams of the port, streams of the JAX package)."""
    half = [c[1] * np.sqrt(c[2] / min(n, c[2])) for c, n in ((port, n_port), (ref, n_ref))]
    return port[0] - ref[0], float(np.hypot(*half)), n_port, n_ref


def _provenance_line(port_dir: str) -> str:
    """What made the runs of ``port_dir`` (its ``provenance.json``), as a
    markdown paragraph; empty where the runs did not record it."""
    path = os.path.join(port_dir, "provenance.json")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        by_arm = json.load(f)
    groups: Dict[str, List[str]] = {}
    for arm, info in by_arm.items():
        groups.setdefault(json.dumps(info, sort_keys=True), []).append(ARM_LABELS.get(arm, arm))
    parts = []
    for info, arms in groups.items():
        i = json.loads(info)
        parts.append(f"{', '.join(arms)}: torch {i['torch']} (CUDA {i['cuda']}) on "
                     f"{i['device']}, cuDNN TF32 {'on' if i['cudnn_tf32'] else 'off'}, "
                     f"matmul TF32 {'on' if i['matmul_tf32'] else 'off'}"
                     + (f", draws {i['draws']}" if "draws" in i else ""))
    return "Runs made with " + "; ".join(parts) + ".\n\n"


def compare_to_reference(port_dir: str, reference_dir: str = "docs") -> List[dict]:
    """Hold the port's pooled runs against the JAX package's: for each
    (arm, fraction), the mean Dice with its 95% CI (1.96·σ/√n) on both
    sides and whether the two CIs overlap, and the same for each pretrained
    arm's paired Δ over scratch; for the main sweep (``seed*``) and the
    rescue probe (``rescue_seed*``) where both sides have them. Beside
    each pair, the port − JAX difference with its 95% CI at the count of
    distinct random streams (``_n_streams``) rather than of cells, and
    whether it excludes zero. Writes ``comparison.md`` into ``port_dir``,
    headed by its ``provenance.json``; returns the rows whose CIs do not
    overlap."""
    head = ("| runs | arm | labels | quantity | port: mean [95% CI] (n) "
            "| JAX: mean [95% CI] (n) | CIs overlap "
            "| port − JAX [95% CI] (streams: port, JAX) | excludes 0 |")
    lines = [head, "|---|---|---|---|---|---|---|---|---|"]
    apart, differ, n_rows, cr25 = [], [], 0, ""
    for prefix in ("seed", "rescue_seed"):
        sides = [_load_runs(d, prefix) for d in (port_dir, reference_dir)]
        if not all(files for _, _, files in sides):
            continue
        runs = "rescue" if prefix.startswith("rescue") else "main"
        for arm in ARMS:
            for frac in map(str, FRACTIONS):
                if not all(frac in pooled.get(arm, {}) for pooled, _, _ in sides):
                    continue
                quantities = [("Dice", [_ci(pooled[arm][frac]) for pooled, _, _ in sides],
                               (arm,))]
                if arm != "scratch":
                    pairs = [_paired(per_seed, arm, frac) for _, per_seed, _ in sides]
                    quantities.append(("paired Δ", [_ci(p - s) for s, p in pairs],
                                       (arm, "scratch")))
                for name, (port, ref), arms in quantities:
                    ok = _overlap(port, ref)
                    diff = _difference(port, ref, *[_n_streams(files, per_seed, arms, frac)
                                                   for _, per_seed, files in sides])
                    excl = bool(abs(diff[0]) > diff[1])
                    row = {"runs": runs, "arm": arm, "fraction": float(frac),
                           "quantity": name, "port": port, "reference": ref, "overlap": ok,
                           "difference": diff, "differs": excl}
                    if name == "paired Δ":
                        row["port_excludes_zero"] = bool(abs(port[0]) > port[1])
                        if (runs, arm, frac) == ("main", "pretrained", "0.25"):
                            cr25 = ("The CR arm's paired Δ at 25% labels: "
                                    f"port {_fmt(port)}, {_excludes(port)}; "
                                    f"JAX {_fmt(ref)}, {_excludes(ref)}.")
                    lines.append(
                        f"| {runs} | {ARM_LABELS[arm]} | {int(float(frac) * 100)}% | {name} "
                        f"| {_fmt(port)} | {_fmt(ref)} | {'yes' if ok else '**no**'} "
                        f"| {diff[0]:+.3f} [{diff[0] - diff[1]:+.3f}, {diff[0] + diff[1]:+.3f}] "
                        f"({diff[2]}, {diff[3]}) | {'**yes**' if excl else 'no'} |")
                    n_rows += 1
                    if not ok:
                        apart.append(row)
                    if excl:
                        differ.append(row)
    lines.append("")
    lines.append(f"{len(apart)} of {n_rows} pairs of CIs do not overlap.")
    lines.append(f"{len(differ)} of {n_rows} port − JAX differences exclude zero at the "
                 f"streams' count (fold k of seed s trains from stream s + k).")
    if cr25:
        lines.append(cr25)
    text = _provenance_line(port_dir) + "\n".join(lines)
    print(text)
    with open(os.path.join(port_dir, "comparison.md"), "w") as f:
        f.write(text + "\n")
    return apart


def _excludes(c: tuple) -> str:
    return f"which {'excludes' if abs(c[0]) > c[1] else 'does not exclude'} zero"


def _fmt(c: tuple) -> str:
    return f"{c[0]:+.3f} [{c[0] - c[1]:+.3f}, {c[0] + c[1]:+.3f}] (n={c[2]})"


def write_snapshot_docs(port_dir: str, reference_dir: str = "docs") -> List[dict]:
    """``table.md`` (the pooled tables of the main sweep and the rescue
    probe, by ``pooled_report``) and ``comparison.md``
    (``compare_to_reference``) for a directory of per-seed snapshots,
    both headed by its ``provenance.json``; returns the rows whose CIs do
    not overlap."""
    parts = []
    for prefix, title in (("seed", "Main sweep"), ("rescue_seed", "10%-labels rescue probe")):
        if not _run_files(port_dir, prefix):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            pooled_report(port_dir, tmp, prefix)
            with open(os.path.join(tmp, "label_efficiency_table.md")) as f:
                parts.append(f"## {title}\n\n{f.read()}")
    with open(os.path.join(port_dir, "table.md"), "w") as f:
        f.write(_provenance_line(port_dir) + "\n".join(parts))
    return compare_to_reference(port_dir, reference_dir)


def cli(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="The paired label-efficiency study.")
    ap.add_argument("--out", required=True, help="output dir (one per seed)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--arms", default="scratch,pretrained,contrastive",
                    help="comma-separated subset of scratch/pretrained/contrastive/"
                         "contrastive_local (scratch is the pairing anchor)")
    ap.add_argument("--rescue", action="store_true",
                    help="10%% labels only: a quarter of the negative slices, 2x epochs")
    ap.add_argument("--report-only", action="store_true",
                    help="pool every */results.json under --out into one table")
    ap.add_argument("--snapshots", metavar="REFERENCE_DIR",
                    help="write table.md and comparison.md for the snapshots in --out "
                         "against the JAX package's in REFERENCE_DIR")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.snapshots:
        return write_snapshot_docs(args.out, args.snapshots)
    if args.report_only:
        return pooled_report(args.out)
    setup_logger()
    return main(args.out, seed=args.seed, arms=tuple(args.arms.split(",")),
                rescue=args.rescue, device=args.device)


if __name__ == "__main__":
    cli()
