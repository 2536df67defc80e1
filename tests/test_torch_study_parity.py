"""A tiny fold run of the paired label-efficiency study follows the JAX
study's from the same seed: the scratch arm at 100% and 50% of the labels,
2 folds of 2 epochs at the study's own dropout, on the study's data and
splits. Both packages start every fold from the same net and draw the
same shuffles, augmentation, dropout masks and kept patients, so each
fold's Dice (positive slices, as the study collects it) agrees within
``DICE_ATOL``: what is left is float rounding in 16 Adam steps and the
thresholded masks' pixels that it flips.

``run_arm`` and ``hold_arm`` run and hold a pretrained arm the same way,
pretraining included (``tests/test_torch_study_arm_*.py``)."""

import copy
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks")
sys.path.insert(0, BENCH_DIR)

import label_efficiency_bench as B  # noqa: E402
from ich_tpu.experiments import pretrain_finetune as jax_pf  # noqa: E402
from ich_tpu.train import ssl as jax_ssl  # noqa: E402

from ich_tpu_torch.experiments import label_efficiency_study as S  # noqa: E402
from ich_tpu_torch.experiments import pretrain_finetune as port_pf  # noqa: E402
from ich_tpu_torch.interop import from_jax  # noqa: E402
from ich_tpu_torch.train import ssl as port_ssl  # noqa: E402

DICE_ATOL = 0.01
FRACTIONS = (1.0, 0.5)


def _cfg(base, out, name="scratch"):
    cfg = base(str(out), name)
    cfg["split"]["n_fold"] = 2
    cfg["train"]["n_epoch"] = 2
    return cfg


def test_tiny_study_folds_follow_the_jax_study(tmp_path):
    jax_labeled, _ = B.make_datasets()
    port_labeled, _ = S.make_datasets()
    jax_dirs = jax_pf.label_efficiency_sweep(_cfg(B.base_cfg, tmp_path / "jax"), None,
                                             B.folds_fn(jax_labeled, n_folds=2),
                                             fractions=FRACTIONS, seed=42)
    port_dirs = port_pf.label_efficiency_sweep(_cfg(S.base_cfg, tmp_path / "port"), None,
                                               S.folds_fn(port_labeled, n_folds=2),
                                               fractions=FRACTIONS, seed=42, device="cpu")
    for frac in FRACTIONS:
        want = B.collect_dice(jax_dirs[frac], n_folds=2)
        got = S.collect_dice(port_dirs[frac], n_folds=2)
        assert want.shape == got.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=0, atol=DICE_ATOL, err_msg=str(frac))


# The pretrained arms at a cut scale: 32 px (the local phase's region
# NT-Xent needs 13 cells of 3x3 on a map of half the input's side), one
# pretraining epoch a phase over the first 256 of the 768 unlabelled
# slices (8 steps of 32), 2 folds of 2 fine-tune epochs at one fraction,
# seed 42.
ARM_SIZE = 32
ARM_UNLABELED = 256
ARM_SEED = 42
ARM_FRACTION = 1.0
LR = S.base_cfg("", "")["train"]["lr"]
TO_PORT = {"pretrained": from_jax.unet_state_dict_from_jax,
           "contrastive": from_jax.unet_encoder_state_dict_from_jax,
           "contrastive_local": from_jax.partial_unet_state_dict_from_jax}


@dataclass
class ArmRun:
    """Both packages' run of one arm: each pretraining phase's per-step
    losses, the port's net before each phase's first step, the pretrained
    weights (the JAX package's in the port's keys) and each fold's Dice."""
    jax_losses: List[List[float]] = field(default_factory=list)
    port_losses: List[List[float]] = field(default_factory=list)
    port_starts: List[Dict[str, np.ndarray]] = field(default_factory=list)
    jax_weights: Dict[str, np.ndarray] = field(default_factory=dict)
    port_weights: Dict[str, np.ndarray] = field(default_factory=dict)
    jax_dice: np.ndarray = None
    port_dice: np.ndarray = None


def _record_steps(run: ArmRun, monkeypatch) -> None:
    """Record every pretraining step's loss in both packages, a phase a
    trainer, and the port's net before each phase's first step."""
    for cls in (jax_ssl.ContextRestoration, jax_ssl.Contrastive):
        def make_recording(self, make=cls._make_train_step):
            step = make(self)
            losses = []
            run.jax_losses.append(losses)

            def recording(state, *args):
                state, loss = step(state, *args)
                losses.append(float(loss))
                return state, loss

            return recording

        monkeypatch.setattr(cls, "_make_train_step", make_recording)
    phases = {}
    for cls in (port_ssl.ContextRestoration, port_ssl.Contrastive):
        def recording(self, state, batch, key, step=cls._train_step):
            if id(self) not in phases:
                phases[id(self)] = []
                run.port_losses.append(phases[id(self)])
                run.port_starts.append({k: t.detach().clone().numpy()
                                        for k, t in state.model.state_dict().items()})
            loss = step(self, state, batch, key)
            phases[id(self)].append(float(loss))
            return loss

        monkeypatch.setattr(cls, "_train_step", recording)


def _one_epoch(pretrain):
    """The JAX pretrainer on the bench's own config, cut to one epoch a
    phase."""
    def cut(cfg, *args, **kw):
        cfg = copy.deepcopy(cfg)
        cfg["train"]["n_epoch"] = 1
        if cfg.get("local"):
            cfg["local"]["n_epoch"] = 1
        return pretrain(cfg, *args, **kw)

    return cut


def run_arm(arm: str, tmp_path, monkeypatch) -> ArmRun:
    """``arm`` of the JAX study (``benchmarks/label_efficiency_bench.py``'s
    pretrainer on its own config and views) and of the port's study
    (``label_efficiency_study``'s pretrainer), each pretrained on its
    package's unlabelled slices, then fine-tuned by its package's
    ``label_efficiency_sweep`` from its own pretrained weights."""
    run = ArmRun()
    _record_steps(run, monkeypatch)
    for name in ("pretrain_context_restoration", "pretrain_contrastive"):
        monkeypatch.setattr(jax_pf, name, _one_epoch(getattr(jax_pf, name)))
    # reporting only, which moves no weight: the t-SNE of the CR phase and
    # the k-fold experiment's PDF, skipped in both packages
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with monkeypatch.context() as m:
            m.setattr(B, "SIZE", ARM_SIZE)
            jax_labeled, jax_unlabeled = B.make_datasets()
        port_labeled, port_unlabeled = S.make_datasets(size=ARM_SIZE)
        jax_unlabeled = jax_unlabeled.subset(np.arange(ARM_UNLABELED))
        port_unlabeled = port_unlabeled.subset(np.arange(ARM_UNLABELED))
        jax_w = B.PRETRAINERS[arm](str(tmp_path / "jax"), ARM_SEED, jax_unlabeled)
        port_w = S.PRETRAINERS[arm](str(tmp_path / "port"), ARM_SEED, port_unlabeled,
                                    device="cpu", n_epoch=1)
        run.jax_weights = {k: np.asarray(v) for k, v in TO_PORT[arm](jax_w).items()}
        run.port_weights = {k: t.detach().clone().numpy() for k, t in port_w.items()}
        jax_dirs = jax_pf.label_efficiency_sweep(
            _cfg(B.base_cfg, tmp_path / "jax", arm), jax_w, B.folds_fn(jax_labeled, n_folds=2),
            fractions=(ARM_FRACTION,), seed=ARM_SEED)
        port_dirs = port_pf.label_efficiency_sweep(
            _cfg(S.base_cfg, tmp_path / "port", arm), port_w,
            S.folds_fn(port_labeled, n_folds=2), fractions=(ARM_FRACTION,), seed=ARM_SEED,
            device="cpu")
    finally:
        torch.set_num_threads(torch_threads)
    run.jax_dice = B.collect_dice(jax_dirs[ARM_FRACTION], n_folds=2)
    run.port_dice = S.collect_dice(port_dirs[ARM_FRACTION], n_folds=2)
    return run


def _noise_bias(key: str, keys) -> bool:
    """A conv bias that feeds a BatchNorm (``X.convN.bias`` beside
    ``X.bnN.weight``): the norm subtracts it, so its gradient is rounding
    noise and Adam walks it by about ``LR`` a step either way."""
    m = re.fullmatch(r"(.*)\.conv(\d)\.bias", key)
    return bool(m) and f"{m.group(1)}.bn{m.group(2)}.weight" in keys


def _ratio(run: ArmRun, keys) -> float:
    """How far the port's weights of ``keys`` lie from the JAX package's,
    over how far pretraining moved them: ||port - JAX|| / ||port - start||
    summed over the tensors, ``start`` the net before the first phase that
    holds the key."""
    apart = moved = 0.0
    for k in keys:
        start = next(s[k] for s in run.port_starts if k in s)
        apart += float(np.sum((run.port_weights[k] - run.jax_weights[k]) ** 2))
        moved += float(np.sum((run.port_weights[k] - start) ** 2))
    return float(np.sqrt(apart / moved))


def hold_arm(run: ArmRun, first_rtol: float, loss_rtol, weight_ratio, stats_ratio: float):
    """Hold one arm's run, each part within its own tolerance:

    1. the pretraining's per-step losses: a phase's steps as many in both
       packages, the first step of the arm within ``first_rtol`` and every
       step of phase i within ``loss_rtol[i]``;
    2. the pretrained weights, in the port's keys (``interop/from_jax``):
       the same keys and shapes; for the weights first moved by phase i,
       ``_ratio`` within ``weight_ratio[i]``; for the BatchNorm running
       statistics, ``_ratio`` within ``stats_ratio``; each conv bias that
       feeds a BatchNorm within 2 ``LR`` a step of its phases;
    3. each fold's Dice within ``DICE_ATOL``."""
    jl, pl = run.jax_losses, run.port_losses
    assert [len(p) for p in pl] == [len(p) for p in jl] and len(pl) == len(loss_rtol)
    np.testing.assert_allclose(pl[0][0], jl[0][0], rtol=first_rtol, err_msg="first step")
    for i, (got, want) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(got, want, rtol=loss_rtol[i], err_msg=f"phase {i}")

    pw, jw = run.port_weights, run.jax_weights
    assert pw.keys() == jw.keys()
    assert all(pw[k].shape == jw[k].shape for k in pw)
    floats = [k for k in pw if pw[k].dtype.kind == "f"]
    assert all(np.array_equal(pw[k], jw[k]) for k in pw if k not in floats)
    first_phase = {k: next(i for i, s in enumerate(run.port_starts) if k in s) for k in floats}
    noise = [k for k in floats if _noise_bias(k, pw)]
    stats = [k for k in floats if k.endswith(("running_mean", "running_var"))]
    for k in noise:
        steps = sum(len(p) for p in pl[first_phase[k]:])
        assert np.abs(pw[k] - jw[k]).max() <= 2 * LR * steps, k
    assert _ratio(run, stats) <= stats_ratio, _ratio(run, stats)
    for i, bound in enumerate(weight_ratio):
        keys = [k for k in floats if first_phase[k] == i and k not in noise and k not in stats]
        assert keys and _ratio(run, keys) <= bound, (i, _ratio(run, keys))

    assert run.port_dice.shape == run.jax_dice.shape == (2,)
    np.testing.assert_allclose(run.port_dice, run.jax_dice, rtol=0, atol=DICE_ATOL)
