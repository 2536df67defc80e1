"""A tiny fold run of the paired label-efficiency study follows the JAX
study's from the same seed: the scratch arm at 100% and 50% of the labels,
2 folds of 2 epochs at the study's own dropout, on the study's data and
splits. Both packages start every fold from the same net and draw the
same shuffles, augmentation, dropout masks and kept patients, so each
fold's Dice (positive slices, as the study collects it) agrees within
``DICE_ATOL``: what is left is float rounding in 16 Adam steps and the
thresholded masks' pixels that it flips."""

import os
import sys

import numpy as np

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks")
sys.path.insert(0, BENCH_DIR)

import label_efficiency_bench as B  # noqa: E402
from ich_tpu.experiments import pretrain_finetune as jax_pf  # noqa: E402

from ich_tpu_torch.experiments import label_efficiency_study as S  # noqa: E402
from ich_tpu_torch.experiments import pretrain_finetune as port_pf  # noqa: E402

DICE_ATOL = 0.01
FRACTIONS = (1.0, 0.5)


def _cfg(base, out):
    cfg = base(str(out), "scratch")
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
