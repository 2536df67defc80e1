"""The port's k-fold experiment (``run_supervised_2d`` and its CLI), the SegICH
2D loader against the JAX package's, and the BMP writer read back by PIL."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from ich_tpu.data import segich as jax_segich
from ich_tpu.data.synthetic import write_segich_tree
from ich_tpu_torch.data import segich
from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.synthetic import synthetic_ich_slices
from ich_tpu_torch.experiments import supervised2d
from ich_tpu_torch.experiments.supervised2d import run_supervised_2d
from ich_tpu_torch.utils import preemption

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp_path, n_fold=2, **train):
    with open(os.path.join(ROOT, "configs", "unet2d.json")) as f:
        cfg = json.load(f)
    cfg["exp_name"] = "exp"
    cfg["path"] = {"DATA": str(tmp_path / "data"), "OUTPUT": str(tmp_path / "out")}
    cfg["split"]["n_fold"] = n_fold
    cfg["data"]["size"] = 32
    cfg["net"].update(depth=3, top_filter=8)
    cfg["train"].update({"n_epoch": 2, "batch_size": 8, **train})
    return cfg


def _folds(k):
    return (synthetic_ich_slices(n_slices=24, size=32, n_volumes=3, seed=k),
            synthetic_ich_slices(n_slices=12, size=32, n_volumes=2, seed=100 + k))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_kfold_experiment_artifacts(tmp_path):
    """The config's augmentation and validation, two folds of two epochs:
    every fold artifact, the checkpoint gone, and the aggregate files."""
    out = run_supervised_2d(_cfg(tmp_path), datasets_by_fold=_folds, device="cpu")
    scores = []
    vol_rows = []
    for k in (1, 2):
        fold = os.path.join(out, f"Fold_{k}")
        for name in ("outputs.json", "trained_unet.bin", "log.txt",
                     "pred/slice_prediction_scores.csv", "pred/volume_prediction_scores.csv"):
            assert os.path.exists(os.path.join(fold, name)), name
        assert not os.path.exists(os.path.join(fold, "checkpoint.bin"))
        with open(os.path.join(fold, "outputs.json")) as f:
            o = json.load(f)
        hist = o["train"]["evolution"]
        assert len(hist) == 2 and all(np.isfinite(r[1]) and r[2] is not None for r in hist)
        scores.append([o["eval"]["dice"]["all"], o["eval"]["dice"]["positive"]])
        bmps = [f for _, _, fs in os.walk(os.path.join(fold, "pred")) for f in fs
                if f.endswith(".bmp")]
        assert len(bmps) == 12
        slice_rows = _rows(os.path.join(fold, "pred/slice_prediction_scores.csv"))
        assert slice_rows[0] == ["", "volID", "slice", "label", "TP", "TN", "FP", "FN",
                                 "pred_fn", "Dice"] and len(slice_rows) == 13
        vol_rows += _rows(os.path.join(fold, "pred/volume_prediction_scores.csv"))[1:]
        log = open(os.path.join(fold, "log.txt")).read()
        assert "Cross-Validation fold" in log and "Epoch: 001/002" in log
    avg = open(os.path.join(out, "average_scores.txt")).read().splitlines()
    s = np.asarray(scores)
    assert avg == [f"Dice = {s[:, 0].mean()} +/- {1.96 * s[:, 0].std()}",
                   f"Dice (Positive) = {s[:, 1].mean()} +/- {1.96 * s[:, 1].std()}"]
    # pandas' concat(...).reset_index(drop=True).to_csv of the volume CSVs;
    # pandas' default float parser is not round-trip exact (it may drop
    # digits past the 17th), and the port writes what it reads
    frames = [pd.read_csv(os.path.join(out, f"Fold_{k}/pred/volume_prediction_scores.csv"))
              for k in (1, 2)]
    want = str(tmp_path / "want.csv")
    pd.concat(frames, axis=0).reset_index(drop=True).to_csv(want)
    got_rows, want_rows = _rows(os.path.join(out, "all_volume_prediction.csv")), _rows(want)
    assert got_rows[0] == want_rows[0] and len(got_rows) == len(want_rows) == 5
    for g, w in zip(got_rows[1:], want_rows[1:]):
        assert g == w and g[1:3] == vol_rows[int(g[0])][:2]
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["train"]["n_epoch"] == 2


def test_kfold_fold_idempotency(tmp_path):
    """A fold with an outputs.json is skipped on a re-run."""
    cfg = _cfg(tmp_path)
    out = run_supervised_2d(cfg, datasets_by_fold=_folds, device="cpu")
    mtime = os.path.getmtime(os.path.join(out, "Fold_1/outputs.json"))
    run_supervised_2d(cfg, datasets_by_fold=_folds, device="cpu")
    assert os.path.getmtime(os.path.join(out, "Fold_1/outputs.json")) == mtime


def test_preemption_checkpoints_and_exits_143(tmp_path):
    """A SIGTERM during a fold: the epoch finishes, a checkpoint is written,
    no outputs.json, exit 143; the restart resumes from the checkpoint."""
    cfg = _cfg(tmp_path, n_fold=1)
    preemption.reset()
    try:
        preemption._handler(15, None)
        with pytest.raises(SystemExit) as exc:
            run_supervised_2d(cfg, datasets_by_fold=_folds, device="cpu")
        assert exc.value.code == 143
    finally:
        preemption.reset()
    fold = tmp_path / "out" / "exp" / "Fold_1"
    assert (fold / "checkpoint.bin").exists() and not (fold / "outputs.json").exists()
    run_supervised_2d(cfg, datasets_by_fold=_folds, device="cpu")
    log = (fold / "log.txt").read_text()
    assert "Recovering Session" in log and "Checkpoint loaded with 1 epoch finished" in log
    assert not (fold / "checkpoint.bin").exists() and (fold / "outputs.json").exists()


def test_gated_unet_and_missing_card_raise():
    """The config's ``gated`` builds the gated U-Net (each conv emits twice
    its channels: features and gate); a missing card raises."""
    net = supervised2d.build_unet_from_cfg({"gated": True, "depth": 3, "top_filter": 4,
                                            "in_channels": 2})
    assert net.down_block[0].gated and net.down_block[0].conv1.weight.shape[:2] == (4, 2)
    assert net(torch.zeros(1, 2, 8, 8)).shape == (1, 1, 8, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            supervised2d.UNet2D(supervised2d.build_unet_from_cfg({"depth": 2}), device="cuda")


@pytest.fixture(scope="module")
def segich_tree(tmp_path_factory):
    """A publicSegICH2D tree on disk (tif slices in HU, bmp masks, the two
    CSVs), written by the JAX package's fixture writer: 6 patients."""
    root = str(tmp_path_factory.mktemp("segich"))
    ds = synthetic_ich_slices(n_slices=36, size=40, n_volumes=6, seed=5)
    write_segich_tree(ds, root)
    return root


def test_load_segich_2d_matches_jax(segich_tree):
    """Windowing (the port's ``window_ct``) and the 40 -> 32 host resize
    give the JAX loader's arrays within 1e-6; masks and ids equal."""
    info = pd.read_csv(os.path.join(segich_tree, "ct_info.csv"), index_col=0)
    got = segich.load_segich_2d(segich_tree, info, window=(50, 200), size=32)
    want = jax_segich.load_segich_2d(segich_tree, info, window=(50, 200), size=32)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.vol_ids, want.vol_ids)
    np.testing.assert_array_equal(got.slice_nbrs, want.slice_nbrs)
    sub = segich.subsample_negatives(info, 0.5, seed=3)
    pd.testing.assert_frame_equal(sub, jax_segich.subsample_negatives(info, 0.5, seed=3))
    assert (segich.split_summary_table(info, sub, info)
            == jax_segich.split_summary_table(info, sub, info))


def test_cli_runs_a_csv_config_to_its_aggregates(segich_tree, tmp_path):
    """``python -m ich_tpu_torch.experiments.supervised2d CONFIG.json`` on
    the CPU: the CSV path (patient folds from the numpy stratified split,
    negative subsampling, the loader) to the aggregate files; each fold
    tests the patients scikit-learn's StratifiedKFold gives it."""
    cfg = _cfg(tmp_path, n_fold=3, n_epoch=1)
    cfg["path"]["DATA"] = segich_tree
    cfg_fn = str(tmp_path / "cfg.json")
    with open(cfg_fn, "w") as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "ich_tpu_torch.experiments.supervised2d",
                        cfg_fn, "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "out" / "exp"
    for name in ("average_scores.txt", "all_volume_prediction.csv", "config.json"):
        assert (out / name).exists(), name
    from sklearn.model_selection import StratifiedKFold

    patients = pd.read_csv(os.path.join(segich_tree, "patient_info.csv"), index_col=0)
    split = StratifiedKFold(n_splits=3, shuffle=True, random_state=cfg["seed"]).split(
        patients.PatientNumber, patients.Hemorrhage)
    for k, (_, test_idx) in enumerate(split):
        vols = [int(r[0]) for r in _rows(out / f"Fold_{k + 1}/pred/volume_prediction_scores.csv")[1:]]
        assert vols == sorted(patients.PatientNumber.iloc[test_idx]), k


@pytest.mark.parametrize("shape", [(32, 32), (5, 7), (3, 10)])
def test_bmp_writer_reads_back_in_pil(tmp_path, shape):
    """Rows padded to 4 bytes and stored bottom-up: PIL reads the array
    back, as an 8-bit grey image like the ones it writes itself."""
    img = (np.random.default_rng(sum(shape)).uniform(size=shape) > 0.5).astype(np.uint8) * 255
    img[0, 0] = 7
    fn = str(tmp_path / "p.bmp")
    save_bmp_gray(fn, img)
    with Image.open(fn) as im:
        assert im.format == "BMP" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im.convert("L")), img)
    Image.fromarray(img).save(str(tmp_path / "pil.bmp"))
    assert os.path.getsize(fn) == os.path.getsize(str(tmp_path / "pil.bmp"))
    with pytest.raises(ValueError):
        save_bmp_gray(fn, img.astype(np.float32))
