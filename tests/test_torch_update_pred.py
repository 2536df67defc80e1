"""The brain-only post-filter against the JAX package's on identical
on-disk artifacts: ``update_pred_folder`` / ``update_kfold_folder`` and
``update_anomaly_pred_folder`` give text-equal CSVs (the concatenated
``all_volume_prediction.csv`` within pandas' float parsing, rtol 1e-14),
equal ``outputs.json`` and ``average_scores.txt``, and rewritten BMPs that
decode equal; the PIL-``NEAREST`` emulation against PIL; the
``pred_on_brain`` CLI against the JAX package's script logic (PIL resize,
JAX update); the ``segment_brain`` CLI on two NIfTIs."""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from ich_tpu.postprocessing import update_pred as jax_update
from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_segich_tree
from ich_tpu_torch.experiments import pred_on_brain, segment_brain
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.postprocessing import update_pred
from ich_tpu_torch.train.segmentation2d import UNet2D

torch.set_num_threads(2)

N_FOLD, SIZE = 2, 24


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _disc(n, size, rng):
    yy, xx = np.mgrid[0:size, 0:size]
    r = rng.uniform(0.2, 0.5, n)[:, None, None] * size
    return ((yy - size / 2) ** 2 + (xx - size / 2) ** 2 < r ** 2).astype(np.float32)


def _experiment(root, ds, rng):
    """k-fold prediction artifacts: each fold's ``pred/<vol>/<slice>.bmp``
    (random blobs, one slice left out), a stale CSV and ``outputs.json``."""
    for k in range(N_FOLD):
        pred = os.path.join(root, f"Fold_{k + 1}", "pred")
        for i in range(len(ds)):
            if i == 3:
                continue
            os.makedirs(os.path.join(pred, str(int(ds.vol_ids[i]))), exist_ok=True)
            blob = (rng.uniform(size=(SIZE, SIZE)) > 0.6).astype(np.uint8) * 255
            save_bmp_gray(os.path.join(pred, f"{int(ds.vol_ids[i])}/{int(ds.slice_nbrs[i])}.bmp"),
                          blob)
        with open(os.path.join(pred, "volume_prediction_scores.csv"), "w") as f:
            f.write("volID,label,TP,TN,FP,FN,Dice\n")
        with open(os.path.join(root, f"Fold_{k + 1}", "outputs.json"), "w") as f:
            json.dump({"train": {"time": 1.5}, "eval": {"dice": {"all": 0.1}}}, f)


@pytest.fixture
def setup(tmp_path):
    rng = np.random.default_rng(0)
    ds = synthetic_ich_slices(n_slices=12, size=SIZE, n_volumes=3, seed=1)
    _experiment(str(tmp_path / "port"), ds, rng)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    brains = [_disc(len(ds), SIZE, np.random.default_rng(10 + k)) for k in range(N_FOLD)]
    return ds, brains


def test_update_kfold_folder_matches_jax(tmp_path, setup):
    ds, brains = setup
    update_pred.update_kfold_folder(str(tmp_path / "port"), N_FOLD, lambda k: ds,
                                    lambda k: brains[k])
    jax_update.update_kfold_folder(str(tmp_path / "jax"), N_FOLD, lambda k: ds,
                                   lambda k: brains[k])
    for k in range(N_FOLD):
        fold = f"Fold_{k + 1}"
        for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
            got = (tmp_path / "port" / fold / "pred" / name).read_bytes()
            assert got == (tmp_path / "jax" / fold / "pred" / name).read_bytes(), (fold, name)
        assert len(_rows(tmp_path / "port" / fold / "pred" / "slice_prediction_scores.csv")) == 12
        assert json.loads((tmp_path / "port" / fold / "outputs.json").read_bytes()) == \
            json.loads((tmp_path / "jax" / fold / "outputs.json").read_bytes())
        for r, _, fs in os.walk(tmp_path / "jax" / fold / "pred"):
            for f in fs:
                if f.endswith(".bmp"):
                    a = np.asarray(Image.open(os.path.join(r, f)))
                    b = np.asarray(Image.open(os.path.join(r, f).replace("/jax/", "/port/")))
                    assert np.array_equal(a, b), f
    assert (tmp_path / "port" / "average_scores.txt").read_bytes() == \
        (tmp_path / "jax" / "average_scores.txt").read_bytes()
    got = _rows(tmp_path / "port" / "all_volume_prediction.csv")
    want = _rows(tmp_path / "jax" / "all_volume_prediction.csv")
    assert got[0] == want[0] and len(got) == len(want) == 1 + 3 * N_FOLD
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3]
        np.testing.assert_allclose([float(x) for x in g[3:]], [float(x) for x in w[3:]],
                                   rtol=1e-14)


def test_update_pred_folder_with_no_brain_and_full_brain(tmp_path, setup):
    """An all-ones brain leaves every BMP byte-equal and a second pass the
    same CSVs; an all-zeros brain empties every prediction."""
    ds, _ = setup
    fold = str(tmp_path / "port" / "Fold_1")
    bmps = sorted(os.path.join(r, f) for r, _, fs in os.walk(fold) for f in fs
                  if f.endswith(".bmp"))
    before = [open(f, "rb").read() for f in bmps]
    ones = np.ones((len(ds), SIZE, SIZE), np.float32)
    update_pred.update_pred_folder(fold, ds, ones)
    assert [open(f, "rb").read() for f in bmps] == before
    first = (tmp_path / "port" / "Fold_1" / "pred" / "slice_prediction_scores.csv").read_bytes()
    update_pred.update_pred_folder(fold, ds, ones)
    assert (tmp_path / "port" / "Fold_1" / "pred" / "slice_prediction_scores.csv"
            ).read_bytes() == first
    out = update_pred.update_pred_folder(fold, ds, np.zeros_like(ones))
    assert all(not np.asarray(Image.open(f)).any() for f in bmps)
    assert out["train"] == {"time": 1.5}
    scored = np.arange(len(ds)) != 3  # the slice without a prediction BMP
    vids, masks = ds.vol_ids[scored], ds.masks[scored]
    fn = [masks[vids == v].sum() for v in np.unique(vids)]
    assert out["eval"]["dice"]["positive"] == np.mean([1.0 / (1.0 + f) for f in fn if f > 0])


def test_update_anomaly_pred_folder_matches_jax(tmp_path, setup):
    ds, brains = setup
    rng = np.random.default_rng(5)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side / "heat", exist_ok=True)
    for i in range(len(ds)):
        if i == 5:
            continue
        heat = rng.uniform(size=(SIZE, SIZE)).astype(np.float32)
        for side in ("port", "jax"):
            d = tmp_path / side / "heat" / str(int(ds.vol_ids[i]))
            os.makedirs(d, exist_ok=True)
            np.save(d / f"{int(ds.slice_nbrs[i])}.npy", heat)
    cols = update_pred.update_anomaly_pred_folder(str(tmp_path / "port" / "heat"), ds, brains[0])
    jax_update.update_anomaly_pred_folder(str(tmp_path / "jax" / "heat"), ds, brains[0])
    assert len(cols["volID"]) == len(ds) - 1
    for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert (tmp_path / "port" / "heat" / name).read_bytes() == \
            (tmp_path / "jax" / "heat" / name).read_bytes(), name
    update_pred.write_prediction_scores([], str(tmp_path / "port"))
    jax_update.write_prediction_scores([], str(tmp_path / "jax"))
    for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("src,out", [((512, 512), 256), ((630, 630), 256), ((100, 37), 256),
                                     ((300, 300), 128), ((37, 100), 64), ((30, 30), 24)])
def test_resize_nearest_matches_pil(src, out):
    img = np.random.default_rng(sum(src)).integers(0, 256, src).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out, out), Image.NEAREST))
    np.testing.assert_array_equal(pred_on_brain.resize_nearest_pil(img, (out, out)), want)


def test_pred_on_brain_cli_matches_the_jax_script(tmp_path, setup):
    """Brain BMPs at 30^2 resized to the tree's 24^2 by PIL in the JAX
    script and by the emulation in the port; one slice without a brain
    mask keeps its prediction."""
    ds, _ = setup
    write_segich_tree(ds, str(tmp_path / "data"))
    brain30 = _disc(len(ds), 30, np.random.default_rng(3))
    for i in range(1, len(ds)):
        d = tmp_path / "brain" / str(int(ds.vol_ids[i]))
        os.makedirs(d, exist_ok=True)
        save_bmp_gray(str(d / f"{int(ds.slice_nbrs[i])}.bmp"), (brain30[i] * 255).astype(np.uint8))
    pred_on_brain.main(["--exp-dir", str(tmp_path / "port"), "--data-dir", str(tmp_path / "data"),
                        "--brain-dir", str(tmp_path / "brain"), "--n-fold", str(N_FOLD),
                        "--size", str(SIZE)])
    masks = np.ones((len(ds), SIZE, SIZE), np.float32)
    for i in range(1, len(ds)):
        fn = tmp_path / "brain" / str(int(ds.vol_ids[i])) / f"{int(ds.slice_nbrs[i])}.bmp"
        masks[i] = np.asarray(Image.open(fn).resize((SIZE, SIZE), Image.NEAREST)) > 0
    jax_update.update_kfold_folder(str(tmp_path / "jax"), N_FOLD, lambda k: ds, lambda k: masks)
    for k in range(N_FOLD):
        for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
            p = f"Fold_{k + 1}/pred/{name}"
            assert (tmp_path / "port" / p).read_bytes() == (tmp_path / "jax" / p).read_bytes()
    assert (tmp_path / "port" / "average_scores.txt").read_bytes() == \
        (tmp_path / "jax" / "average_scores.txt").read_bytes()


def test_segment_brain_cli(tmp_path):
    torch.manual_seed(0)
    net = UNet(depth=3, top_filter=4, midchannels_factor=1, p_dropout=0.0)
    with torch.no_grad():
        net.final_conv.bias.fill_(-0.01)
    torch.save(net.state_dict(), tmp_path / "m.bin")
    rng = np.random.default_rng(0)
    vols = [rng.uniform(-100, 200, size=(40, 36, z)).astype(np.float32) for z in (5, 7)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"v{i}.nii"))
        nifti.save(paths[-1], v, np.diag([0.5, 0.5, 5.0, 1.0]))
    outs = segment_brain.main(paths + ["-o", str(tmp_path / "out"), "-m", str(tmp_path / "m.bin"),
                                       "--depth", "3", "--top-filter", "4", "--size", "32",
                                       "--batch-size", "4", "--device", "cpu"])
    ref = UNet2D(net, batch_size=4, device="cpu")
    for v, fn in zip(vols, outs):
        got, affine, _ = nifti.load(fn)
        want = ref.segment_volume(v, window=(50.0, 200.0), input_size=(32, 32), return_pred=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(affine, np.diag([0.5, 0.5, 5.0, 1.0]))
    assert fn.endswith("v1_mask.nii.gz")
